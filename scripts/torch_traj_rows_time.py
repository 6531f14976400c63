"""The trajectory model's short K-31 rows (``traj_rows``) over a grid of
batches and frames a row: dgrad's span kernel and wgrad's item kernel
timed beside the whole-row kernels on the same inputs, in f32 and bf16,
the evidence behind the ranges that ``dgrad_rows_routed`` and
``wgrad_items_routed`` route (run from the repo root on a GPU):

    python3 scripts/torch_traj_rows_time.py

At each (batch, T) of ``BATCHES`` x ``FRAMES`` the four levels (C_in 72 / 84 / 108 / 168, stride 1,
padding 15) run under the span kernels' own plans (``dgrad_span_plan``,
its split counted in stages and its waves in the clusters the card holds;
``wgrad_span_plan``: items of one batch's columns) and the whole-row plans
(``dgrad_whole_plan``, ``wgrad_whole_plan``), whether or not the wrapper
routes the shape there, and cuDNN's ``conv1d_input`` / ``conv1d_weight``
on the same folded weight (TF32 off; unused by the port), the plain
versions (``fused_conv_pool_{dgrad,wgrad}_reference``) and the bounds
(the larger of the least bytes over 3.35 TB/s and the operations over the
dtype's peak, ``chip_smoke.bwd_work``).  Each span
result is held against its plain version (f32 1e-4 * max(1, max|ref|),
bf16 0.02 * max|ref|) and bit-equal on two runs.  Device ms: 20 launches
in a CUDA graph, the median of 7 replays (dgrad's span time with its
weight layout).  One JSON line a shape
and dtype (the sums over the levels, each level's times, whether the
wrapper routes it), then the shapes where a span kernel lost and the card;
exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the grid: every batch under 64 that the trajectory model's paths use (8
# training, 10 the solve's windows) and the powers of two around them; T
# over the span kernels' reach for whole rows (a 158-column padded row at 128)
BATCHES = (1, 2, 4, 8, 10, 16, 32, 48, 63)
FRAMES = (64, 80, 96, 112, 128)


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_traj_rows_time.py needs a GPU")
    # the plain versions in full f32, as chip_smoke.py runs them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from hm_vae_torch.models.trajectory import TrajectoryModel
    from hm_vae_torch.ops import _build
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.utils.config import load_config

    print(cs.nvidia_smi(), flush=True)
    _build.load_all(["fused_conv_pool", "fused_conv_pool_bwd"])
    tcfg = load_config(cs.TRAJ_CONFIG)
    gen = torch.Generator().manual_seed(cs.SEED)
    tmodel = TrajectoryModel(tcfg.model, tcfg.optim.init, generator=gen).to("cuda")
    convs = [getattr(tmodel.encoder, f"conv_{i}") for i in range(4)]
    dev = torch.cuda.current_device()
    sms = fcp._sm_count(dev)
    bad, lost = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        for T in FRAMES:
            for b in BATCHES:
                row = {"batch": b, "T": T, "dtype": dt, "levels": []}
                for i, conv in enumerate(convs):
                    s, wf, bf, x, y, gy = cs.bwd_inputs(conv, T, gen, b, dtype)
                    K, stride, pad, esz = s.kernel_size, s.stride, s.padding, gy.element_size()
                    T_out, mode = y.shape[2], "reflect" if s.reflect else "constant"
                    assert fcp.traj_rows(b, T, K, stride, pad), (b, T)
                    d_plan = fcp.dgrad_span_plan(
                        b, T, K, stride, pad, s.dgrad_span_start.numel() - 1,
                        s.dgrad_span_max_live, sms, 1, esz,
                        lambda: fcp.span_clusters(dev, K, stride, esz))
                    dw_plan = cs.whole_row_plan(s, gy, T)
                    cols = fcp.wgrad_span_cols(K, stride, esz)
                    t_ld = -(-T_out // (16 // esz)) * (16 // esz)
                    w_plan = fcp.wgrad_span_plan(
                        b, T_out, s.wgrad_row.numel(), sms, 1, cols, 1,
                        fcp.wgrad_items_per_sm(K, stride, cols, esz, 1, T, T_out, t_ld))
                    ww_plan = cs.whole_row_wgrad_plan(s, gy, T)
                    runs = {
                        "dgrad_span": lambda: fcp._dgrad(gy, y, wf, s, T, None, d_plan),
                        "dgrad_whole": lambda: fcp._dgrad(gy, y, wf, s, T, None, dw_plan),
                        "wgrad_items": lambda: fcp._wgrad(gy, y, x, s, None, w_plan)[0],
                        "wgrad_whole": lambda: fcp._wgrad(gy, y, x, s, None, ww_plan)[0],
                        "dgrad_lib": lambda: torch.nn.grad.conv1d_input(
                            (b, wf.shape[1], T + 2 * pad), wf,
                            torch.where(y >= 0, gy, gy * s.negative_slope)),
                        "wgrad_lib": lambda: torch.nn.grad.conv1d_weight(
                            F.pad(x, (pad, pad), mode=mode), wf.shape,
                            torch.where(y >= 0, gy, gy * s.negative_slope)),
                        "dgrad_plain": lambda: fcp.fused_conv_pool_dgrad_reference(
                            gy, y, wf, T, stride, pad, mode, s.negative_slope),
                        "wgrad_plain": lambda: fcp.fused_conv_pool_wgrad_reference(
                            gy, y, x, K, stride, pad, mode, s.negative_slope,
                            s.live_elements())}
                    refs = {"dgrad_span": fcp.fused_conv_pool_dgrad_reference(
                                gy, y, wf, T, stride, pad, mode, s.negative_slope),
                            "wgrad_items": fcp.fused_conv_pool_wgrad_reference(
                                gy, y, x, K, stride, pad, mode, s.negative_slope,
                                s.live_elements())[0]}
                    lv = {}
                    for what, ref in refs.items():
                        out = runs[what]()
                        err = float((out.float() - ref.float()).abs().max())
                        ok = (err <= cs.TOL[dtype](float(ref.float().abs().max()))
                              and torch.equal(runs[what](), out))
                        lv[f"{what}_err"] = err
                        if not ok:
                            bad.append(f"traj{i} ({b}, {T}) {dt} {what}: max|err| {err}")
                    for what, fn in runs.items():
                        lv[what] = cs.device_ms(fn)
                    lv["dgrad_plan"], lv["wgrad_plan"] = d_plan._asdict(), w_plan._asdict()
                    d_bytes, w_bytes, d_ops, w_ops = cs.bwd_work(gy, y, x, wf)
                    for what, nb, no in (("dgrad", d_bytes, d_ops), ("wgrad", w_bytes, w_ops)):
                        lv[f"{what}_bound"] = max(nb / cs.MEM_BPS, no / cs.PEAK_FLOPS[dtype]) * 1e3
                    row["levels"].append(lv)
                for what in runs:
                    row[f"{what}_ms"] = sum(lv[what] for lv in row["levels"])
                for what in ("dgrad", "wgrad"):
                    row[f"{what}_bound_ms"] = sum(lv[f"{what}_bound"] for lv in row["levels"])
                row["dgrad_routed"] = fcp.dgrad_rows_routed(b, T, 31, 1, 15, esz)
                row["wgrad_routed"] = fcp.wgrad_items_routed(b, T, 31, 1, 15, esz)
                for k, span, whole in (("dgrad", "dgrad_span_ms", "dgrad_whole_ms"),
                                       ("wgrad", "wgrad_items_ms", "wgrad_whole_ms")):
                    if row[span] >= row[whole]:
                        lost.append(f"{k} ({b}, {T}) {dt}: {row[span]:.4f} >= "
                                    f"{row[whole]:.4f} ms, routed {row[f'{k}_routed']}")
                print(json.dumps(row), flush=True)
    print(json.dumps({"span_kernels_lost": lost, "failed": bad}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
