"""dgrad's span kernel against its plain version, in both of its forms and
both element types, and timed unrouted beside the whole-row kernel (run
from the repo root on a GPU):

    python3 scripts/torch_dgrad_span_check.py [--parent FILE] [--time]

At the len-64 model's eight levels at batch 64 and 8 and the trajectory
model's four K-31 levels at (8, 128), the span kernel runs spans of
several batches' whole rows under its own plan (``dgrad_span_plan``; at
the trajectory's (8, 128) its split counted in stages, as routed), whether
or not ``dgrad_plan`` routes the shape there; at (8, 1,024), (1,
7,200) and the stride-2 level at (8, 1,024), spans of one batch's long
row.  Each case, in f32 and bf16: the kernel against
``fused_conv_pool_dgrad_reference`` (f32 1e-4 * max(1, max|ref|), bf16 0.02
* max|ref|), two runs bit-equal, its weight layout (``dgrad_span_pack``)
bit for bit its plain version.  ``--parent FILE``: a copy of
``fused_conv_pool_bwd.cu`` from another commit (``git show
<commit>:hm_vae_torch/csrc/fused_conv_pool_bwd.cu > FILE``), built beside;
its f32 long-row dgrad, on the same weight layout, must give the same bits
where the plan's split is 1 (a cluster's ranks walk the same stages as
one block; a source from before the stages' runs split row tiles).
``--time``: device ms (CUDA graphs) of the span kernel with its layout, the
whole-row kernel and cuDNN's ``conv1d_input`` at the rows' shapes, summed a
shape.  One JSON line a case, then the sums and the card; exits 1 if a
check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a copy of fused_conv_pool_bwd.cu whose long-row dgrad is compared")
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dgrad_span_check.py needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.models.trajectory import TrajectoryModel
    from hm_vae_torch.ops import _build
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.utils.config import load_config

    print(cs.nvidia_smi(), flush=True)
    _build.load_all(["fused_conv_pool", "fused_conv_pool_bwd"])
    parent = None
    if args.parent:
        out = os.path.join(ROOT, "build", "dgrad_span_check")
        os.makedirs(out, exist_ok=True)
        lib = os.path.join(out, "libparent_bwd.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                        lib, args.parent], check=True)
        parent = fcp._bind(ctypes.CDLL(lib), "hmvae_conv_dgrad", fcp.DGRAD_ARGTYPES)

    cfg = load_config(cs.CONFIG)
    gen = torch.Generator().manual_seed(cs.SEED)
    model = HMVAE(cfg.model, cfg.optim.init, generator=gen).to("cuda")
    tcfg = load_config(cs.TRAJ_CONFIG)
    tmodel = TrajectoryModel(tcfg.model, tcfg.optim.init,
                             generator=torch.Generator().manual_seed(cs.SEED)).to("cuda")
    traj = [(f"traj{i}", getattr(tmodel.encoder, f"conv_{i}")) for i in range(4)]
    cases = []  # (shape, level, conv, batch, T)
    for b in (64, 8):
        cases += [(f"len64_b{b}", n, c, b, T)
                  for n, c, T in cs.level_cases(model, get_structure(cfg.model))]
    cases += [("traj_b8_t128", n, c, 8, 128) for n, c in traj]
    cases += [(f"traj_b{b}_t{T}", n, c, b, T) for b, T in ((8, 1024), (1, 7200)) for n, c in traj]
    cases.append(("enc1_b8_t1024", "enc1", model.encoder.conv_1, 8, 1024))
    sms = fcp._sm_count(torch.cuda.current_device())
    bad, sums = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        for shape, name, conv, b, T in cases:
            s, wf, bf, x, y, gy = cs.bwd_inputs(conv, T, gen, b, dtype)
            plan = fcp.dgrad_span_plan(b, T, s.kernel_size, s.stride, s.padding,
                                       s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live,
                                       sms, 1, gy.element_size(),
                                       lambda: fcp.span_clusters(torch.cuda.current_device(),
                                                                 s.kernel_size, s.stride,
                                                                 gy.element_size()))

            def span():
                return fcp._dgrad(gy, y, wf, s, T, None, plan)

            ref = fcp.fused_conv_pool_dgrad_reference(
                gy, y, wf, T, s.stride, s.padding, "reflect" if s.reflect else "constant",
                s.negative_slope)
            gx = span()
            torch.cuda.synchronize()
            err = float((gx.float() - ref.float()).abs().max())
            pk = fcp.dgrad_span_pack(s, wf)
            row = {"shape": shape, "level": name, "dtype": dt,
                   "plan": fcp.last_backward_plans()["dgrad"], "max_abs_err": err,
                   "ok": bool(torch.isfinite(gx).all())
                   and err <= cs.TOL[dtype](float(ref.float().abs().max())),
                   "bits_two_runs": torch.equal(span(), gx),
                   "pack_equal": torch.equal(pk, fcp.dgrad_span_pack_reference(s, wf))}
            if (parent is not None and dtype == torch.float32 and row["plan"]["spans"] > 1
                    and plan.split == 1):
                w8 = fcp._aligned(wf, 1, fcp.BWD_CHUNK_CHANNELS)
                g2 = torch.empty((b, w8.shape[1], T), device="cuda")
                e = parent(gy.data_ptr(), y.data_ptr(), w8.data_ptr(),
                           s.dgrad_span_start.data_ptr(), s.dgrad_span_row.data_ptr(),
                           g2.data_ptr(), pk.data_ptr(), b, w8.shape[1], T, s.kernel_size,
                           wf.shape[0], y.shape[2], gy.shape[2], s.stride, s.padding,
                           int(s.reflect), s.negative_slope, plan.nbb, plan.split, plan.span, 1,
                           0, torch.cuda.current_device(),
                           torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                row["parent_bits"] = e == 0 and torch.equal(g2[:, :wf.shape[1]], gx)
            ok = row["ok"] and row["bits_two_runs"] and row["pack_equal"]
            if not (ok and row.get("parent_bits", True)):
                bad.append(f"{shape} {name} {dt}")
            if args.time and row["plan"]["spans"] == 1:
                wp = cs.whole_row_plan(s, gy, T)
                g = torch.where(y >= 0, gy, gy * s.negative_slope)
                row["ms"] = {"span": cs.device_ms(span),
                             "whole": cs.device_ms(lambda: fcp._dgrad(gy, y, wf, s, T, None, wp)),
                             "pack": cs.device_ms(lambda: fcp.dgrad_span_pack(s, wf)),
                             "library": cs.device_ms(lambda: torch.nn.grad.conv1d_input(
                                 (b, wf.shape[1], T + 2 * s.padding), wf, g, stride=s.stride))}
                acc = sums.setdefault(f"{shape}_{dt}", dict.fromkeys(row["ms"], 0.0))
                for k, v in row["ms"].items():
                    acc[k] += v
            print(json.dumps(row), flush=True)
    print(json.dumps({"sums_ms": sums, "failed": bad}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
