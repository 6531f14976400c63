"""wgrad's tile kernel at the test-time solve's shapes against its plain
version, timed beside the whole-row kernel it replaces there (run from the
repo root on a GPU):

    python3 scripts/torch_wgrad_tiles_check.py [--windows G] [--time] [--report]

At the four decoder levels of ``configs/len_64_test_interpolation.yaml``
(K 15, stride 1, reflect padding 7, T 8-64), ``G`` windows of one batch
each (default 10, the solve's), in f32 and bf16 (``chip_smoke.py``'s
``windowed_inputs``): the tile kernel under its plan (``wgrad_tiles_plan``)
against ``fused_conv_pool_wgrad_windowed_reference`` (f32 1e-4 *
max(1, max|ref|), bf16 0.02 * max|ref|), two runs bit-equal, and a run into
gradients filled with NaN first bit-equal to them (the kernel writes every
element).  ``--time``: device ms (CUDA graphs) of the tile kernel, the
whole-row kernel under its whole-row plan (``wgrad_whole_plan``: the wrapper's
clearing included), the clearing alone (``torch.zeros`` of the windows'
gradients), the plain version and cuDNN's grouped ``conv1d_weight`` with
the bias sums, each level and summed.  ``--report``: the backward source's
``nvcc -Xptxas -v`` lines and SASS counts for the tile kernel's two
instantiations.  One JSON line a case, then the sums and the card; exits 1
if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--report", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_wgrad_tiles_check.py needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import _build
    from hm_vae_torch.ops import fused_conv_pool as fcp

    print(cs.nvidia_smi(), flush=True)
    if args.report:
        os.makedirs(cs.OUT_DIR, exist_ok=True)
        cubin = os.path.join(cs.OUT_DIR, "tiles_check_bwd.cubin")
        proc = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v", "-o", cubin,
             str(_build.CSRC_DIR / "fused_conv_pool_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _build.load_all(["fused_conv_pool", "fused_conv_pool_bwd"])
    if args.report:
        report = cs.build_report(proc, cubin, cs.bwd_kind)
        print(json.dumps({"build_report": {k: v for k, v in report.items()
                                           if k.startswith("wgrad_tiles")}}), flush=True)

    G = args.windows
    lcfg = cs.latent_config()
    gen = torch.Generator().manual_seed(cs.SEED)
    model = HMVAE(lcfg.model, lcfg.optim.init, generator=gen).to("cuda")
    cases = [(n, c, T) for n, c, T in cs.level_cases(model, get_structure(lcfg.model))
             if n.startswith("dec")]
    sms = fcp._sm_count(torch.cuda.current_device())
    bad, sums = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        for name, conv, T in cases:
            s, w, b, packed, x, y, gy = cs.windowed_inputs(conv, T, gen, dtype, G)
            K, stride, esz, T_out = s.kernel_size, s.stride, gy.element_size(), y.shape[2]
            mode = "reflect" if s.reflect else "constant"
            plan = cs.wgrad_tiles_plan_of(s, gy, T, G)

            def tiles():
                return fcp._wgrad(gy, y, x, s, G, plan)

            rw, rb = fcp.fused_conv_pool_wgrad_windowed_reference(
                gy, y, x, K, stride, s.padding, G, mode, s.negative_slope, s.live_elements())
            gw, gb = tiles()
            torch.cuda.synchronize()
            err = max(float((gw.float() - rw.float()).abs().max()),
                      float((gb.float() - rb.float()).abs().max()))
            tol = cs.TOL[dtype](max(float(rw.float().abs().max()), float(rb.float().abs().max())))
            gw2, gb2 = tiles()
            nw, nb_ = cs.wgrad_tiles_poisoned(gy, y, x, s, G, plan)
            row = {"level": name, "dtype": dt, "windows": G, "T": T,
                   "plan": fcp.last_backward_plans()["wgrad"], "max_abs_err": err, "tol": tol,
                   "ok": bool(torch.isfinite(gw).all() and torch.isfinite(gb).all())
                   and err <= tol,
                   "bits_two_runs": torch.equal(gw2, gw) and torch.equal(gb2, gb),
                   "every_element_written": torch.equal(nw, gw) and torch.equal(nb_, gb)}
            if not (row["ok"] and row["bits_two_runs"] and row["every_element_written"]):
                bad.append(f"{name} {dt}")
            if args.time:
                t_ld = -(-T_out // (16 // esz)) * (16 // esz)
                wp = fcp.wgrad_whole_plan(
                    1, T_out, s.wgrad_row.numel(), sms, G,
                    lambda sb, split: fcp._wgrad_smem(1, T, K, T_out, t_ld, stride, sb, split,
                                                      esz), fcp.wgrad_span_cols(K, stride, esz))
                g = torch.where(y >= 0, gy, gy * s.negative_slope).reshape(1, -1, T_out)
                xp = F.pad(x.reshape(1, -1, T), (s.padding, s.padding), mode=mode)
                wg = w.reshape(-1, *w.shape[2:])
                C = fcp._aligned(x, 1, fcp.BWD_CHUNK_CHANNELS).shape[1]
                row["ms"] = {
                    "tiles": cs.device_ms(tiles),
                    "whole": cs.device_ms(lambda: fcp._wgrad(gy, y, x, s, G, wp)),
                    "memset": cs.device_ms(lambda: torch.zeros((G, w.shape[1], C, K),
                                                               dtype=dtype, device="cuda")),
                    "plain": cs.device_ms(lambda: fcp.fused_conv_pool_wgrad_windowed_reference(
                        gy, y, x, K, stride, s.padding, G, mode, s.negative_slope,
                        s.live_elements())),
                    "library": cs.device_ms(lambda: (torch.nn.grad.conv1d_weight(
                        xp, wg.shape, g, stride=stride, groups=G), g.sum((0, 2))))}
                row["whole_plan"] = wp._asdict()
                acc = sums.setdefault(dt, dict.fromkeys(row["ms"], 0.0))
                for k, v in row["ms"].items():
                    acc[k] += v
            print(json.dumps(row), flush=True)
    print(json.dumps({"sums_ms": sums, "failed": bad}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
