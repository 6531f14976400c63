"""dgrad's tile kernel at the test-time solve's shapes against its plain
version, timed beside the whole-row kernel it replaces there (run from the
repo root on a GPU):

    python3 scripts/torch_dgrad_tiles_check.py [--windows G] [--time] [--report]

At the four decoder levels of ``configs/len_64_test_interpolation.yaml``
(K 15, stride 1, reflect padding 7, T 8-64), ``G`` windows of one batch
each (default 10, the solve's), in f32 and bf16 (``chip_smoke.py``'s
``windowed_inputs``): the tile kernel under its plan (``dgrad_tiles_plan``)
against ``fused_conv_pool_dgrad_windowed_reference`` (f32 1e-4 *
max(1, max|ref|), bf16 0.02 * max|ref|), two runs bit-equal, and a run into
an input gradient filled with NaN first bit-equal to them (the kernel writes
every element).  ``--time``: device ms (CUDA graphs) of the tile kernel, the
whole-row kernel under its whole-row plan (``dgrad_whole_plan``), the plain
version and cuDNN's grouped ``conv1d_input`` (TF32 off), beside the bound
(each window's folded weight's nonzeros, gy, y and gx moved once at 3.35
TB/s, or the multiply-adds at the dtype's peak, the larger), each level and
summed.  Each case also gives the weight tiles' bytes that the whole-row
kernel's pair lists (``dgrad_row``: a row tile live in either chunk of a
pair reads both) and the tile kernel's chunk lists (``dgrad_chunk_row``)
read over the windows ("list_bytes"; rows past P not read).  Then the
kernel's other paths, unrouted at the solve, checked the same way at a
small level (P 150: row tiles of 64, 64 and 22 rows, the middle one with
no live tile; C 40, chunk 3 with no live tile; K 15), 3 windows: one batch
a window at stride 1 under reflect padding, two at stride 2 under zeros
(``tests/test_torch_dgrad_tiles.py``'s cases), in f32 and bf16.  ``--report``:
the backward source's ``nvcc -Xptxas -v`` lines and SASS counts for the
tile kernel's instantiations.  One JSON line a case, then the sums and the
card; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--report", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_dgrad_tiles_check.py needs a GPU")
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
        cubin = os.path.join(cs.OUT_DIR, "dgrad_tiles_check_bwd.cubin")
        proc = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v", "-o", cubin,
             str(_build.CSRC_DIR / "fused_conv_pool_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _build.load_all(["fused_conv_pool", "fused_conv_pool_bwd"])
    if args.report:
        report = cs.build_report(proc, cubin, cs.bwd_kind)
        print(json.dumps({"build_report": {k: v for k, v in report.items()
                                           if k.startswith("dgrad")}}), flush=True)

    G = args.windows
    lcfg = cs.latent_config()
    gen = torch.Generator().manual_seed(cs.SEED)
    model = HMVAE(lcfg.model, lcfg.optim.init, generator=gen).to("cuda")
    cases = [(n, c, T) for n, c, T in cs.level_cases(model, get_structure(lcfg.model))
             if n.startswith("dec")]
    bad, sums = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        for name, conv, T in cases:
            s, w, b, packed, x, y, gy = cs.windowed_inputs(conv, T, gen, dtype, G)
            K, stride, pad = s.kernel_size, s.stride, s.padding
            mode = "reflect" if s.reflect else "constant"
            plan = cs.dgrad_tiles_plan_of(s, gy, G)

            def tiles():
                return fcp._dgrad(gy, y, w, s, T, G, plan)

            def plain():
                return fcp.fused_conv_pool_dgrad_windowed_reference(gy, y, w, T, stride, pad,
                                                                    mode, s.negative_slope)

            ref = plain()
            gx = tiles()
            torch.cuda.synchronize()
            err = float((gx.float() - ref.float()).abs().max())
            tol = cs.TOL[dtype](float(ref.float().abs().max()))
            row = {"level": name, "dtype": dt, "windows": G, "T": T,
                   "routed": fcp.dgrad_tiles_routed(
                       1, T, K, stride, pad, s.rows, s.dgrad_chunk_start.numel() - 1,
                       s.dgrad_chunk_row.numel(), gy.element_size(), G),
                   "plan": fcp.last_backward_plans()["dgrad"], "max_abs_err": err, "tol": tol,
                   "ok": bool(torch.isfinite(gx).all()) and err <= tol,
                   "bits_two_runs": torch.equal(tiles(), gx),
                   "every_element_written": torch.equal(
                       cs.dgrad_tiles_poisoned(gy, y, w, s, T, G, plan), gx)}
            rows_of = lambda rt: min(64, s.rows - 64 * rt)  # noqa: E731
            tile = 8 * K * gy.element_size() * G  # a tile row's bytes over the windows
            row["list_bytes"] = {
                "pair": 2 * tile * sum(rows_of(r) for r in s.dgrad_row.tolist()),
                "chunk": tile * sum(rows_of(r) for r in s.dgrad_chunk_row.tolist())}
            if not (row["ok"] and row["bits_two_runs"] and row["every_element_written"]):
                bad.append(f"{name} {dt}")
            if args.time:
                wp = cs.whole_row_plan(s, gy, T, G)
                C, P, T_out = x.shape[1], y.shape[1], y.shape[2]
                wg = w.reshape(G * P, C, K)
                g = torch.where(y >= 0, gy, gy * s.negative_slope).reshape(1, G * P, T_out)
                nbytes, _, ops, _ = cs.bwd_work(gy[:1], y[:1], x[:1], w[0])
                t_bytes = G * nbytes / cs.MEM_BPS * 1e3
                t_ops = G * ops / cs.PEAK_FLOPS[dtype] * 1e3
                row["ms"] = {
                    "tiles": cs.device_ms(tiles),
                    "whole": cs.device_ms(lambda: fcp._dgrad(gy, y, w, s, T, G, wp)),
                    "plain": cs.device_ms(plain),
                    "library": cs.device_ms(lambda: torch.nn.grad.conv1d_input(
                        (1, G * C, T + 2 * pad), wg, g, stride=stride, groups=G)),
                    "bound": max(t_bytes, t_ops)}
                row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                row["whole_plan"] = wp._asdict()
                acc = sums.setdefault(dt, dict.fromkeys(row["ms"], 0.0))
                for k, v in row["ms"].items():
                    acc[k] += v
            print(json.dumps(row), flush=True)
    import numpy as np

    for dtype in (torch.float32, torch.bfloat16):
        for nb, stride, mode, T in ((1, 1, "reflect", 16), (2, 2, "constant", 32)):
            G, P, C, K, pad = 3, 150, 40, 15, 7
            rng = np.random.default_rng(nb * 10 + stride)
            tiles = rng.random((3, 5)) < 0.6
            tiles[1] = False
            tiles[:, 3] = False
            tiles[0, 0] = tiles[2, 4] = True
            live = torch.from_numpy(np.repeat(np.repeat(tiles, 64, 0), 8, 1)[:P, :C])
            s = fcp.pack_structure(live, K, dtype, stride, pad, mode, 0.2, device="cuda")
            T_out = (T + 2 * pad - K) // stride + 1
            rnd = lambda *shape: torch.from_numpy(  # noqa: E731
                rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)
            w = (rnd(G, P, C, K) * live.to("cuda")[None, :, :, None]).to(dtype)
            y, gy = rnd(G * nb, P, T_out), rnd(G * nb, P, T_out)
            plan = cs.dgrad_tiles_plan_of(s, gy, G)
            gx = fcp._dgrad(gy, y, w, s, T, G, plan)
            ref = fcp.fused_conv_pool_dgrad_windowed_reference(gy, y, w, T, stride, pad, mode,
                                                               0.2)
            torch.cuda.synchronize()
            err = float((gx.float() - ref.float()).abs().max())
            tol = cs.TOL[dtype](float(ref.float().abs().max()))
            row = {"case": f"small_nb{nb}_stride{stride}_{mode}", "dtype": str(dtype)[6:],
                   "plan": fcp.last_backward_plans()["dgrad"], "max_abs_err": err, "tol": tol,
                   "ok": bool(torch.isfinite(gx).all()) and err <= tol,
                   "dead_chunk_zero": bool((gx[:, 24:32] == 0).all()),
                   "every_element_written": torch.equal(
                       cs.dgrad_tiles_poisoned(gy, y, w, s, T, G, plan), gx)}
            if not (row["ok"] and row["dead_chunk_zero"] and row["every_element_written"]):
                bad.append(f"{row['case']} {row['dtype']}")
            print(json.dumps(row), flush=True)
    print(json.dumps({"sums_ms": sums, "failed": bad}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
