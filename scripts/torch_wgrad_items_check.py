"""wgrad's item kernel against its plain version, in both of its forms and
both element types, and timed unrouted beside the whole-row kernel (run
from the repo root on a GPU):

    python3 scripts/torch_wgrad_items_check.py [--parent FILE] [--time]

At the len-64 model's eight levels at batch 64 and 8 and the trajectory
model's four K-31 levels at (8, 128), the item kernel runs items of several
batches' whole rows under its own plan (``wgrad_span_plan`` over
``wgrad_span_rows``), whether or not ``wgrad_plan`` routes the shape there;
at (8, 1,024), (1, 7,200) and the stride-2 level at (8, 1,024), items of one
batch's columns of a long row.  Each case, in f32 and bf16: the kernel's
weight and bias gradients against ``fused_conv_pool_wgrad_reference`` (f32
1e-4 * max(1, max|ref|), bf16 0.02 * max|ref|), two runs bit-equal.
``--parent FILE``: a copy of ``fused_conv_pool_bwd.cu`` from another commit
(``git show <commit>:hm_vae_torch/csrc/fused_conv_pool_bwd.cu > FILE``),
built beside; its f32 long-row wgrad must give the same bits (and, with
``--time``, is timed beside).  ``--time``: device ms (CUDA graphs) of the
item kernel, the whole-row kernel
(``wgrad_whole_plan``, where the rows fit one) and cuDNN's
``conv1d_weight`` with the bias sum, summed a shape.  One JSON line a case,
then the sums and the card; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
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
    ap.add_argument("--parent", default=None,
                    help="a copy of fused_conv_pool_bwd.cu whose long-row wgrad is compared")
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_wgrad_items_check.py needs a GPU")
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
        out = os.path.join(ROOT, "build", "wgrad_items_check")
        os.makedirs(out, exist_ok=True)
        lib = os.path.join(out, "libparent_bwd.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                        lib, args.parent], check=True)
        parent = fcp._bind(ctypes.CDLL(lib), "hmvae_conv_wgrad", fcp.WGRAD_ARGTYPES)

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
            K, stride, esz = s.kernel_size, s.stride, gy.element_size()
            T_out = y.shape[2]
            cols = fcp.wgrad_span_cols(K, stride, esz)
            nbb = fcp.wgrad_span_rows(b, T, K, stride, s.padding, esz, cols)
            t_ld = -(-T_out // (16 // esz)) * (16 // esz)
            plan = fcp.wgrad_span_plan(
                b, T_out, s.wgrad_row.numel(), sms, 1, cols, max(1, nbb),
                fcp.wgrad_items_per_sm(K, stride, cols, esz, max(1, nbb), T, T_out, t_ld))

            def items():
                return fcp._wgrad(gy, y, x, s, None, plan)

            mode = "reflect" if s.reflect else "constant"
            rw, rb = fcp.fused_conv_pool_wgrad_reference(gy, y, x, K, stride, s.padding, mode,
                                                         s.negative_slope, s.live_elements())
            gw, gb = items()
            torch.cuda.synchronize()
            err = max(float((gw.float() - rw.float()).abs().max()),
                      float((gb.float() - rb.float()).abs().max()))
            tol = cs.TOL[dtype](max(float(rw.float().abs().max()), float(rb.float().abs().max())))
            gw2, gb2 = items()
            row = {"shape": shape, "level": name, "dtype": dt, "batch": b, "T": T,
                   "plan": fcp.last_backward_plans()["wgrad"], "max_abs_err": err, "tol": tol,
                   "ok": bool(torch.isfinite(gw).all() and torch.isfinite(gb).all())
                   and err <= tol,
                   "bits_two_runs": torch.equal(gw2, gw) and torch.equal(gb2, gb)}
            if parent is not None and dtype == torch.float32 and nbb == 0:
                x8 = fcp._aligned(x, 1, fcp.BWD_CHUNK_CHANNELS)
                C = x8.shape[1]
                pw = torch.zeros((1, wf.shape[0], C, K), device="cuda")
                pb = torch.empty((1, wf.shape[0]), device="cuda")

                def parent_items():
                    return parent(gy.data_ptr(), y.data_ptr(), x8.data_ptr(),
                                  s.wgrad_row.data_ptr(), s.wgrad_chunk.data_ptr(),
                                  pw.data_ptr(), pb.data_ptr(), s.wgrad_row.numel(), b, C, T, K,
                                  wf.shape[0], T_out, gy.shape[2], stride, s.padding,
                                  int(s.reflect), s.negative_slope, 1, plan.split, plan.span, 1,
                                  0, torch.cuda.current_device(),
                                  torch.cuda.current_stream().cuda_stream)

                e = parent_items()
                torch.cuda.synchronize()
                row["parent_bits"] = e == 0 and torch.equal(pw[0, :, :wf.shape[1]], gw) and \
                    torch.equal(pb[0], gb)
            if not (row["ok"] and row["bits_two_runs"] and row.get("parent_bits", True)):
                bad.append(f"{shape} {name} {dt}")
            if args.time:
                g = torch.where(y >= 0, gy, gy * s.negative_slope)
                xp = F.pad(x, (s.padding, s.padding), mode=mode)
                row["ms"] = {"items": cs.device_ms(items),
                             **({"parent": cs.device_ms(parent_items)} if "parent_bits" in row
                                else {}),
                             "library": cs.device_ms(
                    lambda: (torch.nn.grad.conv1d_weight(xp, wf.shape, g, stride=stride),
                             g.sum((0, 2))))}
                if fcp.wgrad_whole_rows(b, T, K, T_out, t_ld, stride, esz):
                    wp = fcp.wgrad_whole_plan(
                        b, T_out, s.wgrad_row.numel(), sms, 1,
                        lambda sb, split: fcp._wgrad_smem(b, T, K, T_out, t_ld, stride, sb,
                                                          split, esz))
                    row["ms"]["whole"] = cs.device_ms(lambda: fcp._wgrad(gy, y, x, s, None, wp))
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
