"""Smoke test of the PyTorch/CUDA port on one GPU (run from the repo root).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

0. print the card (``nvidia-smi``); turn TF32 off so that f32 references
   are f32;
1. build the kernel from ``hm_vae_torch/csrc/fused_conv_pool.cu`` (``nvcc``,
   sm_90a);
2. hold ``fused_conv_pool`` against its plain PyTorch version at the eight
   level shapes of the len-64 model at batch 8 (its real operands: masks,
   pool matrices, unpool-folded weights), in f32 and bf16, plus one stride-1
   case with a pool; time kernel, plain version and a cuDNN yardstick;
3. the serving path end to end: ``VAEInference.mean_reconstruction`` of the
   full-width len-64 model (seeded random weights) at batch 8 on the GPU,
   against the same weights on the CPU, in f32 and bf16; the kernel must be
   launched exactly 8 times per reconstruct;
4. the serving entry point: ``hm_vae_torch.cli.refine_vibe`` on a synthetic
   300-frame sequence (237 windows in one batch);
5. print the kernel summary line and, last, the device line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "len64_no_aug_hm_vae.yaml")
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
BATCH = 8
SEED = 0
DEV = "cuda"

# H100 SXM data-sheet peaks (dense): memory, f32 outside the tensor cores, bf16
MEM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel vs plain version on the same inputs: f32 sums differ only in order;
# bf16 rounds its operands and output
TOL = {torch.float32: lambda ref: 1e-4 * max(1.0, ref), torch.bfloat16: lambda ref: 0.02 * ref}
# end to end, GPU against CPU on the same weights, in units of the output's
# scale: f32 sums in another order over 8 levels; bf16 rounds at every level
# (its output step is 2^-8 of the scale).  6D: |gpu - cpu| <= E2E_TOL * max|cpu|.
E2E_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.02}
# Rotation matrices (entries in [-1, 1]) on joints whose 6D -> rotmat is well
# conditioned (condition > COND_MIN, where Gram-Schmidt amplifies a 6D error
# by at most ~1/COND_MIN), and FK positions (metres) of joints whose
# ancestors all are: random weights decode short or near-parallel 6D vectors
# on some joints, where the rotation is undetermined at bf16 precision.
COND_MIN = 0.1
ROT_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.1}
POSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.1}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 20, samples: int = 7) -> float:
    """Median over `samples` of CUDA-event time per call, `reps` calls each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def level_work(x, w, b, m, p, out):
    """(bytes, operations) one call needs: each input read once and the
    output written once, but of the weight only the live entries, those the
    mask keeps in the conv rows the pool reads; multiply-adds only where the
    mask and pool are nonzero."""
    B, C_in, _ = x.shape
    C_out, _, K = w.shape
    T_out = out.shape[-1]
    rows = (torch.ones(C_out, dtype=torch.bool, device=w.device) if p is None
            else (p != 0).any(0))
    live = int(rows.sum()) * C_in if m is None else int((m[rows] != 0).sum())
    nbytes = live * K * w.element_size() + sum(
        t.numel() * t.element_size() for t in (x, b, m, p, out) if t is not None)
    ops = 2 * B * T_out * K * live
    if p is not None:
        ops += 2 * B * T_out * int((p != 0).sum())
    return nbytes, ops


def level_cases(model, st):
    """(name, conv module, input T) of the eight convs of one reconstruct."""
    cases = []
    for i in range(len(st.encoder_levels)):
        cases.append((f"enc{i}", getattr(model.encoder, f"conv_{i}"), st.enc_timesteps[i]))
    for i, lvl in enumerate(st.decoder_levels):
        cases.append((f"dec{i}", getattr(model.decoder, f"conv_{i}"),
                      st.dec_timesteps[i] * (2 if lvl.upsample else 1)))
    return cases


@torch.inference_mode()
def kernel_phase(model, st, dtype, gen):
    from hm_vae_torch.ops.fused_conv_pool import fused_conv_pool, fused_conv_pool_reference

    rows = []
    cases = [(n, c, T, c.spec.stride) for n, c, T in level_cases(model, st)]
    n0, c0, T0, _ = cases[0]
    cases.append((f"{n0}_stride1", c0, T0, 1))  # stride 1 with a pool
    for name, conv, T_in, stride in cases:
        conv = copy.deepcopy(conv)
        conv.dtype = dtype
        w, b, m, p = conv.kernel_operands()
        fw, fb = conv.folded_weight()
        s = conv.spec
        slope = conv.negative_slope
        x = torch.randn((BATCH, w.shape[1], T_in), generator=gen).to(DEV, dtype)
        args = (x, w, b, m, p, stride, s.padding, s.padding_mode, slope)
        out = fused_conv_pool(*args)
        ref = fused_conv_pool_reference(*args)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            fail(f"{name} {dtype}: shape {tuple(out.shape)} vs {tuple(ref.shape)} "
                 "or non-finite output")
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        tol = TOL[dtype](scale)
        if not err <= tol:
            fail(f"{name} {dtype}: max |kernel - plain| {err:.3e} > {tol:.3e}")
        pad = s.padding

        def library():
            xp = F.pad(x, (pad, pad), mode="reflect" if s.padding_mode == "reflect"
                       else "constant")
            return F.leaky_relu(F.conv1d(xp, fw, fb, stride=stride), slope)

        lib_out = library()
        lib_err = float((lib_out.float() - ref.float()).abs().max())
        nbytes, ops = level_work(*args[:5], out)
        t_bytes, t_ops = nbytes / MEM_BPS * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
        row = {
            "level": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": {"B": BATCH, "C_in": w.shape[1], "T": T_in, "C_out": w.shape[0],
                      "P": out.shape[1], "T_out": out.shape[2], "stride": stride,
                      "mask": m is not None, "pool": p is not None},
            "max_abs_err": err, "tol": tol, "library_err": lib_err,
            "ms": time_ms(lambda: fused_conv_pool(*args)),
            "plain_ms": time_ms(lambda: fused_conv_pool_reference(*args)),
            "library_ms": time_ms(library),
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def ancestors_ok(ok):
    """ok (..., 24) per joint -> (..., 24): every strict ancestor of the
    joint is ok (the root has none)."""
    from hm_vae_torch.ops.topology import SMPL24_PARENTS

    out = torch.ones_like(ok)
    for j, par in enumerate(SMPL24_PARENTS):
        if par >= 0:  # parents come before their children
            out[..., j] = out[..., par] & ok[..., par]
    return out


def gram_schmidt_condition(rot6d):
    """min(|a|, |a/|a| x b|) per joint: small values make 6D -> rotmat
    ill-conditioned (the outputs of a random-weight model often are)."""
    a, b = rot6d[..., :3], rot6d[..., 3:]
    na = a.norm(dim=-1)
    cross = torch.linalg.cross(a / na.clamp_min(1e-6)[..., None], b, dim=-1).norm(dim=-1)
    return torch.minimum(na, cross)


def e2e_phase(cfg, dtype, x6d):
    """Reconstruct on the GPU against the same weights on the CPU.

    6D: |gpu - cpu| <= E2E_TOL * max|cpu| on every joint.  Rotation matrices
    within ROT_TOL on joints of condition > COND_MIN; FK positions within
    POSE_TOL on joints whose ancestors all are.  On every joint, the GPU's FK
    against the CPU's FK of the same (GPU) rotation matrices, 1e-4 * max(1,
    max|cpu|).
    """
    from hm_vae_torch.apps.inference import VAEInference
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.ops import fk as fk_mod
    from hm_vae_torch.ops.fused_conv_pool import fused_conv_pool

    name = str(dtype).replace("torch.", "")
    mcfg = dataclasses.replace(cfg.model, compute_dtype=name)
    cfg = dataclasses.replace(cfg, model=mcfg)
    model = HMVAE(mcfg, cfg.optim.init, generator=torch.Generator().manual_seed(SEED))
    cpu = VAEInference(copy.deepcopy(model), cfg, device="cpu")
    gpu = VAEInference(model, cfg, device=DEV)

    fused_conv_pool.launches = 0
    outs = gpu.mean_reconstruction(x6d)
    torch.cuda.synchronize()
    launches = fused_conv_pool.launches
    if launches != 8:
        fail(f"{name}: {launches} fused_conv_pool launches per reconstruct, expected 8")
    o6, om, op = (t.cpu() for t in outs)
    r6, rm, rp = cpu.mean_reconstruction(x6d.cpu())
    for what, o, r in (("rot6d", o6, r6), ("rotmat", om, rm), ("pose", op, rp)):
        if o.shape != r.shape or not torch.isfinite(o).all():
            fail(f"{name} {what}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite")
    scale6 = float(r6.abs().max())
    tol6 = E2E_TOL[dtype] * scale6
    err6 = float((o6 - r6).abs().max())
    if not err6 <= tol6:
        fail(f"{name} rot6d: max |gpu - cpu| {err6:.3e} > {tol6:.3e}")
    well = gram_schmidt_condition(r6) > COND_MIN
    chain = ancestors_ok(well)
    if not (bool(well.any()) and bool(chain[..., 1:].any())):
        fail(f"{name}: no joint with condition > {COND_MIN} to check rotmat and pose on")
    err_m = (om - rm).abs().amax(dim=(-1, -2))
    err_p = (op - rp).abs().amax(dim=-1)
    checks = (("rotmat", float(err_m[well].max()), ROT_TOL[dtype]),
              ("pose", float(err_p[chain].max()), POSE_TOL[dtype]))
    for what, err, tol in checks:
        if not err <= tol:
            fail(f"{name} {what}: max |gpu - cpu| {err:.3e} > {tol:.3e} where "
                 f"well conditioned")
    fk_ref = fk_mod.fk_from_rotmat(om, fk_mod.default_offsets())
    tol_p = 1e-4 * max(1.0, float(fk_ref.abs().max()))
    err_fk = float((op - fk_ref).abs().max())
    if not err_fk <= tol_p:
        fail(f"{name} pose: FK on the GPU vs the CPU {err_fk:.3e} > {tol_p:.3e}")
    errs = {"rot6d": err6, "rot6d_tol": tol6, "rot6d_max_abs": scale6,
            "rot6d_median_abs": float(r6.abs().median()),
            "rotmat_well": checks[0][1], "rotmat_tol": checks[0][2],
            "share_well": float(well.float().mean()),
            "pose_well": checks[1][1], "pose_tol": checks[1][2],
            "share_pose_well": float(chain.float().mean()),
            "rotmat_all": float(err_m.max()), "pose_all": float(err_p.max()),
            "pose_fk": err_fk}
    reps = 20
    fused_conv_pool.launches = 0
    ms = time_ms(lambda: gpu.mean_reconstruction(x6d), reps=reps, samples=5)
    per_call = fused_conv_pool.launches / (3 + 5 * reps)
    if per_call != 8:
        fail(f"{name}: {per_call} launches per reconstruct in the timed runs")
    row = {"phase": "reconstruct", "dtype": name, "batch": int(x6d.shape[0]),
           "launches": launches, "max_abs_err": errs, "ms_per_reconstruct": ms,
           "profile": profile_reconstruct(gpu, x6d)}
    print(json.dumps(row), flush=True)
    return row


def profile_reconstruct(infer, x6d, calls: int = 10):
    """Device time by kernel over `calls` reconstructs (torch.profiler), the
    wall time they took, and the device's idle share of that wall time."""
    from torch.profiler import ProfilerActivity, profile

    infer.mean_reconstruction(x6d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            infer.mean_reconstruction(x6d)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"calls": calls, "wall_us_per_call": wall_us / calls,
            "device_us_per_call": busy / calls,
            "idle_share": 1.0 - busy / wall_us if wall_us > 0 else None,
            "top_us_per_call": {k[:60]: v / calls for k, v in top}}


def cli_phase(rng):
    from hm_vae_torch.cli import refine_vibe
    from hm_vae_torch.ops.fused_conv_pool import fused_conv_pool

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "synthetic_vibe.npy")
    np.save(path, (rng.normal(size=(300, 72)) * 0.3).astype(np.float32))
    fused_conv_pool.launches = 0
    t0 = time.perf_counter()
    refine_vibe.main(["--config", CONFIG, "--vibe_output", path, "--output_path", OUT_DIR,
                      "--device", DEV, "--seed", str(SEED), "--vibe_order_6d"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_conv_pool.launches
    if launches != 8:
        fail(f"refine_vibe: {launches} launches, expected 8 (one batched reconstruct)")
    out = os.path.join(OUT_DIR, "refine_vibe")
    for fname, shape in (("synthetic_vibe_our_rot_mat.npy", (300, 24, 3, 3)),
                         ("synthetic_vibe_vibe_rot_mat.npy", (300, 24, 3, 3)),
                         ("synthetic_vibe_our_6d_vibe_order.npy", (300, 24, 6))):
        a = np.load(os.path.join(out, fname))
        if a.shape != shape or not np.isfinite(a).all():
            fail(f"refine_vibe {fname}: shape {a.shape}, expected {shape}, or non-finite")
    row = {"phase": "refine_vibe", "frames": 300, "windows": 237, "launches": launches,
           "seconds": seconds}
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import _build
    from hm_vae_torch.ops import rotations as rot
    from hm_vae_torch.utils.config import load_config

    # 1. build
    t0 = time.perf_counter()
    _build.load("fused_conv_pool")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = load_config(CONFIG)
    st = get_structure(cfg.model)
    gen = torch.Generator().manual_seed(SEED)
    model = HMVAE(cfg.model, cfg.optim.init, generator=gen).to(DEV)

    # 2. kernel against its plain version at the main path's shapes
    levels = {dt: kernel_phase(model, st, dt, gen) for dt in (torch.float32, torch.bfloat16)}

    # 3. the serving path end to end
    rng = np.random.default_rng(SEED)
    aa = torch.from_numpy((rng.normal(size=(BATCH, 64, 24, 3)) * 0.3).astype(np.float32))
    x6d = rot.rotmat_to_rot6d(rot.aa_to_rotmat(aa)).to(DEV)
    e2e = {dt: e2e_phase(cfg, dt, x6d) for dt in (torch.float32, torch.bfloat16)}

    # 4. the serving entry point
    cli_phase(rng)

    # 5. summary
    main_levels, bf16_levels = ([r for r in levels[dt] if not r["level"].endswith("stride1")]
                                for dt in (torch.float32, torch.bfloat16))
    total = lambda key, rows: sum(r[key] for r in rows)  # noqa: E731
    by_bytes = sum(r["bound_ms"] for r in main_levels if r["bound_by"] == "bytes")
    summary = {"kernels": [{
        "name": "fused_conv_pool", "route": "cuda",
        "source": "hm_vae_torch/csrc/fused_conv_pool.cu",
        "replaces": "hm_vae_tpu/ops/pallas_kernels.py:65",
        "launches": e2e[torch.float32]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in main_levels),
        "ms": total("ms", main_levels), "plain_ms": total("plain_ms", main_levels),
        "bound_ms": total("bound_ms", main_levels),
        "bound_by": "bytes" if by_bytes >= total("bound_ms", main_levels) / 2 else "operations",
        "library_ms": total("library_ms", main_levels),
        "note": "times and bounds are sums over the 8 levels of one len-64 reconstruct "
                "at batch 8, in f32 (top level) and in bf16 (\"bf16\")",
        "bf16": {"max_abs_err": max(r["max_abs_err"] for r in bf16_levels),
                 **{k: total(k, bf16_levels)
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms")}},
    }]}
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
