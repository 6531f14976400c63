"""Smoke test of the PyTorch/CUDA port on one GPU (run from the repo root).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

0. print the card (``nvidia-smi``); turn TF32 off so that f32 references
   are f32;
1. build the kernels from ``hm_vae_torch/csrc/fused_conv_pool.cu`` and
   ``fused_conv_pool_bwd.cu`` (one ``nvcc`` each, sm_90a, started together),
   and beside them cubins whose ``-Xptxas -v`` reports (registers, shared
   memory, spills) and SASS (``HGMMA``: wgmma; ``HMMA``: mma.sync;
   ``UBLKCP``: bulk copies) are printed; the forward's bf16 instantiation
   must contain wgmma, and the dgrad and wgrad kernels tensor-core products;
2. hold the forward kernel against its plain PyTorch version at the eight
   level shapes of the len-64 model (its real operands: masks, pool matrices,
   unpool-folded weights), in f32 and bf16, at batch 8 (plus one stride-1
   case with a pool) and at refine_vibe's batch of 237: the packed entry
   against unpack + plain version, and the Pallas-signature entry against
   the plain version on the raw operands.  Time kernel, plain version and a
   cuDNN yardstick on the device (``device_ms``: calls captured in a CUDA
   graph, replays timed with events), and the kernel's eager calls
   (``eager_ms``);
3. the serving path end to end: ``VAEInference.mean_reconstruction`` of the
   full-width len-64 model (seeded random weights) at batch 8 on the GPU,
   against the same weights on the CPU, in f32 and bf16; the kernel must be
   launched exactly 8 times per reconstruct;
4. the serving entry point: ``hm_vae_torch.cli.refine_vibe`` on a synthetic
   300-frame sequence (237 windows in one batch);
5. the backward kernels (dgrad; wgrad + bias grad) against their plain
   versions and against autograd of the plain forward at the eight level
   shapes, batch 8, f32, each giving the same bits on two runs, timed on the
   device beside the plain versions and ``torch.nn.grad.conv1d_input`` /
   ``conv1d_weight``;
6. training end to end: 20 steps of ``Trainer.fit`` on the full-width len-64
   config with synthetic data made from the seed (sampled by the native C++
   sampler on the compact rot6d wire), on the GPU and on the CPU
   from the same init, batches and noise; per-step losses compared, kernel
   launches per step counted, step time by CUDA events, device time and
   idle share by ``torch.profiler``;
7. the training entry point: ``hm_vae_torch.cli.train`` for a few steps with
   a checkpoint, then ``--resume``;
8. the windowed kernels of the test-time solver (each window of a batch
   through its own decoder clone): forward, dgrad and wgrad at the four
   decoder levels of ``configs/len_64_test_interpolation.yaml`` with 10
   windows of one batch each, against their plain versions, the backward
   also against autograd of the plain forward, each giving the same bits on
   two runs, and against 10 one-window launches; timed on the device beside
   the plain versions and cuDNN's grouped convolution;
9. a short 10-window solve (12 iterations across the z-to-decoder switch)
   through ``LatentOptApps.interpolate`` on the GPU against the CPU, from
   the same weights and z, losses inside a band calibrated by runs from
   weights scaled by 1 + 1e-7 on both sides; and a 7-iteration solve (the
   z phase, then the last iteration through the per-window clones) whose
   6D outputs agree as the reconstruct's do;
10. the full solve on the card (10 windows, 150 iterations, per-window
   clones): ms per solve, kernel launches per iteration and phase, the
   profile; the shared-clone and ``last_conv`` solves' times;
11. the evaluation entry point: ``hm_vae_torch.cli.eval_recovery`` on the
   synthetic test split with the training CLI's checkpoint, and completion
   and generation through ``LatentOptApps``;
12. (run right after phase 5, beside the other kernels) the three kernels at
   the root-trajectory model's four level shapes (``configs/
   trajectory_model.yaml``: K 31, stride 1, C_in 72 / 84 / 108 / 168):
   forward, dgrad and wgrad at batch 8 and T 128 (training), forward and
   dgrad at 10 windows of T 64 (the solver's trajectory loss), the forward
   at batch 1 and T 300 (``eval_trajectory``), each as phases 2 and 5 hold
   and time theirs;
13. trajectory training: 20 steps of ``Trainer.fit`` on the GPU against the
   CPU as in phase 6 (4 / 3 / 4 launches a step), then
   ``hm_vae_torch.cli.train`` on its config with a checkpoint and resume;
14. ``hm_vae_torch.cli.eval_trajectory`` with phase 7's VAE checkpoint and
   phase 13's trajectory checkpoint: prior samples, GT test windows and a
   300-frame sequence in one call;
15. the solve under the keyframe trajectory loss: a short 10-window solve on
   the GPU against the CPU as in phase 9, the full 150-iteration solve
   (ms, launches per phase, profile), and ``eval_recovery
   --try_interpolation_w_trajectory_single_window`` on the synthetic test
   split;
16. the lora scope's base convs (``finetune_scope: lora``: each decoder
   conv's folded weight shared by every window, at slope 1.0 and with no
   bias, the adapters' delta and the activation added after): forward and
   dgrad at the four decoder levels with 10 windows of one batch, held and
   timed as phases 2 and 5 hold theirs, two runs bit-equal; the adapters'
   rank-r convs, forward and backward, profiled beside cuDNN's grouped
   ``conv1d`` of the same function;
17. the lora solve: a short 10-window solve on the GPU against the CPU as in
   phase 9 (the solver draws the same adapters on both sides), then the full
   solve: 600 / 596 / 0 non-windowed and no windowed launches, ms, peak
   memory, profile;
18. the bf16 clone (``opt_param_dtype`` and ``opt_moment_dtype``
   bfloat16): the short solve on the GPU against the CPU, then the full
   solve: the f32 solve's launches, ms and peak memory beside the f32
   solve's, and the clones' bytes;
19. ``eval_recovery --finetune_scope lora``, and ``eval_recovery`` under
   ``configs/len64_production.yaml`` (the bf16 clone and moments) with
   phase 7's checkpoint, on the synthetic test split;
20. (run right after phase 12, beside the other kernels) the three kernels
   at ``configs/len64_production.yaml``'s batch of 64, f32, at the eight
   len-64 levels, held and timed as phases 2 and 5 hold and time theirs,
   each giving the same bits on two runs;
21. the production config's steps: 32 steps at batch 64, one step captured
   in a CUDA graph and replayed 32 times, against the same steps run
   eagerly, from one init and one superbatch of the f16 aa wire, the
   curriculum boundary inside the call (parameters, moments and counts
   compared; the entries count 8 / 7 / 8 launches a step in the warm-up and
   the capture, none at a replay); then its dtypes at batch 8, 4 steps a call, across a boundary
   inside a call, GPU against CPU in a band calibrated by runs whose
   batches are scaled by 1 + 1e-7 on both sides;
22. ``hm_vae_torch.cli.train --config configs/len64_production.yaml`` (in
   this process, log, snapshot and retention set for a short run): four
   32-step calls with an asynchronous snapshot after each and
   keep_checkpoints 2, then ``--resume``; the train split the native
   sampler on the aa wire, the steps a CUDA graph; then the step's cost
   through ``Trainer.fit``: ms a step by CUDA events, the kernels'
   launches a call in the device trace (256 / 224 / 256), peak memory,
   device time and idle share, beside the same config at
   ``steps_per_call: 1`` (eager);
23. random root rotation on the card: ``configs/len8_data_aug_hm_vae.yaml``
   trains through the native sampler with ``device_augment``, and
   ``apply_root_rot`` on the GPU agrees with the CPU on the same rotations;
25. (run before 24) the serving export (``hm_vae_torch/apps/export.py``):
   the len-64 model with the trajectory model exported on the card in f32
   and bf16 and the len-64 functions on the CPU; the bundles loaded by
   ``python3 chip_smoke.py --serve-exported <dir>``, a process that cannot
   import the port's model code, where ``reconstruct``, ``encode_mean`` and
   ``decode`` run at batch 1, 8 and 237 and ``trajectory`` at (1, 16),
   (8, 128) and (1, 300), each call counting its kernel launches (8 / 4 / 4
   / 4), and are timed (events, device time) beside the in-process path;
   their outputs against ``VAEInference`` and ``TrajectoryRunner`` on the
   card (f32 1e-4 * max(1, max|ref|), bf16 0.02 * max|ref|), the CPU export
   moved to the card against the card's own; the operator's dispatch beside
   the direct launch; ``cli/export_model.py`` and ``cli/explore_latent.py``;
26. (run after 25) trajectories of any length: the forward kernel at the
   trajectory model's four K-31 levels at batch 1, T 7,200 (a 4-minute
   take at 30 fps), batch 4, T 2,048 and batch 2, T 4,096, f32 and bf16,
   rows longer than a block's window staged as windows, held and timed as
   phase 2 holds and times its rows; ``TrajectoryRunner`` on the card at
   (1, 7200) and (4, 2048) against the CPU; phase 25's exported f32 and
   bf16 ``trajectory`` functions at those lengths against the in-process
   path, 4 launches a call;
27. data preparation: raw AMASS-layout takes made from the seed (SMPL-H
   poses at 120 fps in three subsets, 1,200-28,800 frames, one of 4
   minutes) through ``python -m hm_vae_torch.cli.prep_data`` and its
   ``--gen_masks``; a few ``Trainer`` steps of the len-64 VAE on the
   prepared data; ``eval_trajectory --seq_generation_npy_path`` on the
   4-minute take (7,200 frames in one call);
28. the SMPL body model at SMPL's sizes (V 6,890, J 24, 10 betas, 207
   pose correctives, F 13,776; made from the seed): the LBS on the card for
   64 and 640 frames of a solve's output against the CPU,
   ``vertex_error_from_rotmats``, ``save_mesh_obj`` through
   ``HM_VAE_SMPL_MODEL``, timed by ``utils/profiling.time_fn``;
24. print the kernel summary line and, last, the device line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "len64_no_aug_hm_vae.yaml")
LATENT_CONFIG = os.path.join(ROOT, "configs", "len_64_test_interpolation.yaml")
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
BATCH = 8
SEED = 0
DEV = "cuda"

VIBE_BATCH = 237  # refine_vibe's windows for a 300-frame sequence
# H100 SXM data-sheet peaks (dense): memory; the card's fastest rate for each
# dtype's accuracy: bf16 tensor cores, and for f32 3xTF32 (three TF32
# products per multiply-add) on the TF32 tensor cores.  The forward and both
# backward kernels are bounded at the same rate, whatever unit they use.
MEM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
TRAIN_STEPS = 20
WINDOWS = 10  # the solve's windows (bench.py's latent-opt shape)
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


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 20, samples: int = 7) -> float:
    """Median over `samples` of CUDA-event time per call, `reps` eager calls
    each: at a few microseconds a call this is the host's enqueue rate."""
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


def device_ms(fn, reps: int = 20, samples: int = 7) -> float:
    """Device time per call: `reps` calls captured in one CUDA graph, the
    median over `samples` replays timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def raw_operands(conv, dtype):
    """(weight, bias, mask, pool) of the Pallas wrapper's signature for one
    conv: the raw weight with its mask and pool, or with the unpool folded
    in (the wrapper takes no unpool)."""
    cast = lambda t: None if t is None else t.detach().to(dtype).contiguous()  # noqa: E731
    w, b, m, p = cast(conv.weight), cast(conv.bias), cast(conv.mask), cast(conv.pool)
    if conv.unpool is not None:
        wm = w if m is None else w * m[:, :, None]
        w, m = torch.einsum("ock,cp->opk", wm, conv.unpool.to(dtype)).contiguous(), None
    return w, b, m, p


def level_work(x, raw, folded, out):
    """(bytes, operations) one call needs at the least, whatever the design:
    x read once and the output written once, plus the fewer weight bytes of
    the two forms (the raw live entries, those the mask keeps in the conv
    rows the pool reads, with mask and pool; or the folded weight's nonzeros
    and its bias), and the fewer multiply-adds (raw: masked conv + pool;
    folded: its nonzeros)."""
    w, b, m, p = raw
    B, C_in, _ = x.shape
    C_out, _, K = w.shape
    N = B * out.shape[-1]
    rows = (torch.ones(C_out, dtype=torch.bool, device=w.device) if p is None
            else (p != 0).any(0))
    live = int(rows.sum()) * C_in if m is None else int((m[rows] != 0).sum())
    raw_bytes = live * K * w.element_size() + sum(
        t.numel() * t.element_size() for t in (b, m, p) if t is not None)
    raw_ops = 2 * N * K * live + (2 * N * int((p != 0).sum()) if p is not None else 0)
    fw, fb = folded
    nnz = int((fw != 0).sum())
    fold_bytes = nnz * fw.element_size() + (0 if fb is None else fb.numel() * fb.element_size())
    io = sum(t.numel() * t.element_size() for t in (x, out))
    return io + min(raw_bytes, fold_bytes), min(raw_ops, 2 * N * nnz)


def level_cases(model, st):
    """(name, conv module, input T) of the eight convs of one reconstruct."""
    cases = []
    for i in range(len(st.encoder_levels)):
        cases.append((f"enc{i}", getattr(model.encoder, f"conv_{i}"), st.enc_timesteps[i]))
    for i, lvl in enumerate(st.decoder_levels):
        cases.append((f"dec{i}", getattr(model.decoder, f"conv_{i}"),
                      st.dec_timesteps[i] * (2 if lvl.upsample else 1)))
    return cases


def check(name, out, ref, dtype):
    """max |out - ref| within TOL, else fail; returns (err, tol)."""
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"{name}: shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite output")
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[dtype](float(ref.float().abs().max()))
    if not err <= tol:
        fail(f"{name}: max |kernel - plain| {err:.3e} > {tol:.3e}")
    return err, tol


@torch.inference_mode()
def kernel_phase(model, st, dtype, batch, gen):
    """Every level at `batch`: :func:`fwd_level_row` of each."""
    cases = [(n, c, T, c.spec.stride) for n, c, T in level_cases(model, st)]
    if batch == BATCH:
        n0, c0, T0, _ = cases[0]
        cases.append((f"{n0}_stride1", c0, T0, 1))  # stride 1 with a pool
    return [fwd_level_row(name, conv, T_in, stride, batch, dtype, gen)
            for name, conv, T_in, stride in cases]


@torch.inference_mode()
def fwd_level_row(name, conv, T_in, stride, batch, dtype, gen, bits=False):
    """One level at `batch`: the packed entry against unpack + plain
    version, the Pallas-signature entry against the plain version (and,
    with `bits`, two runs bit-equal), and the device times of kernel, plain
    version and cuDNN."""
    from hm_vae_torch.ops.fused_conv_pool import (
        CHUNK_CHANNELS, _sm_count, forward_plan, fused_conv_pool, fused_conv_pool_packed,
        fused_conv_pool_reference, last_forward_plan, unpack_level)

    dt = str(dtype).replace("torch.", "")
    conv = copy.deepcopy(conv)
    conv.dtype = dtype
    conv.spec = dataclasses.replace(conv.spec, stride=stride)
    packed = conv.packed_operands()  # prepared once, outside the timing
    fw, fb = unpack_level(packed)
    raw = raw_operands(conv, dtype)
    s = conv.spec
    slope = conv.negative_slope
    x = torch.randn((batch, fw.shape[1], T_in), generator=gen).to(DEV, dtype)
    out = fused_conv_pool_packed(x, packed)
    plan = last_forward_plan()  # the staging the launcher ran
    if plan != forward_plan(dtype, batch, T_in, fw.shape[2], packed.rows, out.shape[2], stride,
                            s.padding, max_live=packed.max_live, sms=_sm_count(x.device.index)):
        fail(f"{name} {dt} B={batch}: the launch ran plan {plan}, its planner built for the "
             f"host gives another")
    ref = fused_conv_pool_reference(x, fw, fb, None, None, stride, s.padding,
                                    s.padding_mode, slope)
    torch.cuda.synchronize()
    err, tol = check(f"{name} {dt} B={batch} packed", out, ref, dtype)
    if bits and not torch.equal(fused_conv_pool_packed(x, packed), out):
        fail(f"{name} {dt} B={batch}: the forward differs between two runs on the same inputs")
    args = (x, *raw, stride, s.padding, s.padding_mode, slope)
    plain = fused_conv_pool_reference(*args)
    err_api, _ = check(f"{name} {dt} B={batch} unpacked", fused_conv_pool(*args),
                       plain, dtype)
    pad = s.padding

    def library():
        xp = F.pad(x, (pad, pad), mode="reflect" if s.padding_mode == "reflect"
                   else "constant")
        return F.leaky_relu(F.conv1d(xp, fw, fb, stride=stride), slope)

    lib_err = float((library().float() - ref.float()).abs().max())
    nbytes, ops = level_work(x, raw, (fw, fb), out)
    t_bytes, t_ops = nbytes / MEM_BPS * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    kernel = lambda: fused_conv_pool_packed(x, packed)  # noqa: E731
    row = {
        "level": name, "dtype": dt, "batch": batch,
        "shape": {"C_in": fw.shape[1], "T": T_in, "C_out": s.out_channels,
                  "P": out.shape[1], "T_out": out.shape[2], "stride": stride,
                  "mask": raw[2] is not None, "pool": raw[3] is not None},
        # the launch's staging: whole rows or windows, tap segments, bytes
        "plan": plan,
        "live_tiles": int(packed.tile_start[-1]),
        "tiles": (packed.tile_start.numel() - 1) * -(-fw.shape[1] // CHUNK_CHANNELS[dtype]),
        "max_abs_err": max(err, err_api), "tol": tol, "library_err": lib_err,
        "ms": device_ms(kernel),
        "plain_ms": device_ms(lambda: fused_conv_pool_reference(*args)),
        "library_ms": device_ms(library),
        "eager_ms": time_ms(kernel),
        "bytes": nbytes, "ops": ops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    print(json.dumps(row), flush=True)
    return row


def build_report(proc, cubin, kind):
    """Registers, shared memory and spills per kernel from ``nvcc -Xptxas
    -v``, ptxas's notes that it serialized a kernel's wgmma (C7520), and the
    count of HGMMA (wgmma), HMMA (mma.sync) and UBLKCP (bulk copy)
    instructions in each one's SASS; ``kind(mangled name)`` names the
    kernel."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc -cubin failed:\n{out}{err}")
    report = {}
    key = None
    for line in (out + err).splitlines():
        if "Compiling entry function" in line:
            key = kind(line)
        elif key and "Used" in line and "registers" in line:
            report.setdefault(key, {})["ptxas"] = line.split("info    :")[-1].strip()
        elif key and "spill" in line:
            report.setdefault(key, {})["spills"] = line.strip()
        if "C7520" in line:
            r = report.setdefault(kind(line), {})
            r["wgmma_serialized"] = r.get("wgmma_serialized", 0) + 1
    from hm_vae_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    for part in sass.split("Function : ")[1:]:
        report.setdefault(kind(part.splitlines()[0]), {}).update(
            hgmma=part.count("HGMMA"), hmma=part.count("HMMA"), ublkcp=part.count("UBLKCP"))
    return report


def fwd_kind(name):
    """bf16 or f32, and "_windows" for the instantiation that stages rows as
    windows (``conv_gemm_kernel<T, true>``)."""
    return ("bf16" if "nv_bfloat16" in name else "f32") + ("_windows" if "Lb1E" in name else "")


def bwd_kind(name):
    """dgrad, or wgrad by its tap tiles a warp: two (K <= 15, "wgrad"),
    three (K <= 23, "wgrad_nq3") or four (K <= 31, "wgrad_nq4", the
    trajectory model's K 31)."""
    if "dgrad" in name:
        return "dgrad"
    for nq in (3, 4):
        if f"ILi{nq}E" in name:
            return f"wgrad_nq{nq}"
    return "wgrad"


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


def reconstruct_agreement(name, outs, refs, dtype):
    """(rot6d, rotmat, pose) against a reference's, on the CPU.  6D:
    |out - ref| <= E2E_TOL * max|ref| on every joint; rotation matrices
    within ROT_TOL on joints of condition > COND_MIN; FK positions within
    POSE_TOL on joints whose ancestors all are.  Returns the errors."""
    (o6, om, op), (r6, rm, rp) = outs, refs
    for what, o, r in (("rot6d", o6, r6), ("rotmat", om, rm), ("pose", op, rp)):
        if o.shape != r.shape or not torch.isfinite(o).all():
            fail(f"{name} {what}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite")
    scale6 = float(r6.abs().max())
    tol6 = E2E_TOL[dtype] * scale6
    err6 = float((o6 - r6).abs().max())
    if not err6 <= tol6:
        fail(f"{name} rot6d: max |out - ref| {err6:.3e} > {tol6:.3e}")
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
            fail(f"{name} {what}: max |out - ref| {err:.3e} > {tol:.3e} where "
                 f"well conditioned")
    return {"rot6d": err6, "rot6d_tol": tol6, "rot6d_max_abs": scale6,
            "rot6d_median_abs": float(r6.abs().median()),
            "rotmat_well": checks[0][1], "rotmat_tol": checks[0][2],
            "share_well": float(well.float().mean()),
            "pose_well": checks[1][1], "pose_tol": checks[1][2],
            "share_pose_well": float(chain.float().mean()),
            "rotmat_all": float(err_m.max()), "pose_all": float(err_p.max())}


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
    errs = reconstruct_agreement(f"{name} gpu vs cpu", (o6, om, op),
                                 cpu.mean_reconstruction(x6d.cpu()), dtype)
    fk_ref = fk_mod.fk_from_rotmat(om, fk_mod.default_offsets())
    tol_p = 1e-4 * max(1.0, float(fk_ref.abs().max()))
    err_fk = float((op - fk_ref).abs().max())
    if not err_fk <= tol_p:
        fail(f"{name} pose: FK on the GPU vs the CPU {err_fk:.3e} > {tol_p:.3e}")
    errs["pose_fk"] = err_fk
    reps = 20
    fused_conv_pool.launches = 0
    ms = time_ms(lambda: gpu.mean_reconstruction(x6d), reps=reps, samples=5)
    per_call = fused_conv_pool.launches / (3 + 5 * reps)
    if per_call != 8:
        fail(f"{name}: {per_call} launches per reconstruct in the timed runs")
    row = {"phase": "reconstruct", "dtype": name, "batch": int(x6d.shape[0]),
           "launches": launches, "max_abs_err": errs, "ms_per_reconstruct": ms,
           "profile": profile_calls(lambda: gpu.mean_reconstruction(x6d))}
    print(json.dumps(row), flush=True)
    return row


# the port's kernels by their names in a device trace (a CUDA-graph replay
# runs them with no call of their entries, so only the trace sees them)
TRACE_KERNELS = re.compile(r"::(conv_gemm_kernel|dgrad_kernel|wgrad_kernel)[<(]")
TRACE_NAME = {"fused_conv_pool": "conv_gemm_kernel", "fused_conv_pool_dgrad": "dgrad_kernel",
              "fused_conv_pool_wgrad": "wgrad_kernel"}


def profile_calls(fn, calls: int = 10, warm: bool = True):
    """Device time by kernel over `calls` calls of `fn` (torch.profiler), after
    one call unprofiled unless `warm` is false, the
    wall time they took, the device's idle share of that wall time, the
    device operations (kernels, copies, sets) per call, and the port's
    kernels' launches per call in the trace (TRACE_KERNELS).  It records the
    device's activity only: the host's operator events are read by nothing
    here, and at a solve's ~140k device operations they cost over a minute
    of processing."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, count, ours = {}, 0, {}
    for ev in prof.events():
        # a user annotation (such as Optimizer.step) is a range on the
        # device's timeline over kernels counted on their own
        if ev.device_type.name == "CUDA" and not getattr(ev, "is_user_annotation", False):
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            count += 1
            m = TRACE_KERNELS.search(ev.name)
            if m:
                ours[m.group(1)] = ours.get(m.group(1), 0) + 1
    busy = sum(kernels.values())
    by_name = {}  # kernel names cut to 60 characters, their times summed
    for k, v in kernels.items():
        by_name[k[:60]] = by_name.get(k[:60], 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"calls": calls, "wall_us_per_call": wall_us / calls,
            "device_us_per_call": busy / calls,
            "idle_share": 1.0 - busy / wall_us if wall_us > 0 else None,
            "device_ops_per_call": count / calls,
            "trace_launches_per_call": {k: v / calls for k, v in sorted(ours.items())},
            "top_us_per_call": {k: v / calls for k, v in top}}


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


def bwd_work(gy, y, x, wf):
    """(dgrad bytes, wgrad bytes, operations of each) one call needs at the
    least: gy and y read once, the folded weight's nonzeros (dgrad reads
    them; wgrad writes their gradient and the bias's), x read (wgrad) or its
    gradient written (dgrad), and the multiply-adds of the nonzeros over the
    B*T_out columns (wgrad: plus the bias sums)."""
    nnz = int((wf != 0).sum())
    B, P, T_out = gy.shape
    N = B * T_out
    io = 2 * gy.numel() * gy.element_size() + nnz * wf.element_size()
    x_bytes = x.numel() * x.element_size()
    ops = 2 * N * nnz
    return io + x_bytes, io + x_bytes + P * wf.element_size(), ops, ops + N * P


def bwd_inputs(conv, T_in, gen, batch=BATCH):
    """One level's backward operands at `batch`, f32, on the card: the
    structure, the folded weight and bias, x, the forward's output y and a
    random output gradient gy."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    s = conv.structure()
    with torch.no_grad():
        wf, bf = conv.folded_weight()
    wf = wf.detach().contiguous()
    bf = None if bf is None else bf.detach()
    x = torch.randn((batch, wf.shape[1], T_in), generator=gen).to(DEV)
    with torch.no_grad():
        y = fcp.FusedConvPoolFn.apply(x, wf, bf, s)
    gy = torch.randn(y.shape, generator=gen).to(DEV)
    return s, wf, bf, x, y, gy


def bwd_phase(model, st, gen):
    """The backward kernels at the eight level shapes, batch 8, f32:
    :func:`bwd_level_row` of each."""
    return [bwd_level_row(name, conv, T_in, BATCH, gen)
            for name, conv, T_in in level_cases(model, st)]


def bwd_level_row(name, conv, T_in, batch, gen, with_wgrad=True):
    """The backward kernels (dgrad, and wgrad unless `with_wgrad` is false)
    of one level at `batch`, f32: each against its plain version on the
    same gy, y and x, and, with y from the plain forward, against autograd
    of the plain forward (cuDNN, TF32 off); two runs bit-equal; device
    times of kernel, plain version and torch.nn.grad's conv1d_input /
    conv1d_weight on the folded weight (with the activation's mask; no
    reflect fold); and bounds."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    s, wf, bf, x, y, gy = bwd_inputs(conv, T_in, gen, batch)
    mode = "reflect" if s.reflect else "constant"
    slope, pad, stride, K = s.negative_slope, s.padding, s.stride, s.kernel_size
    live = s.live_elements()

    def dgrad(y=y):
        return fcp.fused_conv_pool_dgrad(gy, y, wf, s, T_in)

    def wgrad(y=y):
        return fcp.fused_conv_pool_wgrad(gy, y, x, s)

    def d_plain():
        return fcp.fused_conv_pool_dgrad_reference(gy, y, wf, T_in, stride, pad, mode, slope)

    def w_plain():
        return fcp.fused_conv_pool_wgrad_reference(gy, y, x, K, stride, pad, mode, slope,
                                                   live)

    def d_lib():
        g = torch.where(y >= 0, gy, gy * slope)
        return torch.nn.grad.conv1d_input((batch, wf.shape[1], T_in + 2 * pad), wf, g,
                                          stride=stride)

    def w_lib():
        g = torch.where(y >= 0, gy, gy * slope)
        return (torch.nn.grad.conv1d_weight(F.pad(x, (pad, pad), mode=mode), wf.shape, g,
                                            stride=stride), g.sum((0, 2)))

    f32 = torch.float32
    gx, rx = dgrad(), d_plain()
    # autograd of the plain forward, the kernels reading its output
    leaves = [x.clone().requires_grad_(), wf.clone().requires_grad_()]
    if bf is not None:
        leaves.append(bf.clone().requires_grad_())
    ya = fcp.fused_conv_pool_reference(leaves[0], leaves[1], leaves[2] if bf is not None
                                       else None, None, None, stride, pad, mode, slope)
    ag = torch.autograd.grad(ya, leaves, gy)
    ya = ya.detach()
    gx_a = dgrad(ya)
    torch.cuda.synchronize()
    err_d = max(check(f"{name} dgrad", gx, rx, f32)[0],
                check(f"{name} dgrad vs autograd", gx_a, ag[0], f32)[0])
    if not torch.equal(dgrad(), gx):
        fail(f"{name}: dgrad differs between two runs on the same inputs")
    d_bytes, w_bytes, d_ops, w_ops = bwd_work(gy, y, x, wf)
    cases = [("dgrad", dgrad, d_plain, d_lib, err_d, d_bytes, d_ops)]
    if with_wgrad:
        (gw, gb), (rw, rb) = wgrad(), w_plain()
        gw_a, gb_a = wgrad(ya)
        torch.cuda.synchronize()
        err_w = max(check(f"{name} wgrad", gw, rw, f32)[0],
                    check(f"{name} wgrad vs autograd", gw_a, ag[1] * live[:, :, None],
                          f32)[0])
        if bf is not None:
            err_w = max(err_w, check(f"{name} bias grad", gb, rb, f32)[0],
                        check(f"{name} bias grad vs autograd", gb_a, ag[2], f32)[0])
        if not torch.equal(wgrad()[0], gw):
            fail(f"{name}: wgrad differs between two runs on the same inputs")
        cases.append(("wgrad", wgrad, w_plain, w_lib, err_w, w_bytes, w_ops))
    row = {"level": name, "batch": batch, "C_in": wf.shape[1], "T_in": T_in,
           "P": wf.shape[0], "T_out": y.shape[2], "stride": stride,
           "live_tiles": int(s.tile_chunk.numel()), "chunk_pairs": s.dgrad_start.numel() - 1}
    for what, fn, plain, lib, err, nbytes, ops in cases:
        t_bytes, t_ops = nbytes / MEM_BPS * 1e3, ops / PEAK_FLOPS[f32] * 1e3
        row[what] = {"max_abs_err": err, "ms": device_ms(fn), "plain_ms": device_ms(plain),
                     "library_ms": device_ms(lib), "eager_ms": time_ms(fn),
                     "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(json.dumps(row), flush=True)
    return row


def train_config(data_root, path=CONFIG):
    """A full-width config (the len-64 VAE's unless `path` names another) on
    synthetic data made from the seed, logging every step, no validation or
    snapshot inside the run."""
    from hm_vae_torch.utils.config import load_config

    cfg = load_config(path)
    big = 10 ** 9
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic=True, data_root=data_root),
        run=dataclasses.replace(cfg.run, log_iter=1, validation_iter=big,
                                snapshot_save_iter=big, image_save_iter=big))


# kernel launches a training step: the VAE's 8 convs (enc0's input is data,
# no dgrad); the trajectory model's 4 levels (level 0's input is data)
TRAIN_LAUNCHES = {"fused_conv_pool": 8, "fused_conv_pool_dgrad": 7, "fused_conv_pool_wgrad": 8}
TRAJ_TRAIN_LAUNCHES = {"fused_conv_pool": 4, "fused_conv_pool_dgrad": 3,
                       "fused_conv_pool_wgrad": 4}


def train_phase(data_root, path=CONFIG, want=TRAIN_LAUNCHES, phase="train"):
    """TRAIN_STEPS steps of Trainer.fit of `path`'s model (the len-64 VAE,
    or the trajectory model) on the GPU and on the CPU from the
    same init, batches and noise, and on each a run from the init scaled by
    1 + 1e-7: Adam amplifies last-place differences (and the random-weight
    model's ill-conditioned 6D -> rotmat amplifies them further), so the
    GPU-vs-CPU losses must agree to 1e-4 relative over the first 5 steps and
    stay within 10x the larger perturbed run's spread (so far) + 1e-4 after.
    The perturbation is run on both sides because its spread differs by 10x
    between them at some steps.  Then kernel launches per step, step time
    (CUDA events) and the profile."""
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.train_step import loss_fields, to_device, train_step
    from hm_vae_torch.train.trainer import build_trainer

    cfg = train_config(data_root, path)
    counters = (fcp.fused_conv_pool, fcp.fused_conv_pool_dgrad, fcp.fused_conv_pool_wgrad)
    losses, launches, wall = {}, None, {}
    for run, dev, scale in (("gpu", DEV, 1.0), ("cpu", "cpu", 1.0),
                            ("gpu_perturbed", DEV, 1.0 + 1e-7),
                            ("cpu_perturbed", "cpu", 1.0 + 1e-7)):
        trainer, train_ds, _, _ = build_trainer(cfg, os.path.join(OUT_DIR, f"{phase}_{run}"),
                                                device=dev)
        with torch.no_grad():
            for p in trainer.state.model.parameters():
                p.mul_(scale)
        out = []
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        trainer.fit(train_ds, None, max_iter=TRAIN_STEPS,
                    log_cb=lambda step, m: out.append(m["loss_total"]))
        wall[run] = time.perf_counter() - t0
        if run == "gpu":
            in_run = {c.__name__: c.launches for c in counters}
            launches = {k: v // TRAIN_STEPS if v % TRAIN_STEPS == 0 else v / TRAIN_STEPS
                        for k, v in in_run.items()}
            gpu, gpu_ds = trainer, train_ds
        losses[run] = np.array(out)
    if any(len(v) != TRAIN_STEPS or not np.isfinite(v).all() for v in losses.values()):
        fail(f"{phase}: losses {losses}")
    if launches != want:
        fail(f"{phase}: kernel launches per step {launches}, expected {want} (the first "
             "conv's input is data and needs no input gradient)")
    rel = np.abs(losses["gpu"] / losses["cpu"] - 1)
    spread = {dev: np.maximum.accumulate(np.abs(losses[f"{dev}_perturbed"] / losses[dev] - 1))
              for dev in ("gpu", "cpu")}
    band = 10 * np.maximum(spread["gpu"], spread["cpu"]) + 1e-4
    if not ((rel[:5] <= 1e-4).all() and (rel <= band).all()):
        fail(f"{phase}: GPU vs CPU loss relative difference {rel.tolist()} outside "
             f"{band.tolist()} (first 5 steps: 1e-4)")
    # step time and profile on the GPU trainer's state (training on)
    batch = to_device(gpu_ds.sample_batch(cfg.optim.batch_size), DEV, loss_fields(gpu.state.model))
    noise = torch.Generator()

    def step():
        return train_step(gpu.state, batch, cfg, generator=noise.manual_seed(0),
                          mean_std=gpu.mean_std)

    # the value-only repack of the 8 convs, which every step's forward runs
    from hm_vae_torch.models.hm_vae import SkeletonConv
    from hm_vae_torch.ops.fused_conv_pool import repack

    convs = [m for m in gpu.state.model.modules() if isinstance(m, SkeletonConv)]

    @torch.no_grad()
    def repack_all():
        return [repack(c.structure(), *c.folded_weight()) for c in convs]

    row = {"phase": phase, "config": os.path.relpath(path, ROOT), "batch": cfg.optim.batch_size,
           "steps": TRAIN_STEPS, "loss_gpu": losses["gpu"].tolist(),
           "loss_cpu": losses["cpu"].tolist(), "max_rel_diff": float(rel.max()),
           "rel_diff": rel.tolist(), "band": band.tolist(),
           "spread": {k: v.tolist() for k, v in spread.items()},
           "launches_per_step": launches, "launches_in_run": in_run, "fit_seconds": wall,
           "ms_per_step": time_ms(step, reps=10, samples=5),
           "profile": profile_calls(step, calls=5),
           "repack_profile": profile_calls(repack_all, calls=5)}
    print(json.dumps(row), flush=True)
    return row


def train_cli_phase(data_root, path=CONFIG, phase="train_cli"):
    """``python -m hm_vae_torch.cli.train`` (in this process) on `path` for 3
    steps, which writes gen_00000003.pt, then ``--resume`` to step 5; returns
    the checkpoint of step 5."""
    from hm_vae_torch.cli import train as train_cli

    out = os.path.join(OUT_DIR, phase)
    shutil.rmtree(out, ignore_errors=True)
    args = ["--config", path, "--output_path", out, "--data_root", data_root, "--device", DEV]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_cli.main(args + ["--max_iter", "3"])
        train_cli.main(args + ["--max_iter", "5", "--resume"])
    text = buf.getvalue()
    ck = os.path.join(out, "outputs", os.path.splitext(os.path.basename(path))[0],
                      "checkpoints")
    names = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
    resumed = [line for line in text.splitlines() if line.startswith("Resume from")]
    if resumed != ["Resume from iteration 3"] or names != ["gen_00000003.pt", "gen_00000005.pt"]:
        fail(f"{phase}: resume lines {resumed}, checkpoints {names}:\n{text}")
    row = {"phase": phase, "config": os.path.relpath(path, ROOT), "resumed": resumed[0],
           "checkpoints": names,
           "seconds": time.perf_counter() - t0,
           "finish": [line for line in text.splitlines() if line.startswith("Finish")][-1][:200]}
    print(json.dumps(row), flush=True)
    return os.path.join(ck, names[-1])


def latent_config(**lat):
    """``configs/len_64_test_interpolation.yaml`` with solver overrides."""
    from hm_vae_torch.utils.config import load_config

    cfg = load_config(LATENT_CONFIG)
    return dataclasses.replace(cfg, latent_opt=dataclasses.replace(cfg.latent_opt, **lat))


def windowed_inputs(conv, T_in, gen):
    """One decoder level's operands for WINDOWS windows of one batch each, on
    the card: the conv's fold scaled per window (the structure's zeros
    kept) and its bias, x, the windowed forward's output y, a random gy."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    s = conv.structure()
    wf, bf = (None if t is None else t.detach().cpu() for t in conv.folded_weight())
    scale = 1.0 + 0.3 * torch.randn((WINDOWS, 1, 1, 1), generator=gen)
    w = (wf[None] * scale).contiguous().to(DEV)
    b = None if bf is None else (bf[None] * scale[:, :, 0, 0]).contiguous().to(DEV)
    x = torch.randn((WINDOWS, wf.shape[1], T_in), generator=gen).to(DEV)
    packed = fcp.repack(s, w, b)
    y = fcp.fused_conv_pool_windowed(x, packed)
    gy = torch.randn(y.shape, generator=gen).to(DEV)
    return s, w, b, packed, x, y, gy


def windowed_phase(model, st, gen):
    """The windowed forward, dgrad and wgrad at the four decoder levels, 10
    windows of one batch each, f32: against their plain versions, the
    backward also against autograd of the plain forward, each against 10
    one-window launches on each window's weight, two runs bit-equal; device
    times of kernel, plain version and cuDNN's grouped convolution
    (``groups=WINDOWS`` on the stacked folded weights, and its
    conv1d_input / conv1d_weight), beside the bounds (each window's
    least bytes and operations, times WINDOWS)."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    f32, G = torch.float32, WINDOWS
    rows = []
    for name, conv, T_in in level_cases(model, st):
        if not name.startswith("dec"):
            continue
        s, w, b, packed, x, y, gy = windowed_inputs(conv, T_in, gen)
        mode = "reflect" if s.reflect else "constant"
        slope, pad, stride, K = s.negative_slope, s.padding, s.stride, s.kernel_size
        live = s.live_elements()[None, :, :, None]
        C, P, T_out = x.shape[1], y.shape[1], y.shape[2]
        xg, wg = x.reshape(1, G * C, T_in), w.reshape(G * P, C, K)
        bg = None if b is None else b.reshape(-1)

        def fwd():
            return fcp.fused_conv_pool_windowed(x, packed)

        def dgrad(y=y):
            return fcp.fused_conv_pool_dgrad_windowed(gy, y, w, s, T_in)

        def wgrad(y=y):
            return fcp.fused_conv_pool_wgrad_windowed(gy, y, x, s, G)

        def f_plain():
            return fcp.fused_conv_pool_windowed_reference(x, w, b, stride, pad, mode, slope)

        def d_plain():
            return fcp.fused_conv_pool_dgrad_windowed_reference(gy, y, w, T_in, stride, pad,
                                                                mode, slope)

        def w_plain():
            return fcp.fused_conv_pool_wgrad_windowed_reference(gy, y, x, K, stride, pad, G,
                                                                mode, slope, live[0, :, :, 0])

        def g_grouped():
            return torch.where(y >= 0, gy, gy * slope).reshape(1, G * P, T_out)

        def f_lib():
            xp = F.pad(xg, (pad, pad), mode=mode)
            return F.leaky_relu(F.conv1d(xp, wg, bg, stride=stride, groups=G), slope)

        def d_lib():
            return torch.nn.grad.conv1d_input((1, G * C, T_in + 2 * pad), wg, g_grouped(),
                                              stride=stride, groups=G)

        def w_lib():
            g = g_grouped()
            return (torch.nn.grad.conv1d_weight(F.pad(xg, (pad, pad), mode=mode), wg.shape, g,
                                                stride=stride, groups=G), g.sum((0, 2)))

        out, gx, (gw, gb) = fwd(), dgrad(), wgrad()
        err_f = check(f"{name} windowed", out, f_plain(), f32)[0]
        err_d = check(f"{name} windowed dgrad", gx, d_plain(), f32)[0]
        rw, rb = w_plain()
        err_w = check(f"{name} windowed wgrad", gw, rw, f32)[0]
        if b is not None:
            err_w = max(err_w, check(f"{name} windowed bias grad", gb, rb, f32)[0])
        # autograd of the plain forward, the kernels reading its output
        leaves = [t.clone().requires_grad_() for t in (x, w) + (() if b is None else (b,))]
        ya = fcp.fused_conv_pool_windowed_reference(leaves[0], leaves[1],
                                                    leaves[2] if b is not None else None,
                                                    stride, pad, mode, slope)
        ag = torch.autograd.grad(ya, leaves, gy)
        ya = ya.detach()
        gw_a, gb_a = wgrad(ya)
        err_d = max(err_d, check(f"{name} windowed dgrad vs autograd", dgrad(ya), ag[0],
                                 f32)[0])
        err_w = max(err_w, check(f"{name} windowed wgrad vs autograd", gw_a, ag[1] * live,
                                 f32)[0])
        if b is not None:
            err_w = max(err_w, check(f"{name} windowed bias grad vs autograd", gb_a, ag[2],
                                     f32)[0])
        if not (torch.equal(wgrad()[0], gw) and torch.equal(dgrad(), gx)):
            fail(f"{name}: a windowed backward kernel differs between two runs")
        # against G one-window launches on each window's weight
        one = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0}
        with torch.no_grad():
            for g in range(G):
                sl = slice(g, g + 1)
                single = fcp.repack(s, w[g], None if b is None else b[g])
                one["fwd"] = max(one["fwd"], check(
                    f"{name} window {g} vs one launch", out[sl],
                    fcp.fused_conv_pool_packed(x[sl], single), f32)[0])
                one["dgrad"] = max(one["dgrad"], check(
                    f"{name} window {g} dgrad vs one launch", gx[sl],
                    fcp.fused_conv_pool_dgrad(gy[sl], y[sl], w[g], s, T_in), f32)[0])
                one["wgrad"] = max(one["wgrad"], check(
                    f"{name} window {g} wgrad vs one launch", gw[g],
                    fcp.fused_conv_pool_wgrad(gy[sl], y[sl], x[sl], s)[0], f32)[0])
        torch.cuda.synchronize()
        nbytes, ops = level_work(x[:1], raw_operands(conv, f32),
                                 (w[0], None if b is None else b[0]), out[:1])
        d_bytes, w_bytes, d_ops, w_ops = bwd_work(gy[:1], y[:1], x[:1], w[0])
        row = {"level": name, "windows": G, "batch_per_window": 1, "C_in": C, "T_in": T_in,
               "P": P, "T_out": T_out, "stride": stride,
               "live_tiles": int(s.tile_chunk.numel())}
        for what, fn, plain, lib, err, nb, no in (
                ("fwd", fwd, f_plain, f_lib, err_f, nbytes, ops),
                ("dgrad", dgrad, d_plain, d_lib, err_d, d_bytes, d_ops),
                ("wgrad", wgrad, w_plain, w_lib, err_w, w_bytes, w_ops)):
            t_bytes, t_ops = G * nb / MEM_BPS * 1e3, G * no / PEAK_FLOPS[f32] * 1e3
            row[what] = {"max_abs_err": err, "vs_one_window_err": one[what],
                         "ms": device_ms(fn), "plain_ms": device_ms(plain),
                         "library_ms": device_ms(lib), "eager_ms": time_ms(fn),
                         "bytes": G * nb, "ops": G * no, "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def solve_sequence(rng):
    """(WINDOWS*64, 24, 3, 3) rotations of a smooth synthetic motion, and its
    root translation (WINDOWS*64, 3): the root's steps accumulated, the
    first zeroed."""
    from hm_vae_torch.data import layout, synthetic

    T = WINDOWS * 64
    frames = synthetic.synth_sequence(rng, T)
    steps = frames[:, layout.ROOT_V].copy()
    steps[0] = 0.0
    return frames[:, layout.ROTMAT].reshape(T, 24, 3, 3), np.cumsum(steps, axis=0)


def solve_agreement_phase(seq, traj=None, root_trans=None, phase="solve_agreement",
                          lat=None):
    """A 12-iteration 10-window interpolation (z phase 6, decoder phase 5,
    the last a decoder step) through ``LatentOptApps.interpolate`` on the
    GPU and on the CPU from the same weights and z, and on each side from
    the weights scaled by 1 + 1e-7: the losses agree to 1e-4 relative over
    the first 5 iterations and within 10x the larger perturbed spread (so
    far) + 1e-4 after; 6D within 10x the larger perturbed 6D spread +
    1e-4 * max|cpu|; rotations (joints of condition > COND_MIN) and
    positions (joints whose ancestors all are) likewise, + ROT_TOL /
    POSE_TOL.  Then a 7-iteration solve (6 z iterations, the last one's
    forward through the per-window clones), before Adam's amplification:
    losses within 1e-4 relative, 6D as the reconstruct's (E2E_TOL), and
    rotations and positions on the same joints within the 6D tolerance
    amplified by Gram-Schmidt (1/COND_MIN) and FK (the pose's extent).

    With `traj` = (trajectory model, mean_std) and the sequence's
    `root_trans`: the 12-iteration solve under the keyframe trajectory loss
    (reg_w_trajectory 1), the trajectory model on each side's device.  With
    `lat` (solver overrides: the lora scope, the bf16 clone) the
    12-iteration solve in that mode, its adapters drawn on the CPU by the
    solver on both sides.  Either runs the 12-iteration solve only."""
    from hm_vae_torch.apps.tasks import LatentOptApps
    from hm_vae_torch.models.hm_vae import HMVAE

    extra = {} if traj is None else {"optimize_trajectory": True, "reg_w_trajectory": 1.0}
    cfg = latent_config(opt_it=12, prev_epochs=5, **extra, **(lat or {}))
    base = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(SEED))
    outs, wall = {}, {}

    def run_on(dev, scale, cfg):
        m = copy.deepcopy(base)
        with torch.no_grad():
            for prm in m.parameters():
                prm.mul_(scale)
        t = None if traj is None else (copy.deepcopy(traj[0]).to(dev), traj[1])
        apps = LatentOptApps(m.to(dev), cfg, trajectory=t)
        t0 = time.perf_counter()
        out = apps.interpolate(seq, torch.Generator().manual_seed(SEED), root_trans=root_trans)
        return {k: v.cpu() for k, v in out.items()}, time.perf_counter() - t0

    for run, dev, scale in (("gpu", DEV, 1.0), ("cpu", "cpu", 1.0),
                            ("gpu_perturbed", DEV, 1.0 + 1e-7),
                            ("cpu_perturbed", "cpu", 1.0 + 1e-7)):
        outs[run], wall[run] = run_on(dev, scale, cfg)
    loss = {k: v["loss_history"].numpy().astype(np.float64) for k, v in outs.items()}
    if any(len(v) != 12 or not np.isfinite(v).all() for v in loss.values()):
        fail(f"{phase}: loss histories {loss}")
    rel = np.abs(loss["gpu"] / loss["cpu"] - 1)
    spread = {d: np.maximum.accumulate(np.abs(loss[f"{d}_perturbed"] / loss[d] - 1))
              for d in ("gpu", "cpu")}
    band = 10 * np.maximum(spread["gpu"], spread["cpu"]) + 1e-4
    if not ((rel[:5] <= 1e-4).all() and (rel <= band).all()):
        fail(f"{phase}: GPU vs CPU loss relative difference {rel.tolist()} outside "
             f"{band.tolist()} (first 5 iterations: 1e-4)")
    g, c = outs["gpu"], outs["cpu"]
    well = gram_schmidt_condition(c["rot_6d"]) > COND_MIN
    chain = ancestors_ok(well)
    errs = {}
    for what, sel, tol0 in (("rot_6d", None, 1e-4 * float(c["rot_6d"].abs().max())),
                            ("rot_mat", well, ROT_TOL[torch.float32]),
                            ("pose", chain, POSE_TOL[torch.float32])):
        def dev_of(a, b):
            d = (a[what] - b[what]).abs()
            d = d.reshape(d.shape[:2] + (-1,)).amax(-1)  # per frame and joint
            return float(d.max() if sel is None else d[sel].max())

        err = dev_of(g, c)
        tol = 10 * max(dev_of(outs["gpu_perturbed"], g), dev_of(outs["cpu_perturbed"], c)) + tol0
        if not err <= tol:
            fail(f"{phase} {what}: max |gpu - cpu| {err:.3e} > {tol:.3e}")
        errs[what] = {"err": err, "tol": tol}
    row = {"phase": phase, "config": os.path.relpath(LATENT_CONFIG, ROOT),
           "windows": WINDOWS, "opt_it": 12, "prev_epochs": 5, "trajectory": traj is not None,
           "overrides": lat or {},
           "loss_gpu": loss["gpu"].tolist(), "loss_cpu": loss["cpu"].tolist(),
           "rel_diff": rel.tolist(), "band": band.tolist(),
           "spread": {k: v.tolist() for k, v in spread.items()}, "outputs": errs,
           "share_well": float(well.float().mean()), "seconds": wall}
    if traj is not None or lat:
        print(json.dumps(row), flush=True)
        return row
    # before Adam's amplification: 6 z iterations, the last iteration's
    # forward through the 10 per-window clones (the windowed forward), held
    # as the reconstruct is (e2e_phase's tolerances)
    tight = {}
    for dev in (DEV, "cpu"):
        tight[dev], wall[f"tight_{dev}"] = run_on(dev, 1.0, latent_config(opt_it=7,
                                                                          prev_epochs=5))
    g, c = tight[DEV], tight["cpu"]
    well = gram_schmidt_condition(c["rot_6d"]) > COND_MIN
    chain = ancestors_ok(well)
    err6 = float((g["rot_6d"] - c["rot_6d"]).abs().max())
    err_m = float((g["rot_mat"] - c["rot_mat"]).abs().amax(dim=(-1, -2))[well].max())
    err_p = float((g["pose"] - c["pose"]).abs().amax(dim=-1)[chain].max())
    rel7 = np.abs(g["loss_history"].numpy() / c["loss_history"].numpy() - 1)
    # 6D as the reconstruct's; Gram-Schmidt amplifies a 6D difference by up
    # to 1/COND_MIN on the joints held, and FK carries a rotation's
    # difference out along the chain (at most the pose's extent)
    tol6 = E2E_TOL[torch.float32] * float(c["rot_6d"].abs().max())
    tol_rot = tol6 / COND_MIN
    checks = (("rot_6d", err6, tol6), ("rot_mat", err_m, tol_rot),
              ("pose", err_p, tol_rot * max(1.0, float(c["pose"].abs().max()))),
              ("loss", float(rel7.max()), 1e-4))
    for what, err, tol in checks:
        errs[f"tight_{what}"] = {"err": err, "tol": tol}
    if not all(err <= tol for _, err, tol in checks):
        fail(f"7-iteration solve: max |gpu - cpu| against tolerance {errs}")
    row["share_well"] = float(well.float().mean())
    print(json.dumps(row), flush=True)
    return row


LAUNCH_NAMES = ("fused_conv_pool", "fused_conv_pool_dgrad", "fused_conv_pool_wgrad",
                "fused_conv_pool_windowed", "fused_conv_pool_dgrad_windowed",
                "fused_conv_pool_wgrad_windowed")


def launch_counters():
    from hm_vae_torch.ops import fused_conv_pool as fcp

    return list(fcp.launch_entries())  # in LAUNCH_NAMES' order


def timed_solve(apps, seq, reps=2, root_trans=None):
    """Kernel launches of one solve (counts set to 0 just before), its
    loss history, and ms per solve by CUDA events over ``reps`` solves."""
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    out = apps.interpolate(seq, torch.Generator().manual_seed(SEED), root_trans=root_trans)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        apps.interpolate(seq, torch.Generator().manual_seed(SEED), root_trans=root_trans)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return out, launches, ms


def solve_phase(model, seq):
    """The full solve of the config (10 windows, 150 iterations, per-window
    clones, full scope) on the card: launches per phase (z phase: 4 forward
    and 4 dgrad a iteration, no wgrad; decoder phase: 4 windowed forward,
    dgrad and wgrad; the last iteration its forward only), the loss falls,
    ms per solve, the profile; then the shared-clone and last_conv solves."""
    from hm_vae_torch.apps.tasks import LatentOptApps

    cfg = latent_config()
    lat = cfg.latent_opt
    n_z = min(lat.prev_epochs + 1, lat.opt_it - 1)
    n_d = lat.opt_it - 1 - n_z
    LatentOptApps(model, latent_config(opt_it=3, prev_epochs=0)).interpolate(
        seq, torch.Generator().manual_seed(SEED))  # warm-up: structures, libraries
    rows = {mode: mode_solve(model, seq, f"{mode} solve", overrides, want,
                             reps=2 if mode == "per_window" else 1,
                             profile=mode == "per_window")
            for mode, overrides, want in (
                ("per_window", {}, (4 * n_z, 4 * n_z, 0, 4 * (n_d + 1), 4 * n_d, 4 * n_d)),
                ("shared", {"per_window_decoder": False},
                 (4 * (n_z + n_d + 1), 4 * (n_z + n_d), 4 * n_d, 0, 0, 0)),
                ("last_conv", {"finetune_scope": "last_conv"},
                 (4 * n_z + 3 * (n_d + 1), 4 * n_z, 0, n_d + 1, 0, n_d)))}
    per_iter = {"z_phase": {"fwd": 4, "dgrad": 4, "wgrad": 0},
                "decoder_phase": {"fwd_windowed": 4, "dgrad_windowed": 4, "wgrad_windowed": 4}}
    row = {"phase": "solve", "config": os.path.relpath(LATENT_CONFIG, ROOT), "windows": WINDOWS,
           "opt_it": lat.opt_it, "z_iterations": n_z, "decoder_iterations": n_d,
           "launches_per_iteration": per_iter, **rows}
    print(json.dumps(row), flush=True)
    return row, rows["per_window"]["launches"]


def mode_solve(model, seq, name, overrides, want, reps=1, profile=True):
    """The full solve (10 windows, 150 iterations; the config's solver with
    `overrides`) on the card: its kernel launches must be exactly `want`
    (LAUNCH_NAMES order; the first, counted solve warms up), the loss fall,
    the outputs be finite; ms per solve by CUDA events over `reps` solves,
    the peak of allocated device memory, and the profile of one solve."""
    from hm_vae_torch.apps.tasks import LatentOptApps

    apps = LatentOptApps(model, latent_config(**overrides))
    torch.cuda.reset_peak_memory_stats()
    out, launches, ms = timed_solve(apps, seq, reps=reps)
    peak = torch.cuda.max_memory_allocated()
    want = dict(zip(LAUNCH_NAMES, want))
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    hist = out["loss_history"].cpu().numpy()
    if not (np.isfinite(hist).all() and len(hist) == apps.cfg.latent_opt.opt_it
            and hist[-1] < hist[0]):
        fail(f"{name}: loss history {hist.tolist()}")
    for k in ("rot_6d", "rot_mat", "pose"):
        if out[k].shape[0] != seq.shape[0] or not torch.isfinite(out[k]).all():
            fail(f"{name}: {k} of shape {tuple(out[k].shape)} or non-finite")
    row = {"ms_per_solve": ms, "launches": launches, "peak_memory_bytes": peak,
           "loss_first": float(hist[0]), "loss_last": float(hist[-1])}
    if profile:
        row["profile"] = profile_calls(
            lambda: apps.interpolate(seq, torch.Generator().manual_seed(SEED)), calls=1)
    return row


def eval_phase(data_root, model, ck):
    """``python -m hm_vae_torch.cli.eval_recovery`` (in this process) on two
    sequences of the synthetic test split with the training CLI's
    checkpoint `ck` (:func:`eval_cli`), its solves running the kernels of
    both phases; then completion and generation through LatentOptApps at a
    shorter solve."""
    from hm_vae_torch.apps.tasks import LatentOptApps
    from hm_vae_torch.data.dataset import EvalMotionDataset

    row = eval_cli(data_root, ck, "eval_recovery", LATENT_CONFIG, [],
                   lambda n: n["fused_conv_pool_dgrad"] and n["fused_conv_pool_wgrad_windowed"])

    cfg = latent_config(opt_it=30, prev_epochs=10, prev_epochs_completion=20)
    apps = LatentOptApps(model, cfg)
    ds = EvalMotionDataset(os.path.join(data_root, "seqs"), os.path.join(data_root, "test.json"))
    seqs = [ds[i]["rot_mat"] for i in range(2)]
    t1 = time.perf_counter()
    comp = apps.complete_many(seqs, torch.Generator().manual_seed(SEED))
    gen = apps.generate_many([q[:64] for q in seqs], torch.Generator().manual_seed(SEED),
                             num_windows=2, overlap=10)
    torch.cuda.synchronize()
    apps_seconds = time.perf_counter() - t1
    for i, q in enumerate(seqs):
        n_c = (q.shape[0] - 64) // 63 + 1
        for what, o, T in (("completion", comp[i], 64 + 63 * (n_c - 1)),
                           ("generation", gen[i], 64 + 2 * 54)):
            for k in ("rot_6d", "rot_mat", "pose"):
                v = torch.as_tensor(o[k])
                if v.shape[0] != T or not torch.isfinite(v).all():
                    fail(f"{what} of sequence {i}: {k} of shape {tuple(v.shape)}, expected "
                         f"{T} frames, or non-finite")
    row.update(completion_generation_seconds=apps_seconds,
               completion_frames=[int(o["pose"].shape[0]) for o in comp],
               generation_frames=[int(o["pose"].shape[0]) for o in gen])
    print(json.dumps(row), flush=True)
    return row


TRAJ_CONFIG = os.path.join(ROOT, "configs", "trajectory_model.yaml")
PRODUCTION_CONFIG = os.path.join(ROOT, "configs", "len64_production.yaml")
TRAJ_SERVE_T = 300  # eval_trajectory runs a whole sequence in one call


def traj_kernel_phase(tmodel, gen):
    """The three kernels at the trajectory model's four levels (K 31,
    stride 1, C_in 72 / 84 / 108 / 168, the pool folded in), f32: forward,
    dgrad and wgrad at batch 8 and T 128 (a training step); forward and
    dgrad at 10 windows of one batch and T 64 (the solver's trajectory term,
    non-windowed: the weights are shared); the forward at batch 1 and T 300
    (eval_trajectory); the forward in bf16 at batch 8, T 128 and at batch 1,
    T 300 (the bf16 serving bundle's trajectory, phase 25).  Each row as
    phases 2 and 5 check and time them.
    Returns {(case, kernel): [rows over the levels]}."""
    f32, bf16, T = torch.float32, torch.bfloat16, tmodel.cfg.train_seq_len
    rows = {}
    for i in range(len(tmodel.encoder.structure.levels)):
        conv = getattr(tmodel.encoder, f"conv_{i}")
        for case, batch, T_in, kinds, dtype in (
                ("train", BATCH, T, ("fwd", "dgrad", "wgrad"), f32),
                ("solve", WINDOWS, 64, ("fwd", "dgrad"), f32),
                ("serve", 1, TRAJ_SERVE_T, ("fwd",), f32),
                # the bf16 serving bundle's trajectory (export phase)
                ("serve_bf16_b8", BATCH, T, ("fwd",), bf16),
                ("serve_bf16", 1, TRAJ_SERVE_T, ("fwd",), bf16)):
            name = f"traj{i}_{case}"
            rows.setdefault((case, "fwd"), []).append(
                fwd_level_row(name, conv, T_in, 1, batch, dtype, gen))
            if "dgrad" in kinds:
                b = bwd_level_row(name, conv, T_in, batch, gen, with_wgrad="wgrad" in kinds)
                for k in kinds[1:]:
                    rows.setdefault((case, k), []).append(b[k])
    return rows


def eval_trajectory_phase(data_root, vae_ck, traj_ck):
    """``python -m hm_vae_torch.cli.eval_trajectory`` (in this process) with
    the VAE checkpoint of phase 7 and the trajectory model's of its training
    CLI phase: prior samples (--pred_trajectory_for_single_window), GT test
    windows (--debug_trajectory) and a 300-frame rotation sequence in one
    call (--seq_generation_npy_path); the files must exist, be finite and
    of their shapes; 4 forward launches for the VAE's decode and 4 for each
    of the three trajectory runs."""
    from hm_vae_torch.cli import eval_trajectory
    from hm_vae_torch.data import layout, synthetic
    from hm_vae_torch.ops import fused_conv_pool as fcp

    out = os.path.join(OUT_DIR, "eval_trajectory")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    seq = os.path.join(out, "synthetic_300.npy")
    frames = synthetic.synth_sequence(np.random.default_rng(SEED + 1), TRAJ_SERVE_T)
    np.save(seq, frames[:, layout.ROTMAT].reshape(TRAJ_SERVE_T, 24, 3, 3))
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    eval_trajectory.main(["--config", CONFIG, "--test_model", vae_ck, "--trajectory_config",
                          TRAJ_CONFIG, "--trajectory_test_model", traj_ck, "--output_path", out,
                          "--data_root", data_root, "--num_samples", "4",
                          "--pred_trajectory_for_single_window", "--debug_trajectory",
                          "--seq_generation_npy_path", seq, "--device", DEV])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    if launches["fused_conv_pool"] != 16 or sum(launches.values()) != 16:
        fail(f"eval_trajectory: kernel launches {launches}, expected 16 forward (the VAE's "
             "decode, then 4 a trajectory run)")
    d = os.path.join(out, "eval_trajectory", os.path.splitext(os.path.basename(CONFIG))[0])
    shapes = {}
    for tag, n, T in (("sampled_single_window", 4, 64), ("debug_gt_window", 4, 64),
                      ("synthetic_300_traj", 1, TRAJ_SERVE_T)):
        for b in range(n):
            for suffix, shape in (("", (T, 24, 9)), ("_trans", (T, 3))):
                f = os.path.join(d, f"{tag}_{b}{suffix}.npy")
                a = np.load(f) if os.path.exists(f) else None
                if a is None or a.shape != shape or not np.isfinite(a).all():
                    fail(f"eval_trajectory {f}: {None if a is None else a.shape}, expected "
                         f"{shape}, finite")
                shapes[f"{tag}{suffix}"] = list(shape)
    row = {"phase": "eval_trajectory", "files": shapes, "launches": launches,
           "seconds": seconds}
    print(json.dumps(row), flush=True)
    return row


def traj_solve_phase(model, traj, seq, root_trans):
    """The full solve (10 windows, 150 iterations, per-window clones) under
    the keyframe trajectory loss (reg_w_trajectory 1): ms per solve, kernel
    launches per phase (the solve's, plus 4 non-windowed forward launches of
    the trajectory model every iteration and 4 dgrad every iteration but the
    last, forward-only one), the profile."""
    from hm_vae_torch.apps.tasks import LatentOptApps

    cfg = latent_config(optimize_trajectory=True, reg_w_trajectory=1.0)
    lat = cfg.latent_opt
    n_z = min(lat.prev_epochs + 1, lat.opt_it - 1)
    n_d = lat.opt_it - 1 - n_z
    apps = LatentOptApps(model, cfg, trajectory=traj)
    LatentOptApps(model, latent_config(opt_it=3, prev_epochs=0, optimize_trajectory=True,
                                       reg_w_trajectory=1.0), trajectory=traj).interpolate(
        seq, torch.Generator().manual_seed(SEED), root_trans=root_trans)  # warm-up
    out, launches, ms = timed_solve(apps, seq, reps=2, root_trans=root_trans)
    want = dict(zip(LAUNCH_NAMES, (4 * n_z + 4 * lat.opt_it, 4 * n_z + 4 * (lat.opt_it - 1), 0,
                                   4 * (n_d + 1), 4 * n_d, 4 * n_d)))
    if launches != want:
        fail(f"trajectory solve: kernel launches {launches}, expected {want}")
    hist = out["loss_history"].cpu().numpy()
    if not (np.isfinite(hist).all() and len(hist) == lat.opt_it and hist[-1] < hist[0]):
        fail(f"trajectory solve: loss history {hist.tolist()}")
    for k in ("rot_6d", "rot_mat", "pose"):
        if out[k].shape[0] != seq.shape[0] or not torch.isfinite(out[k]).all():
            fail(f"trajectory solve: {k} of shape {tuple(out[k].shape)} or non-finite")
    per_iter = {"z_phase": {"fwd": 4 + 4, "dgrad": 4 + 4, "wgrad": 0},
                "decoder_phase": {"fwd": 4, "dgrad": 4, "fwd_windowed": 4, "dgrad_windowed": 4,
                                  "wgrad_windowed": 4}}
    row = {"phase": "solve_trajectory", "config": os.path.relpath(LATENT_CONFIG, ROOT),
           "windows": WINDOWS, "opt_it": lat.opt_it, "z_iterations": n_z,
           "decoder_iterations": n_d, "launches_per_iteration": per_iter,
           "ms_per_solve": ms, "launches": launches, "loss_first": float(hist[0]),
           "loss_last": float(hist[-1]),
           "profile": profile_calls(lambda: apps.interpolate(
               seq, torch.Generator().manual_seed(SEED), root_trans=root_trans), calls=1)}
    print(json.dumps(row), flush=True)
    return row


def eval_traj_recovery_phase(data_root, vae_ck, traj_ck):
    """``eval_recovery --try_interpolation_w_trajectory_single_window`` (in
    this process) on two sequences of the synthetic test split, with the
    checkpoints of phase 7 and of the trajectory training CLI phase."""
    from hm_vae_torch.cli import eval_recovery

    out = os.path.join(OUT_DIR, "eval_traj")
    shutil.rmtree(out, ignore_errors=True)
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    eval_recovery.main(["--config", LATENT_CONFIG, "--output_path", out, "--data_root",
                        data_root, "--test_model", vae_ck, "--trajectory_config", TRAJ_CONFIG,
                        "--trajectory_test_model", traj_ck,
                        "--try_interpolation_w_trajectory_single_window", "--max_seqs", "2",
                        "--device", DEV, "--seed", str(SEED)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    d = os.path.join(out, "eval_interpolation_w_trajectory_single_window",
                     os.path.splitext(os.path.basename(LATENT_CONFIG))[0])
    files = sorted(os.listdir(d)) if os.path.isdir(d) else []
    if "summary.json" not in files:
        fail(f"eval_recovery (trajectory) wrote {files}, no summary.json")
    with open(os.path.join(d, "summary.json")) as f:
        summary = json.load(f)
    n = summary["num_seqs"]
    for suffix, shape in (("_rot_opt_res.npy", (64, 24, 3, 3)),
                          ("_root_trans_opt_res.npy", (64, 24, 3))):
        got = [f for f in files if f.endswith(suffix)]
        if len(got) != n or not all(
                np.load(os.path.join(d, f)).shape == shape
                and np.isfinite(np.load(os.path.join(d, f))).all() for f in got):
            fail(f"eval_recovery (trajectory): {suffix} files {got}, expected {n} of {shape}")
    if not (launches["fused_conv_pool_dgrad"] and launches["fused_conv_pool_wgrad_windowed"]):
        fail(f"eval_recovery (trajectory): kernel launches {launches}")
    row = {"phase": "eval_recovery_trajectory",
           "task": "try_interpolation_w_trajectory_single_window", "files": files,
           "summary": summary, "seconds": seconds, "launches": launches}
    print(json.dumps(row), flush=True)
    return row

LORA = {"finetune_scope": "lora"}
BF16_CLONE = {"opt_param_dtype": "bfloat16", "opt_moment_dtype": "bfloat16"}


def lora_base_phase(model, st, gen):
    """The lora scope's base convs: the four decoder levels' shared folded
    weights at slope 1.0 and with no bias, on 10 windows of one batch each
    (one batch of 10 through one weight), f32: the forward and dgrad as
    phases 2 and 5 hold and time them (dgrad also against autograd of the
    plain forward, two runs bit-equal), the forward also bit-equal on two
    runs.  Then the adapters' rank-r convs (``lora_delta``: im2col products
    batched over windows, rank ``lora_rank``), forward and backward at the
    four levels, as the decoder phase runs them an iteration: device time by
    ``torch.profiler``, beside the same function as cuDNN's ``conv1d``
    grouped by window (the yardstick, used nowhere in the port), which must
    agree with it."""
    from hm_vae_torch.models.hm_vae import lora_b_init, lora_delta
    from hm_vae_torch.ops import fused_conv_pool as fcp

    rank = latent_config().latent_opt.lora_rank
    fwd, bwd, deltas = [], [], []
    for name, conv, T_in in level_cases(model, st):
        if not name.startswith("dec"):
            continue
        base = copy.deepcopy(conv)
        base.negative_slope, base.bias = 1.0, None
        fwd.append(fwd_level_row(f"{name}_lora_base", base, T_in, base.spec.stride, WINDOWS,
                                 torch.float32, gen))
        bwd.append(bwd_level_row(f"{name}_lora_base", base, T_in, WINDOWS, gen,
                                 with_wgrad=False))
        with torch.no_grad():
            packed = base.packed_operands()
            x = torch.randn((WINDOWS, packed.in_channels, T_in), generator=gen).to(DEV)
            if not torch.equal(fcp.fused_conv_pool_packed(x, packed),
                               fcp.fused_conv_pool_packed(x, packed)):
                fail(f"{name}: the slope-1.0 forward differs between two runs")
        out_f, in_f = conv.folded_shape()
        s = conv.spec
        a = (0.1 * torch.randn((WINDOWS, out_f, rank), generator=gen)).to(DEV)
        b = torch.stack([lora_b_init(rank, in_f, s.kernel_size, gen)
                         for _ in range(WINDOWS)]).to(DEV)
        deltas.append((x.requires_grad_(), a.requires_grad_(), b.requires_grad_(), s))

    def port(x, a, b, s):
        return lora_delta(x, a, b, s.stride, s.padding, s.padding_mode)

    def grouped(x, a, b, s):
        G, r, K = b.shape[0], b.shape[1], b.shape[-1]
        xp = F.pad(x.reshape(1, -1, x.shape[-1]), (s.padding, s.padding),
                   mode="reflect" if s.padding_mode == "reflect" else "constant")
        lo = F.conv1d(xp, b.reshape(G * r, -1, K), stride=s.stride, groups=G)
        return torch.einsum("gor,grt->got", a, lo.reshape(G, r, -1))

    def iteration(delta):
        def run():
            outs = [delta(*d) for d in deltas]
            leaves = [t for x, a, b, _ in deltas for t in (x, a, b)]
            torch.autograd.grad(sum(o.sum() for o in outs), leaves)
        return run

    with torch.no_grad():
        err = max(float((port(*d) - grouped(*d)).abs().max()) for d in deltas)
        scale = max(float(grouped(*d).abs().max()) for d in deltas)
    if not err <= 1e-4 * max(1.0, scale):
        fail(f"lora_delta against the grouped conv1d: max |diff| {err:.3e}")
    row = {"phase": "lora_rank_conv", "windows": WINDOWS, "rank": rank,
           "note": "the adapters' rank-r convs and A products, forward and backward at the 4 "
                   "decoder levels: one decoder-phase iteration's; grouped_conv1d: the same "
                   "function by cuDNN's conv1d grouped by window, TF32 off",
           "max_abs_err": err, "profile": profile_calls(iteration(port), calls=10),
           "grouped_conv1d_profile": profile_calls(iteration(grouped), calls=10)}
    print(json.dumps(row), flush=True)
    return fwd, bwd, row


def clone_bytes(model, dtype):
    """Bytes of the full-scope per-window clones of `model`'s decoder (the
    decoder phase's stacked parameters, WINDOWS of each) stored in `dtype`."""
    n = sum(p.numel() for p in model.decoder.parameters())
    return WINDOWS * n * torch.empty((), dtype=dtype).element_size()


def eval_cli(data_root, ck, phase, config, extra, check):
    """``eval_recovery --final_try_long_seq_interpolation`` (in this
    process) on two sequences of the synthetic test split with the training
    CLI's checkpoint `ck`, under `config` and the flags `extra`; the files
    and the summary (two outputs of whole windows, finite), and
    `check(launches)` on the kernel launches of the run; returns its row."""
    from hm_vae_torch.cli import eval_recovery

    out = os.path.join(OUT_DIR, phase)
    shutil.rmtree(out, ignore_errors=True)
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    eval_recovery.main(["--config", config, "--output_path", out, "--data_root", data_root,
                        "--test_model", ck, "--final_try_long_seq_interpolation",
                        "--max_seqs", "2", "--device", DEV, "--seed", str(SEED)] + extra)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    d = os.path.join(out, "eval_long_seq_interpolation",
                     os.path.splitext(os.path.basename(config))[0])
    files = sorted(os.listdir(d)) if os.path.isdir(d) else []
    res = [f for f in files if f.endswith("_rot_opt_res.npy")]
    if len(res) != 2 or "summary.json" not in files:
        fail(f"{phase} wrote {files}, expected two *_rot_opt_res.npy and summary.json")
    for f in res:
        a = np.load(os.path.join(d, f))
        if a.ndim != 4 or a.shape[1:] != (24, 3, 3) or a.shape[0] % 64 or not np.isfinite(a).all():
            fail(f"{phase} {f}: shape {a.shape} or non-finite")
    with open(os.path.join(d, "summary.json")) as f:
        summary = json.load(f)
    if not check(launches):
        fail(f"{phase}: kernel launches {launches}")
    return {"phase": phase, "task": "final_try_long_seq_interpolation",
            "config": os.path.relpath(config, ROOT), "flags": extra, "files": files,
            "summary": summary, "seconds": seconds, "launches": launches}



# ---------------------------------------------------------------------------
# the production training path (configs/len64_production.yaml)

PROD_BATCH = 64  # the production config's batch
AUG_CONFIG = os.path.join(ROOT, "configs", "len8_data_aug_hm_vae.yaml")


def b64_kernel_phase(model, st, gen):
    """The three kernels at the 8 len-64 levels, f32, at the production
    batch of 64 (the bf16 parameters are cast to the f32 compute dtype before
    the fold, so production runs the f32 kernels): the forward as phase 2
    holds it, two runs bit-equal; dgrad and wgrad as phase 5 holds them
    (plain versions, autograd, two runs bit-equal)."""
    fwd = [fwd_level_row(f"{n}@b{PROD_BATCH}", c, T, c.spec.stride, PROD_BATCH,
                         torch.float32, gen, bits=True)
           for n, c, T in level_cases(model, st)]
    bwd = [bwd_level_row(f"{n}@b{PROD_BATCH}", c, T, PROD_BATCH, gen)
           for n, c, T in level_cases(model, st)]
    return fwd, bwd


def production_config(data_root, path=PRODUCTION_CONFIG, **sections):
    """`path` (the production config unless another is named) on synthetic
    data made from the seed, no validation, snapshot or image inside the
    run, with `sections` ({section: {key: value}}) replaced."""
    cfg = train_config(data_root, path)
    return dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), **v)
                                       for k, v in sections.items()})


def state_diff(a, b):
    """Largest |a - b| over two train states' parameters, moments and
    counts, by kind (0 everywhere: the same bits)."""
    out = {"params": 0.0, "moments": 0.0, "counts": 0}
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        out["params"] = max(out["params"], float((p.detach().float() - q.detach().float())
                                                  .abs().max()))
        sa, sb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        if sa.keys() != sb.keys():
            fail(f"optimizer state of {n}: {sorted(sa)} against {sorted(sb)}")
        for k in sa:
            d = float((sa[k].double() - sb[k].double()).abs().max())
            kind = "counts" if k == "step" else "moments"
            out[kind] = max(out[kind], d)
    ga, gb = a.optimizer.param_groups[0]["step"], b.optimizer.param_groups[0]["step"]
    out["counts"] = max(out["counts"], abs(int(ga) - int(gb)), abs(a.step - b.step))
    return out


def graph_agreement_phase(data_root):
    """(a) 32 steps of the production config at batch 64 from one init and
    one superbatch (the native sampler's f16 aa wire, upcast on the card),
    the curriculum boundary set at step 16 inside the call: MultiStep's CUDA
    graph (one step captured, replayed 32 times) against the same 32 steps
    run eagerly.  Parameters, moments and per-leaf counts are compared; the
    largest difference is printed (0: the same bits).  The entries' launch
    counts (set to 0 before each run) are a step's launches 3 times on the
    graph (two warm-up steps and the capture; a replay calls no entry) and
    32 times eagerly."""
    from hm_vae_torch.data.dataset import make_loaders
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.losses import draw_noise, eps_shapes
    from hm_vae_torch.train.train_step import MultiStep, create_state
    from hm_vae_torch.train.trainer import step_generator

    cfg = production_config(data_root, loss={"iteration_interval": 16})
    K, B = cfg.run.steps_per_call, cfg.optim.batch_size
    train_ds = make_loaders(cfg)[0]
    stream = train_ds.iter_compact_superbatches(K, B, False, cfg.data.native_threads, "aa",
                                                dtype=np.float16)
    host = next(stream)
    batches = {"aa": torch.from_numpy(host["aa"]).to(DEV).float()}
    stream.close()
    shapes = eps_shapes(cfg, B)
    draws = [draw_noise(shapes, step_generator(cfg.run.seed, k)) for k in range(K)]
    eps = [torch.stack([d[lv] for d in draws]).to(DEV) for lv in range(len(shapes))]
    states, metrics, launches = {}, {}, {}
    for mode in ("graph", "eager"):
        states[mode] = create_state(cfg, DEV)
        multi = MultiStep(states[mode], cfg, graph=mode == "graph")
        for c in fcp.launch_entries():
            c.launches = 0
        metrics[mode] = {k: float(v) for k, v in multi(batches, eps).items()}
        torch.cuda.synchronize()
        launches[mode] = {k: v for k, v in fcp.launch_counts().items() if v}
    diff = state_diff(states["graph"], states["eager"])
    same = all(v == 0 for v in diff.values()) and metrics["graph"] == metrics["eager"]
    head = states["graph"].model.encoder.latent_head_0.weight
    head_count = int(states["graph"].optimizer.state[head]["step"])
    if head_count != K - 16:
        fail(f"production graph: the shallow head stepped {head_count} times, expected "
             f"{K - 16} (from the boundary at 16)")
    want = {m: {k: n * v for k, v in TRAIN_LAUNCHES.items()} for m, n in (("graph", 3),
                                                                         ("eager", K))}
    if launches != want:
        fail(f"production graph: entry launch counts {launches}, expected {want} (graph: "
             "two warm-up steps and the capture)")
    if not all(np.isfinite(v) for m in metrics.values() for v in m.values()):
        fail(f"production graph: metrics {metrics}")
    row = {"phase": "production_graph_vs_eager", "config": os.path.relpath(PRODUCTION_CONFIG, ROOT),
           "batch": B, "steps": K, "iteration_interval": 16, "bit_equal": same,
           "max_abs_diff": diff, "metrics": metrics, "launches": launches}
    print(json.dumps(row), flush=True)
    return row


def perturb_inputs(trainer, scale):
    """Scale by `scale` the batches `trainer` steps on, after their upcast
    on the device (the one f32 operand of a step under bf16 parameters)."""
    consume = type(trainer)._consume
    trainer._consume = lambda staged: {k: v * scale for k, v in consume(trainer, staged).items()}


def production_agreement_phase(data_root, steps=20):
    """(b) The production config's dtypes (bf16 parameters and moments, the
    f16 aa wire) at batch 8, 4 steps a call (a CUDA graph on the card), the
    curriculum boundary at step 10 inside the third call: Trainer.fit on the
    GPU against the CPU from the same init and windows, the loss after every
    call within 10x the larger spread of runs whose batches are scaled by
    1 + 1e-7 after the upcast on each side, + 1e-4 (the bf16 gradients and
    stochastic write-back amplify last places, as the CPU test of the
    production path calibrates its band), and within 1e-4 after the first
    call."""
    from hm_vae_torch.train.trainer import build_trainer

    cfg = production_config(data_root, optim={"batch_size": BATCH},
                            run={"steps_per_call": 4, "log_iter": 1},
                            loss={"iteration_interval": 10})
    losses, wall = {}, {}
    for run, dev, scale in (("gpu", DEV, 1.0), ("cpu", "cpu", 1.0),
                            ("gpu_perturbed", DEV, 1.0 + 1e-7),
                            ("cpu_perturbed", "cpu", 1.0 + 1e-7)):
        trainer, train_ds, _, _ = build_trainer(
            cfg, os.path.join(OUT_DIR, f"production_agreement_{run}"), device=dev)
        if scale != 1.0:
            perturb_inputs(trainer, scale)
        out = []
        t0 = time.perf_counter()
        trainer.fit(train_ds, None, max_iter=steps, log_cb=lambda s, m: out.append(m["loss_total"]))
        wall[run] = time.perf_counter() - t0
        losses[run] = np.array(out)
    if any(len(v) != steps // 4 or not np.isfinite(v).all() for v in losses.values()):
        fail(f"production agreement: losses {losses}")
    rel = np.abs(losses["gpu"] / losses["cpu"] - 1)
    spread = {d: np.maximum.accumulate(np.abs(losses[f"{d}_perturbed"] / losses[d] - 1))
              for d in ("gpu", "cpu")}
    band = 10 * np.maximum(spread["gpu"], spread["cpu"]) + 1e-4
    if not (rel[0] <= 1e-4 and (rel <= band).all()):
        fail(f"production agreement: GPU vs CPU loss relative difference {rel.tolist()} "
             f"outside {band.tolist()} (first call: 1e-4)")
    row = {"phase": "production_agreement", "config": os.path.relpath(PRODUCTION_CONFIG, ROOT),
           "batch": BATCH, "steps": steps, "steps_per_call": 4, "iteration_interval": 10,
           "loss_gpu": losses["gpu"].tolist(), "loss_cpu": losses["cpu"].tolist(),
           "rel_diff": rel.tolist(), "band": band.tolist(),
           "spread": {k: v.tolist() for k, v in spread.items()}, "fit_seconds": wall}
    print(json.dumps(row), flush=True)
    return row


def production_cli_phase(data_root):
    """``python -m hm_vae_torch.cli.train --config <production>`` (in this
    process) on synthetic data: 4 calls of 32 steps with an asynchronous
    snapshot after every call and keep_checkpoints 2, then ``--resume`` for
    one more call.  The train split must be the native sampler on the aa
    wire, the steps a CUDA graph; returns the checkpoint names."""
    from hm_vae_torch.cli import train as train_cli
    from hm_vae_torch.data.native_loader import NativeMotionLoader
    from hm_vae_torch.train import trainer as trainer_mod

    with open(PRODUCTION_CONFIG) as f:
        text = f.read()
    for key, value in (("log_iter", 32), ("snapshot_save_iter", 32), ("keep_checkpoints", 2)):
        text, n = re.subn(rf"(?m)^{key}: .*$", f"{key}: {value}", text)
        if n != 1:
            fail(f"production CLI: no single {key} line in {PRODUCTION_CONFIG}")
    path = os.path.join(OUT_DIR, "len64_production_smoke.yaml")
    with open(path, "w") as f:
        f.write(text)
    out = os.path.join(OUT_DIR, "production_cli")
    shutil.rmtree(out, ignore_errors=True)
    seen = []
    fit = trainer_mod.Trainer.fit

    def recorded_fit(self, train_ds, *a, **kw):
        r = fit(self, train_ds, *a, **kw)
        seen.append({"train_split": type(train_ds).__name__, "wire": self.cfg.data.wire_format,
                     "transfer_dtype": self.cfg.data.transfer_dtype,
                     "graph": bool(self._multi and self._multi.graph),
                     "async_checkpoint": self.cfg.run.async_checkpoint,
                     "native": isinstance(train_ds, NativeMotionLoader)})
        return r

    args = ["--config", path, "--output_path", out, "--data_root", data_root, "--device", DEV]
    buf = io.StringIO()
    t0 = time.perf_counter()
    trainer_mod.Trainer.fit = recorded_fit
    try:
        with contextlib.redirect_stdout(buf):
            train_cli.main(args + ["--max_iter", "128"])
            first = sorted(os.listdir(os.path.join(out, "outputs", "len64_production_smoke",
                                                   "checkpoints")))
            train_cli.main(args + ["--max_iter", "160", "--resume"])
    finally:
        trainer_mod.Trainer.fit = fit
    text = buf.getvalue()
    ck = os.path.join(out, "outputs", "len64_production_smoke", "checkpoints")
    names = sorted(os.listdir(ck))
    resumed = [line for line in text.splitlines() if line.startswith("Resume from")]
    if (resumed != ["Resume from iteration 128"] or first != ["gen_00000096.pt", "gen_00000128.pt"]
            or names != ["gen_00000128.pt", "gen_00000160.pt"]):
        fail(f"production CLI: resume lines {resumed}, checkpoints {first} then {names}:\n{text}")
    if not all(s["native"] and s["wire"] == "aa" and s["graph"] and s["async_checkpoint"]
               for s in seen) or len(seen) != 2:
        fail(f"production CLI: the runs were {seen}")
    blob = torch.load(os.path.join(ck, names[-1]), map_location="cpu", weights_only=True)
    if blob["step"] != 160 or not all(torch.isfinite(v).all() for v in blob["state_dict"].values()):
        fail(f"production CLI: checkpoint step {blob['step']} or non-finite weights")
    logged = [line for line in text.splitlines() if line.startswith("[")]
    row = {"phase": "production_train_cli", "config": os.path.relpath(PRODUCTION_CONFIG, ROOT),
           "overrides": {"log_iter": 32, "snapshot_save_iter": 32, "keep_checkpoints": 2},
           "runs": seen, "resumed": resumed[0], "checkpoints_after_128": first,
           "checkpoints_after_resume": names, "logged_steps": [line[1:9] for line in logged],
           "seconds": time.perf_counter() - t0,
           "finish": [line for line in text.splitlines() if line.startswith("Finish")][-1][:200]}
    print(json.dumps(row), flush=True)
    return row


def production_step_phase(data_root, calls=4):
    """The production step's cost through Trainer.fit at batch 64 (32 steps
    a call, a CUDA graph; the native sampler's f16 aa wire, double-buffered
    ingest): ms a step by CUDA events over `calls` calls after a first call
    (the capture), peak memory, and the device time, idle share and the
    port's kernels' launches a call in the device trace (torch.profiler,
    device only) over two calls; then the same config at steps_per_call 1
    (eager steps), measured the same way in the same run over half as many
    steps (32 steps profiled).  The entries' own launch counts, set to 0
    before the run and read after it, are the warm-up's and the capture's
    on the graph (a replay calls no entry) and every step's eagerly; the
    kernels' runs counted on the device (``device_runs``, set to 0 after the
    first call and read at the end) must be 8 / 7 / 8 a step over every
    later step either way, graph replays included.  The device trace's
    launches per 32 steps are reported beside them and not held to them:
    the profiler has dropped one step's records from a trace of 32 eager
    steps and from one of two 32-step graph calls (the 32 eager steps are
    traced as four consecutive units of 8, their counts summed)."""
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.trainer import build_trainer

    per_32 = {k: 32 * v for k, v in TRAIN_LAUNCHES.items()}
    trace_want = {TRACE_NAME[k]: v for k, v in per_32.items()}
    out = {}
    for K, units, profiled in ((32, calls, 2), (1, calls // 2, 1)):
        cfg = production_config(data_root, run={"steps_per_call": K, "log_iter": 10 ** 9})
        trainer, train_ds, _, _ = build_trainer(cfg, os.path.join(OUT_DIR, f"production_K{K}"),
                                                device=DEV)
        for c in fcp.launch_entries():
            c.launches = 0
        n = 32  # steps a measured unit: one call, or 32 eager steps
        trainer.fit(train_ds, None, max_iter=n)  # the first call captures the graph
        torch.cuda.synchronize()
        first = {k: v for k, v in fcp.launch_counts().items() if v}
        fcp.device_runs(torch.cuda.current_device(), reset=True)
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.fit(train_ds, None, max_iter=n * (1 + units))
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / (n * units)
        peak = torch.cuda.max_memory_allocated()
        state = {"i": n * (1 + units)}
        n_prof = n if K > 1 else 8  # steps a profiled unit

        def unit():
            state["i"] += n_prof
            trainer.fit(train_ds, None, max_iter=state["i"])

        prof = profile_calls(unit, calls=profiled)
        per_32 = dict(prof["trace_launches_per_call"])
        for _ in range(n // n_prof - 1):  # the eager steps' next units of 8
            more = profile_calls(unit, calls=1, warm=False)["trace_launches_per_call"]
            per_32 = {k: per_32.get(k, 0) + more.get(k, 0) for k in {*per_32, *more}}
        in_run = {k: v for k, v in fcp.launch_counts().items() if v}
        runs = fcp.device_runs(torch.cuda.current_device())
        steps = state["i"]
        runs_want = {TRACE_NAME[k]: (steps - n) * v for k, v in TRAIN_LAUNCHES.items()}
        want_first = {k: (3 if K > 1 else n) * v for k, v in TRAIN_LAUNCHES.items()}
        want_run = {k: (3 if K > 1 else steps) * v for k, v in TRAIN_LAUNCHES.items()}
        if first != want_first or in_run != want_run:
            fail(f"production step K={K}: entry launch counts {first} after the first call, "
                 f"{in_run} after {steps} steps; expected {want_first}, {want_run}")
        if runs != runs_want:
            fail(f"production step K={K}: {runs} kernel runs on the device over steps "
                 f"{n + 1}-{steps}, expected {runs_want}")
        out[K] = {"ms_per_step": ms, "steps": steps, "entry_launches_in_run": in_run,
                  "device_runs_after_first_call": runs,
                  "device_runs_per_32_steps": {k: 32 * v / (steps - n) for k, v in runs.items()},
                  "trace_launches_per_32_steps": per_32,
                  "trace_complete": per_32 == trace_want, "profiled_steps": n_prof,
                  "peak_memory_bytes": peak, "profile_per_unit": prof,
                  "device_ms_per_step": prof["device_us_per_call"] / n_prof / 1e3,
                  "idle_share": prof["idle_share"]}
    row = {"phase": "production_step", "config": os.path.relpath(PRODUCTION_CONFIG, ROOT),
           "batch": PROD_BATCH, "graph_steps_per_call_32": out[32],
           "eager_steps_per_call_1": out[1]}
    print(json.dumps(row), flush=True)
    return row


def device_aug_phase(data_root, steps=12):
    """Random root rotation on the card: ``configs/len8_data_aug_hm_vae.yaml``
    (fps and root-rotation augmentation, device_augment) trains `steps`
    steps through the native sampler, the rotation applied on the card; and
    ``apply_root_rot`` on the GPU against the CPU on the same rotations, for
    every wire field of a (K, B) superbatch."""
    from hm_vae_torch.data import device_aug
    from hm_vae_torch.data.native_loader import NativeMotionLoader
    from hm_vae_torch.ops import rotations
    from hm_vae_torch.train.trainer import build_trainer

    cfg = production_config(data_root, AUG_CONFIG)
    if not (cfg.data.random_root_rot_flag and cfg.data.device_augment):
        fail(f"{AUG_CONFIG} does not rotate the root on the device")
    trainer, train_ds, _, _ = build_trainer(cfg, os.path.join(OUT_DIR, "device_aug"), device=DEV)
    if not isinstance(train_ds, NativeMotionLoader) or trainer._augment is None:
        fail(f"device aug: train split {type(train_ds).__name__}, augment {trainer._augment}")
    losses = []
    t0 = time.perf_counter()
    trainer.fit(train_ds, None, max_iter=steps, log_cb=lambda s, m: losses.append(m["loss_total"]))
    seconds = time.perf_counter() - t0
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"device aug: losses {losses}")
    # apply_root_rot: the GPU against the CPU on the same rotations
    gen = torch.Generator().manual_seed(SEED)
    prefix, T = (4, 8), 16
    R = device_aug.random_rotation_matrices(device_aug.aug_generator(SEED, 0), prefix)
    aa = torch.randn(prefix + (T, 24, 3), generator=gen) * 0.7
    batch = {"aa": aa, "rot_mat": rotations.aa_to_rotmat(aa),
             "rot_6d": torch.randn(prefix + (T, 24, 6), generator=gen),
             "root_v": torch.randn(prefix + (T, 3), generator=gen)}
    mean, std = torch.randn(3, generator=gen), torch.rand(3, generator=gen) + 0.5
    cpu = device_aug.apply_root_rot(batch, R, mean, std)
    gpu = device_aug.apply_root_rot({k: v.to(DEV) for k, v in batch.items()}, R.to(DEV),
                                    mean.to(DEV), std.to(DEV))
    errs = {}
    for k in batch:
        errs[k] = float((gpu[k].cpu() - cpu[k]).abs().max())
        scale = max(1.0, float(cpu[k].abs().max()))
        if not errs[k] <= 1e-5 * scale:
            fail(f"device aug: apply_root_rot {k} GPU vs CPU {errs[k]:.3e} > {1e-5 * scale:.3e}")
    Rg = device_aug.random_rotation_matrices(device_aug.aug_generator(SEED, 0), prefix, DEV)
    orth = float((Rg @ Rg.transpose(-1, -2) - torch.eye(3, device=DEV)).abs().max())
    if orth > 1e-5 or float((torch.linalg.det(Rg) - 1).abs().max()) > 1e-5:
        fail(f"device aug: the card's draws are not rotations ({orth:.3e})")
    row = {"phase": "device_aug", "config": os.path.relpath(AUG_CONFIG, ROOT), "steps": steps,
           "train_split": type(train_ds).__name__, "wire": cfg.data.wire_format,
           "losses": losses, "seconds": seconds, "apply_root_rot_gpu_vs_cpu": errs,
           "draw_orthogonality_err": orth}
    print(json.dumps(row), flush=True)
    return row


EXPORT_DIR = os.path.join(OUT_DIR, "export")
# kernel launches a call of each exported function (one a skeleton conv)
EXPORT_LAUNCHES = {"reconstruct": 8, "encode_mean": 4, "decode": 4, "trajectory": 4}
EXPORT_BATCHES = (1, BATCH, VIBE_BATCH)  # batch 1, the reconstruct's 8, refine_vibe's 237
TRAJ_EXPORT_CASES = ((1, 16), (BATCH, 128), (1, TRAJ_SERVE_T))  # (batch, T)
EXPORT_TIMED = {"reconstruct": (BATCH, VIBE_BATCH), "encode_mean": (BATCH, VIBE_BATCH),
                "decode": (BATCH, VIBE_BATCH), "trajectory": ((BATCH, 128), (1, TRAJ_SERVE_T))}
# the modules a serving process may hold: the operator's registration and
# load_exported, no model code
SERVE_MODULES = {"hm_vae_torch", "hm_vae_torch.ops", "hm_vae_torch.ops.fused_conv_pool",
                 "hm_vae_torch.ops._build", "hm_vae_torch.ops.skeleton_nn", "hm_vae_torch.apps",
                 "hm_vae_torch.apps.export"}


def export_cases(cfg, st):
    """{function: {case: input}} on the card, made from the seed: random
    rotations (6D) at EXPORT_BATCHES, z lists at the same batches, FK
    positions of random rotations at TRAJ_EXPORT_CASES."""
    from hm_vae_torch.ops import fk as fk_mod
    from hm_vae_torch.ops import rotations as rot

    rng = np.random.default_rng(SEED + 3)

    def rotations(b, T):
        aa = torch.from_numpy((rng.normal(size=(b, T, 24, 3)) * 0.3).astype(np.float32))
        return rot.aa_to_rotmat(aa)

    x = {b: rot.rotmat_to_rot6d(rotations(b, cfg.model.train_seq_len)).to(DEV)
         for b in EXPORT_BATCHES}
    z = {b: tuple(torch.from_numpy(rng.normal(size=(b, st.z_edges[i], st.z_dims[i]))
                                   .astype(np.float32)).to(DEV)
                  for i in range(cfg.model.num_layers)) for b in EXPORT_BATCHES}
    pose = {c: fk_mod.fk_from_rotmat(rotations(*c), fk_mod.default_offsets()).to(DEV)
            for c in TRAJ_EXPORT_CASES}
    return {"reconstruct": x, "encode_mean": x, "decode": z, "trajectory": pose}


def timing(fn):
    """ms a call by CUDA events (eager calls) and device time a call (the
    calls captured in a CUDA graph and replayed), on the card."""
    return {"ms": time_ms(fn, reps=10, samples=5), "device_ms": device_ms(fn, reps=10, samples=5)}


def export_phase(model, tmodel, data_root, vae_ck):
    """25. The serving export (``hm_vae_torch/apps/export.py``): the len-64
    model (full width, seeded random weights) with the trajectory model,
    exported on the card in f32 (by ``cli/export_model.py``) and bf16, and
    the f32 len-64 functions exported on the CPU; the bundles loaded in a
    process that imports torch and the operator's module only
    (:func:`serve_exported`), where every function runs on its inputs
    (counting 8 / 4 / 4 / 4 kernel launches a call) and is timed; its
    outputs against the in-process serving path on the card
    (``VAEInference``, ``TrajectoryRunner``), the CPU export moved to the
    card against the card's own; the operator's dispatch beside the direct
    launch; then ``cli/explore_latent.py`` with the training CLI's
    checkpoint on the synthetic data root."""
    from hm_vae_torch.apps import export as texport
    from hm_vae_torch.apps.inference import VAEInference
    from hm_vae_torch.cli import explore_latent, export_model
    from hm_vae_torch.data import layout
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.models.trajectory import TrajectoryRunner
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.utils.config import load_config

    t_phase = time.perf_counter()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    cfg = load_config(CONFIG)
    st = get_structure(cfg.model)
    ms = layout.load_mean_std()
    bundles = {}
    # f32: the export CLI, with no checkpoint: the configs' seeded init (run.seed
    # 0), the weights of `model` and `tmodel`, the vendored stats
    counters = launch_counters()
    for cnt in counters:
        cnt.launches = 0
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        export_model.main(["--config", CONFIG, "--trajectory_config", TRAJ_CONFIG, "--out",
                           os.path.join(EXPORT_DIR, "float32"), "--device", DEV])
    bundles["float32"] = {"seconds": time.perf_counter() - t0}
    summary = json.loads(printed.getvalue().strip().splitlines()[-1])
    with open(os.path.join(EXPORT_DIR, "float32", texport.MANIFEST_NAME)) as f:
        bundles["float32"]["manifest"] = json.load(f)
    export_cli_launches = {c.__name__: c.launches for c in counters}
    if summary != {"out": os.path.join(EXPORT_DIR, "float32"),
                   "device": str(next(model.parameters()).device),
                   "serve_dtype": "float32", "functions": {
                       k: v["bytes"] for k, v in bundles["float32"]["manifest"]["functions"]
                       .items()}} or sorted(summary["functions"]) != sorted(EXPORT_LAUNCHES):
        fail(f"export_model printed {summary}")
    # bf16, and the len-64 functions exported on the CPU, through the API
    t0 = time.perf_counter()
    man = texport.export_bundle(os.path.join(EXPORT_DIR, "bfloat16"), model, cfg,
                                trajectory=(tmodel, ms), serve_dtype="bfloat16")
    bundles["bfloat16"] = {"seconds": time.perf_counter() - t0, "manifest": man}
    t0 = time.perf_counter()
    man = texport.export_bundle(os.path.join(EXPORT_DIR, "cpu"), copy.deepcopy(model).cpu(), cfg)
    bundles["cpu"] = {"seconds": time.perf_counter() - t0, "manifest": man}
    for dt, b in bundles.items():
        print(json.dumps({"phase": "export_bundle", "bundle": dt, "seconds": b["seconds"],
                          "device": b["manifest"]["device"],
                          "functions": {k: {"bytes": v["bytes"], "seconds": v["seconds"]}
                                        for k, v in b["manifest"]["functions"].items()}}),
              flush=True)

    # the in-process serving path on the same inputs: references and times
    cases = export_cases(cfg, st)
    torch.save({"inputs": cases}, os.path.join(EXPORT_DIR, "inputs.pt"))
    refs, inproc_times = {}, {}
    for dt in ("float32", "bfloat16"):
        m = model if dt == "float32" else texport._bf16_copy(model)
        t = tmodel if dt == "float32" else texport._bf16_copy(tmodel)
        infer, runner = VAEInference(m, cfg, device=DEV), TrajectoryRunner(t, ms)

        @torch.inference_mode()
        def predict(pose):
            return runner._predict(pose)

        fns = {"reconstruct": infer.mean_reconstruction, "encode_mean": infer.mean_z,
               "decode": infer.decode_full, "trajectory": predict}
        for name, fn in fns.items():
            for c, x in cases[name].items():
                refs[(dt, name, c)] = [o.float().cpu() for o in
                                       torch.utils._pytree.tree_leaves(fn(x))]
            for c in EXPORT_TIMED[name]:
                inproc_times[(dt, name, c)] = timing(lambda fn=fn, x=cases[name][c]: fn(x))

    # the bundles served in a process without the model code
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-exported",
                           EXPORT_DIR], cwd=ROOT, capture_output=True, text=True, timeout=900)
    serve_seconds = time.perf_counter() - t0
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        fail(f"serving the exported bundles failed:\n{proc.stderr[-6000:]}")
    served = torch.load(os.path.join(EXPORT_DIR, "served.pt"))
    rows = []
    for (bundle, name, c), r in sorted(served["runs"].items(), key=str):
        dt = "float32" if bundle == "cpu" else bundle
        dtype = getattr(torch, dt)
        ref = refs[(dt, name, c)]
        if bundle == "cpu":  # against the card's own export, not the in-process path
            ref = served["runs"][("float32", name, c)]["outputs"]
        what = f"export {bundle} {name} {c}"
        if name in ("reconstruct", "decode"):
            errs = reconstruct_agreement(what, r["outputs"], ref, dtype)
        else:
            errs = {}
            for i, (o, w) in enumerate(zip(r["outputs"], ref)):
                errs[f"out{i}"] = check(f"{what} out{i}", o, w, dtype)[0]
        row = {"bundle": bundle, "function": name, "case": list(c) if isinstance(c, tuple)
               else c, "launches": r["launches"], "max_abs_err": errs}
        if bundle != "cpu" and c in EXPORT_TIMED[name]:
            row.update(loaded=r["timing"], in_process=inproc_times[(dt, name, c)])
        rows.append(row)
        print(json.dumps({"phase": "export_serve", **row}), flush=True)

    # the operator's cost: the same launch through the dispatcher and direct
    f32 = {}
    for name, conv, T_in in level_cases(model, st):
        p = conv.packed_operands()
        x = torch.randn((BATCH, p.in_channels, T_in), generator=torch.Generator()
                        .manual_seed(SEED)).to(DEV)
        f32[name] = {"op_ms": time_ms(lambda: fcp.fused_conv_pool_packed(x, p)),
                     "direct_ms": time_ms(lambda: fcp._launch_packed(x, p))}
    dispatch = {"op_ms": sum(v["op_ms"] for v in f32.values()),
                "direct_ms": sum(v["direct_ms"] for v in f32.values()), "levels": f32}

    # the latent-space CLI on the training CLI's checkpoint and the synthetic
    # data root
    z_path = os.path.join(EXPORT_DIR, "z.npz")
    np.savez(z_path, **{f"z{i}": z.cpu().numpy()
                        for i, z in enumerate(cases["decode"][1])})
    for cnt in counters:
        cnt.launches = 0
    explore_latent.main(["--config", CONFIG, "--test_model", vae_ck, "--data_root", data_root,
                         "--output_path", EXPORT_DIR, "--check_hier_latent_space",
                         "--vis_given_z_vec", z_path, "--num_samples", "2", "--num_lerp", "3",
                         "--device", DEV])
    explore_launches = {c.__name__: c.launches for c in counters}
    d = os.path.join(EXPORT_DIR, "latent_space", os.path.splitext(os.path.basename(CONFIG))[0])
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    want = {"given_z", "sweep_baseline", "swap_shallow_from_b", "swap_deep_from_b"} | {
        f"sweep_level_{i}" for i in range(cfg.model.num_layers)} | {f"lerp_{i}" for i in range(3)}
    if set(index) != want:
        fail(f"explore_latent wrote {sorted(index)}, expected {sorted(want)}")
    for probe in index:
        for suffix in ("_pose.npy", "_rot.npy"):
            a = np.load(os.path.join(d, probe + suffix))
            if not np.isfinite(a).all() or a.shape[:2] != (index[probe][0], cfg.model.train_seq_len):
                fail(f"explore_latent {probe}{suffix}: shape {a.shape} or non-finite")
    if not explore_launches["fused_conv_pool"] or sum(explore_launches.values()) != \
            explore_launches["fused_conv_pool"]:
        fail(f"explore_latent: kernel launches {explore_launches}")
    row = {"phase": "export", "seconds": time.perf_counter() - t_phase,
           "serve_process_seconds": serve_seconds, "serve_modules": served["modules"],
           "load_seconds": served["load_seconds"], "bytes": {
               dt: {k: v["bytes"] for k, v in b["manifest"]["functions"].items()}
               for dt, b in bundles.items()},
           "operator_dispatch_b8_f32": dispatch, "export_cli": summary,
           "export_cli_launches": export_cli_launches, "explore_latent_probes": len(index),
           "explore_latent_launches": explore_launches}
    print(json.dumps(row), flush=True)
    return rows, row


def serve_exported(export_dir):
    """``--serve-exported``: load the bundles of :func:`export_phase` with
    ``load_exported`` in a process where the port's model code cannot be
    imported (the CPU bundle moved to the card), run every function on its
    inputs (the launches of each call counted) and time the cases of
    EXPORT_TIMED; write the outputs, counts and times to ``served.pt``."""
    import importlib.abc

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "hm_vae_tpu") or (
                    name.startswith("hm_vae_torch.") and name not in SERVE_MODULES):
                raise ImportError(f"a serving process does not import {name}")

    sys.meta_path.insert(0, Block())
    from hm_vae_torch.apps.export import load_exported
    from hm_vae_torch.ops import fused_conv_pool as fcp

    inputs = torch.load(os.path.join(export_dir, "inputs.pt"))["inputs"]
    fns, load_seconds = {}, {}
    for bundle, device in (("float32", None), ("bfloat16", None), ("cpu", DEV)):
        t0 = time.perf_counter()
        fns[bundle] = load_exported(os.path.join(export_dir, bundle), device=device)
        load_seconds[bundle] = time.perf_counter() - t0
    runs = {}
    with torch.inference_mode():
        for bundle, table in fns.items():
            for name, fn in table.items():
                for c, x in inputs[name].items():
                    fcp.fused_conv_pool.launches = 0
                    out = fn(x)
                    torch.cuda.synchronize()
                    launches = fcp.fused_conv_pool.launches
                    if launches != EXPORT_LAUNCHES[name]:
                        fail(f"{bundle} {name} {c}: {launches} kernel launches, expected "
                             f"{EXPORT_LAUNCHES[name]}")
                    runs[(bundle, name, c)] = {
                        "launches": launches,
                        "outputs": [o.float().cpu() for o in torch.utils._pytree.tree_leaves(out)]}
                    if bundle != "cpu" and c in EXPORT_TIMED[name]:
                        runs[(bundle, name, c)]["timing"] = timing(lambda fn=fn, x=x: fn(x))
    modules = sorted(n for n in sys.modules if n.startswith("hm_vae_torch"))
    if not set(modules) <= SERVE_MODULES:
        fail(f"the serving process imported {modules}")
    torch.save({"runs": runs, "modules": modules, "load_seconds": load_seconds},
               os.path.join(export_dir, "served.pt"))
    print(json.dumps({"phase": "serve_exported", "modules": modules,
                      "load_seconds": load_seconds, "runs": len(runs)}), flush=True)


# ---------------------------------------------------------------------------
# trajectories of any length, data preparation, the SMPL body model

# (case, batch, T): a 4-minute take at 30 fps, four 2,048-frame sequences,
# and the exported bundle's two 4,096-frame sequences; every one past the
# rows the forward kernel staged whole before it staged windows
LONG_CASES = (("b1_t7200", 1, 7200), ("b4_t2048", 4, 2048), ("b2_t4096", 2, 4096))
# the exported bundles' calls of the long phase: f32 at (2, 4096), bf16 at all
LONG_BUNDLE_CASES = {"float32": ("b2_t4096",), "bfloat16": ("b1_t7200", "b4_t2048", "b2_t4096")}


def long_trajectory_phase(tmodel, gen):
    """26. Trajectories longer than the forward kernel's whole-row staging
    held: (a) the kernel at the trajectory model's four K-31 levels at each
    of LONG_CASES, f32 and bf16, against its plain version on the card and
    timed beside it and cuDNN (:func:`fwd_level_row`, which records the
    launch's staging plan); (b) ``TrajectoryRunner`` on the card at (1,
    7200) and (4, 2048) in f32 against the same runner on the CPU (root_v
    and world poses, 1e-4 * max(1, max|ref|)), 4 forward launches a call;
    (c) phase 25's exported ``trajectory`` functions, loaded here, at the
    cases of LONG_BUNDLE_CASES against the in-process path on the card
    (f32 1e-4 * max(1, max|ref|), bf16 0.02 * max|ref|), 4 launches a call,
    timed; (d) :func:`index_checks`, the window staging at other strides,
    paddings and windowed.  Returns ({(case, dtype): [rows over the
    levels]}, the phase's row)."""
    from hm_vae_torch.apps import export as texport
    from hm_vae_torch.data import layout, synthetic
    from hm_vae_torch.models.trajectory import TrajectoryRunner
    from hm_vae_torch.ops import fk as fk_mod
    from hm_vae_torch.ops import rotations as rot

    t_phase = time.perf_counter()
    rows = {}
    for i in range(len(tmodel.encoder.structure.levels)):
        conv = getattr(tmodel.encoder, f"conv_{i}")
        for case, batch, T in LONG_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                dt = str(dtype).replace("torch.", "")
                rows.setdefault((case, dt), []).append(
                    fwd_level_row(f"traj{i}_long_{case}", conv, T, 1, batch, dtype, gen))
                if rows[(case, dt)][-1]["plan"]["rows"] != "window":
                    fail(f"traj{i} {case} {dt}: the launch stages whole rows of {T} steps")
    index = index_checks(tmodel.encoder.conv_0, gen)

    # one long smooth motion (a 4-minute take); the shorter sequences are
    # windows of it
    ms = layout.load_mean_std()
    frames = synthetic.synth_sequence(np.random.default_rng(SEED + 7), 7200)
    six = torch.from_numpy(frames[:, layout.ROT6D].reshape(7200, 24, 6))

    def sequences(case):
        _, b, T = next(c for c in LONG_CASES if c[0] == case)
        starts = np.linspace(0, 7200 - T, b).astype(int)
        return torch.stack([six[s:s + T] for s in starts])

    counters = launch_counters()

    def counted(fn, x):
        for c in counters:
            c.launches = 0
        with torch.inference_mode():
            out = fn(x)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        if launches["fused_conv_pool"] != 4 or sum(launches.values()) != 4:
            fail(f"long trajectory: kernel launches {launches}, expected 4 forward a call")
        return out, launches

    gpu, cpu = TrajectoryRunner(tmodel, ms), TrajectoryRunner(copy.deepcopy(tmodel).cpu(), ms)
    runner = {}
    for case in ("b1_t7200", "b4_t2048"):
        x = sequences(case)
        (world, root_v), launches = counted(gpu, x.to(DEV))
        world_c, root_v_c = cpu(x)
        errs = {k: check(f"TrajectoryRunner {case} {k} GPU vs CPU", a.cpu(), b,
                         torch.float32)[0]
                for k, a, b in (("root_v", root_v, root_v_c), ("world", world, world_c))}
        runner[case] = {"shape": list(world.shape), "launches": launches, "max_abs_err": errs,
                        "ms": time_ms(lambda x=x.to(DEV): gpu(x), reps=5, samples=5)}

    bundles = {}
    offsets = fk_mod.default_offsets()
    for dt, cases in LONG_BUNDLE_CASES.items():
        fn = texport.load_exported(os.path.join(EXPORT_DIR, dt))["trajectory"]
        t = tmodel if dt == "float32" else texport._bf16_copy(tmodel)
        ref_runner = TrajectoryRunner(t, ms)
        for case in cases:
            pose = fk_mod.fk_from_rotmat(rot.rot6d_to_rotmat(sequences(case)), offsets).to(DEV)
            out, launches = counted(fn, pose)
            with torch.inference_mode():
                ref = ref_runner._predict(pose)
            err = check(f"exported {dt} trajectory {case}", out.float(), ref.float(),
                        getattr(torch, dt))[0]
            bundles[f"{dt}_{case}"] = {"shape": list(out.shape), "launches": launches,
                                       "max_abs_err": err,
                                       **timing(lambda fn=fn, pose=pose: fn(pose))}
    row = {"phase": "long_trajectory", "config": os.path.relpath(TRAJ_CONFIG, ROOT),
           "plans": {f"{case}_{dt}": r[0]["plan"] for (case, dt), r in rows.items()},
           "index_checks": index, "runner": runner, "bundles": bundles, "seconds": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return rows, row


def index_checks(conv, gen):
    """The window staging's index arithmetic past the trajectory model's
    stride 1 and reflect padding, each launch against its plain version on
    the card and required to stage windows: a long row (batch 2, T 4,096)
    at stride 2 with reflect and at stride 3 with zeros, f32 and bf16
    (:func:`fwd_level_row`); and the windowed launch, WINDOWS windows of one
    2,048-step row each, f32, at stride 1 reflect and stride 2 zeros."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    def variant(stride, mode):
        c = copy.deepcopy(conv)
        c.spec = dataclasses.replace(c.spec, stride=stride, padding_mode=mode)
        return c

    out = {}
    for stride, mode in ((2, "reflect"), (3, "constant")):
        for dtype in (torch.float32, torch.bfloat16):
            name = f"traj0_long_s{stride}_{mode}_{str(dtype).replace('torch.', '')}"
            r = fwd_level_row(name, variant(stride, mode), 4096, stride, 2, dtype, gen)
            out[name] = {k: r[k] for k in ("max_abs_err", "tol", "plan")}
    with torch.inference_mode():
        for stride, mode in ((1, "reflect"), (2, "constant")):
            name = f"traj0_windowed_s{stride}_{mode}"
            s, w, b, _, x, y, _ = windowed_inputs(variant(stride, mode), 2048, gen)
            plan = fcp.last_forward_plan()
            ref = fcp.fused_conv_pool_windowed_reference(x, w, b, stride, s.padding, mode,
                                                         s.negative_slope)
            err, tol = check(name, y, ref, torch.float32)
            out[name] = {"max_abs_err": err, "tol": tol, "plan": plan}
    for name, r in out.items():
        if r["plan"]["rows"] != "window":
            fail(f"{name}: the launch stages whole rows ({r['plan']})")
    return out


# raw AMASS-layout takes of the prep phase: (subset, frames at 120 fps);
# CMU trains, HumanEva validates, Transitions_mocap tests; the last CMU take
# is 4 minutes long (7,200 frames at 30 fps)
PREP_RAW = (("CMU", 1200), ("CMU", 2400), ("CMU", 3600), ("CMU", 4800), ("CMU", 6000),
            ("CMU", 9600), ("CMU", 12000), ("CMU", 28800), ("HumanEva", 1200),
            ("HumanEva", 7200), ("Transitions_mocap", 2400), ("Transitions_mocap", 4800))
PREP_STEPS = 4  # Trainer steps on the prepared data


def prep_phase():
    """27. Data preparation end to end: raw AMASS-layout takes made from the
    seed (PREP_RAW: SMPL-H ``poses`` (N, 156) as smooth random joint
    motions, ``trans``, ``mocap_framerate`` 120, ``betas``) converted by
    ``python -m hm_vae_torch.cli.prep_data`` (a subprocess, as a user runs
    it) at 30 fps, then ``--gen_masks 0.1 0.5``; every split filled, every
    file of its shape and finite.  Then PREP_STEPS steps of ``Trainer.fit``
    of the len-64 VAE on the prepared data (8 / 7 / 8 launches a step), and
    ``eval_trajectory --seq_generation_npy_path`` on the 4-minute take's
    rotation matrices: one 7,200-frame run of the trajectory model through
    the forward kernel (4 launches)."""
    from hm_vae_torch.cli import eval_trajectory
    from hm_vae_torch.data import layout
    from hm_vae_torch.train.trainer import build_trainer

    t_phase = time.perf_counter()
    root = os.path.join(OUT_DIR, "prep")
    shutil.rmtree(root, ignore_errors=True)
    raw, dest = os.path.join(root, "amass"), os.path.join(root, "prepared")
    rng = np.random.default_rng(SEED + 11)
    names = []
    for k, (subset, n) in enumerate(PREP_RAW):
        d = os.path.join(raw, subset, f"subject{k % 3}")
        os.makedirs(d, exist_ok=True)
        t = np.arange(n)[:, None] / 120.0
        freq, phase, amp = (rng.uniform(0.1, 1.0, 156), rng.uniform(0, 2 * np.pi, 156),
                            rng.uniform(0.05, 0.6, 156))
        np.savez(os.path.join(d, f"take{k}_poses.npz"),
                 poses=amp * np.sin(2 * np.pi * freq * t + phase),
                 trans=np.cumsum(rng.normal(scale=0.005, size=(n, 3)), axis=0),
                 mocap_framerate=np.float64(120.0), betas=rng.normal(size=16))
        names.append(f"{subset}_subject{k % 3}_take{k}_poses.npy")
    t0 = time.perf_counter()
    for extra in (["--amass_dir", raw], ["--gen_masks", "0.1", "0.5"]):
        proc = subprocess.run([sys.executable, "-m", "hm_vae_torch.cli.prep_data", "--dest", dest,
                               *extra], cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"prep_data {extra[0]} failed:\n{proc.stderr[-4000:]}")
    prep_seconds = time.perf_counter() - t0
    splits = {}
    for split in ("train", "val", "test"):
        with open(os.path.join(dest, f"{split}.json")) as f:
            splits[split] = list(json.load(f).values())
    want = {"train": 8, "val": 2, "test": 2}
    if {k: len(v) for k, v in splits.items()} != want or sorted(sum(splits.values(), [])) != \
            sorted(names):
        fail(f"prep_data wrote the splits {splits}, expected {want} of {names}")
    frames = {}
    for name, (_, n) in zip(names, PREP_RAW):
        a = np.load(os.path.join(dest, "seqs", name), mmap_mode="r")
        frames[name] = a.shape[0]
        if a.shape != (n // 4, layout.FRAME_DIM) or not np.isfinite(a).all():
            fail(f"prep_data {name}: {a.shape}, expected ({n // 4}, {layout.FRAME_DIM}), finite")
        for prob in (0.1, 0.5):
            if name in splits["test"]:
                m = np.load(os.path.join(dest, "eval_masks", f"missing_prob_{prob}", name))
                if m.shape != (n // 4, 24) or not set(np.unique(m)) <= {0.0, 1.0}:
                    fail(f"mask {prob} {name}: {m.shape}")
    ms = np.load(os.path.join(dest, "mean_std.npy"))
    if ms.shape != (2, layout.FRAME_DIM) or not np.isfinite(ms).all():
        fail(f"prep_data mean_std: {ms.shape} or non-finite")

    # the Trainer on the prepared data
    cfg = train_config(dest)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, synthetic=False))
    trainer, train_ds, _, test_ds = build_trainer(cfg, os.path.join(root, "train"), device=DEV)
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    losses = []
    t0 = time.perf_counter()
    trainer.fit(train_ds, None, max_iter=PREP_STEPS, test_ds=test_ds,
                log_cb=lambda step, m: losses.append(m["loss_total"]))
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - t0
    train_launches = {c.__name__: c.launches for c in counters}
    if len(losses) != PREP_STEPS or not np.isfinite(losses).all():
        fail(f"training on the prepared data: losses {losses}")
    if train_launches != {c.__name__: TRAIN_LAUNCHES.get(c.__name__, 0) * PREP_STEPS
                          for c in counters}:
        fail(f"training on the prepared data: kernel launches {train_launches}")

    # the 4-minute take through eval_trajectory, in one call
    long_name = names[PREP_RAW.index(("CMU", 28800))]
    seq = os.path.join(root, "take_4min.npy")
    a = np.load(os.path.join(dest, "seqs", long_name))
    np.save(seq, a[:, layout.ROTMAT].reshape(-1, 24, 3, 3))
    out = os.path.join(root, "eval_trajectory")
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    eval_trajectory.main(["--config", CONFIG, "--trajectory_config", TRAJ_CONFIG,
                          "--output_path", out, "--data_root", dest,
                          "--seq_generation_npy_path", seq, "--device", DEV])
    torch.cuda.synchronize()
    eval_seconds = time.perf_counter() - t0
    eval_launches = {c.__name__: c.launches for c in counters}
    if eval_launches["fused_conv_pool"] != 4 or sum(eval_launches.values()) != 4:
        fail(f"eval_trajectory on the 4-minute take: kernel launches {eval_launches}, "
             "expected 4 forward")
    d = os.path.join(out, "eval_trajectory", os.path.splitext(os.path.basename(CONFIG))[0])
    for suffix, shape in (("", (7200, 24, 9)), ("_trans", (7200, 3))):
        f = os.path.join(d, f"take_4min_traj_0{suffix}.npy")
        r = np.load(f) if os.path.exists(f) else None
        if r is None or r.shape != shape or not np.isfinite(r).all():
            fail(f"eval_trajectory {f}: {None if r is None else r.shape}, expected {shape}")
    row = {"phase": "prep", "raw_frames": [n for _, n in PREP_RAW], "frames": frames,
           "splits": {k: len(v) for k, v in splits.items()}, "prep_data_seconds": prep_seconds,
           "train_losses": losses, "train_launches": train_launches,
           "fit_seconds": fit_seconds, "eval_trajectory_launches": eval_launches,
           "eval_trajectory_seconds": eval_seconds, "seconds": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return row


# SMPL's published sizes: vertices, joints, shape coefficients, faces (the
# pose correctives: 9 * (J - 1) = 207)
SMPL_V, SMPL_J, SMPL_BETAS, SMPL_F = 6890, 24, 10, 13776
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)


def smpl_model_file(path):
    """A body model npz in the official layout at SMPL's sizes, made from the
    seed: each vertex skinned to up to 4 joints, each joint regressed from 32
    vertices (rows summing to 1), the root's parent stored as uint32 -1."""
    rng = np.random.default_rng(SEED + 13)
    V, J = SMPL_V, SMPL_J
    weights = np.zeros((V, J))
    for k in range(4):  # a dominant joint, then up to 3 lesser ones
        weights[np.arange(V), rng.integers(0, J, V)] += rng.uniform(0.1, 1.0, V) * (
            1.0 if k == 0 else 0.3)
    weights /= weights.sum(1, keepdims=True)
    jreg = np.zeros((J, V))
    for j in range(J):
        jreg[j, rng.choice(V, 32, replace=False)] = rng.uniform(0.1, 1.0, 32)
    jreg /= jreg.sum(1, keepdims=True)
    kintree = np.stack([np.asarray(SMPL_PARENTS), np.arange(J)])
    kintree[0, 0] = 2 ** 32 - 1
    np.savez(path, v_template=rng.normal(scale=0.3, size=(V, 3)),
             shapedirs=rng.normal(scale=0.01, size=(V, 3, SMPL_BETAS)),
             posedirs=rng.normal(scale=0.005, size=(V, 3, 9 * (J - 1))),
             J_regressor=jreg, weights=weights, kintree_table=kintree.astype(np.uint32),
             f=rng.integers(0, V, (SMPL_F, 3)))
    return path


def smpl_phase(model, seq, root_trans):
    """28. The SMPL body model on the card (``utils/smpl.py``), at SMPL's
    published sizes (a model made from the seed): the LBS forward (float64
    on the device, float32 out) for one 64-frame window and for 10 windows
    (640 frames) of a short solve's output, with betas and the root
    translation, against the same module on the CPU (1e-5 * max(1,
    max|ref|)); ``vertex_error_from_rotmats`` of the solve's output against
    its input, on the card and the CPU; ``save_mesh_obj`` of one window
    through ``HM_VAE_SMPL_MODEL`` (64 .obj files of V vertices and F faces);
    each timed by ``utils/profiling.time_fn`` (CUDA events)."""
    from hm_vae_torch.apps.metrics import vertex_error_from_rotmats
    from hm_vae_torch.apps.tasks import LatentOptApps
    from hm_vae_torch.utils import profiling, viz
    from hm_vae_torch.utils.smpl import SMPLBodyModel

    t_phase = time.perf_counter()
    root = os.path.join(OUT_DIR, "smpl")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = smpl_model_file(os.path.join(root, "smpl_seeded.npz"))
    gpu, cpu = SMPLBodyModel(path, device=DEV), SMPLBodyModel(path, device="cpu")
    out = LatentOptApps(model, latent_config(opt_it=3, prev_epochs=0)).interpolate(
        seq, torch.Generator().manual_seed(SEED))
    rot_mat = out["rot_mat"].detach().float()
    trans = torch.from_numpy(root_trans.astype(np.float32))
    betas = np.random.default_rng(SEED + 14).normal(size=SMPL_BETAS)
    lbs = {}
    for name, T in (("window", 64), ("windows_10", WINDOWS * 64)):
        r, tr = rot_mat[:T].to(DEV), trans[:T].to(DEV)
        verts = gpu(r, transl=tr, betas=betas)
        ref = cpu(r.cpu(), transl=tr.cpu(), betas=betas)
        if verts.device.type != torch.device(DEV).type or verts.dtype != torch.float32:
            fail(f"smpl {name}: vertices on {verts.device} in {verts.dtype}")
        err = float((verts.cpu() - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        if tuple(verts.shape) != (T, SMPL_V, 3) or not err <= tol:
            fail(f"smpl {name}: shape {tuple(verts.shape)}, max |gpu - cpu| {err} > {tol}")
        lbs[name] = {"frames": T, "max_abs_err": err, "tol": tol,
                     "ms": 1e3 * profiling.time_fn(lambda r=r, tr=tr: gpu(r, transl=tr,
                                                                          betas=betas), iters=5)}
    seq_t = torch.from_numpy(seq.astype(np.float32))
    v_err = vertex_error_from_rotmats(gpu, rot_mat.to(DEV), seq_t.to(DEV))
    v_err_cpu = vertex_error_from_rotmats(cpu, rot_mat.cpu(), seq_t)
    if not (np.isfinite(v_err) and v_err > 0 and abs(v_err - v_err_cpu) <= 1e-5 * max(1, v_err)):
        fail(f"vertex_error_from_rotmats: {v_err} on the card, {v_err_cpu} on the CPU")
    v_ms = 1e3 * profiling.time_fn(
        lambda: vertex_error_from_rotmats(gpu, rot_mat.to(DEV), seq_t.to(DEV)), iters=3)
    os.environ["HM_VAE_SMPL_MODEL"] = path
    mask = np.zeros(64)
    mask[::8] = 1
    with profiling.Timer(verbose=False) as t_obj:
        obj_dir = viz.save_mesh_obj(os.path.join(root, "mesh"), rot_mat[:64], trans[:64],
                                    temporal_mask=mask, device=DEV)
    objs = sorted(os.listdir(obj_dir))
    with open(os.path.join(obj_dir, objs[0])) as f:
        lines = f.read().splitlines()
    if (len(objs) != 64 or sum(ln.startswith("v ") for ln in lines) != SMPL_V
            or sum(ln.startswith("f ") for ln in lines) != SMPL_F
            or len(os.listdir(os.path.join(root, "mesh", "k_objs"))) != 8):
        fail(f"save_mesh_obj wrote {len(objs)} frames, {len(lines)} lines a frame")
    row = {"phase": "smpl", "sizes": {"V": SMPL_V, "J": SMPL_J, "betas": SMPL_BETAS,
                                      "F": SMPL_F, "posedirs": 9 * (SMPL_J - 1)},
           "lbs": lbs, "vertex_error": v_err, "vertex_error_cpu": v_err_cpu,
           "vertex_error_ms": v_ms, "save_mesh_obj_seconds": t_obj.elapsed,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if sys.argv[1:2] == ["--serve-exported"]:
        serve_exported(sys.argv[2])
        return
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    def elapsed(phases):
        print(json.dumps({"phases_done": phases, "elapsed_s": time.perf_counter() - t_start}),
              flush=True)

    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import _build
    from hm_vae_torch.ops import rotations as rot
    from hm_vae_torch.utils.config import load_config

    # 1. build: the libraries (one nvcc each, all started together), and
    #    beside them cubins whose compiler reports and SASS show registers,
    #    spills and wgmma
    os.makedirs(OUT_DIR, exist_ok=True)
    reports = {}
    for src, kind in (("fused_conv_pool", fwd_kind), ("fused_conv_pool_bwd", bwd_kind)):
        cubin = os.path.join(OUT_DIR, f"{src}.cubin")
        reports[src] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v", "-o", cubin,
             str(_build.CSRC_DIR / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), cubin, kind)
    t0 = time.perf_counter()
    _build.load_all(list(reports))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    report = {src: build_report(*r) for src, r in reports.items()}
    print(json.dumps({"phase": "build_report", **report}), flush=True)
    if not report["fused_conv_pool"].get("bf16", {}).get("hgmma"):
        fail("the bf16 instantiation has no HGMMA (wgmma) instruction")
    for what in ("dgrad", "wgrad", "wgrad_nq4"):
        r = report["fused_conv_pool_bwd"].get(what, {})
        if not (r.get("hgmma") or r.get("hmma")):
            fail(f"the {what} kernel has no HGMMA or HMMA (tensor-core) instruction")

    cfg = load_config(CONFIG)
    st = get_structure(cfg.model)
    gen = torch.Generator().manual_seed(SEED)
    model = HMVAE(cfg.model, cfg.optim.init, generator=gen).to(DEV)

    elapsed("1")
    # 2. kernel against its plain version at the main path's shapes: the
    #    batch-8 reconstruct and refine_vibe's batch of 237 windows
    levels = {(dt, b): kernel_phase(model, st, dt, b, gen)
              for b in (BATCH, VIBE_BATCH) for dt in (torch.float32, torch.bfloat16)}

    elapsed("2")
    # 3. the serving path end to end
    rng = np.random.default_rng(SEED)
    aa = torch.from_numpy((rng.normal(size=(BATCH, 64, 24, 3)) * 0.3).astype(np.float32))
    x6d = rot.rotmat_to_rot6d(rot.aa_to_rotmat(aa)).to(DEV)
    e2e = {dt: e2e_phase(cfg, dt, x6d) for dt in (torch.float32, torch.bfloat16)}

    elapsed("3")
    # 4. the serving entry point
    cli_phase(rng)

    elapsed("4")
    # 5. the backward kernels against their plain versions
    bwd = bwd_phase(model, st, gen)
    # 12 (run here, beside the other kernels). the three kernels at the
    #    trajectory model's level shapes
    from hm_vae_torch.data.dataset import make_loaders
    from hm_vae_torch.models.trajectory import TrajectoryModel

    tcfg = load_config(TRAJ_CONFIG)
    tmodel = TrajectoryModel(tcfg.model, tcfg.optim.init,
                             generator=torch.Generator().manual_seed(SEED)).to(DEV)
    traj_rows = traj_kernel_phase(tmodel, gen)
    # 20 (run here, beside the other kernels). the three kernels at the
    #    production batch of 64
    b64_fwd, b64_bwd = b64_kernel_phase(model, st, gen)

    elapsed("5, 12, 20")
    # 6-7. training end to end, and its entry point
    data_root = os.path.join(OUT_DIR, "train_data")
    shutil.rmtree(data_root, ignore_errors=True)
    train = train_phase(data_root)
    vae_ck = train_cli_phase(data_root)

    elapsed("6-7")
    # 8-11. the test-time solver: its windowed kernels, the GPU against the
    #    CPU, the full solve, the evaluation entry point
    lcfg = latent_config()
    lmodel = HMVAE(lcfg.model, lcfg.optim.init,
                   generator=torch.Generator().manual_seed(SEED)).to(DEV)
    windowed = windowed_phase(lmodel, get_structure(lcfg.model), gen)
    seq, root_trans = solve_sequence(np.random.default_rng(SEED))
    solve_agreement_phase(seq)
    solve, solve_launches = solve_phase(lmodel, seq)
    eval_phase(data_root, lmodel, vae_ck)

    elapsed("8-11")
    # 13-15. the trajectory model: training end to end and its entry point,
    #    eval_trajectory, the solve under the keyframe trajectory loss (GPU
    #    against CPU, the full solve) and eval_recovery's trajectory-guided
    #    interpolation
    traj_train = train_phase(data_root, TRAJ_CONFIG, TRAJ_TRAIN_LAUNCHES, "train_trajectory")
    traj_ck = train_cli_phase(data_root, TRAJ_CONFIG, "train_cli_trajectory")
    traj_eval = eval_trajectory_phase(data_root, vae_ck, traj_ck)
    train_ds = make_loaders(train_config(data_root))[0]
    traj = (tmodel, np.stack([train_ds.mean, train_ds.std]))
    solve_agreement_phase(seq, traj, root_trans, "solve_agreement_trajectory")
    traj_solve = traj_solve_phase(lmodel, traj, seq, root_trans)
    eval_traj_recovery_phase(data_root, vae_ck, traj_ck)

    elapsed("13-15")
    # 16. the lora scope's base convs: forward and dgrad at slope 1.0, no
    #     bias, 10 windows through one weight; the adapters' rank-r convs
    lat0 = lcfg.latent_opt
    n_z = min(lat0.prev_epochs + 1, lat0.opt_it - 1)
    n_d = lat0.opt_it - 1 - n_z
    lora_fwd, lora_bwd, rank_row = lora_base_phase(lmodel, get_structure(lcfg.model), gen)
    # 17. the lora solve: GPU against CPU, then the full solve (the base
    #     convs non-windowed, no wgrad: 4 forward an iteration, 4 dgrad but
    #     the last)
    solve_agreement_phase(seq, phase="solve_agreement_lora", lat=LORA)
    lora_solve = {"phase": "solve_lora", "config": os.path.relpath(LATENT_CONFIG, ROOT),
                  "overrides": LORA, "windows": WINDOWS, "opt_it": lat0.opt_it,
                  **mode_solve(lmodel, seq, "lora solve", LORA,
                               (4 * lat0.opt_it, 4 * (n_z + n_d), 0, 0, 0, 0)),
                  "rank_conv_device_us_per_iteration":
                      rank_row["profile"]["device_us_per_call"]}
    print(json.dumps(lora_solve), flush=True)
    # 18. the bf16 clone: GPU against CPU, then the full solve (the launches
    #     of the f32 solve), its clone bytes and time beside the f32 solve's
    solve_agreement_phase(seq, phase="solve_agreement_bf16_clone", lat=BF16_CLONE)
    bf16_solve = {"phase": "solve_bf16_clone", "config": os.path.relpath(LATENT_CONFIG, ROOT),
                  "overrides": BF16_CLONE, "windows": WINDOWS, "opt_it": lat0.opt_it,
                  **mode_solve(lmodel, seq, "bf16-clone solve", BF16_CLONE,
                               tuple(solve_launches[n] for n in LAUNCH_NAMES)),
                  "clone_bytes": {"bfloat16": clone_bytes(lmodel, torch.bfloat16),
                                  "float32": clone_bytes(lmodel, torch.float32)},
                  "f32_solve": {k: solve["per_window"][k]
                                for k in ("ms_per_solve", "peak_memory_bytes")}}
    print(json.dumps(bf16_solve), flush=True)
    # 19. the entry points: eval_recovery under the lora scope, and under the
    #     production config (its bf16 clone and moments; its training keys
    #     stay out of the evaluation) with phase 7's checkpoint
    for row in (eval_cli(data_root, vae_ck, "eval_recovery_lora", LATENT_CONFIG,
                         ["--finetune_scope", "lora"],
                         lambda n: n["fused_conv_pool_dgrad"] and not n["fused_conv_pool_wgrad"]
                         and not any(n[k] for k in LAUNCH_NAMES[3:])),
                eval_cli(data_root, vae_ck, "eval_recovery_production", PRODUCTION_CONFIG, [],
                         lambda n: n["fused_conv_pool_dgrad"]
                         and n["fused_conv_pool_wgrad_windowed"])):
        print(json.dumps(row), flush=True)

    elapsed("16-19")
    # 21-23. the production training path: the graphed steps against eager
    #    ones and the GPU against the CPU, the training CLI with asynchronous
    #    snapshots and a resume, the step's cost; root rotation on the card
    graph_agreement_phase(data_root)
    production_agreement_phase(data_root)
    prod_cli = production_cli_phase(data_root)
    prod_step = production_step_phase(data_root)
    device_aug_phase(data_root)

    elapsed("21-23")
    # 25. the serving export: bundles exported on the card and the CPU,
    #    served from a process without the model code, against the
    #    in-process path; the export and latent-space CLIs
    export_rows, export_row = export_phase(model, tmodel, data_root, vae_ck)

    elapsed("25")
    # 26. trajectories of any length: the forward kernel at long rows, the
    #    runner on the card against the CPU, phase 25's exported functions
    long_rows, long_row = long_trajectory_phase(tmodel, gen)
    elapsed("26")
    # 27. data preparation: raw takes -> prep_data (+ masks) -> training on
    #    them -> eval_trajectory on the 4-minute take
    prep_phase()
    elapsed("27")
    # 28. the SMPL body model on the card at SMPL's sizes
    smpl_phase(lmodel, seq, root_trans)
    elapsed("28")
    # 24. summary: sums over the 8 levels of one reconstruct (forward) or of
    #    one training step (backward), over the 4 decoder levels of a solve's
    #    iteration (windowed), and over the trajectory model's 4 levels
    def total(rows):
        out = {k: sum(r[k] for r in rows)
               for k in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms")}
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        out["bound_by"] = "bytes" if by_bytes >= out["bound_ms"] / 2 else "operations"
        out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        return out

    def sums(dtype, batch):
        out = total([r for r in levels[(dtype, batch)] if not r["level"].endswith("stride1")])
        out["max_abs_err"] = max(r["max_abs_err"] for r in levels[(dtype, batch)])
        return out

    def bwd_sums(what):
        return total([r[what] for r in bwd])

    f32, bf16 = sums(torch.float32, BATCH), sums(torch.bfloat16, BATCH)
    bwd_note = ("f32; times (device time from CUDA-graph replays; eager_ms: eager calls) and "
                "bounds are sums over the 8 levels at batch 8 (dgrad: enc0 runs it in this "
                "timing but not in training); launches: per training step (launches_in_run: "
                f"the {TRAIN_STEPS} steps of the GPU run); library_ms: "
                "torch.nn.grad.conv1d_%s on the folded weight, TF32 off")
    summary = {"kernels": [{
        "name": "fused_conv_pool", "route": "cuda",
        "source": "hm_vae_torch/csrc/fused_conv_pool.cu",
        "replaces": "hm_vae_tpu/ops/pallas_kernels.py:65",
        "launches": e2e[torch.float32]["launches"],
        **f32,
        "note": "times (device time from CUDA-graph replays; eager_ms: eager calls) and "
                "bounds are sums over the 8 levels of one len-64 reconstruct at batch 8, "
                "in f32 (top level) and in bf16 (\"bf16\"); \"b237\": the same at "
                "refine_vibe's batch of 237 windows; launches_per_train_step: in training",
        "launches_per_train_step": train["launches_per_step"]["fused_conv_pool"],
        "bf16": bf16,
        "b237": {"f32": sums(torch.float32, VIBE_BATCH),
                 "bf16": sums(torch.bfloat16, VIBE_BATCH)},
        "build": report["fused_conv_pool"],
    }] + [{
        "name": f"fused_conv_pool_{what}", "route": "cuda",
        "source": "hm_vae_torch/csrc/fused_conv_pool_bwd.cu",
        "replaces": "hm_vae_tpu/models/hm_vae.py:200 (JAX autodiff of the level; no Pallas "
                    "backward exists)",
        "launches": train["launches_per_step"][f"fused_conv_pool_{what}"],
        "launches_in_run": train["launches_in_run"][f"fused_conv_pool_{what}"],
        **bwd_sums(what),
        "note": bwd_note % ("input" if what == "dgrad" else "weight"),
        "build": report["fused_conv_pool_bwd"][what],
    } for what in ("dgrad", "wgrad")] + [{
        "name": f"fused_conv_pool{suffix}_windowed", "route": "cuda",
        "source": f"hm_vae_torch/csrc/{src}",
        "replaces": f"{replaces} under jax.vmap over windows (per-window decoder clones, "
                    "hm_vae_tpu/apps/latent_opt.py:423)",
        "launches": solve_launches[f"fused_conv_pool{suffix}_windowed"],
        **total([r[what] for r in windowed]),
        "note": f"f32, {WINDOWS} windows of one batch each; times (device time from CUDA-graph "
                "replays; eager_ms: eager calls) and bounds are sums over the 4 decoder levels; "
                "launches: in one 150-iteration solve (4 a decoder-phase iteration); "
                f"library_ms: cuDNN's grouped {lib} (groups = windows) on the stacked folded "
                "weights, TF32 off",
    } for what, suffix, src, replaces, lib in (
        ("fwd", "", "fused_conv_pool.cu", "hm_vae_tpu/ops/pallas_kernels.py:65", "conv1d"),
        ("dgrad", "_dgrad", "fused_conv_pool_bwd.cu", "hm_vae_tpu/models/hm_vae.py:200",
         "torch.nn.grad.conv1d_input"),
        ("wgrad", "_wgrad", "fused_conv_pool_bwd.cu", "hm_vae_tpu/models/hm_vae.py:200",
         "torch.nn.grad.conv1d_weight"))]}
    for row in summary["kernels"][:6]:
        if row["name"] in LAUNCH_NAMES[:3]:
            row["launches_per_solve"] = solve_launches[row["name"]]
        row["launches_per_lora_solve"] = lora_solve["launches"][row["name"]]
        row["launches_per_bf16_clone_solve"] = bf16_solve["launches"][row["name"]]
    for what, rows, lib in (("", lora_fwd, "cuDNN conv1d"),
                            ("_dgrad", [r["dgrad"] for r in lora_bwd],
                             "torch.nn.grad.conv1d_input")):
        summary["kernels"].append({
            "name": f"fused_conv_pool{what}@lora_base", "route": "cuda",
            "source": "hm_vae_torch/csrc/" + ("fused_conv_pool_bwd.cu" if what
                                              else "fused_conv_pool.cu"),
            "replaces": ("hm_vae_tpu/ops/pallas_kernels.py:65" if not what else
                         "hm_vae_tpu/models/hm_vae.py:200 (JAX autodiff of the level)")
                        + " at the lora scope's base conv (hm_vae_tpu/models/hm_vae.py:200-226, "
                          "the weight shared by every window under jax.vmap)",
            "launches": lora_solve["launches"][f"fused_conv_pool{what}"],
            **total(rows),
            "note": f"f32, slope 1.0, no bias, {WINDOWS} windows of one batch through one "
                    "weight; sums over the 4 decoder levels; launches: in one 150-iteration "
                    "lora solve; times: device time from CUDA-graph replays; library_ms: "
                    f"{lib} on the folded weight, TF32 off"})
    served_bf16 = {tuple(r["case"]): r["launches"] for r in export_rows
                   if r["bundle"] == "bfloat16" and r["function"] == "trajectory"}
    traj_launches = {"train": traj_train["launches_per_step"],
                     "solve": traj_solve["launches"], "serve": traj_eval["launches"],
                     "serve_bf16_b8": {"fused_conv_pool": served_bf16[(BATCH, 128)]},
                     "serve_bf16": {"fused_conv_pool": served_bf16[(1, TRAJ_SERVE_T)]}}
    traj_notes = {
        "train": "a training step of configs/trajectory_model.yaml, batch 8, T 128; launches: "
                 "per training step",
        "solve": f"the trajectory loss of a {WINDOWS}-window solve, one batch a window, T 64 "
                 "(non-windowed: the weights are shared); launches: in one 150-iteration "
                 "solve under the loss, with the decoder's z-phase launches",
        "serve": f"eval_trajectory on a whole sequence, batch 1, T {TRAJ_SERVE_T}; launches: "
                 "in the eval_trajectory run (the VAE's decode, then 4 a trajectory run)",
        "serve_bf16_b8": "the bf16 serving bundle's trajectory function (phase 25), batch 8, "
                         "T 128; launches: in one call of the loaded artifact",
        "serve_bf16": f"the bf16 serving bundle's trajectory function (phase 25), batch 1, T "
                      f"{TRAJ_SERVE_T}; launches: in one call of the loaded artifact"}
    for (case, what), rows in traj_rows.items():
        suffix = {"fwd": "", "dgrad": "_dgrad", "wgrad": "_wgrad"}[what]
        name = f"fused_conv_pool{suffix}"
        summary["kernels"].append({
            "name": f"{name}@trajectory_{case}", "route": "cuda",
            "source": "hm_vae_torch/csrc/" + ("fused_conv_pool.cu" if what == "fwd"
                                              else "fused_conv_pool_bwd.cu"),
            "replaces": ("hm_vae_tpu/ops/pallas_kernels.py:65 (at hm_vae_tpu/models/"
                         "trajectory.py:45-50)" if what == "fwd" else
                         "hm_vae_tpu/models/trajectory.py:45-50 (JAX autodiff of the level; "
                         "no Pallas backward exists)"),
            "launches": traj_launches[case][name],
            **total(rows),
            "note": f"{'bf16' if 'bf16' in case else 'f32'}, K 31, sums over the 4 "
                    f"trajectory levels; {traj_notes[case]}; "
                    "times: device time from CUDA-graph replays; library_ms: "
                    + {"fwd": "cuDNN conv1d", "dgrad": "torch.nn.grad.conv1d_input",
                       "wgrad": "torch.nn.grad.conv1d_weight"}[what]
                    + " on the folded weight, TF32 off"})
    prod_run = prod_step["graph_steps_per_call_32"]
    for what, rows, lib in (("", b64_fwd, "cuDNN conv1d"),
                            ("_dgrad", [r["dgrad"] for r in b64_bwd],
                             "torch.nn.grad.conv1d_input"),
                            ("_wgrad", [r["wgrad"] for r in b64_bwd],
                             "torch.nn.grad.conv1d_weight")):
        name = f"fused_conv_pool{what}"
        summary["kernels"].append({
            "name": f"{name}@b{PROD_BATCH}", "route": "cuda",
            "source": "hm_vae_torch/csrc/" + ("fused_conv_pool_bwd.cu" if what
                                              else "fused_conv_pool.cu"),
            "replaces": ("hm_vae_tpu/ops/pallas_kernels.py:65" if not what else
                         "hm_vae_tpu/models/hm_vae.py:200 (JAX autodiff of the level; no "
                         "Pallas backward exists)")
                        + " at configs/len64_production.yaml's batch of 64",
            "launches": prod_run["entry_launches_in_run"].get(name, 0),
            **total(rows),
            "device_launches_per_call": prod_run["device_runs_per_32_steps"][TRACE_NAME[name]],
            "trace_launches_per_call": prod_run["trace_launches_per_32_steps"][TRACE_NAME[name]],
            "note": f"f32 (bf16 parameters are cast to f32 before the fold), batch "
                    f"{PROD_BATCH}; sums over the 8 len-64 levels (dgrad: enc0 runs it in this "
                    "timing but not in training); launches: the entry's count over the graphed "
                    f"production step's {prod_run['steps']} steps (the two warm-up steps and the "
                    "capture: a replay calls no entry); device_launches_per_call: the "
                    "kernel's runs a 32-step call (CUDA-graph replays) counted on the device; "
                    "trace_launches_per_call: its launches in the device trace of one such "
                    "call; "
                    "times: device time from CUDA-graph replays; library_ms: "
                    f"{lib} on the folded weight, TF32 off"})
    long_launches = {**{(case, "bfloat16"): long_row["bundles"][f"bfloat16_{case}"]["launches"]
                        for case in LONG_BUNDLE_CASES["bfloat16"]},
                     ("b2_t4096", "float32"): long_row["bundles"]["float32_b2_t4096"]["launches"],
                     **{(case, "float32"): long_row["runner"][case]["launches"]
                        for case in ("b1_t7200", "b4_t2048")}}
    long_paths = {("b1_t7200", "float32"): "TrajectoryRunner on a 4-minute take (7,200 frames)",
                  ("b4_t2048", "float32"): "TrajectoryRunner on four 2,048-frame sequences",
                  ("b2_t4096", "float32"): "the f32 bundle's trajectory on two 4,096-frame "
                                           "sequences"}
    for (case, dt), rows in long_rows.items():
        summary["kernels"].append({
            "name": f"fused_conv_pool@trajectory_long_{case}" + ("_bf16" if dt == "bfloat16"
                                                                  else ""),
            "route": "cuda", "source": "hm_vae_torch/csrc/fused_conv_pool.cu",
            "replaces": "hm_vae_tpu/ops/pallas_kernels.py:65 (at hm_vae_tpu/models/"
                        "trajectory.py:45-50, any T)",
            "launches": long_launches[(case, dt)]["fused_conv_pool"],
            **total(rows), "plan": rows[0]["plan"],
            "note": f"{dt}, K 31, sums over the 4 trajectory levels at batch and T "
                    f"{case[1:].replace('_t', ', ')}, rows staged as windows; launches: in one "
                    + long_paths.get((case, dt), "call of the bf16 bundle's trajectory")
                    + " (phase 26); times: device time from CUDA-graph replays; library_ms: "
                      "cuDNN conv1d on the folded weight, TF32 off"})
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
