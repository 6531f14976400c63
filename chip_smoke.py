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
   must contain wgmma, and the dgrad and wgrad kernels tensor-core products
   (their whole-row bf16 instantiations HMMA, dgrad's span kernel and every
   form of wgrad's item kernel HGMMA in both element types);
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
6. training end to end: 12 steps of ``Trainer.fit`` on the full-width len-64
   config with synthetic data made from the seed (sampled by the native C++
   sampler on the compact rot6d wire), on the GPU and on the CPU
   from the same init, batches and noise; per-step losses compared, kernel
   launches per step counted by the entries and by the device (as every
   training phase below), step time by CUDA events, device time and idle
   share by ``torch.profiler``;
7. the training entry point: ``hm_vae_torch.cli.train`` for a few steps with
   a checkpoint, then ``--resume``;
8. the windowed kernels of the test-time solver (each window of a batch
   through its own decoder clone): forward, dgrad and wgrad at the four
   decoder levels of ``configs/len_64_test_interpolation.yaml`` with 10
   windows of one batch each, against their plain versions, the backward
   also against autograd of the plain forward, each giving the same bits on
   two runs, and against 10 one-window launches; timed on the device beside
   the plain versions and cuDNN's grouped convolution; where the wrapper
   routes them to the tile kernels (wgrad's and dgrad's: the solve's
   shapes), each launch must run its tile kernel, a launch into a
   NaN-filled gradient must give the same bits, and the whole-row kernel
   is held and timed beside it;
9. a short 10-window solve (9 iterations across the z-to-decoder switch)
   through ``LatentOptApps.interpolate`` on the GPU against the CPU, from
   the same weights and z, losses inside a band calibrated by runs from
   weights scaled by 1 + 1e-7 on both sides; and a 7-iteration solve (the
   z phase, then the last iteration through the per-window clones) whose
   6D outputs agree as the reconstruct's do;
10. the full solve on the card (10 windows, 150 iterations, per-window
   clones): ms per solve, kernel launches per iteration and phase (the
   tile kernels' among the windowed wgrad's and dgrad's, dgrad's also as
   the device counts its dgrad runs), the profile; the shared-clone and
   ``last_conv`` solves' times;
11. the evaluation entry point: ``hm_vae_torch.cli.eval_recovery`` on the
   synthetic test split with the training CLI's checkpoint, and completion
   and generation through ``LatentOptApps``;
12. (run right after phase 5, beside the other kernels) the three kernels at
   the root-trajectory model's four level shapes (``configs/
   trajectory_model.yaml``: K 31, stride 1, C_in 72 / 84 / 108 / 168):
   forward, dgrad and wgrad at batch 8 and T 128 (training), forward and
   dgrad at 10 windows of T 64 (the solver's trajectory loss), the forward
   at batch 1 and T 300 (``eval_trajectory``), each as phases 2 and 5 hold
   and time theirs; dgrad runs spans and wgrad (at T 128) items of one
   batch's row there, as routed, the whole-row kernels held and timed
   beside them;
13. trajectory training: 12 steps of ``Trainer.fit`` on the GPU against the
   CPU as in phase 6 (4 / 3 / 4 launches a step; the step's device ms,
   dgrad's and wgrad's ms and idle share as "cost"), then
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
   each giving the same bits on two runs; dgrad and wgrad as routed there
   (spans and items of several batches' whole rows), the whole-row kernels
   held and timed beside them, unrouted, and the spans' weight layout
   (``dgrad_span_pack``) bit for bit against its plain version;
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
   launches a call in the device trace (256 / 224 / 256), dgrad's and
   wgrad's device ms a step, the weight layout's launches (one a step at each level
   whose dgrad runs spans), peak memory, device time and idle share,
   beside the same config at ``steps_per_call: 1`` (eager);
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
29. (run after 28) the backward over rows of any length: dgrad and wgrad
   at the trajectory model's four K-31 levels at batch 1, T 7,200, batch
   8, T 1,024 and batch 8, T 1,000 (a last item of 104 columns), and at
   the len-64 model's stride-2 K-15 level at batch 8, T 1,024 (all past one
   block's whole-row staging: spans), each against its plain version and
   autograd, bit-equal on two runs, with the plan its launch ran (dgrad:
   span, spans, stages, channels a block, split, bytes; wgrad: item width,
   stages, split, bytes), timed as phase 5's; both span kernels timed,
   beside the whole-row kernels at shapes whose rows fit whole (the len-64
   levels at batch 8 and 64, f32; the trajectory's at batch 8, T 128, and
   dgrad's at 10 windows of T 64, each in f32 and bf16), routed or not;
   dgrad's spans and wgrad's items in bf16 at the K-31 levels at (1,
   7,200) and (8, 1,024) and at the stride-2 level (wgrad's whole rows
   timed beside its items there), held at 0.02 * max|ref|, bit-equal on
   two runs; the clusters of 1-8 span blocks the card runs at once (the
   span plan's waves at the trajectory's short rows); then 5 steps of the
   trajectory model at train_seq_len 1,024 on the card against the CPU,
   under phase 13's gate (4 / 3 / 4 launches a step), and 5 more at bf16
   compute (finite losses, 4 / 3 / 4 device runs a step, the step's cost);
30. data-parallel training over torch.distributed ranks started by
   ``python -m torch.distributed.run`` with ``HMVAE_DIST=1`` (the ranks run
   ``chip_smoke.py --rank-audit <report> <root> <runs.json>``, which runs
   entry points as ``python -m`` does and records the files each rank
   writes under ``root``, its output and its launches): (a) two gloo ranks
   sharing cuda:0 train the len-64 VAE 5 steps on fixed global batches and
   noise, against the one-process run (both ranks the same bits; 8 / 7 / 8
   runs a step on each rank's device counters); (b) in the same launch,
   ``hm_vae_torch.cli.train`` under two ranks, then ``--resume``: only rank
   0 writes, both print the same metrics; (c) one NCCL rank (a group of one
   in this process): the production config's 32-step CUDA graph with the
   gradients' all-reduce captured in it, bit-equal to the graph without a
   group (256 / 224 / 256 runs a call); (d) in (a)'s launch, tensor
   parallelism: the two ranks at ``run.model_parallel`` 2 (the latent heads
   sharded over them) train the same steps, both ranks the same bits, the
   sharded heads after the first step the one-process run's bits, in (a)'s
   gate, 8 / 7 / 8 runs a step on each rank; then ``hm_vae_torch.cli.train``
   at model_parallel 2 resumes (b)'s checkpoint (written at 1), only rank 0
   writing;
31. ``eval_recovery --data_parallel 2`` under two gloo ranks on a 10-window
   take against the one-process run (per-window clones at 30 iterations,
   the shared clone at 12), inside the band of a run from weights
   scaled by 1 + 1e-7; only rank 0 writes;
32. the VALID-packed forward (padding 0) on a rank's halo-extended shard
   (batch 1, 3,600 + 30 frames), then ``eval_trajectory
   --sequence_parallel 2`` under two gloo ranks on takes of 7,200 and
   7,201 frames against the one-process run (7,201: all but the last
   4 x 15 frames), and ``--sequence_parallel_strict`` raising at 7,201.
   Times of two ranks sharing the one card are labelled so: they are not
   scaling numbers;
33. the compact parameter layout (``model.param_layout: compact``): 5 steps
   of the len-64 VAE on the card against the CPU (phase 6's gate); on the
   card against the dense layout from the same weights, batches and noise,
   every loss, live entry and Adam moment the same bits; phase 7's dense
   checkpoint resumed compact, written and resumed dense; the serving
   forward the dense model's bits at batch 8 and 237;
34. training with adapters (``model.lora_rank`` 16): 5 steps of the len-64
   VAE on the card against the CPU (phase 6's gate, 8 / 7 / 8 launches a
   step); the three kernels at its base convs (slope 1.0, no bias, batch 8,
   the weight trained), held and timed as phases 2 and 5 hold and time
   theirs;
35. training with bf16 conv compute (``compute_dtype: bfloat16`` on
   ``configs/len64_production.yaml``: bf16 parameters, moments and
   compute, the JAX package's "MAX-PERF triple"): the bf16 dgrad and wgrad
   at the 8 len-64 levels (batch 8 and 64: dgrad's spans and wgrad's items
   of several batches' rows, routed there, with the whole-row kernels timed
   beside them) and the trajectory model's 4 K-31 levels (batch 8, T 128:
   dgrad's spans and wgrad's items of one batch's row, routed there, the
   whole-row kernels beside them), held
   and timed as phase 5 holds and times its rows, in bf16 (0.02 *
   max|ref|), two runs bit-equal; the triple's 32-step CUDA-graph call at
   batch 64 against the same steps eagerly, bit for bit, and its cost (ms a
   step by events, device ms, dgrad's and wgrad's ms, idle share, peak
   memory, 8 / 7 / 8 device runs a step); GPU against CPU at
   batch 4, two 4-step calls, in a band from batches scaled by 1 + 2^-7
   (a perturbation that survives the cast to bf16) on both sides; JAX's
   convergence criterion (40 steps on a fixed batch: its small config at lr
   1e-3 against f32, and the production config at its lr against f32
   compute); the
   training CLI on the YAML with ``compute_dtype: bfloat16`` added, two
   calls and ``--resume``; the trajectory model at bf16 compute, 4 steps,
   and its step's cost (ms by events, device ms, dgrad's and wgrad's ms,
   idle share), held against the same steps on the CPU in the 1 + 2^-7
   band; its ``elapsed_s``;

36. the test-time solve at bf16 conv compute (``compute_dtype: bfloat16``,
   the triple's model evaluated under its own config): the windowed bf16
   forward, dgrad and wgrad at the four decoder levels with 10 windows of
   one batch, held and timed as phase 8 holds and times f32 (0.02 *
   max|ref|, cuDNN's grouped bf16 convolution, bounds at bf16 rates); the
   windowed span and item kernels in f32 and bf16 at 4 windows of 512
   frames (the top two levels' padded rows past 256 columns), their plans
   reported, the whole-row bf16 wgrad timed beside the items; a short
   10-window solve at bf16 compute and the production solver dtypes on the
   GPU against the CPU as in phase 9 (the band never under 2^-7); the full
   per-window, shared and lora solves at bf16 compute, the launches the f32
   solves' (by the entries and the device), ms, device ms, idle share and
   peak memory beside the f32 per-window solve's; ``eval_recovery`` under
   ``configs/len64_production.yaml`` with ``compute_dtype: bfloat16`` on
   phase 35's checkpoint, its backward launches all bf16;
24. print the kernel summary line and, last, the device line.

From the build on, the full run solves the CPU sides of the solve
agreements (phases 9, 15, 17, 18, 36) in a pool of one worker process (no
card visible to it, half the host's cores, killed with the script) while
the card runs the phases before them.  Each ``phases_done`` line counts the
CPU runs not yet ended: the host-timed numbers (ms by events) of a group
that began or ended with runs pending were taken beside the worker, and
are compared with no number taken without it; phase 36's solves, its f32
per-window solve among them, run after the last.

``python3 chip_smoke.py --long-backward`` runs phase 1 and then phase 29
alone, and ends with the card's line: a short check of the backward
kernels over long rows.  ``python3 chip_smoke.py --bf16-train`` runs phase 1
and then phase 35 alone, the same way; ``--bf16-solve`` phase 1 and then
phase 36 (with its own f32 per-window solve and triple checkpoint).

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
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
TRAIN_STEPS = 12  # phases 6 and 13 (20 until PR 12; cut for the time limit)
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
def fwd_level_row(name, conv, T_in, stride, batch, dtype, gen, bits=False, padding=None):
    """One level at `batch` (and `padding`, default the conv's: 0 for the
    VALID packing of sequence parallelism): the packed entry against unpack
    + plain version, the Pallas-signature entry against the plain version
    (and, with `bits`, two runs bit-equal), and the device times of kernel,
    plain version and cuDNN."""
    from hm_vae_torch.ops.fused_conv_pool import (
        CHUNK_CHANNELS, _sm_count, forward_plan, fused_conv_pool, fused_conv_pool_packed,
        fused_conv_pool_reference, last_forward_plan, unpack_level)

    dt = str(dtype).replace("torch.", "")
    conv = copy.deepcopy(conv)
    conv.dtype = dtype
    conv.spec = dataclasses.replace(conv.spec, stride=stride,
                                    padding=conv.spec.padding if padding is None else padding)
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
        if "C7520" in line or "wgmma.mma_async instructions are serialized" in line:
            r = report.setdefault(kind(line), {})
            r["wgmma_serialized"] = r.get("wgmma_serialized", 0) + 1
            r["wgmma_serialized_note"] = line.strip()[-300:]
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
    """dgrad ("dgrad_spans" for ``dgrad_span_kernel``, "dgrad_span_pack"
    for its weight's layout), or wgrad by its tap tiles a warp: two (K <=
    15, "wgrad"), three (K <= 23, "wgrad_nq3") or four (K <= 31,
    "wgrad_nq4", the trajectory model's K 31); ``wgrad_span_kernel``, the
    item kernel: over items of one batch's columns by its m64 tiles a
    warpgroup, "wgrad_spans_nt1" (K <= 15) or "wgrad_spans_nt2" (K <= 31),
    over items of several batches' whole rows "wgrad_spans_rows";
    ``wgrad_tiles_kernel``, the tile kernel over many windows' short rows,
    "wgrad_tiles"; ``dgrad_tiles_kernel``, dgrad's, by its N tile,
    "dgrad_tiles_n8" to "dgrad_tiles_n64"; "_bf16" after the name of a bf16
    instantiation."""
    bf16 = "_bf16" if "nv_bfloat16" in name else ""
    if "wgrad_tiles" in name:
        return "wgrad_tiles" + bf16
    if "dgrad_tiles" in name:
        return "dgrad_tiles_n" + re.search(r"Li(\d+)E", name).group(1) + bf16
    if "dgrad_span_pack" in name:
        return "dgrad_span_pack" + bf16
    if "dgrad" in name:
        return ("dgrad_spans" if "dgrad_span" in name else "dgrad") + bf16
    if "wgrad_span" in name:
        if "Lb1E" in name:
            return "wgrad_spans_rows" + bf16
        return ("wgrad_spans_nt2" if "ILi2E" in name else "wgrad_spans_nt1") + bf16
    for nq in (3, 4):
        if f"ILi{nq}E" in name:
            return f"wgrad_nq{nq}{bf16}"
    return "wgrad" + bf16


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
TRACE_KERNELS = re.compile(
    r"::(conv_gemm_kernel|dgrad_kernel|dgrad_span_kernel|dgrad_span_pack_kernel|wgrad_kernel"
    r"|wgrad_span_kernel|wgrad_tiles_kernel|dgrad_tiles_kernel)[<(]")
# the dgrad kernels of a training step in a device trace: whole rows, spans,
# the spans' weight layout and tiles; the wgrad kernels: whole rows, items
# and tiles
DGRAD_TRACE = ("dgrad_kernel", "dgrad_span_kernel", "dgrad_span_pack_kernel",
               "dgrad_tiles_kernel")
WGRAD_TRACE = ("wgrad_kernel", "wgrad_span_kernel", "wgrad_tiles_kernel")
TRACE_NAME = {"fused_conv_pool": "conv_gemm_kernel", "fused_conv_pool_dgrad": "dgrad_kernel",
              "fused_conv_pool_wgrad": "wgrad_kernel"}


def profile_calls(fn, calls: int = 10, warm: bool = True):
    """Device time by kernel over `calls` calls of `fn` (torch.profiler), after
    one call unprofiled unless `warm` is false, the
    wall time they took, the device's idle share of that wall time, the
    device operations (kernels, copies, sets) per call, and the port's
    kernels' launches per call in the trace (TRACE_KERNELS).  It records the
    device's activity only (the host's operator events are read by nothing
    here) and reads the profiler's raw events: building its event list over
    a solve's ~150k device operations took ~20 s a solve."""
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
    kernels, count, ours, ours_us = {}, 0, {}, {}
    for ev in prof.profiler.kineto_results.events():
        # a user annotation (such as Optimizer.step) is a range on the
        # device's timeline over kernels counted on their own
        if ev.device_type().name == "CUDA" and not ev.is_user_annotation():
            name, us = ev.name(), ev.duration_ns() / 1e3
            kernels[name] = kernels.get(name, 0.0) + us
            count += 1
            m = TRACE_KERNELS.search(name)
            if m:
                ours[m.group(1)] = ours.get(m.group(1), 0) + 1
                ours_us[m.group(1)] = ours_us.get(m.group(1), 0.0) + us
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
            "trace_us_per_call": {k: v / calls for k, v in sorted(ours_us.items())},
            "top_us_per_call": {k: v / calls for k, v in top}}


def step_cost(prof):
    """A profiled step's device ms, idle share and dgrad's and wgrad's
    device ms (every form of each kernel, dgrad's weight layout included),
    from :func:`profile_calls` of one step a call."""
    return {"device_ms_per_step": prof["device_us_per_call"] / 1e3,
            "idle_share": prof["idle_share"],
            **{f"{what}_ms_per_step": sum(prof["trace_us_per_call"].get(k, 0.0)
                                          for k in names) / 1e3
               for what, names in (("dgrad", DGRAD_TRACE), ("wgrad", WGRAD_TRACE))}}


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


def bwd_inputs(conv, T_in, gen, batch=BATCH, dtype=torch.float32):
    """One level's backward operands at `batch` in `dtype` (the conv's
    compute dtype: f32, or bf16 as under ``compute_dtype: bfloat16``), on
    the card: the structure, the folded weight and bias, x, the forward's
    output y and a random output gradient gy."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    if dtype != conv.dtype:
        conv = copy.deepcopy(conv)
        conv.dtype = dtype
    s = conv.structure()
    with torch.no_grad():
        wf, bf = conv.folded_weight()
    wf = wf.detach().contiguous()
    bf = None if bf is None else bf.detach()
    x = torch.randn((batch, wf.shape[1], T_in), generator=gen).to(DEV, dtype)
    with torch.no_grad():
        y = fcp.FusedConvPoolFn.apply(x, wf, bf, s)
    gy = torch.randn(y.shape, generator=gen).to(DEV, dtype)
    return s, wf, bf, x, y, gy


def bwd_phase(model, st, gen):
    """The backward kernels at the eight level shapes, batch 8, f32:
    :func:`bwd_level_row` of each."""
    return [bwd_level_row(name, conv, T_in, BATCH, gen)
            for name, conv, T_in in level_cases(model, st)]


def bwd_level_row(name, conv, T_in, batch, gen, with_wgrad=True, dtype=torch.float32):
    """The backward kernels (dgrad, and wgrad unless `with_wgrad` is false)
    of one level at `batch` in `dtype` (f32, or bf16: the compute dtype's
    kernels, held at TOL[bf16]): each against its plain version on the
    same gy, y and x, and, with y from the plain forward, against autograd
    of the plain forward (cuDNN, TF32 off); two runs bit-equal; device
    times of kernel, plain version and torch.nn.grad's conv1d_input /
    conv1d_weight on the folded weight (with the activation's mask; no
    reflect fold); and bounds at the dtype's peak.  Where dgrad's plan runs
    the span kernel over rows that fit a whole-row block (several batches'
    rows a span), the whole-row kernel is held and timed beside it,
    unrouted ("whole_rows"), and the span kernel's weight layout
    (``dgrad_span_pack``) is held bit for bit against its plain version and
    timed beside it ("pack"); where wgrad's plan runs the item kernel over
    rows that fit a whole-row block (several batches' rows an item, or one
    batch's columns at the trajectory's routed short rows and bf16 rows
    too long for f32's whole-row block), the whole-row wgrad is held and
    timed beside it the same way."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    s, wf, bf, x, y, gy = bwd_inputs(conv, T_in, gen, batch, dtype)
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

    gx, rx = dgrad(), d_plain()
    plan = {"dgrad": fcp.last_backward_plans()["dgrad"]}  # what the launch ran
    extra = {}
    if plan["dgrad"]["span"]:
        extra["pack"] = pack_row(name, s, wf)
    if plan["dgrad"]["span"] and plan["dgrad"]["spans"] == 1:
        wp = whole_row_plan(s, gy, T_in)
        if not wp.span:

            def d_whole():
                return fcp._dgrad(gy, y, wf, s, T_in, None, wp)

            extra["whole_rows"] = {
                "max_abs_err": check(f"{name} dgrad whole rows", d_whole(), rx, dtype)[0],
                "ms": device_ms(d_whole), "plan": wp._asdict()}
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
    err_d = max(check(f"{name} dgrad", gx, rx, dtype)[0],
                check(f"{name} dgrad vs autograd", gx_a, ag[0], dtype)[0])
    if gx.dtype != dtype:
        fail(f"{name}: dgrad returned {gx.dtype}, expected {dtype}")
    if not torch.equal(dgrad(), gx):
        fail(f"{name}: dgrad differs between two runs on the same inputs")
    d_bytes, w_bytes, d_ops, w_ops = bwd_work(gy, y, x, wf)
    cases = [("dgrad", dgrad, d_plain, d_lib, err_d, d_bytes, d_ops)]
    w_extra = {}
    if with_wgrad:
        (gw, gb), (rw, rb) = wgrad(), w_plain()
        plan["wgrad"] = fcp.last_backward_plans()["wgrad"]
        if plan["wgrad"]["span"]:
            plan["wgrad"]["stages"] = fcp.WGRAD_SPAN_STAGES
        wp = whole_row_wgrad_plan(s, gy, T_in) if plan["wgrad"]["span"] else None
        if wp is not None and not wp.span:

            def w_whole():
                return fcp._wgrad(gy, y, x, s, None, wp)

            ww, wb = w_whole()
            w_extra["whole_rows"] = {
                "max_abs_err": max(check(f"{name} wgrad whole rows", ww, rw, dtype)[0],
                                   check(f"{name} bias grad whole rows", wb, rb, dtype)[0]),
                "ms": device_ms(w_whole), "plan": wp._asdict()}
        gw_a, gb_a = wgrad(ya)
        torch.cuda.synchronize()
        err_w = max(check(f"{name} wgrad", gw, rw, dtype)[0],
                    check(f"{name} wgrad vs autograd", gw_a, ag[1] * live[:, :, None],
                          dtype)[0])
        if bf is not None:
            err_w = max(err_w, check(f"{name} bias grad", gb, rb, dtype)[0],
                        check(f"{name} bias grad vs autograd", gb_a, ag[2], dtype)[0])
        if gw.dtype != dtype or gb.dtype != dtype:
            fail(f"{name}: wgrad returned {gw.dtype} and {gb.dtype}, expected {dtype}")
        gw2, gb2 = wgrad()
        if not (torch.equal(gw2, gw) and torch.equal(gb2, gb)):
            fail(f"{name}: wgrad differs between two runs on the same inputs")
        cases.append(("wgrad", wgrad, w_plain, w_lib, err_w, w_bytes, w_ops))
    row = {"level": name, "dtype": str(dtype).replace("torch.", ""), "batch": batch,
           "C_in": wf.shape[1], "T_in": T_in, "P": wf.shape[0], "T_out": y.shape[2],
           "stride": stride,
           "live_tiles": int(s.tile_chunk.numel()), "chunk_pairs": s.dgrad_start.numel() - 1}
    for what, fn, plain, lib, err, nbytes, ops in cases:
        t_bytes, t_ops = nbytes / MEM_BPS * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
        row[what] = {"max_abs_err": err, "ms": device_ms(fn), "plain_ms": device_ms(plain),
                     "library_ms": device_ms(lib), "eager_ms": time_ms(fn),
                     "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "plan": plan[what], **(extra if what == "dgrad" else w_extra)}
    print(json.dumps(row), flush=True)
    return row


def whole_row_plan(s, gy, T_in, windows=1):
    """The whole-row dgrad plan of a call of `windows` windows
    (``dgrad_whole_plan``): the plan that ``dgrad_kernel`` runs at shapes
    routed to spans or to the tile kernel."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    gran = 16 // gy.element_size()
    return fcp.dgrad_whole_plan(gy.shape[0] // windows, T_in, s.kernel_size, s.stride,
                                s.padding, -(-gy.shape[2] // gran) * gran,
                                s.dgrad_start.numel() - 1, s.dgrad_max_live,
                                fcp._sm_count(gy.device.index), windows, esz=gy.element_size())


def dgrad_tiles_plan_of(s, gy, windows):
    """dgrad's tile kernel's plan (``dgrad_tiles_plan``) for a windowed dgrad
    of ``windows`` windows, whether or not the wrapper routes the shape
    there."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    return fcp.dgrad_tiles_plan(s.dgrad_chunk_start.numel() - 1, windows,
                                fcp._sm_count(gy.device.index),
                                fcp.dgrad_tiles_per_sm(gy.element_size()))


def dgrad_tiles_poisoned(gy, y, w, s, T_in, windows, plan):
    """dgrad's tile kernel launched into input gradients filled with NaN
    first (the wrapper's are uncleared memory): where the kernel writes
    every element, the wrapper's bits."""
    from hm_vae_torch.ops import _build
    from hm_vae_torch.ops import fused_conv_pool as fcp

    esz = gy.element_size()
    gy, y = fcp._aligned(gy, 2, 16 // esz), fcp._aligned(y, 2, 16 // esz)
    w = fcp._aligned(w, w.dim() - 2, fcp.BWD_CHUNK_CHANNELS)
    (B, P, T_out), C = gy.shape, w.shape[-2]
    gx = torch.full((B, C, T_in), float("nan"), dtype=gy.dtype, device=gy.device)
    lib, tiles = fcp._bwd_library()[0], fcp._bwd_library()[5]
    rows = s.dgrad_chunk_row
    err = tiles(gy.data_ptr(), y.data_ptr(), w.data_ptr(), s.dgrad_chunk_start.data_ptr(),
                rows.data_ptr() if rows.numel() else None, gx.data_ptr(), rows.numel(), B, C,
                T_in, s.kernel_size, P, T_out, gy.shape[2], s.stride, s.padding, int(s.reflect),
                s.negative_slope, plan.blocks, windows, fcp._DTYPES[gy.dtype], gy.device.index,
                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "dgrad_tiles_poisoned")
    torch.cuda.synchronize()
    return gx[:, :s.in_channels]


def whole_row_wgrad_plan(s, gy, T_in):
    """The whole-row wgrad plan of a call (``wgrad_whole_plan``): the plan
    that ``wgrad_kernel`` runs at shapes routed to items of several
    batches' rows."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    esz = gy.element_size()
    B, _, T_out = gy.shape
    t_ld = -(-T_out // (16 // esz)) * (16 // esz)
    K, stride = s.kernel_size, s.stride
    return fcp.wgrad_whole_plan(
        B, T_out, s.wgrad_row.numel(), fcp._sm_count(gy.device.index), 1,
        lambda sb, split: fcp._wgrad_smem(B, T_in, K, T_out, t_ld, stride, sb, split, esz),
        fcp.wgrad_span_cols(K, stride, esz))


def wgrad_tiles_plan_of(s, gy, T_in, windows):
    """The tile kernel's plan (``wgrad_tiles_plan``) for a windowed wgrad of
    ``windows`` windows, whether or not the wrapper routes the shape there."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    esz, (B, _, T_out) = gy.element_size(), gy.shape
    t_ld = -(-T_out // (16 // esz)) * (16 // esz)
    smem = fcp._wgrad_tiles_layout(s.kernel_size, s.stride, B // windows, T_in, T_out, t_ld,
                                   s.wgrad_row.numel(), esz)["total"]
    return fcp.wgrad_tiles_plan(s.wgrad_row.numel(), windows, fcp._sm_count(gy.device.index),
                                fcp.wgrad_tiles_per_sm(smem))


def wgrad_tiles_poisoned(gy, y, x, s, windows, plan):
    """The tile kernel's gradients launched into tensors filled with NaN
    first (the wrapper's are uncleared memory): where the kernel writes
    every element, the wrapper's bits."""
    from hm_vae_torch.ops import _build
    from hm_vae_torch.ops import fused_conv_pool as fcp

    esz = gy.element_size()
    gy, y = fcp._aligned(gy, 2, 16 // esz), fcp._aligned(y, 2, 16 // esz)
    x = fcp._aligned(x, 1, fcp.BWD_CHUNK_CHANNELS)
    (B, P, T_out), (C, T_in), K = gy.shape, x.shape[1:], s.kernel_size
    gw = torch.full((windows, P, C, K), float("nan"), dtype=gy.dtype, device=gy.device)
    gb = torch.full((windows, P), float("nan"), dtype=gy.dtype, device=gy.device)
    lib, tiles = fcp._bwd_library()[0], fcp._bwd_library()[4]
    err = tiles(gy.data_ptr(), y.data_ptr(), x.data_ptr(), s.wgrad_row.data_ptr(),
                s.wgrad_chunk.data_ptr(), gw.data_ptr(), gb.data_ptr(), s.wgrad_row.numel(), B,
                C, T_in, K, P, T_out, gy.shape[2], s.stride, s.padding, int(s.reflect),
                s.negative_slope, plan.blocks, windows, fcp._DTYPES[gy.dtype],
                gy.device.index, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "wgrad_tiles_poisoned")
    torch.cuda.synchronize()
    return gw[:, :, :s.in_channels], gb


def pack_row(name, s, wf):
    """``dgrad_span_pack``'s kernel on a folded weight: bit for bit its plain
    version, two runs bit-equal; device ms beside the plain version's, and
    its bound: the weight read and the layout written once."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    got, ref = fcp.dgrad_span_pack(s, wf), fcp.dgrad_span_pack_reference(s, wf)
    if not (torch.equal(got, ref) and torch.equal(fcp.dgrad_span_pack(s, wf), got)):
        fail(f"{name}: dgrad_span_pack differs from its plain version or between two runs")
    nbytes = wf.numel() * wf.element_size() + got.numel() * got.element_size()
    return {"max_abs_err": 0.0, "ms": device_ms(lambda: fcp.dgrad_span_pack(s, wf)),
            "plain_ms": device_ms(lambda: fcp.dgrad_span_pack_reference(s, wf)),
            "library_ms": None, "bytes": nbytes, "bound_ms": nbytes / MEM_BPS * 1e3,
            "bound_by": "bytes"}


def train_config(data_root, path=CONFIG, model=None):
    """A full-width config (the len-64 VAE's unless `path` names another) on
    synthetic data made from the seed, logging every step, no validation or
    snapshot inside the run; `model`: its model section's overrides (a
    nested ``model:`` section's keys)."""
    from hm_vae_torch.utils.config import load_config

    cfg = load_config(path)
    big = 10 ** 9
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **(model or {})),
        data=dataclasses.replace(cfg.data, synthetic=True, data_root=data_root),
        run=dataclasses.replace(cfg.run, log_iter=1, validation_iter=big,
                                snapshot_save_iter=big, image_save_iter=big))


# kernel launches a training step: the VAE's 8 convs (enc0's input is data,
# no dgrad); the trajectory model's 4 levels (level 0's input is data)
TRAIN_LAUNCHES = {"fused_conv_pool": 8, "fused_conv_pool_dgrad": 7, "fused_conv_pool_wgrad": 8}
TRAJ_TRAIN_LAUNCHES = {"fused_conv_pool": 4, "fused_conv_pool_dgrad": 3,
                       "fused_conv_pool_wgrad": 4}


def train_phase(data_root, path=CONFIG, want=TRAIN_LAUNCHES, phase="train",
                steps=TRAIN_STEPS, model=None):
    """`steps` (TRAIN_STEPS) steps of Trainer.fit of `path`'s model (the len-64 VAE,
    or the trajectory model) on the GPU and on the CPU from the
    same init, batches and noise, and on each a run from the init scaled by
    1 + 1e-7: Adam amplifies last-place differences (and the random-weight
    model's ill-conditioned 6D -> rotmat amplifies them further), so the
    GPU-vs-CPU losses must agree to 1e-4 relative over the first 5 steps and
    stay within 10x the larger perturbed run's spread (so far) + 1e-4 after.
    The perturbation is run on both sides because its spread differs by 10x
    between them at some steps.  Then kernel launches per step, step time
    (CUDA events) and the profile.  `model`: the model section's overrides
    (:func:`train_config`).  The kernels' runs a step of the GPU run, as
    the device counted them (both dgrad kernels on one count, both wgrad
    kernels on another), are held to `want` too."""
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.train_step import loss_fields, to_device, train_step
    from hm_vae_torch.train.trainer import build_trainer

    cfg = train_config(data_root, path, model)
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
        if run == "gpu":
            fcp.device_runs(torch.cuda.current_device(), reset=True)
        t0 = time.perf_counter()
        trainer.fit(train_ds, None, max_iter=steps,
                    log_cb=lambda step, m: out.append(m["loss_total"]))
        wall[run] = time.perf_counter() - t0
        if run == "gpu":
            in_run = {c.__name__: c.launches for c in counters}
            launches = {k: v // steps if v % steps == 0 else v / steps
                        for k, v in in_run.items()}
            runs = {k: v / steps for k, v in
                    fcp.device_runs(torch.cuda.current_device()).items()}
            gpu, gpu_ds = trainer, train_ds
        losses[run] = np.array(out)
    if any(len(v) != steps or not np.isfinite(v).all() for v in losses.values()):
        fail(f"{phase}: losses {losses}")
    if launches != want:
        fail(f"{phase}: kernel launches per step {launches}, expected {want} (the first "
             "conv's input is data and needs no input gradient)")
    if runs != {TRACE_NAME[k]: v for k, v in want.items()}:
        fail(f"{phase}: the device counted {runs} kernel runs a step, expected {want}")
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

    row = {"phase": phase, "config": os.path.relpath(path, ROOT), "model_overrides": model,
           "batch": cfg.optim.batch_size, "steps": steps, "loss_gpu": losses["gpu"].tolist(),
           "loss_cpu": losses["cpu"].tolist(), "max_rel_diff": float(rel.max()),
           "rel_diff": rel.tolist(), "band": band.tolist(),
           "spread": {k: v.tolist() for k, v in spread.items()},
           "launches_per_step": launches, "launches_in_run": in_run,
           "device_runs_per_step": runs, "fit_seconds": wall,
           "ms_per_step": time_ms(step, reps=10, samples=5),
           "profile": profile_calls(step, calls=5),
           "repack_profile": profile_calls(repack_all, calls=5)}
    row["cost"] = step_cost(row["profile"])
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


def latent_config(model=None, **lat):
    """``configs/len_64_test_interpolation.yaml`` with solver overrides and
    `model` overrides of its model section (phase 36's ``compute_dtype``)."""
    from hm_vae_torch.utils.config import load_config

    cfg = load_config(LATENT_CONFIG)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **(model or {})),
                               latent_opt=dataclasses.replace(cfg.latent_opt, **lat))


def windowed_inputs(conv, T_in, gen, dtype=torch.float32, windows=WINDOWS):
    """One decoder level's operands for `windows` windows of one batch each
    in `dtype` (the conv's compute dtype), on the card: the conv's fold
    scaled per window (the structure's zeros kept) and its bias, x, the
    windowed forward's output y, a random gy."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    if dtype != conv.dtype:
        conv = copy.deepcopy(conv)
        conv.dtype = dtype
    s = conv.structure()
    with torch.no_grad():
        wf, bf = (None if t is None else t.detach().float().cpu()
                  for t in conv.folded_weight())
    scale = 1.0 + 0.3 * torch.randn((windows, 1, 1, 1), generator=gen)
    w = (wf[None] * scale).to(dtype).contiguous().to(DEV)
    b = None if bf is None else (bf[None] * scale[:, :, 0, 0]).to(dtype).contiguous().to(DEV)
    x = torch.randn((windows, wf.shape[1], T_in), generator=gen).to(DEV, dtype)
    packed = fcp.repack(s, w, b)
    y = fcp.fused_conv_pool_windowed(x, packed)
    gy = torch.randn(y.shape, generator=gen).to(DEV, dtype)
    return s, w, b, packed, x, y, gy


def windowed_phase(model, st, gen, dtype=torch.float32, windows=WINDOWS, frames=64,
                   levels=None, tag="", spans=False):
    """The windowed forward, dgrad and wgrad at the decoder levels
    (`levels`: their names, default all four), `windows` windows of one
    batch each, in `dtype`, at a window of `frames` frames (the levels' T
    scaled from the config's 64): against their plain versions, the
    backward also against autograd of the plain forward, each against
    `windows` one-window launches on each window's weight, two runs
    bit-equal, all within TOL[dtype]; device times of kernel, plain version
    and cuDNN's grouped convolution (``groups=windows`` on the stacked
    folded weights, and its conv1d_input / conv1d_weight, in `dtype`),
    beside the bounds (each window's least bytes and operations, times the
    windows, at `dtype`'s rate); the plans the launches ran.  With `spans`
    every level must run dgrad's span kernel and wgrad's item kernel, and
    where the whole-row wgrad would take the rows too (bf16) it is held and
    timed beside the items, unrouted ("whole_rows").  Where the wrapper
    gives the wgrad to the tile kernel (``wgrad_tiles_routed``: the solve's
    shapes) its launch must run it; a launch into gradients filled with NaN
    must give the same bits (it writes every element); the whole-row wgrad
    is held and timed beside it, unrouted ("whole_rows", its wrapper's
    clearing included), with the clearing's own time ("memset_ms").  Where
    it gives the dgrad to its tile kernel (``dgrad_tiles_routed``), the
    same: its launch must run it, a launch into an input gradient filled
    with NaN must give the same bits, and the whole-row dgrad is held and
    timed beside it, unrouted ("whole_rows")."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    G = windows
    rows = []
    for name, conv, T_in in level_cases(model, st):
        if not name.startswith("dec") or (levels and name not in levels):
            continue
        T_in = T_in * frames // 64
        name = f"{name}{tag}"
        s, w, b, packed, x, y, gy = windowed_inputs(conv, T_in, gen, dtype, G)
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

        out, gx = fwd(), dgrad()
        plan = {"dgrad": fcp.last_backward_plans()["dgrad"]}  # what the launches ran
        gw, gb = wgrad()
        plan["wgrad"] = fcp.last_backward_plans()["wgrad"]
        if spans and not (plan["dgrad"]["span"] and plan["wgrad"]["span"]):
            fail(f"{name}: expected dgrad's spans and wgrad's items, the launches ran {plan}")
        esz = gy.element_size()
        tiles = fcp.wgrad_tiles_routed(1, T_in, K, stride, pad, s.wgrad_row.numel(), esz, G)
        if tiles != (plan["wgrad"]["blocks"] > 0):
            fail(f"{name}: the tile kernel routed {tiles}, the wgrad launch ran {plan['wgrad']}")
        dtiles = fcp.dgrad_tiles_routed(1, T_in, K, stride, pad, P, s.dgrad_chunk_start.numel() - 1,
                                        s.dgrad_chunk_row.numel(), esz, G)
        if dtiles != (plan["dgrad"]["blocks"] > 0):
            fail(f"{name}: dgrad's tile kernel routed {dtiles}, the dgrad launch ran "
                 f"{plan['dgrad']}")
        err_f = check(f"{name} windowed", out, f_plain(), dtype)[0]
        err_d = check(f"{name} windowed dgrad", gx, d_plain(), dtype)[0]
        rw, rb = w_plain()
        err_w = check(f"{name} windowed wgrad", gw, rw, dtype)[0]
        if b is not None:
            err_w = max(err_w, check(f"{name} windowed bias grad", gb, rb, dtype)[0])
        if not all(t.dtype == dtype for t in (out, gx, gw, gb)):
            fail(f"{name}: the windowed kernels returned {[t.dtype for t in (out, gx, gw, gb)]}")
        # autograd of the plain forward, the kernels reading its output
        leaves = [t.clone().requires_grad_() for t in (x, w) + (() if b is None else (b,))]
        ya = fcp.fused_conv_pool_windowed_reference(leaves[0], leaves[1],
                                                    leaves[2] if b is not None else None,
                                                    stride, pad, mode, slope)
        ag = torch.autograd.grad(ya, leaves, gy)
        ya = ya.detach()
        gw_a, gb_a = wgrad(ya)
        err_d = max(err_d, check(f"{name} windowed dgrad vs autograd", dgrad(ya), ag[0],
                                 dtype)[0])
        err_w = max(err_w, check(f"{name} windowed wgrad vs autograd", gw_a, ag[1] * live,
                                 dtype)[0])
        if b is not None:
            err_w = max(err_w, check(f"{name} windowed bias grad vs autograd", gb_a, ag[2],
                                     dtype)[0])
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
                    fcp.fused_conv_pool_packed(x[sl], single), dtype)[0])
                one["dgrad"] = max(one["dgrad"], check(
                    f"{name} window {g} dgrad vs one launch", gx[sl],
                    fcp.fused_conv_pool_dgrad(gy[sl], y[sl], w[g], s, T_in), dtype)[0])
                one["wgrad"] = max(one["wgrad"], check(
                    f"{name} window {g} wgrad vs one launch", gw[g],
                    fcp.fused_conv_pool_wgrad(gy[sl], y[sl], x[sl], s)[0], dtype)[0])
        torch.cuda.synchronize()
        d_extra, w_extra = {}, {}
        if dtiles:
            rx = d_plain()
            nx = dgrad_tiles_poisoned(gy, y, w, s, T_in, G, dgrad_tiles_plan_of(s, gy, G))
            if not torch.equal(nx, gx):
                fail(f"{name}: dgrad's tile kernel left elements of a NaN-filled gradient "
                     "unwritten or differs from the wrapper's launch")
            d_extra["every_element_written"] = True
            dp = whole_row_plan(s, gy, T_in, G)
            if not dp.span:

                def d_whole():
                    return fcp._dgrad(gy, y, w, s, T_in, G, dp)

                d_extra["whole_rows"] = {
                    "max_abs_err": check(f"{name} dgrad whole rows", d_whole(), rx, dtype)[0],
                    "ms": device_ms(d_whole), "plan": dp._asdict()}
        if tiles:
            nw, nb_ = wgrad_tiles_poisoned(gy, y, x, s, G, wgrad_tiles_plan_of(s, gy, T_in, G))
            if not (torch.equal(nw, gw) and torch.equal(nb_, gb)):
                fail(f"{name}: the tile kernel left elements of NaN-filled gradients unwritten "
                     "or differs from the wrapper's launch")
            w_extra["every_element_written"] = True
            C8 = fcp._aligned(x, 1, fcp.BWD_CHUNK_CHANNELS).shape[1]
            w_extra["memset_ms"] = device_ms(
                lambda: torch.zeros((G, P, C8, K), dtype=dtype, device=DEV))
        if spans or tiles:
            t_ld = -(-T_out // (16 // esz)) * (16 // esz)
            wp = fcp.wgrad_whole_plan(
                1, T_out, s.wgrad_row.numel(), fcp._sm_count(gy.device.index), G,
                lambda sb, split: fcp._wgrad_smem(1, T_in, K, T_out, t_ld, stride, sb, split,
                                                  esz), fcp.wgrad_span_cols(K, stride, esz))
            if not wp.span:

                def w_whole():
                    return fcp._wgrad(gy, y, x, s, G, wp)

                ww, wb = w_whole()
                w_extra["whole_rows"] = {
                    "max_abs_err": max(check(f"{name} wgrad whole rows", ww, rw, dtype)[0],
                                       check(f"{name} bias grad whole rows", wb, rb,
                                             dtype)[0]),
                    "ms": device_ms(w_whole), "plan": wp._asdict()}
        nbytes, ops = level_work(x[:1], raw_operands(conv, dtype),
                                 (w[0], None if b is None else b[0]), out[:1])
        d_bytes, w_bytes, d_ops, w_ops = bwd_work(gy[:1], y[:1], x[:1], w[0])
        row = {"level": name, "dtype": str(dtype).replace("torch.", ""), "windows": G,
               "batch_per_window": 1, "C_in": C, "T_in": T_in, "P": P, "T_out": T_out,
               "stride": stride, "live_tiles": int(s.tile_chunk.numel())}
        for what, fn, plain, lib, err, nb, no in (
                ("fwd", fwd, f_plain, f_lib, err_f, nbytes, ops),
                ("dgrad", dgrad, d_plain, d_lib, err_d, d_bytes, d_ops),
                ("wgrad", wgrad, w_plain, w_lib, err_w, w_bytes, w_ops)):
            t_bytes, t_ops = G * nb / MEM_BPS * 1e3, G * no / PEAK_FLOPS[dtype] * 1e3
            row[what] = {"max_abs_err": err, "vs_one_window_err": one[what],
                         "ms": device_ms(fn), "plain_ms": device_ms(plain),
                         "library_ms": device_ms(lib), "eager_ms": time_ms(fn),
                         "bytes": G * nb, "ops": G * no, "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                         **({"plan": plan[what]} if what in plan else {}),
                         **{"dgrad": d_extra, "wgrad": w_extra}.get(what, {})}
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


# the agreement solves' depth: 9 iterations (z 5, clone 3, the last a clone
# step); 12 (z 6, clone 5) until PR 12, cut for the time limit
AGREE_IT, AGREE_PREV = 9, 4


# phase 9's second solve: 6 z iterations, the last one's forward through the
# per-window clones
TIGHT = {"opt_it": 7, "prev_epochs": 5}


def agreement_config(traj, lat=None, model=None):
    """The AGREE_IT-iteration solve's config: under the keyframe trajectory
    loss where `traj`, with solver overrides `lat` and model overrides
    `model`."""
    extra = {"optimize_trajectory": True, "reg_w_trajectory": 1.0} if traj else {}
    return latent_config(model, opt_it=AGREE_IT, prev_epochs=AGREE_PREV, **extra, **(lat or {}))


def agreement_solve(seq, cfg, dev, scale, traj=None, root_trans=None):
    """One solve of an agreement (``LatentOptApps.interpolate``) on `dev`:
    the seeded model under `cfg` with its weights scaled by `scale`, the
    trajectory model (`traj` = (model, mean_std)) copied to `dev`; its
    outputs on the CPU and its seconds."""
    from hm_vae_torch.apps.tasks import LatentOptApps
    from hm_vae_torch.models.hm_vae import HMVAE

    m = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for prm in m.parameters():
            prm.mul_(scale)
    t = None if traj is None else (copy.deepcopy(traj[0]).to(dev), traj[1])
    apps = LatentOptApps(m.to(dev), cfg, trajectory=t)
    t0 = time.perf_counter()
    out = apps.interpolate(seq, torch.Generator().manual_seed(SEED), root_trans=root_trans)
    return {k: v.cpu() for k, v in out.items()}, time.perf_counter() - t0


# the solver's modes: the lora scope, the bf16 clone and moments (phases
# 17-19); bf16 conv compute (phase 36: the triple's model, evaluated under
# its own config)
LORA = {"finetune_scope": "lora"}
BF16_CLONE = {"opt_param_dtype": "bfloat16", "opt_moment_dtype": "bfloat16"}
BF16_COMPUTE = {"compute_dtype": "bfloat16"}


# The solve agreements (phases 9, 15, 17, 18, 36): phase -> (under the
# keyframe trajectory loss, solver overrides, model overrides, the least
# relative band).  Their CPU runs are a third of the script's host time:
# main submits them (:func:`submit_cpu_sides`) to a pool of one worker
# process as soon as their inputs exist, and the card runs the phases
# before them meanwhile.
AGREEMENTS = {
    "solve_agreement": (False, None, None, None),
    "solve_agreement_trajectory": (True, None, None, None),
    "solve_agreement_lora": (False, LORA, None, None),
    "solve_agreement_bf16_clone": (False, BF16_CLONE, None, None),
    # phase 35's bf16 floor: a 1 + 1e-7 scale of the f32 weights mostly
    # rounds away in the cast to bf16
    "solve_agreement_bf16": (False, BF16_CLONE, BF16_COMPUTE, 2.0 ** -7),
}
CPU_POOL = []  # the worker pool, made at the first submission
CPU_SIDES = {}  # "<phase>_<run>" -> the future of (outputs, seconds)


def cpu_worker_init(parent):
    """The worker's start: no card visible, half the host's cores (the
    other half drive the card), and killed when its parent dies
    (PR_SET_PDEATHSIG), so that it cannot outlive a killed run."""
    import ctypes
    import signal

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # 1: PR_SET_PDEATHSIG
    if os.getppid() != parent:  # the parent died before the prctl
        os._exit(1)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))


def cpu_solve(seq, cfg, scale, traj, root_trans):
    """:func:`agreement_solve` on the CPU in the worker; `traj` = (main's
    trajectory model's state as numpy, mean_std): the model's packed
    operands stay on the card, so only its weights cross.  Outputs as
    numpy."""
    if traj is not None:
        from hm_vae_torch.models.trajectory import TrajectoryModel
        from hm_vae_torch.utils.config import load_config

        tcfg = load_config(TRAJ_CONFIG)
        m = TrajectoryModel(tcfg.model, tcfg.optim.init)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in traj[0].items()})
        traj = (m, traj[1])
    out, seconds = agreement_solve(seq, cfg, "cpu", scale, traj, root_trans)
    return {k: v.numpy() for k, v in out.items()}, seconds


def submit_cpu_sides(seq, phase, traj=None, root_trans=None):
    """Submits the CPU runs of the agreement `phase` to the worker, once:
    from the weights and from the weights scaled by 1 + 1e-7 (and phase 9's
    TIGHT solve), under main's trajectory model (`traj` = (model,
    mean_std))."""
    if f"{phase}_cpu" in CPU_SIDES:
        return
    if not CPU_POOL:
        import concurrent.futures
        import multiprocessing

        CPU_POOL.append(concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=cpu_worker_init, initargs=(os.getpid(),)))
    with_traj, lat, model, _ = AGREEMENTS[phase]
    cfg = agreement_config(with_traj, lat, model)
    t = None if traj is None else (
        {k: v.detach().cpu().numpy() for k, v in traj[0].state_dict().items()}, traj[1])
    runs = [("cpu", cfg, 1.0), ("cpu_perturbed", cfg, 1.0 + 1e-7)]
    if phase == "solve_agreement":
        runs.append(("tight_cpu", latent_config(**TIGHT), 1.0))
    for run, c, scale in runs:
        CPU_SIDES[f"{phase}_{run}"] = CPU_POOL[0].submit(cpu_solve, seq, c, scale, t,
                                                         root_trans)


def cpu_side(name):
    """The CPU run `name`'s (outputs, seconds), waiting for the worker."""
    out, seconds = CPU_SIDES[name].result()
    return {k: torch.from_numpy(v) for k, v in out.items()}, seconds


def cpu_sides_pending():
    return sum(not f.done() for f in CPU_SIDES.values())


def solve_agreement_phase(seq, phase="solve_agreement", traj=None, root_trans=None):
    """An AGREE_IT-iteration 10-window interpolation (z phase 5, decoder
    phase 3, the last a decoder step) through ``LatentOptApps.interpolate`` on the
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

    `phase` names the agreement's mode in AGREEMENTS.  Under the keyframe
    trajectory loss (reg_w_trajectory 1; `traj` = (trajectory model,
    mean_std) and the sequence's `root_trans`), the trajectory model on
    each side's device; with solver overrides (the lora scope, the bf16
    clone), that mode, its adapters drawn on the CPU by the solver on both
    sides.  Either runs the AGREE_IT-iteration solve only.  Model overrides
    (phase 36's ``compute_dtype: bfloat16``) hold the outputs at the bf16
    tolerances (E2E_TOL, ROT_TOL, POSE_TOL); a floor is the least relative
    band, over the first 5 iterations too.  The CPU runs come from the
    worker (:func:`submit_cpu_sides`, here if main has not yet)."""
    with_traj, lat, model, floor = AGREEMENTS[phase]
    submit_cpu_sides(seq, phase, traj, root_trans)
    cfg = agreement_config(with_traj, lat, model)
    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    outs, wall = {}, {}
    for run, scale in (("gpu", 1.0), ("gpu_perturbed", 1.0 + 1e-7)):
        outs[run], wall[run] = agreement_solve(seq, cfg, DEV, scale, traj, root_trans)
    for run in ("cpu", "cpu_perturbed"):
        outs[run], wall[run] = cpu_side(f"{phase}_{run}")
    loss = {k: v["loss_history"].numpy().astype(np.float64) for k, v in outs.items()}
    if any(len(v) != AGREE_IT or not np.isfinite(v).all() for v in loss.values()):
        fail(f"{phase}: loss histories {loss}")
    rel = np.abs(loss["gpu"] / loss["cpu"] - 1)
    spread = {d: np.maximum.accumulate(np.abs(loss[f"{d}_perturbed"] / loss[d] - 1))
              for d in ("gpu", "cpu")}
    band = np.maximum(10 * np.maximum(spread["gpu"], spread["cpu"]) + 1e-4, floor or 0.0)
    first = max(1e-4, floor or 0.0)
    if not ((rel[:5] <= first).all() and (rel <= band).all()):
        fail(f"{phase}: GPU vs CPU loss relative difference {rel.tolist()} outside "
             f"{band.tolist()} (first 5 iterations: {first})")
    g, c = outs["gpu"], outs["cpu"]
    well = gram_schmidt_condition(c["rot_6d"]) > COND_MIN
    chain = ancestors_ok(well)
    errs = {}
    tol6 = (1e-4 if dtype == torch.float32 else E2E_TOL[dtype]) * float(c["rot_6d"].abs().max())
    for what, sel, tol0 in (("rot_6d", None, tol6), ("rot_mat", well, ROT_TOL[dtype]),
                            ("pose", chain, POSE_TOL[dtype])):
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
           "windows": WINDOWS, "opt_it": AGREE_IT, "prev_epochs": AGREE_PREV,
           "trajectory": with_traj,
           "overrides": lat or {}, "model_overrides": model or {}, "floor": floor,
           "loss_gpu": loss["gpu"].tolist(), "loss_cpu": loss["cpu"].tolist(),
           "rel_diff": rel.tolist(), "band": band.tolist(),
           "spread": {k: v.tolist() for k, v in spread.items()}, "outputs": errs,
           "share_well": float(well.float().mean()), "seconds": wall}
    if with_traj or lat:
        print(json.dumps(row), flush=True)
        return row
    # before Adam's amplification: 6 z iterations, the last iteration's
    # forward through the 10 per-window clones (the windowed forward), held
    # as the reconstruct is (e2e_phase's tolerances)
    g, wall[f"tight_{DEV}"] = agreement_solve(seq, latent_config(**TIGHT), DEV, 1.0)
    c, wall["tight_cpu"] = cpu_side(f"{phase}_tight_cpu")
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


def timed_solve(apps, seq, reps=2, root_trans=None, runs=None, profile=False, tiles=None):
    """Kernel launches of one solve (counts set to 0 just before), its
    loss history, and ms per solve by CUDA events over ``reps`` solves;
    with `profile` that counted solve runs under :func:`profile_calls`
    (the phase's earlier solves warmed the structures) and its profile is
    returned too.  `runs` (a dict) receives the kernels' runs in that solve
    as the device counted them, `tiles` (a dict) the launches of the tile
    kernels among the windowed wgrad's and dgrad's ("wgrad_tiles",
    "dgrad_tiles")."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    counters = launch_counters()
    for c in counters + [fcp.wgrad_tiles, fcp.dgrad_tiles]:
        c.launches = 0
    if runs is not None:
        fcp.device_runs(torch.cuda.current_device(), reset=True)
    solved = []

    def counted():
        solved.append(apps.interpolate(seq, torch.Generator().manual_seed(SEED),
                                       root_trans=root_trans))

    prof = profile_calls(counted, calls=1, warm=False) if profile else counted()
    out = solved[0]
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    if tiles is not None:
        tiles["wgrad_tiles"] = fcp.wgrad_tiles.launches
        tiles["dgrad_tiles"] = fcp.dgrad_tiles.launches
    if runs is not None:
        runs.update(fcp.device_runs(torch.cuda.current_device()))
    ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        apps.interpolate(seq, torch.Generator().manual_seed(SEED), root_trans=root_trans)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return (out, launches, ms, prof) if profile else (out, launches, ms)


def tile_levels(model, dtype, kernel="wgrad"):
    """The decoder levels whose windowed wgrad (`kernel` "wgrad") or dgrad
    ("dgrad") at the solve's shapes (WINDOWS windows of one batch) the
    wrapper gives its tile kernel in `dtype` (``wgrad_tiles_routed``,
    ``dgrad_tiles_routed``)."""
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import fused_conv_pool as fcp

    esz = torch.empty((), dtype=dtype).element_size()

    def routed(c, T):
        sp, s = c.spec, c.structure()
        if kernel == "wgrad":
            return fcp.wgrad_tiles_routed(1, T, sp.kernel_size, sp.stride, sp.padding,
                                          s.wgrad_row.numel(), esz, WINDOWS)
        return fcp.dgrad_tiles_routed(1, T, sp.kernel_size, sp.stride, sp.padding, s.rows,
                                      s.dgrad_chunk_start.numel() - 1, s.dgrad_chunk_row.numel(),
                                      esz, WINDOWS)

    return [n for n, c, T in level_cases(model, get_structure(model.cfg))
            if n.startswith("dec") and routed(c, T)]


def solve_tiles(model, dtype, n_d):
    """The tile kernels' launches a per-window solve of `n_d` decoder-phase
    iterations makes: one a routed level an iteration, each kernel."""
    return {f"{k}_tiles": n_d * len(tile_levels(model, dtype, k)) for k in ("wgrad", "dgrad")}


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
    tiles = solve_tiles(model, torch.float32, n_d)
    rows = {mode: mode_solve(model, seq, f"{mode} solve", overrides, want,
                             reps=2 if mode == "per_window" else 1,
                             profile=mode == "per_window", device_check=mode == "per_window",
                             tiles=tiles if mode == "per_window" else None)
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


def mode_solve(model, seq, name, overrides, want, reps=1, profile=True, model_overrides=None,
               device_check=False, tiles=None):
    """The full solve (10 windows, 150 iterations; the config's solver with
    `overrides`, its model section with `model_overrides`, which `model`
    was made under) on the card: its kernel launches must be exactly `want`
    (LAUNCH_NAMES order; the first, counted solve warms up), where given
    `tiles` (by tile kernel, :func:`solve_tiles`) of its windowed wgrad's
    and dgrad's through the tile kernels, and with `device_check` the
    kernels' runs counted on the device their sums over the windowed and
    the plain entries (where every windowed dgrad runs the tile kernel, its
    launches the device's dgrad runs less the plain entry's: "dgrad_tiles_
    device"); the loss must fall, the outputs be
    finite; ms per solve by CUDA events over `reps` solves, the peak of
    allocated device memory, and with `profile` the counted solve's
    profile."""
    from hm_vae_torch.apps.tasks import LatentOptApps

    apps = LatentOptApps(model, latent_config(model_overrides, **overrides))
    torch.cuda.reset_peak_memory_stats()
    runs = {} if device_check else None
    tile_runs = {}
    out, launches, ms, *prof = timed_solve(apps, seq, reps=reps, runs=runs, profile=profile,
                                           tiles=tile_runs)
    peak = torch.cuda.max_memory_allocated()
    want = dict(zip(LAUNCH_NAMES, want))
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    if tiles is not None and any(tile_runs[k] != v for k, v in tiles.items()):
        fail(f"{name}: {tile_runs} windowed launches ran the tile kernels, expected {tiles}")
    if device_check:
        want_runs = {TRACE_NAME[a]: want[a] + want[w]
                     for a, w in zip(LAUNCH_NAMES[:3], LAUNCH_NAMES[3:])}
        if runs != want_runs:
            fail(f"{name}: the device counted {runs}, expected {want_runs}")
        if tiles and tiles["dgrad_tiles"] == want["fused_conv_pool_dgrad_windowed"]:
            tile_runs["dgrad_tiles_device"] = runs["dgrad_kernel"] - launches[
                "fused_conv_pool_dgrad"]
            if tile_runs["dgrad_tiles_device"] != tile_runs["dgrad_tiles"]:
                fail(f"{name}: the device ran {tile_runs['dgrad_tiles_device']} windowed dgrad "
                     f"kernels, the tile kernel's count is {tile_runs['dgrad_tiles']}")
    hist = out["loss_history"].cpu().numpy()
    if not (np.isfinite(hist).all() and len(hist) == apps.cfg.latent_opt.opt_it
            and hist[-1] < hist[0]):
        fail(f"{name}: loss history {hist.tolist()}")
    for k in ("rot_6d", "rot_mat", "pose"):
        if out[k].shape[0] != seq.shape[0] or not torch.isfinite(out[k]).all():
            fail(f"{name}: {k} of shape {tuple(out[k].shape)} or non-finite")
    row = {"ms_per_solve": ms, "launches": launches, **tile_runs, "peak_memory_bytes": peak,
           "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
           **({"device_runs": runs} if device_check else {})}
    if profile:
        row["profile"] = prof[0]
    return row


def eval_phase(data_root, model, ck):
    """``python -m hm_vae_torch.cli.eval_recovery`` (in this process) on
    EVAL_SEQS sequences of the synthetic test split with the training CLI's
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
    phases 2 and 5 check and time them (dgrad's spans and wgrad's items, as
    routed at these short rows, with the whole-row kernels beside them).
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
    out, launches, ms, prof = timed_solve(apps, seq, reps=2, root_trans=root_trans,
                                          profile=True)
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
           "loss_last": float(hist[-1]), "profile": prof}
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


# eval_cli's sequences: 1 (2 before the bf16-compute solve's phase; each
# is a 150-iteration solve of ~4 s, cut for the time limit)
EVAL_SEQS = 1


def eval_cli(data_root, ck, phase, config, extra, check):
    """``eval_recovery --final_try_long_seq_interpolation`` (in this
    process) on EVAL_SEQS sequences of the synthetic test split with the
    training CLI's checkpoint `ck`, under `config` and the flags `extra`;
    the files and the summary (an output of whole windows for each, finite),
    and `check(launches)` on the kernel launches of the run; returns its
    row."""
    from hm_vae_torch.cli import eval_recovery

    out = os.path.join(OUT_DIR, phase)
    shutil.rmtree(out, ignore_errors=True)
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    eval_recovery.main(["--config", config, "--output_path", out, "--data_root", data_root,
                        "--test_model", ck, "--final_try_long_seq_interpolation",
                        "--max_seqs", str(EVAL_SEQS), "--device", DEV, "--seed", str(SEED)]
                       + extra)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    d = os.path.join(out, "eval_long_seq_interpolation",
                     os.path.splitext(os.path.basename(config))[0])
    files = sorted(os.listdir(d)) if os.path.isdir(d) else []
    res = [f for f in files if f.endswith("_rot_opt_res.npy")]
    if len(res) != EVAL_SEQS or "summary.json" not in files:
        fail(f"{phase} wrote {files}, expected {EVAL_SEQS} *_rot_opt_res.npy and summary.json")
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


def graph_agreement_phase(data_root, model=None, phase="production_graph_vs_eager"):
    """(a) 32 steps of the production config at batch 64 from one init and
    one superbatch (the native sampler's f16 aa wire, upcast on the card),
    the curriculum boundary set at step 16 inside the call: MultiStep's CUDA
    graph (one step captured, replayed 32 times) against the same 32 steps
    run eagerly.  Parameters, moments and per-leaf counts are compared; the
    largest difference is printed (0: the same bits).  The entries' launch
    counts (set to 0 before each run) are a step's launches 3 times on the
    graph (two warm-up steps and the capture; a replay calls no entry) and
    32 times eagerly.  `model`: the model section's overrides (phase 35's
    ``compute_dtype: bfloat16``)."""
    from hm_vae_torch.data.dataset import make_loaders
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.losses import draw_noise, eps_shapes
    from hm_vae_torch.train.train_step import MultiStep, create_state
    from hm_vae_torch.train.trainer import step_generator

    cfg = production_config(data_root, loss={"iteration_interval": 16},
                            **({"model": model} if model else {}))
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
        fail(f"{phase}: the shallow head stepped {head_count} times, expected "
             f"{K - 16} (from the boundary at 16)")
    want = {m: {k: n * v for k, v in TRAIN_LAUNCHES.items()} for m, n in (("graph", 3),
                                                                         ("eager", K))}
    if launches != want:
        fail(f"{phase}: entry launch counts {launches}, expected {want} (graph: "
             "two warm-up steps and the capture)")
    if not all(np.isfinite(v) for m in metrics.values() for v in m.values()):
        fail(f"{phase}: metrics {metrics}")
    row = {"phase": phase, "config": os.path.relpath(PRODUCTION_CONFIG, ROOT),
           "model_overrides": model, "batch": B, "steps": K, "iteration_interval": 16,
           "bit_equal": same, "max_abs_diff": diff, "metrics": metrics, "launches": launches}
    print(json.dumps(row), flush=True)
    return row


def perturb_inputs(trainer, scale):
    """Scale by `scale` the batches `trainer` steps on, after their upcast
    on the device (the one f32 operand of a step under bf16 parameters)."""
    consume = type(trainer)._consume
    trainer._consume = lambda staged: {k: v * scale for k, v in consume(trainer, staged).items()}


def production_agreement_phase(data_root, steps=12, model=None, scale=1.0 + 1e-7,
                               first_tol=1e-4, phase="production_agreement", batch=BATCH):
    """(b) The production config's dtypes (bf16 parameters and moments, the
    f16 aa wire) at batch 8, 4 steps a call (a CUDA graph on the card), the
    curriculum boundary at step 10 inside the third call: Trainer.fit on the
    GPU against the CPU from the same init and windows, the loss after every
    call within 10x the larger spread of runs whose batches are scaled by
    `scale` (1 + 1e-7) after the upcast on each side, + 1e-4 (the bf16
    gradients and stochastic write-back amplify last places, as the CPU test
    of the production path calibrates its band), and within `first_tol`
    (1e-4; None: the band alone) after the first call.  `model`: the model
    section's overrides (phase 35's ``compute_dtype: bfloat16``, whose band
    needs a scale that survives the cast to bf16, and a smaller `batch` for
    its slower CPU side)."""
    from hm_vae_torch.train.trainer import build_trainer

    cfg = production_config(data_root, optim={"batch_size": batch},
                            run={"steps_per_call": 4, "log_iter": 1},
                            loss={"iteration_interval": 10},
                            **({"model": model} if model else {}))
    losses, wall = {}, {}
    for run, dev, sc in (("gpu", DEV, 1.0), ("cpu", "cpu", 1.0),
                         ("gpu_perturbed", DEV, scale), ("cpu_perturbed", "cpu", scale)):
        trainer, train_ds, _, _ = build_trainer(
            cfg, os.path.join(OUT_DIR, f"{phase}_{run}"), device=dev)
        if sc != 1.0:
            perturb_inputs(trainer, sc)
        out = []
        t0 = time.perf_counter()
        trainer.fit(train_ds, None, max_iter=steps, log_cb=lambda s, m: out.append(m["loss_total"]))
        wall[run] = time.perf_counter() - t0
        losses[run] = np.array(out)
    if any(len(v) != steps // 4 or not np.isfinite(v).all() for v in losses.values()):
        fail(f"{phase}: losses {losses}")
    rel = np.abs(losses["gpu"] / losses["cpu"] - 1)
    spread = {d: np.maximum.accumulate(np.abs(losses[f"{d}_perturbed"] / losses[d] - 1))
              for d in ("gpu", "cpu")}
    band = 10 * np.maximum(spread["gpu"], spread["cpu"]) + 1e-4
    if not ((first_tol is None or rel[0] <= first_tol) and (rel <= band).all()):
        fail(f"{phase}: GPU vs CPU loss relative difference {rel.tolist()} "
             f"outside {band.tolist()} (first call: {first_tol})")
    row = {"phase": phase, "config": os.path.relpath(PRODUCTION_CONFIG, ROOT),
           "model_overrides": model, "batch": batch, "steps": steps, "steps_per_call": 4,
           "iteration_interval": 10, "perturbation": scale, "first_call_tol": first_tol,
           "loss_gpu": losses["gpu"].tolist(), "loss_cpu": losses["cpu"].tolist(),
           "rel_diff": rel.tolist(), "band": band.tolist(),
           "spread": {k: v.tolist() for k, v in spread.items()}, "fit_seconds": wall}
    print(json.dumps(row), flush=True)
    return row


def production_cli_phase(data_root, calls=4, compute_dtype=None):
    """``python -m hm_vae_torch.cli.train --config <production>`` (in this
    process) on synthetic data: `calls` calls of 32 steps with an
    asynchronous snapshot after every call and keep_checkpoints 2, then
    ``--resume`` for one more call.  The train split must be the native
    sampler on the aa wire, the steps a CUDA graph; returns the checkpoint
    names.  `compute_dtype`: a ``compute_dtype:`` line added to the written
    YAML (the CLI has no override flag)."""
    from hm_vae_torch.cli import train as train_cli
    from hm_vae_torch.data.native_loader import NativeMotionLoader
    from hm_vae_torch.train import trainer as trainer_mod

    with open(PRODUCTION_CONFIG) as f:
        text = f.read()
    for key, value in (("log_iter", 32), ("snapshot_save_iter", 32), ("keep_checkpoints", 2)):
        text, n = re.subn(rf"(?m)^{key}: .*$", f"{key}: {value}", text)
        if n != 1:
            fail(f"production CLI: no single {key} line in {PRODUCTION_CONFIG}")
    name = "len64_production_smoke"
    if compute_dtype:
        if re.search(r"(?m)^compute_dtype:", text):
            fail(f"production CLI: {PRODUCTION_CONFIG} already sets compute_dtype")
        text += f"\ncompute_dtype: {compute_dtype}\n"
        name = f"len64_production_{compute_dtype}_smoke"
    path = os.path.join(OUT_DIR, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(text)
    out = os.path.join(OUT_DIR, "production_cli" + (f"_{compute_dtype}" if compute_dtype else ""))
    shutil.rmtree(out, ignore_errors=True)
    seen = []
    fit = trainer_mod.Trainer.fit

    def recorded_fit(self, train_ds, *a, **kw):
        r = fit(self, train_ds, *a, **kw)
        seen.append({"train_split": type(train_ds).__name__, "wire": self.cfg.data.wire_format,
                     "transfer_dtype": self.cfg.data.transfer_dtype,
                     "compute_dtype": self.cfg.model.compute_dtype,
                     "graph": bool(self._multi and self._multi.graph),
                     "async_checkpoint": self.cfg.run.async_checkpoint,
                     "native": isinstance(train_ds, NativeMotionLoader)})
        return r

    args = ["--config", path, "--output_path", out, "--data_root", data_root, "--device", DEV]
    buf = io.StringIO()
    t0 = time.perf_counter()
    trainer_mod.Trainer.fit = recorded_fit
    end = 32 * calls
    try:
        with contextlib.redirect_stdout(buf):
            train_cli.main(args + ["--max_iter", str(end)])
            first = sorted(os.listdir(os.path.join(out, "outputs", name, "checkpoints")))
            train_cli.main(args + ["--max_iter", str(end + 32), "--resume"])
    finally:
        trainer_mod.Trainer.fit = fit
    text = buf.getvalue()
    ck = os.path.join(out, "outputs", name, "checkpoints")
    names = sorted(os.listdir(ck))
    resumed = [line for line in text.splitlines() if line.startswith("Resume from")]
    gen = [f"gen_{i:08d}.pt" for i in (end - 32, end, end + 32)]
    if resumed != [f"Resume from iteration {end}"] or first != gen[:2] or names != gen[1:]:
        fail(f"production CLI: resume lines {resumed}, checkpoints {first} then {names}:\n{text}")
    if not all(s["native"] and s["wire"] == "aa" and s["graph"] and s["async_checkpoint"]
               and s["compute_dtype"] == (compute_dtype or "float32")
               for s in seen) or len(seen) != 2:
        fail(f"production CLI: the runs were {seen}")
    blob = torch.load(os.path.join(ck, names[-1]), map_location="cpu", weights_only=True)
    if blob["step"] != end + 32 or not all(torch.isfinite(v).all()
                                           for v in blob["state_dict"].values()):
        fail(f"production CLI: checkpoint step {blob['step']} or non-finite weights")
    logged = [line for line in text.splitlines() if line.startswith("[")]
    row = {"phase": "production_train_cli", "config": os.path.relpath(PRODUCTION_CONFIG, ROOT),
           "overrides": {"log_iter": 32, "snapshot_save_iter": 32, "keep_checkpoints": 2,
                         **({"compute_dtype": compute_dtype} if compute_dtype else {})},
           "runs": seen, "resumed": resumed[0], "checkpoints_after_128": first,
           "checkpoints_after_resume": names, "checkpoint": os.path.join(ck, names[-1]),
           "logged_steps": [line[1:9] for line in logged],
           "seconds": time.perf_counter() - t0,
           "finish": [line for line in text.splitlines() if line.startswith("Finish")][-1][:200]}
    print(json.dumps(row), flush=True)
    return row


def trace_launches(per_call, kernel):
    """A kernel's launches in a device trace's counts (``profile_calls``):
    dgrad's are those of its whole-row and its span kernel, wgrad's those of
    its whole-row and its item kernel, as the device counts them."""
    if kernel in ("dgrad_kernel", "wgrad_kernel"):
        stem = kernel[:5]
        return per_call.get(f"{stem}_kernel", 0) + per_call.get(f"{stem}_span_kernel", 0)
    return per_call.get(kernel, 0)


def span_dgrad_levels(model, cfg):
    """How many of a training step's 7 dgrad levels (all but enc0, whose
    input is data) run the span kernel at the config's batch and compute
    dtype (``dgrad_plan``)."""
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import fused_conv_pool as fcp

    n = 0
    for _, conv, T in level_cases(model, get_structure(cfg.model))[1:]:
        s = conv.structure()
        esz = torch.empty((), dtype=s.dtype).element_size()
        gran = 16 // esz
        T_out = (T + 2 * s.padding - s.kernel_size) // s.stride + 1
        n += fcp.dgrad_plan(cfg.optim.batch_size, T, s.kernel_size, s.stride, s.padding,
                            -(-T_out // gran) * gran, s.dgrad_start.numel() - 1,
                            s.dgrad_max_live, fcp._sm_count(torch.cuda.current_device()), 1,
                            (s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live),
                            esz).span > 0
    return n


def production_step_phase(data_root, calls=4, model=None, eager=True,
                          phase="production_step", profiled=2):
    """The production step's cost through Trainer.fit at batch 64 (32 steps
    a call, a CUDA graph; the native sampler's f16 aa wire, double-buffered
    ingest): ms a step by CUDA events over `calls` calls after a first call
    (the capture), peak memory and its rise above what was allocated as the
    timed calls began (the state, and whatever earlier phases keep), and
    the device time, idle share and the port's kernels' launches a call in
    the device trace (torch.profiler, device only) over `profiled` calls
    (two), and dgrad's device ms a step there (its kernels: whole rows, or
    spans and their weight's layout) and wgrad's (whole rows, or items);
    then the same config at steps_per_call 1
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
    traced as four consecutive units of 8, their counts summed).  `model`:
    the model section's overrides; `eager`: false times the graph alone;
    `profiled`: the graph's calls in the device trace."""
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.trainer import build_trainer

    per_32 = {k: 32 * v for k, v in TRAIN_LAUNCHES.items()}
    trace_want = {TRACE_NAME[k]: v for k, v in per_32.items()}
    out = {}
    modes = ((32, calls, profiled),) + (((1, calls // 2, 1),) if eager else ())
    for K, units, profiled in modes:
        cfg = production_config(data_root, run={"steps_per_call": K, "log_iter": 10 ** 9},
                                **({"model": model} if model else {}))
        trainer, train_ds, _, _ = build_trainer(
            cfg, os.path.join(OUT_DIR, f"{phase.replace('_step', '')}_K{K}"), device=DEV)
        for c in fcp.launch_entries() + (fcp.dgrad_span_pack,):
            c.launches = 0
        n = 32  # steps a measured unit: one call, or 32 eager steps
        trainer.fit(train_ds, None, max_iter=n)  # the first call captures the graph
        torch.cuda.synchronize()
        first = {k: v for k, v in fcp.launch_counts().items() if v}
        fcp.device_runs(torch.cuda.current_device(), reset=True)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # what earlier phases and the state hold
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
        # dgrad's launches in the trace: whole rows or spans, as the device
        # counts them (the spans' weight layout apart)
        seen = {k: trace_launches(per_32, k) for k in trace_want}
        runs_want = {TRACE_NAME[k]: (steps - n) * v for k, v in TRAIN_LAUNCHES.items()}
        want_first = {k: (3 if K > 1 else n) * v for k, v in TRAIN_LAUNCHES.items()}
        want_run = {k: (3 if K > 1 else steps) * v for k, v in TRAIN_LAUNCHES.items()}
        if first != want_first or in_run != want_run:
            fail(f"{phase} K={K}: entry launch counts {first} after the first call, "
                 f"{in_run} after {steps} steps; expected {want_first}, {want_run}")
        if runs != runs_want:
            fail(f"{phase} K={K}: {runs} kernel runs on the device over steps "
                 f"{n + 1}-{steps}, expected {runs_want}")
        # the span kernel's weight layout: one launch a step at each level
        # whose dgrad runs spans (a replay calls no entry)
        pack_want = (3 if K > 1 else steps) * span_dgrad_levels(trainer.state.model, cfg)
        if fcp.dgrad_span_pack.launches != pack_want:
            fail(f"{phase} K={K}: dgrad_span_pack launched {fcp.dgrad_span_pack.launches} "
                 f"times, expected {pack_want}")
        out[K] = {"ms_per_step": ms, "steps": steps, "entry_launches_in_run": in_run,
                  "pack_launches_in_run": fcp.dgrad_span_pack.launches,
                  "device_runs_after_first_call": runs,
                  "device_runs_per_32_steps": {k: 32 * v / (steps - n) for k, v in runs.items()},
                  "trace_launches_per_32_steps": per_32,
                  "trace_complete": seen == trace_want, "profiled_steps": n_prof,
                  "peak_memory_bytes": peak, "peak_above_start_bytes": peak - base,
                  "profile_per_unit": prof,
                  "device_ms_per_step": prof["device_us_per_call"] / n_prof / 1e3,
                  "dgrad_ms_per_step": sum(prof["trace_us_per_call"].get(k, 0.0)
                                           for k in DGRAD_TRACE) / n_prof / 1e3,
                  "wgrad_ms_per_step": sum(prof["trace_us_per_call"].get(k, 0.0)
                                           for k in WGRAD_TRACE) / n_prof / 1e3,
                  "idle_share": prof["idle_share"]}
    row = {"phase": phase, "config": os.path.relpath(PRODUCTION_CONFIG, ROOT),
           "model_overrides": model, "batch": PROD_BATCH, "graph_steps_per_call_32": out[32],
           **({"eager_steps_per_call_1": out[1]} if eager else {})}
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


# ---------------------------------------------------------------------------
# phases 29-32: the backward over long rows, and the parallel package over
# torch.distributed ranks (two ranks share the one card under gloo; NCCL runs
# one rank)

LONG_BWD_CASES = (("b1_t7200", 1, 7200), ("b8_t1024", 8, 1024), ("b8_t1000", 8, 1000))
LONG_TRAIN_T = 1024  # the trajectory model's train_seq_len in long_backward's steps
LONG_TRAIN_STEPS = 5


def span_vs_whole_rows(model, st, tmodel, gen):
    """The span kernels (wgrad: items of several batches' whole rows where
    an item holds two or more, else of one batch's output columns; dgrad:
    spans of whole padded rows, one or more batches' a span; each its own
    plan) beside the whole-row kernels (their whole-row plans), on the same
    inputs, each unrouted where its plan does not take the shape: the len-64
    model's 8 levels at batch 8 (wgrad only) and at the production batch of
    64 (both routed there), f32; and the trajectory model's 4 levels at
    batch 8, T 128 (both routed there), in f32 and bf16, and, dgrad only,
    at 10 windows of T 64 (the solve's, routed), in f32.  Each row: the
    kernels' device ms (dgrad's span time with its weight packing), the
    span kernels' max |err| against the plain versions (TOL of the dtype),
    their plans and two runs bit-equal.  Returns {shape: rows}."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = {f"len64_b{b}": [(f"{n}@b{b}", c, T, b, f32, True) for n, c, T in
                              level_cases(model, st)]
              for b in (BATCH, PROD_BATCH)}
    for dtype, tag in ((f32, ""), (bf16, "@bf16")):
        for b, T, with_wgrad in ((BATCH, 128, True),) + (((WINDOWS, 64, False),)
                                                          if dtype == f32 else ()):
            shapes[f"traj_b{b}_t{T}{tag}"] = [
                (f"traj{i}@b{b}_t{T}{tag}", getattr(tmodel.encoder, f"conv_{i}"), T, b, dtype,
                 with_wgrad) for i in range(len(tmodel.encoder.structure.levels))]
    sms = fcp._sm_count(torch.cuda.current_device())
    out = {}
    for shape, cases in shapes.items():
        for name, conv, T_in, batch, dtype, with_wgrad in cases:
            s, wf, bf, x, y, gy = bwd_inputs(conv, T_in, gen, batch, dtype)
            K, stride, T_out, esz = s.kernel_size, s.stride, y.shape[2], gy.element_size()
            mode = "reflect" if s.reflect else "constant"
            row = {"level": name, "batch": batch, "T_in": T_in,
                   "dtype": str(dtype).replace("torch.", "")}
            if with_wgrad:
                cols = fcp.wgrad_span_cols(K, stride, esz)
                nbb = max(1, fcp.wgrad_span_rows(batch, T_in, K, stride, s.padding, esz, cols))
                gran = 16 // esz
                plan = fcp.wgrad_span_plan(
                    batch, T_out, s.wgrad_row.numel(), sms, 1, cols, nbb,
                    fcp.wgrad_items_per_sm(K, stride, cols, esz, nbb, T_in, T_out,
                                           -(-T_out // gran) * gran))
                ww_plan = whole_row_wgrad_plan(s, gy, T_in)

                def span():
                    return fcp._wgrad(gy, y, x, s, None, plan)

                def whole():
                    return fcp._wgrad(gy, y, x, s, None, ww_plan)

                gw, gb = span()
                rw, rb = fcp.fused_conv_pool_wgrad_reference(
                    gy, y, x, K, stride, s.padding, mode, s.negative_slope, s.live_elements())
                err = check(f"{name} wgrad span kernel", gw, rw, dtype)[0]
                if bf is not None:
                    err = max(err, check(f"{name} span bias grad", gb, rb, dtype)[0])
                gw2, gb2 = span()
                if not (torch.equal(gw2, gw) and torch.equal(gb2, gb)):
                    fail(f"{name}: the wgrad item kernel differs between two runs")
                row.update({"max_abs_err": err, "span_ms": device_ms(span),
                            "whole_ms": device_ms(whole), "plan": plan._asdict(),
                            "whole_plan": ww_plan._asdict()})
            if shape != f"len64_b{BATCH}":
                # at the trajectory's short rows the split is counted in stages and
                # the waves in the clusters the card holds, as routed
                d_plan = fcp.dgrad_span_plan(
                    batch, T_in, K, stride, s.padding, s.dgrad_span_start.numel() - 1,
                    s.dgrad_span_max_live, sms, 1, esz,
                    lambda: fcp.span_clusters(torch.cuda.current_device(), K, stride, esz))
                w_plan = whole_row_plan(s, gy, T_in)

                def d_span():
                    return fcp._dgrad(gy, y, wf, s, T_in, None, d_plan)

                def d_whole():
                    return fcp._dgrad(gy, y, wf, s, T_in, None, w_plan)

                gx = d_span()
                d_err = check(f"{name} dgrad span kernel", gx,
                              fcp.fused_conv_pool_dgrad_reference(gy, y, wf, T_in, stride,
                                                                  s.padding, mode,
                                                                  s.negative_slope),
                              dtype)[0]
                if not torch.equal(d_span(), gx):
                    fail(f"{name}: the dgrad span kernel differs between two runs")
                row["dgrad"] = {"max_abs_err": d_err, "span_ms": device_ms(d_span),
                                "whole_ms": device_ms(d_whole), "plan": d_plan._asdict(),
                                "whole_plan": w_plan._asdict()}
            print(json.dumps({"span_vs_whole": shape, **row}), flush=True)
            out.setdefault(shape, []).append(row)
    return out


def long_backward_phase(model, st, tmodel, gen):
    """29. dgrad and wgrad over padded rows past one block's whole-row
    staging: the trajectory model's four K-31 levels at batch 1, T 7,200,
    batch 8, T 1,024 and batch 8, T 1,000, and the len-64 model's stride-2
    K-15 level (enc1) at batch 8, T 1,024 (the old limit: 256 / stride
    padded columns), each against its plain version and autograd,
    bit-equal on two runs, timed, with the plan its launch ran (spans); the
    span kernels beside the whole-row ones (:func:`span_vs_whole_rows`);
    then LONG_TRAIN_STEPS steps of the
    trajectory model at train_seq_len 1,024 on the card against the CPU,
    under the training gate (:func:`train_phase`), on synthetic takes of
    1,100-1,500 frames, and as many at bf16 compute (finite losses, 4 / 3
    / 4 device runs a step: :func:`bf16_trajectory_steps`); dgrad's spans
    and wgrad's items in bf16 at (1, 7,200), (8, 1,024) and enc1 (whose
    rows wgrad's bf16 whole-row block would take: timed beside the items),
    held at TOL[bf16], bit-equal on two runs, timed beside cuDNN's bf16.  Returns ({case: [rows over the levels]}, the
    train row, the phase's row with the span-vs-whole rows, {case: bf16
    rows})."""
    from hm_vae_torch.data import synthetic
    from hm_vae_torch.ops import fused_conv_pool as fcp

    t_phase = time.perf_counter()
    rows = {}
    for case, batch, T in LONG_BWD_CASES:
        for i in range(len(tmodel.encoder.structure.levels)):
            conv = getattr(tmodel.encoder, f"conv_{i}")
            rows.setdefault(case, []).append(
                bwd_level_row(f"traj{i}_long_{case}", conv, T, batch, gen))
    rows["enc1_b8_t1024"] = [bwd_level_row("enc1_long_b8_t1024", model.encoder.conv_1, 1024,
                                           BATCH, gen)]
    for case, rs in rows.items():
        for r in rs:
            if not (r["dgrad"]["plan"]["span"] > 0 and r["wgrad"]["plan"]["span"] > 0):
                fail(f"long_backward {r['level']}: plans {r['dgrad']['plan']} / "
                     f"{r['wgrad']['plan']} stage whole rows")
    # dgrad's spans and wgrad's items (but at enc1, whose rows fit whole) in
    # bf16 over the same long rows
    bf16 = {case: [bwd_level_row(f"traj{i}_long_{case}@bf16",
                                 getattr(tmodel.encoder, f"conv_{i}"), T, batch, gen,
                                 dtype=torch.bfloat16)
                   for i in range(len(tmodel.encoder.structure.levels))]
            for case, batch, T in LONG_BWD_CASES if case != "b8_t1000"}
    bf16["enc1_b8_t1024"] = [bwd_level_row("enc1_long_b8_t1024@bf16", model.encoder.conv_1,
                                           1024, BATCH, gen, dtype=torch.bfloat16)]
    for case, rs in bf16.items():
        for r in rs:
            # wgrad's bf16 stages, half as large, would take enc1's rows
            # whole; its plan takes items there as f32's does (timed beside)
            items = r["wgrad"]["plan"]["span"] > 0 and r["wgrad"]["plan"]["sb"] == 1
            if not (r["dgrad"]["plan"]["span"] > 0 and r["dgrad"]["plan"]["spans"] > 1
                    and items and ("whole_rows" in r["wgrad"]) == (case == "enc1_b8_t1024")):
                fail(f"long_backward {r['level']}: plans {r['dgrad']['plan']} / "
                     f"{r['wgrad']['plan']}: no span plan, or wgrad's not its expected one")
    t_svw = time.perf_counter()
    span_vs_whole = span_vs_whole_rows(model, st, tmodel, gen)
    t_svw = time.perf_counter() - t_svw
    data_root = os.path.join(OUT_DIR, "long_train_data")
    shutil.rmtree(data_root, ignore_errors=True)
    synthetic.generate_dataset(data_root, num_seqs=10, min_len=1100, max_len=1500, seed=SEED)
    path = os.path.join(OUT_DIR, "trajectory_model_t1024.yaml")
    with open(TRAJ_CONFIG) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(re.sub(r"(?m)^train_seq_len:.*$", f"train_seq_len: {LONG_TRAIN_T}", text))
    train = train_phase(data_root, path, TRAJ_TRAIN_LAUNCHES, "train_trajectory_t1024",
                        steps=LONG_TRAIN_STEPS)
    # the same at bf16 compute: dgrad's bf16 spans and wgrad's bf16 items over long rows
    train_bf16 = bf16_trajectory_steps(data_root, path, LONG_TRAIN_STEPS,
                                       "bf16_trajectory_t1024")
    row = {"phase": "long_backward", "cases": {c: [r["level"] for r in rs]
                                               for c, rs in rows.items()},
           "plans": {r["level"]: {"dgrad": r["dgrad"]["plan"], "wgrad": r["wgrad"]["plan"]}
                     for rs in rows.values() for r in rs},
           **{f"bf16_{what}": {case: {"ms": sum(r[what]["ms"] for r in rs),
                                      "library_ms": sum(r[what]["library_ms"] for r in rs),
                                      "max_abs_err": max(r[what]["max_abs_err"] for r in rs),
                                      "plan": rs[0][what]["plan"]}
                               for case, rs in bf16.items()}
              for what in ("dgrad", "wgrad")},
           "span_vs_whole": {shape: {**({"span_ms": sum(r["span_ms"] for r in rs),
                                         "whole_ms": sum(r["whole_ms"] for r in rs)}
                                        if "span_ms" in rs[0] else {}),
                                     **({"dgrad_span_ms": sum(r["dgrad"]["span_ms"] for r in rs),
                                         "dgrad_whole_ms": sum(r["dgrad"]["whole_ms"]
                                                               for r in rs)}
                                        if "dgrad" in rs[0] else {})}
                             for shape, rs in span_vs_whole.items()},
           "span_vs_whole_s": t_svw,
           # the dgrad span kernel's clusters the card runs at once, by split
           # (1-8), at K 31: the trajectory's short rows' waves
           "span_clusters": {str(dt).replace("torch.", ""): fcp.span_clusters(
               torch.cuda.current_device(), 31, 1, torch.empty((), dtype=dt).element_size())
               for dt in (torch.float32, torch.bfloat16)},
           "train_steps": LONG_TRAIN_STEPS, "train_seq_len": LONG_TRAIN_T,
           "train_bf16": train_bf16, "elapsed_s": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return rows, train, row, bf16


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(nproc, args, timeout, expect_fail=False):
    """``python -m torch.distributed.run --nproc_per_node nproc`` on
    localhost with ``HMVAE_DIST=1``; the whole process group is killed at
    ``timeout``.  A non-zero exit (or a zero one where `expect_fail`) fails
    the run.  Returns (stdout, stderr, seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
           "--max_restarts", "0", *args]
    env = dict(os.environ, HMVAE_DIST="1", OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        fail(f"torchrun {args[:3]} hung past {timeout} s:\n{out[-3000:]}\n{err[-3000:]}")
    if (proc.returncode != 0) != expect_fail:
        fail(f"torchrun {args} exited {proc.returncode}:\n{out[-3000:]}\n{err[-6000:]}")
    return out, err, time.perf_counter() - t0


def rank_reports(prefix, nproc):
    reports = []
    for r in range(nproc):
        with open(f"{prefix}_rank{r}.json") as f:
            reports.append(json.load(f))
    return reports


def rank_audit(argv):
    """``chip_smoke.py --rank-audit <report prefix> <root> <runs.json>``, a
    rank started by torchrun: runs each entry point of ``runs.json`` (a list
    of {"module", "argv", "expect_error"}) in turn as ``python -m`` runs it,
    in this process (the group joined by the first run stays), recording
    every file it writes, makes, renames or removes under ``root`` (an audit
    hook), each run's standard output and kernel launches (the entries'
    counts and the device's run counters), and the group's backend, into
    ``<prefix>_rank<r>.json``.  A run whose ``expect_error`` is set must
    raise a ValueError containing it (recorded); any other error fails the
    rank.  The module name ``ddp_steps`` runs :func:`ddp_steps` instead
    (argv: a prefix and ``run.model_parallel``), on this rank's data row's
    rows, its parameters after the first and the last step (the sharded
    heads gathered) into ``<prefix>_rank<r>_first.npz`` and ``_last.npz``."""
    import runpy

    import torch.distributed as dist

    prefix, root = argv[0], os.path.abspath(argv[1])
    with open(argv[2]) as f:
        runs = json.load(f)
    writes = []

    def hook(event, a):
        path = None
        if event == "open" and a[0] is not None and not isinstance(a[0], int):
            mode, flags = a[1] or "", a[2] or 0
            if any(c in mode for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
                path = a[0]
        elif event in ("os.mkdir", "os.remove", "os.rmdir"):
            path = a[0]
        elif event == "os.rename":
            path = a[1]
        if path is not None:
            p = os.path.abspath(os.fsdecode(path))
            if p.startswith(root + os.sep):
                writes.append(os.path.relpath(p, root))

    sys.addaudithook(hook)
    from hm_vae_torch.ops import fused_conv_pool as fcp

    done = []
    for run in runs:
        for c in fcp.launch_entries():
            c.launches = 0
        if torch.cuda.is_initialized():
            fcp.device_runs(torch.cuda.current_device(), reset=True)
        if run["module"] == "ddp_steps":  # :func:`ddp_steps` on this rank's rows
            from hm_vae_torch.parallel import multihost as mh
            from hm_vae_torch.utils.config import load_config

            mh.maybe_initialize_distributed(DEV)
            cfg = load_config(CONFIG)
            cfg = dataclasses.replace(cfg, run=dataclasses.replace(
                cfg.run, model_parallel=int(run["argv"][1])))
            first, params, losses, runs_ = ddp_steps(cfg)
            for what, p in (("first", first), ("last", params)):
                np.savez(f"{run['argv'][0]}_rank{mh.process_index()}_{what}.npz", **p)
            done.append({"losses": losses, "device_runs": runs_})
            continue
        buf, error = io.StringIO(), None
        sys.argv = [run["module"]] + run["argv"]
        with contextlib.redirect_stdout(buf):
            try:
                runpy.run_module(run["module"], run_name="__main__", alter_sys=True)
            except ValueError as e:
                if not run.get("expect_error") or run["expect_error"] not in str(e):
                    raise
                error = str(e)
        if run.get("expect_error") and error is None:
            raise RuntimeError(f"{run['module']} {run['argv']} did not raise "
                               f"{run['expect_error']!r}")
        done.append({"stdout": buf.getvalue(), "error": error,
                     "launches": fcp.launch_counts(),
                     "device_runs": fcp.device_runs(torch.cuda.current_device())})
    rank = dist.get_rank() if dist.is_initialized() else 0
    report = {"rank": rank, "world": dist.get_world_size() if dist.is_initialized() else 1,
              "backend": dist.get_backend() if dist.is_initialized() else None,
              "device": torch.cuda.current_device(), "writes": sorted(set(writes)),
              "runs": done}
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(f"{prefix}_rank{rank}.json", "w") as f:
        json.dump(report, f)


def audited(nproc, prefix, root, runs, timeout):
    """``runs`` ([(module, argv, expect_error)]) in ``nproc`` ranks under
    torchrun through :func:`rank_audit`; (each rank's report, seconds)."""
    with open(f"{prefix}_runs.json", "w") as f:
        json.dump([{"module": m, "argv": a, "expect_error": e} for m, a, e in runs], f)
    _, _, seconds = torchrun(nproc, [os.path.join(ROOT, "chip_smoke.py"), "--rank-audit",
                                     prefix, root, f"{prefix}_runs.json"], timeout=timeout)
    return rank_reports(prefix, nproc), seconds


DDP_STEPS = 5


def ddp_inputs(cfg, steps=DDP_STEPS):
    """Fixed global batches (steps, B, 64, 24, ...) of smooth random
    rotations and each step's noise for the global batch, made from the
    seed on the host: the same on every rank and in the one-process run."""
    from hm_vae_torch.data import layout, synthetic
    from hm_vae_torch.train.losses import draw_noise, eps_shapes
    from hm_vae_torch.train.trainer import step_generator

    B, T = cfg.optim.batch_size, cfg.model.train_seq_len
    rng = np.random.default_rng(SEED + 29)
    frames = np.stack([synthetic.synth_sequence(rng, T) for _ in range(steps * B)])
    rm = frames[..., layout.ROTMAT].reshape(steps, B, T, 24, 3, 3).astype(np.float32)
    six = np.concatenate((rm[..., :, 0], rm[..., :, 1]), axis=-1)
    shapes = eps_shapes(cfg, B)
    eps = [draw_noise(shapes, step_generator(cfg.run.seed, k)) for k in range(steps)]
    return {"rot_6d": six, "rot_mat": rm}, [np.stack([e[lv].numpy() for e in eps])
                                            for lv in range(len(shapes))]


def ddp_steps(cfg, scale=1.0):
    """DDP_STEPS train_step calls of `cfg`'s model on the card from the
    seeded init (scaled by `scale`), on the (data, model) grid of
    ``cfg.run.model_parallel`` (``make_groups``: the latent heads sharded
    over the model group, the gradients averaged over the data group), on
    this rank's data row's rows of :func:`ddp_inputs` (all of them in one
    process); the parameters after the first step and after the last (the
    sharded heads gathered), each step's loss averaged over the data group,
    and the device's kernel runs."""
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.parallel.sharding import (allreduce_mean, gather_state, make_groups,
                                                model_shards, rank_rows)
    from hm_vae_torch.train.train_step import create_state, train_step

    batches, eps = ddp_inputs(cfg)
    g = make_groups(cfg.run.model_parallel)
    r0, r1 = rank_rows(cfg.optim.batch_size, g.data)
    dev = torch.device(DEV, torch.cuda.current_device())
    state = create_state(cfg, dev, model_group=g.model)
    shards = model_shards(state.model)
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(scale)

    def params():
        full = gather_state(dict(state.model.named_parameters()), shards, g.model)
        return {n: p.detach().float().cpu().numpy() for n, p in full.items()}

    fcp.device_runs(dev.index, reset=True)
    losses = []
    for k in range(DDP_STEPS):
        m = train_step(state, {f: torch.from_numpy(v[k, r0:r1]).to(dev)
                               for f, v in batches.items()}, cfg,
                       [torch.from_numpy(e[k, r0:r1]).to(dev) for e in eps], group=g.data)
        losses.append(float(allreduce_mean(m, g.data)["loss_total"]))
        if k == 0:
            first = params()  # collectives and copies: no kernel of ours runs
    runs = fcp.device_runs(dev.index)
    return first, params(), losses, runs


def nccl_graph(data_root, group):
    """The production config's 32 steps at batch 64 on one superbatch, as
    :func:`graph_agreement_phase` runs them: MultiStep's CUDA graph with
    the gradients' all-reduce over `group` captured in it, against the same
    graph without a group; the largest state difference (0: the same bits)
    and the graphed run's kernel runs on the device."""
    from hm_vae_torch.data.dataset import make_loaders
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.losses import draw_noise, eps_shapes
    from hm_vae_torch.train.train_step import MultiStep, create_state
    from hm_vae_torch.train.trainer import step_generator

    cfg = production_config(data_root)
    K, B = cfg.run.steps_per_call, cfg.optim.batch_size
    dev = torch.device(DEV, torch.cuda.current_device())
    train_ds = make_loaders(cfg)[0]
    stream = train_ds.iter_compact_superbatches(K, B, False, cfg.data.native_threads, "aa",
                                                dtype=np.float16)
    host = next(stream)
    stream.close()
    batches = {"aa": torch.from_numpy(host["aa"]).to(dev).float()}
    shapes = eps_shapes(cfg, B)
    draws = [draw_noise(shapes, step_generator(cfg.run.seed, k)) for k in range(K)]
    eps = [torch.stack([d[lv] for d in draws]).to(dev) for lv in range(len(shapes))]
    states, metrics, runs, graphed = {}, {}, {}, {}
    for mode, g in (("group", group), ("no_group", None)):
        states[mode] = create_state(cfg, dev)
        multi = MultiStep(states[mode], cfg, graph=True, group=g)
        graphed[mode] = multi.graph
        multi(batches, eps)  # capture and the first call
        fcp.device_runs(dev.index, reset=True)
        metrics[mode] = {k: float(v) for k, v in multi(batches, eps).items()}
        runs[mode] = fcp.device_runs(dev.index)
    diff = state_diff(states["group"], states["no_group"])
    return {"steps": 2 * K, "batch": B, "graphed": graphed, "max_abs_diff": diff,
            "bit_equal": all(v == 0 for v in diff.values())
            and metrics["group"] == metrics["no_group"],
            "metrics": metrics, "device_runs_per_call": runs}


def ddp_train_phase(data_root):
    """30. Data-parallel training on the card.  (a) Two gloo ranks on
    cuda:0 (``chip_smoke.py --rank-audit`` under torchrun) train the
    len-64 VAE DDP_STEPS steps, batch 8 (4 a rank), on fixed global batches
    and noise: both ranks' parameters the same bits; the losses (averaged
    over the ranks) against the one-process run's in the training gate
    (1e-4 relative, and 10x the spread of a run from the init scaled by
    1 + 1e-7, as :func:`train_phase`); the parameters within Adam's
    amplification of last-place differences (at most 2 lr a step, on at
    most 1% of the elements beyond 1e-5); 8 / 7 / 8 kernel runs a step on
    each rank.  (b) In the same launch, ``hm_vae_torch.cli.train`` under
    the two ranks for 3 steps, then ``--resume`` to 5: only rank 0 writes
    under the output directory, both ranks print the same metrics.  (c) One
    NCCL rank, a group of one in this process (destroyed after): the
    production config's 32-step CUDA graph with the all-reduce captured in
    it, bit-equal to the graph without a group, 256 / 224 / 256 runs a
    call.  (d) In (a)'s launch, tensor parallelism: the two ranks at
    ``run.model_parallel`` 2 (data 1, the latent heads sharded over them)
    train the same DDP_STEPS steps: both ranks' parameters the same bits,
    the sharded heads after the first step the one-process step's bits, the
    losses and parameters in (a)'s gate, 8 / 7 / 8 runs a step on each rank;
    then ``hm_vae_torch.cli.train`` at model_parallel 2 ``--resume``s (b)'s
    checkpoint of step 5 (written at model_parallel 1) to step 7: only rank 0
    writes."""
    from hm_vae_torch.utils.config import load_config

    t_phase = time.perf_counter()
    out = os.path.join(OUT_DIR, "ddp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cfg = load_config(CONFIG)
    lr = cfg.optim.lr
    # (b)'s config: log every step, a snapshot at step 3
    cli_root = os.path.join(out, "cli")
    path = os.path.join(out, "len64_cli.yaml")
    with open(CONFIG) as f:
        text = f.read()
    for key, value in (("log_iter", 1), ("snapshot_save_iter", 3), ("validation_iter", 10 ** 9),
                       ("image_save_iter", 10 ** 9)):
        text, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {value}", text)
        if not n:
            text += f"\n{key}: {value}\n"
    with open(path, "w") as f:
        f.write(text)
    # (d)'s: the same at model_parallel 2, its name the same (the same output
    # directory: it resumes (b)'s checkpoint)
    os.makedirs(os.path.join(out, "mp2"))
    path_mp2 = os.path.join(out, "mp2", "len64_cli.yaml")
    with open(path_mp2, "w") as f:
        f.write(text + "\nmodel_parallel: 2\n")
    base = ["--config", path, "--output_path", cli_root, "--data_root", data_root]
    # (a), (b) and (d) in one launch: the steps, the CLI for 3 steps and again
    # with --resume, the steps at model_parallel 2 and the CLI at 2, in each rank
    prefix, tp_prefix = os.path.join(out, "steps"), os.path.join(out, "tp_steps")
    audits, seconds = audited(
        2, os.path.join(out, "audit"), cli_root,
        [("ddp_steps", [prefix, "1"], None),
         ("hm_vae_torch.cli.train", base + ["--max_iter", "3"], None),
         ("hm_vae_torch.cli.train", base + ["--max_iter", "5", "--resume"], None),
         ("ddp_steps", [tp_prefix, "2"], None),
         ("hm_vae_torch.cli.train", ["--config", path_mp2] + base[2:]
          + ["--max_iter", "7", "--resume"], None)], 400)
    # (a)
    one_first, one, one_losses, _ = ddp_steps(cfg)
    _, _, pert_losses, _ = ddp_steps(cfg, 1.0 + 1e-7)
    want_runs = {"conv_gemm_kernel": 8 * DDP_STEPS, "dgrad_kernel": 7 * DDP_STEPS,
                 "wgrad_kernel": 8 * DDP_STEPS}

    def steps_gate(what, run, prefix):
        """Both ranks' parameters the same bits; the losses and parameters
        against the one-process run's in the training gate; the kernels'
        runs a step on each rank."""
        reports = [a["runs"][run] for a in audits]
        first, params = ([dict(np.load(f"{prefix}_rank{r}_{w}.npz")) for r in range(2)]
                         for w in ("first", "last"))
        if any(not np.array_equal(p[0][n], p[1][n]) for p in (first, params) for n in p[0]):
            fail(f"{what}: the two ranks' parameters differ")
        for a, r in zip(audits, reports):
            if a["backend"] != "gloo" or r["device_runs"] != want_runs:
                fail(f"{what} rank {a['rank']}: backend {a['backend']}, device runs "
                     f"{r['device_runs']}, expected gloo and {want_runs}")
        two_losses = np.array(reports[0]["losses"])
        if reports[1]["losses"] != reports[0]["losses"]:
            fail(f"{what}: the ranks' averaged losses differ: {[r['losses'] for r in reports]}")
        rel = np.abs(two_losses / np.array(one_losses) - 1)
        band = 10 * np.maximum.accumulate(np.abs(np.array(pert_losses) / one_losses - 1)) + 1e-4
        diffs = {n: np.abs(params[0][n] - one[n]) for n in one}
        max_diff = max(float(d.max()) for d in diffs.values())
        share = sum(int((d > 1e-5).sum()) for d in diffs.values()) / sum(d.size for d in
                                                                        diffs.values())
        if not ((rel <= 1e-4).all() and (rel <= band).all() and max_diff <= 2 * lr * DDP_STEPS
                and share <= 0.01):
            fail(f"{what}: losses {two_losses.tolist()} against one process {one_losses} "
                 f"(rel {rel.tolist()}, band {band.tolist()}); parameters max |diff| "
                 f"{max_diff}, share beyond 1e-5 {share}")
        row = {"backend": audits[0]["backend"], "graphed": False, "ranks": 2,
               "device": "cuda:0 (shared)", "losses_two_ranks": two_losses.tolist(),
               "losses_one_process": one_losses, "rel_diff": rel.tolist(),
               "band": band.tolist(), "params_max_abs_diff": max_diff,
               "params_share_beyond_1e-5": share,
               "device_runs_per_rank": [r["device_runs"] for r in reports]}
        equal = [n for n in one if np.array_equal(first[0][n], one_first[n])]
        return row, equal

    steps_row, _ = steps_gate("ddp_train", 0, prefix)
    # (d)
    tp_row, equal_first = steps_gate("tensor_parallel", 3, tp_prefix)
    heads = sorted(n for n in one if n.split(".")[1].startswith("latent_"))
    if not set(heads) <= set(equal_first):
        fail(f"tensor_parallel: sharded heads {sorted(set(heads) - set(equal_first))} differ "
             "from the one-process run's after the first step")
    tp_row.update(model_parallel=2, data_parallel=1, sharded_leaves=len(heads),
                  heads_bit_equal_after_first_step=True,
                  params_bit_equal_after_first_step=f"{len(equal_first)} of {len(one)}")
    # (b) and (d)'s CLI
    ck = os.path.join(cli_root, "outputs", "len64_cli", "checkpoints")
    names = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
    # logged[run][rank]: the step lines each rank printed
    logged = [[[ln for ln in a["runs"][i]["stdout"].splitlines() if ln.startswith("[0")]
               for a in audits] for i in (1, 2, 4)]
    resumed = [[ln for a in audits for ln in a["runs"][i]["stdout"].splitlines()
                if ln.startswith("Resume from")] for i in (2, 4)]
    want_names = ["gen_00000003.pt", "gen_00000005.pt", "gen_00000006.pt", "gen_00000007.pt"]
    if (audits[1]["writes"] or names != want_names
            or any(lg[0] != lg[1] or not lg[0] for lg in logged)
            or resumed != [["Resume from iteration 3"] * 2, ["Resume from iteration 5"] * 2]
            or not any(w.endswith("gen_00000007.pt") for w in audits[0]["writes"])):
        fail(f"ddp_train cli: rank 1 wrote {audits[1]['writes']}, rank 0 "
             f"{audits[0]['writes']}; checkpoints {names}; logged {logged}; resumed {resumed}")
    cli_row = {"backend": audits[0]["backend"], "checkpoints": names,
               "rank0_writes": audits[0]["writes"], "rank1_writes": audits[1]["writes"],
               "logged_rank0": logged[1][0][-1], "logged_same_on_both_ranks": True,
               "resumed": resumed[0], "seconds_two_ranks_sharing_one_card_a_b_d": seconds}
    tp_row["cli"] = {"config": "len64_cli.yaml + model_parallel: 2", "resumed": resumed[1],
                     "logged_rank0": logged[2][0][-1], "logged_same_on_both_ranks": True}
    # (c) one NCCL rank, in this process (a group of one, destroyed after)
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        nccl = nccl_graph(data_root, dist.group.WORLD)
        nccl["backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
    want = {"conv_gemm_kernel": 256, "dgrad_kernel": 224, "wgrad_kernel": 256}
    if (nccl["backend"] != "nccl" or not nccl["bit_equal"] or not all(nccl["graphed"].values())
            or nccl["device_runs_per_call"]["group"] != want):
        fail(f"ddp_train nccl: {nccl}")
    row = {"phase": "ddp_train", "steps": steps_row, "cli": cli_row,
           "nccl_graph": {**nccl, "seconds": time.perf_counter() - t0},
           "tensor_parallel": tp_row, "elapsed_s": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return row


SOLVE_SHARED = {"opt_it": 12, "prev_epochs": 6}  # the shared clone's solve, cut from 150 / 50
# the per-window clones' solve, cut from 150 / 50 for the time limit (20 z
# and 9 clone iterations, the last through the clones)
SOLVE_PER_WINDOW = {"opt_it": 30, "prev_epochs": 19}


def parallel_solve_phase(vae_ck):
    """31. ``eval_recovery --data_parallel 2`` under two gloo ranks on the
    card (one torchrun launch, ``chip_smoke.py --rank-audit``) against the
    one-process run, on one synthetic test take of 10 windows
    (``configs/len_64_test_interpolation.yaml``, interpolation): the
    per-window clones at SOLVE_PER_WINDOW (30 iterations: 20 on z, 9 on
    the clones, the last through them), the shared clone at SOLVE_SHARED (12 iterations: 7 on z,
    5 on the clone, as phase 9's agreement solve, before Adam amplifies the
    summation order over the ranks).  The summary within the solve gate (10x the spread of a
    one-process run from the checkpoint scaled by 1 + 1e-7, + 1e-4
    relative), the outputs likewise; rank 0 writes every file, rank 1 none;
    each rank's kernel launches (windowed under per-window clones)."""
    from hm_vae_torch.cli import eval_recovery
    from hm_vae_torch.data import synthetic

    t_phase = time.perf_counter()
    out = os.path.join(OUT_DIR, "parallel_solve")
    shutil.rmtree(out, ignore_errors=True)
    data_root = os.path.join(out, "data")
    # 10 takes of 640 frames: the test split holds one, 10 windows of 64
    synthetic.generate_dataset(data_root, num_seqs=10, min_len=640, max_len=640, seed=SEED)
    blob = torch.load(vae_ck, map_location="cpu", weights_only=False)
    blob["state_dict"] = {k: v * (1 + 1e-7) if v.is_floating_point() else v
                          for k, v in blob["state_dict"].items()}
    pert_ck = os.path.join(out, "perturbed.pt")
    torch.save(blob, pert_ck)
    with open(LATENT_CONFIG) as f:
        latent_text = f.read()

    def cut(mode, depth):  # the latent config at `depth`, written for `mode`
        path = os.path.join(out, f"len_64_test_interpolation_{mode}.yaml")
        text = latent_text
        for key, value in depth.items():
            text, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {value}", text)
            if not n:
                fail(f"parallel_solve: the latent config names no {key}")
        with open(path, "w") as f:
            f.write(text)
        return path

    modes = (("per_window", cut("per_window", SOLVE_PER_WINDOW), []),
             ("shared", cut("shared", SOLVE_SHARED), ["--shared_decoder_clone"]))

    def base(config, extra):
        return ["--config", config, "--data_root", data_root,
                "--final_try_long_seq_interpolation", "--max_seqs", "1", "--device", DEV,
                "--seed", str(SEED)] + extra

    two = os.path.join(out, "two")
    audits, seconds = audited(
        2, os.path.join(out, "audit"), two,
        [("hm_vae_torch.cli.eval_recovery",
          base(c, e) + ["--test_model", vae_ck, "--output_path", os.path.join(two, m),
                        "--data_parallel", "2"], None) for m, c, e in modes], 400)
    rows = {}
    for i, (mode, config, extra) in enumerate(modes):
        name = os.path.splitext(os.path.basename(config))[0]
        res = {}
        for run, ck in (("one", vae_ck), ("perturbed", pert_ck)):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                eval_recovery.main(base(config, extra) + ["--test_model", ck, "--output_path",
                                                         os.path.join(out, run, mode)])
            torch.cuda.synchronize()
            res[f"{run}_seconds"] = time.perf_counter() - t0
        dirs = {run: os.path.join(out, run, mode, "eval_long_seq_interpolation", name)
                for run in ("one", "perturbed", "two")}
        summaries = {}
        for run, d in dirs.items():
            with open(os.path.join(d, "summary.json")) as f:
                summaries[run] = json.load(f)
        files = sorted(f for f in os.listdir(dirs["one"]) if f.endswith((".npy", ".json")))
        w0 = sorted(os.path.basename(w) for w in audits[0]["writes"]
                    if w.startswith(mode + os.sep) and w.endswith((".npy", ".json")))
        if audits[1]["writes"] or w0 != files or len(files) != 2:
            fail(f"parallel_solve {mode}: rank 0 wrote {audits[0]['writes']}, rank 1 "
                 f"{audits[1]['writes']}; the one-process run {files}")
        gate = {}
        for k, v in summaries["one"].items():
            if k == "num_seqs":
                if summaries["two"][k] != v:
                    fail(f"parallel_solve {mode}: num_seqs {summaries['two'][k]} != {v}")
                continue
            rel = abs(summaries["two"][k] / v - 1)
            band = 10 * abs(summaries["perturbed"][k] / v - 1) + 1e-4
            gate[k] = {"rel_diff": rel, "band": band}
            if rel > band:
                fail(f"parallel_solve {mode}: {k} {summaries['two'][k]} against {v} (rel {rel} "
                     f"> band {band})")
        res_file = next(f for f in files if f.endswith("_rot_opt_res.npy"))
        a, b, p = (np.load(os.path.join(dirs[r], res_file)) for r in ("two", "one", "perturbed"))
        out_err, out_band = float(np.abs(a - b).max()), 10 * float(np.abs(p - b).max()) + 1e-4
        if out_err > out_band or a.shape != (640, 24, 3, 3):
            fail(f"parallel_solve {mode}: rotations differ by {out_err} > {out_band}, shape "
                 f"{a.shape}")
        launches = [r["runs"][i]["launches"] for r in audits]
        windowed = all(n["fused_conv_pool_wgrad_windowed"] > 0 for n in launches)
        if windowed != (mode == "per_window") or not all(n["fused_conv_pool_dgrad"] > 0
                                                         for n in launches):
            fail(f"parallel_solve {mode}: launches per rank {launches}")
        rows[mode] = {"config": os.path.relpath(LATENT_CONFIG, ROOT) + " at "
                      + str(SOLVE_PER_WINDOW if mode == "per_window" else SOLVE_SHARED),
                      "windows": 10, "summary_two_ranks": summaries["two"],
                      "summary_one": summaries["one"], "gate": gate,
                      "rotations_max_abs_diff": out_err, "rotations_band": out_band,
                      "launches_per_rank": launches, **res}
    row = {"phase": "parallel_solve", "backend": audits[0]["backend"], "graphed": False,
           **rows, "seconds_two_ranks_sharing_one_card": seconds,
           "elapsed_s": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return row


SP_T = 7200
SP_TAIL = 4 * 15  # pad_incomplete: the last num_levels * halo frames see repeated frames


def sequence_parallel_phase(data_root, vae_ck, traj_ck, tmodel, gen):
    """32. The VALID-packed forward (padding 0) at the trajectory model's four
    levels on a rank's halo-extended shard of the 7,200-frame take (batch 1,
    3,600 + 2 x 15 frames), held and timed as phase 2's rows; then
    ``eval_trajectory --sequence_parallel 2`` under two gloo ranks on the
    card (torchrun, ``chip_smoke.py --rank-audit``) on a 7,200-frame
    synthetic take against the one-process run (the runner unsharded):
    within the f32 kernel tolerance; at 7,201 frames (pad_incomplete) all
    but the last 4 x 15 frames; ``--sequence_parallel_strict`` at 7,201
    raising on the ranks; rank 0 writing the files; each rank's 4
    launches of the VALID-packed forward a run.  Returns (the VALID rows,
    the phase's row)."""
    from hm_vae_torch.cli import eval_trajectory
    from hm_vae_torch.data import layout, synthetic

    t_phase = time.perf_counter()
    halo = (tmodel.cfg.kernel_size - 1) // 2
    valid = [fwd_level_row(f"traj{i}_valid_b1_t{SP_T // 2}", getattr(tmodel.encoder, f"conv_{i}"),
                           SP_T // 2 + 2 * halo, 1, 1, torch.float32, gen, padding=0)
             for i in range(len(tmodel.encoder.structure.levels))]
    out = os.path.join(OUT_DIR, "sequence_parallel")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    frames = synthetic.synth_sequence(np.random.default_rng(SEED + 32), SP_T + 1)
    rm = frames[:, layout.ROTMAT].reshape(SP_T + 1, 24, 3, 3)
    folder = os.path.join(out, "takes")
    os.makedirs(folder)
    for T in (SP_T, SP_T + 1):
        np.save(os.path.join(folder, f"take{T}.npy"), rm[:T])
    base = ["--config", CONFIG, "--test_model", vae_ck, "--trajectory_config", TRAJ_CONFIG,
            "--trajectory_test_model", traj_ck, "--data_root", data_root, "--device", DEV]
    takes = ["--seq_generation_npy_folder", folder]  # both takes in one run
    one, two = os.path.join(out, "one"), os.path.join(out, "two")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        eval_trajectory.main(base + takes + ["--output_path", one])
    torch.cuda.synchronize()
    one_seconds = time.perf_counter() - t0
    # one launch: both takes, then --sequence_parallel_strict raising at 7,201
    strict = ["--seq_generation_npy_path", os.path.join(folder, f"take{SP_T + 1}.npy"),
              "--output_path", os.path.join(out, "strict"), "--sequence_parallel", "2",
              "--sequence_parallel_strict"]
    audits, seconds = audited(
        2, os.path.join(out, "audit"), two,
        [("hm_vae_torch.cli.eval_trajectory",
          base + takes + ["--output_path", two, "--sequence_parallel", "2"], None),
         ("hm_vae_torch.cli.eval_trajectory", base + strict,
          f"T={SP_T + 1} not divisible by 2 shards")], 300)
    names = sorted(f"take{T}_traj_0{sfx}.npy" for T in (SP_T, SP_T + 1) for sfx in ("", "_trans"))
    w0 = sorted(os.path.basename(w) for w in audits[0]["writes"] if w.endswith(".npy"))
    if audits[1]["writes"] or w0 != names:
        fail(f"sequence_parallel: rank 0 wrote {audits[0]['writes']}, rank 1 "
             f"{audits[1]['writes']}")
    launches = [r["runs"][0]["launches"] for r in audits]
    if any(n["fused_conv_pool"] != 8 or sum(n.values()) != 8 for n in launches):
        fail(f"sequence_parallel: launches per rank {launches}, expected 4 forward a take")
    if not all(r["runs"][1]["error"] for r in audits):
        fail("sequence_parallel strict: a rank did not raise")
    rows = {}
    for T in (SP_T, SP_T + 1):
        keep = T if T % 2 == 0 else T - SP_TAIL
        errs = {}
        for f in (f"take{T}_traj_0.npy", f"take{T}_traj_0_trans.npy"):
            d = os.path.join("eval_trajectory", os.path.splitext(os.path.basename(CONFIG))[0], f)
            a, b = np.load(os.path.join(two, d)), np.load(os.path.join(one, d))
            if a.shape != b.shape or a.shape[0] != T:
                fail(f"sequence_parallel {f}: shapes {a.shape} / {b.shape}")
            errs[f] = check(f"sequence_parallel {f} (first {keep} frames)",
                            torch.from_numpy(a[:keep]), torch.from_numpy(b[:keep]),
                            torch.float32)[0]
        rows[f"t{T}"] = {"compared_frames": keep, "max_abs_err": errs}
    rows.update(backend=audits[0]["backend"], graphed=False, launches_per_rank=launches,
                seconds_one_process=one_seconds, seconds_two_ranks_sharing_one_card=seconds)
    row = {"phase": "sequence_parallel", **rows,
           "strict_error": audits[0]["runs"][1]["error"],
           "valid_plans": [r["plan"] for r in valid],
           "elapsed_s": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return valid, row


# phases 33-34: the compact parameter layout, and training with adapters

NEW_STEPS = 5  # the steps of phases 33 and 34's training gates
LORA_TRAIN_RANK = 16


def compact_phase(data_root, vae_ck, x6d):
    """33. ``model.param_layout: compact`` on the card.  (a) The len-64 VAE
    with it, NEW_STEPS steps of ``Trainer.fit`` on the card against the CPU
    in phase 6's gate, 8 / 7 / 8 launches a step.  (b) On the card against
    the dense layout from the same weights (the compact model loaded with
    the dense init's live entries), batches and noise: every step's loss,
    every live entry and its Adam moments the same bits.  (c) Phase 7's
    dense checkpoint resumed compact, written, and resumed dense: the live
    entries and moments the same bits, the dead entries zeros.  (d) The
    serving forward (``VAEInference.mean_reconstruction``, packed operands)
    of the compact model at batch 8 and 237, the dense model's bits, 8
    launches a reconstruct."""
    from hm_vae_torch.apps.inference import VAEInference
    from hm_vae_torch.models import param_layout as pl
    from hm_vae_torch.models.hm_vae import HMVAE, SkeletonConv
    from hm_vae_torch.ops import rotations as rot
    from hm_vae_torch.ops.fused_conv_pool import fused_conv_pool
    from hm_vae_torch.train.trainer import Trainer, build_trainer

    t_phase = time.perf_counter()
    compact = {"param_layout": "compact"}
    train = train_phase(data_root, CONFIG, TRAIN_LAUNCHES, "train_compact", NEW_STEPS, compact)
    cfg_d, cfg_c = train_config(data_root), train_config(data_root, model=compact)
    out = os.path.join(OUT_DIR, "compact")
    shutil.rmtree(out, ignore_errors=True)

    def live_state(trainer):
        """(parameters, optimizer state) in the compact layout."""
        sd = trainer.state.model.state_dict()
        opt = trainer.state.optimizer.state_dict()
        if trainer.cfg.model.param_layout == "dense":
            names = [n for n, _ in trainer.state.model.named_parameters()]
            sd = pl.convert_state_dict(sd, cfg_d.model, "compact")
            opt = pl.convert_optimizer_state(opt, names, cfg_d.model, "compact")
        return sd, opt

    def same_bits(a, b):
        (sa, oa), (sb, ob) = live_state(a), live_state(b)
        return (sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
                and all(torch.equal(t, ob["state"][i][k]) for i, st in oa["state"].items()
                        for k, t in st.items()))

    # (b)
    runs, init = {}, None
    for name, cfg in (("dense", cfg_d), ("compact", cfg_c)):
        trainer, train_ds, _, _ = build_trainer(cfg, os.path.join(out, name), device=DEV)
        if init is None:  # copies: the dense run trains its tensors in place
            init = {k: v.clone() for k, v in pl.convert_state_dict(
                trainer.state.model.state_dict(), cfg_d.model, "compact").items()}
        else:
            trainer.state.model.load_state_dict(init)
        losses = []
        trainer.fit(train_ds, None, max_iter=NEW_STEPS,
                    log_cb=lambda step, m: losses.append(m["loss_total"]))
        runs[name] = (trainer, losses)
    if runs["dense"][1] != runs["compact"][1] or not same_bits(runs["dense"][0],
                                                               runs["compact"][0]):
        fail(f"compact: the layouts' runs differ: losses {runs['dense'][1]} (dense), "
             f"{runs['compact'][1]} (compact)")
    n_live = sum(p.numel() for p in runs["compact"][0].state.model.parameters())
    n_dense = sum(p.numel() for p in runs["dense"][0].state.model.parameters())
    # (c)
    resumed_c = Trainer(cfg_c, os.path.join(out, "resume_c"), device=DEV)
    resumed_d = Trainer(cfg_d, os.path.join(out, "resume_d"), device=DEV)
    steps = (resumed_c.resume(vae_ck), resumed_d.resume(vae_ck))
    back = Trainer(cfg_d, os.path.join(out, "back"), device=DEV)
    steps += (back.resume(resumed_c.save()),)
    zeros = all(bool((m.weight[~m.mask.bool()] == 0).all())
                for m in back.state.model.modules()
                if isinstance(m, SkeletonConv) and m.mask is not None)
    if (len(set(steps)) != 1 or not same_bits(resumed_c, resumed_d)
            or not same_bits(back, resumed_c) or not zeros):
        fail(f"compact: resume across layouts: steps {steps}, zeros {zeros}")
    # (d)
    rng = np.random.default_rng(SEED + 33)
    T = cfg_d.model.train_seq_len
    aa = torch.from_numpy((rng.normal(size=(VIBE_BATCH, T, 24, 3)) * 0.3).astype(np.float32))
    cases = {BATCH: x6d, VIBE_BATCH: rot.rotmat_to_rot6d(rot.aa_to_rotmat(aa)).to(DEV)}
    dense_model = HMVAE(cfg_d.model, cfg_d.optim.init,
                        generator=torch.Generator().manual_seed(SEED))
    compact_model = HMVAE(cfg_c.model)
    compact_model.load_state_dict(pl.convert_state_dict(dense_model.state_dict(), cfg_d.model,
                                                        "compact"))
    serve = {}
    for batch, x in cases.items():
        outs = {}
        for name, m in (("dense", dense_model), ("compact", compact_model)):
            infer = VAEInference(m, cfg_d, device=DEV)
            fused_conv_pool.launches = 0
            outs[name] = infer.mean_reconstruction(x)
            torch.cuda.synchronize()
            if fused_conv_pool.launches != 8:
                fail(f"compact: {fused_conv_pool.launches} launches a reconstruct ({name})")
        if not all(torch.equal(a, b) for a, b in zip(outs["dense"], outs["compact"])):
            fail(f"compact: the serving forward differs from the dense one at batch {batch}")
        serve[batch] = {"bit_equal": True, "launches": 8}
    row = {"phase": "compact", "config": os.path.relpath(CONFIG, ROOT),
           "train_gpu_vs_cpu": {k: train[k] for k in ("max_rel_diff", "launches_per_step",
                                                      "ms_per_step")},
           "dense_vs_compact_on_card": {"steps": NEW_STEPS, "losses": runs["compact"][1],
                                        "losses_bit_equal": True,
                                        "live_entries_and_moments_bit_equal": True,
                                        "parameters": {"compact": n_live, "dense": n_dense}},
           "resume_across_layouts": {"steps": steps, "bit_equal": True,
                                     "dead_entries_zero": zeros},
           "serving_forward": serve, "elapsed_s": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return row


def lora_train_phase(data_root, model, st, gen):
    """34. Training a VAE with adapters: the len-64 VAE with ``model.lora_rank``
    LORA_TRAIN_RANK (a nested ``model: {lora_rank: 16}``), NEW_STEPS steps of
    ``Trainer.fit`` on the card against the CPU in phase 6's gate, 8 / 7 / 8
    launches a step (the decoder's base convs at slope 1.0 without bias: the
    forward, dgrad and wgrad of a trained weight); then the kernels at that
    operating point (the four decoder convs' folded weights, slope 1.0, no
    bias, batch 8, not windowed): the forward (two runs bit-equal), dgrad and
    wgrad against their plain versions and autograd, two runs bit-equal,
    timed as phase 5's rows beside cuDNN's conv1d / conv1d_input /
    conv1d_weight."""
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.losses import eps_shapes
    from hm_vae_torch.train.train_step import create_state

    t_phase = time.perf_counter()
    train = train_phase(data_root, CONFIG, TRAIN_LAUNCHES, "train_lora", NEW_STEPS,
                        {"lora_rank": LORA_TRAIN_RANK})
    # the launches at the decoder's 4 base convs, counted: one forward and
    # backward of the decoder alone (its latents need a gradient, as a
    # step's do), then of the encoder alone (its input is data), of the
    # model the Trainer builds; the two must make up the step's counts
    lcfg = train_config(data_root, CONFIG, {"lora_rank": LORA_TRAIN_RANK})
    lmodel = create_state(lcfg, DEV).model
    counters = (fcp.fused_conv_pool, fcp.fused_conv_pool_dgrad, fcp.fused_conv_pool_wgrad)

    def counted(loss):
        for c in counters:
            c.launches = 0
        loss().backward()
        torch.cuda.synchronize()
        return {c.__name__: c.launches for c in counters}

    z = [torch.randn(s, generator=gen).to(DEV).requires_grad_()
         for s in eps_shapes(lcfg, BATCH)]
    x = torch.randn((BATCH, lcfg.model.train_seq_len, 24, 6), generator=gen).to(DEV)
    dec = counted(lambda: lmodel.decode(z).float().square().sum())
    enc = counted(lambda: sum(s.float().square().sum() for s in lmodel.encode(x)[1]))
    if (any(dec[k] + enc[k] != train["launches_per_step"][k] for k in dec)
            or not all(dec.values())):
        fail(f"lora_train: the decoder's launches {dec} and the encoder's {enc} do not make "
             f"up a step's {train['launches_per_step']}, or a kernel ran no time")
    fwd, bwd = [], []
    for name, conv, T_in in level_cases(model, st):
        if not name.startswith("dec"):
            continue
        base = copy.deepcopy(conv)
        base.negative_slope, base.bias = 1.0, None
        fwd.append(fwd_level_row(f"{name}_lora_train_base", base, T_in, base.spec.stride, BATCH,
                                 torch.float32, gen, bits=True))
        bwd.append(bwd_level_row(f"{name}_lora_train_base", base, T_in, BATCH, gen))
    row = {"phase": "lora_train", "rank": LORA_TRAIN_RANK, "steps": NEW_STEPS,
           "launches_per_step": train["launches_per_step"],
           "launches_decoder": dec, "launches_encoder": enc,
           "ms_per_step": train["ms_per_step"], "max_rel_diff": train["max_rel_diff"],
           "elapsed_s": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return row, fwd, bwd


# phase 35: the production config with bf16 conv compute, the JAX package's
# "MAX-PERF triple" (bf16 parameters, moments and compute; its bench.py)
BF16_TRIPLE = {"compute_dtype": "bfloat16"}
# its GPU-against-CPU band: batches scaled by 1 + 2^-7 after the upcast.  The
# first conv casts its input to bf16 (8 significant bits), where 1 + 1e-7
# rounds away and would leave the band at its 1e-4 floor; 2^-7 is one bf16
# step, which survives the cast
BF16_SCALE = 1.0 + 2.0 ** -7
BF16_AGREEMENT_STEPS = 8  # (c): two 4-step calls
BF16_AGREEMENT_BATCH = 4  # (c)'s batch: the CPU side's bf16 steps set the phase's time
BF16_CONVERGE_STEPS = 40  # (d): tests/test_train_step.py's criterion
BF16_TRAJ_STEPS = 4
# the bf16 instantiations of the whole-row backward kernels (build_report)
BF16_BWD_KINDS = ("dgrad_bf16", "wgrad_bf16", "wgrad_nq4_bf16")
# the wgrad item kernel's forms (build_report): f32 and bf16, items of one
# batch's columns (one or two m64 tiles a warpgroup) and of several batches'
# whole rows
WGRAD_ITEM_KINDS = tuple(f"wgrad_spans_{f}{d}" for d in ("", "_bf16")
                         for f in ("nt1", "nt2", "rows"))
# wgrad's tile kernel (build_report), f32 and bf16: wgmma in both
WGRAD_TILE_KINDS = ("wgrad_tiles", "wgrad_tiles_bf16")
# dgrad's tile kernel (build_report), f32 and bf16 at each N tile: wgmma
DGRAD_TILE_KINDS = tuple(f"dgrad_tiles_n{n}{d}" for d in ("", "_bf16") for n in (8, 16, 32, 64))


# (d)'s small model: tests/test_train_step.py's TINY config (latent 6, K 3,
# 8 frames), batch 4, as JAX's criterion runs it
BF16_TINY = {"latent_d": 6, "shallow_latent_d": 6, "kernel_size": 3, "train_seq_len": 8}


def _criterion_run(cfg, batch, steps):
    """`steps` eager steps of a fresh state on one fixed batch, fresh noise
    each step: the losses, the entries' launch counts and the device's."""
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.losses import draw_noise, eps_shapes
    from hm_vae_torch.train.train_step import create_state, train_step
    from hm_vae_torch.train.trainer import step_generator

    shapes = eps_shapes(cfg, cfg.optim.batch_size)
    state = create_state(cfg, DEV)
    for c in fcp.launch_entries():
        c.launches = 0
    fcp.device_runs(torch.cuda.current_device(), reset=True)
    out = []
    for k in range(steps):
        eps = [e.to(DEV) for e in draw_noise(shapes, step_generator(cfg.run.seed, k))]
        out.append(float(train_step(state, batch, cfg, eps)["loss_total"]))
    return (np.array(out), {k: v for k, v in fcp.launch_counts().items() if v},
            fcp.device_runs(torch.cuda.current_device()))


def bf16_converge(data_root):
    """(d) JAX's convergence criterion for the triple
    (``tests/test_train_step.py::test_bf16_params_track_f32_training``), on
    the card, each run BF16_CONVERGE_STEPS eager steps on one fixed batch
    (fresh noise each step) from the same init: the triple's last loss below
    0.9x the reference run's first (and its own first), and the means of
    the last 10 losses within 15%.  Two cases: JAX's own (its TINY model,
    batch 4, lr 1e-3, the triple against f32 parameters, moments and
    compute), and the production config at batch 8 and its own lr (1e-4)
    against the same config at f32 compute (bf16 parameters and moments
    both).  At lr 1e-3 the production model does not meet the criterion at
    f32 compute either (a loss that rises between; PERF.md).  The entries'
    and the device's counts over the production triple's steps are 8 / 7 /
    8 a step."""
    from hm_vae_torch.data.dataset import make_loaders
    from hm_vae_torch.utils import config as tcfg

    n = BF16_CONVERGE_STEPS
    aa = np.random.default_rng(SEED).normal(size=(4, 8, 24, 3)).astype(np.float32) * 0.3
    tiny = {"aa": torch.from_numpy(aa).to(DEV)}
    out = {}
    for case in ("jax_tiny", "production"):
        losses, launches = {}, {}
        for triple in (True, False):
            if case == "jax_tiny":
                pd = "bfloat16" if triple else "float32"
                cfg = tcfg.Config(
                    model=tcfg.ModelConfig(**BF16_TINY, compute_dtype=pd),
                    loss=tcfg.LossConfig(iteration_interval=5),
                    optim=tcfg.OptimConfig(lr=1e-3, batch_size=4, param_dtype=pd,
                                           moment_dtype=pd))
                batch = tiny
            else:
                cfg = production_config(
                    data_root, optim={"batch_size": BATCH},
                    model={"compute_dtype": "bfloat16" if triple else "float32"})
                stream = make_loaders(cfg)[0].iter_compact_superbatches(
                    1, BATCH, False, cfg.data.native_threads, "aa", dtype=np.float16)
                batch = {"aa": torch.from_numpy(next(stream)["aa"][0]).to(DEV).float()}
                stream.close()
            losses[triple], entries, runs = _criterion_run(cfg, batch, n)
            launches[triple] = {"entries": entries, "device": runs}
        bf, ref = losses[True], losses[False]
        rel = abs(bf[-10:].mean() - ref[-10:].mean()) / ref[-10:].mean()
        if not (np.isfinite(bf).all() and np.isfinite(ref).all() and bf[-1] < 0.9 * ref[0]
                and bf[-1] < 0.9 * bf[0] and rel < 0.15):
            fail(f"bf16 convergence ({case}): losses {bf.tolist()} against {ref.tolist()} "
                 f"(last-10 means {rel:.3f} apart)")
        out[case] = {"steps": n, "lr": cfg.optim.lr, "batch": cfg.optim.batch_size,
                     "loss_triple": bf.tolist(), "loss_reference": ref.tolist(),
                     "last10_rel_diff": rel, "launches_in_run": launches[True]["entries"],
                     "device_runs_in_run": launches[True]["device"]}
    prod = out["production"]
    want = {"entries": {k: n * v for k, v in TRAIN_LAUNCHES.items()},
            "device": {TRACE_NAME[k]: n * v for k, v in TRAIN_LAUNCHES.items()}}
    got = {"entries": prod["launches_in_run"], "device": prod["device_runs_in_run"]}
    if got != want:
        fail(f"bf16 convergence: launches {got} over {n} production steps, expected {want}")
    prod["launches_per_step"] = {k: v // n for k, v in prod["launches_in_run"].items()}
    return out


def bf16_trajectory_steps(data_root, path=TRAJ_CONFIG, steps=BF16_TRAJ_STEPS,
                          name="bf16_trajectory", agree=False):
    """The trajectory model (``path``: K 31, batch 8, T 128, routed to
    dgrad's spans and wgrad's items; or a copy at train_seq_len 1,024, rows
    past a whole-row block) at bf16 compute, `steps` Trainer.fit steps on
    the card: finite losses, and the kernels' runs on the device 4 / 3 / 4
    a step (the bf16 span and item kernels).  With `agree` the same steps
    on the CPU from the same init, batches and noise, every step's loss
    within the band that production_agreement_phase holds the len-64
    triple to: 10x the larger spread of runs whose batches are scaled by
    BF16_SCALE (1 + 2^-7) after the upcast on each side, + 1e-4; steps 1-3
    also within 2^-7 relative."""
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.train.train_step import loss_fields, to_device, train_step
    from hm_vae_torch.train.trainer import build_trainer

    cfg = train_config(data_root, path, BF16_TRIPLE)
    agreement = None
    if agree:
        losses = {}
        for run, dev, sc in (("cpu", "cpu", 1.0), ("gpu_perturbed", DEV, BF16_SCALE),
                             ("cpu_perturbed", "cpu", BF16_SCALE)):
            tr, ds, _, _ = build_trainer(cfg, os.path.join(OUT_DIR, f"{name}_{run}"), device=dev)
            if sc != 1.0:
                perturb_inputs(tr, sc)
            losses[run] = []
            tr.fit(ds, None, max_iter=steps,
                   log_cb=lambda step, m, out=losses[run]: out.append(m["loss_total"]))
    trainer, train_ds, _, _ = build_trainer(cfg, os.path.join(OUT_DIR, name), device=DEV)
    for c in fcp.launch_entries():
        c.launches = 0
    fcp.device_runs(torch.cuda.current_device(), reset=True)
    out = []
    trainer.fit(train_ds, None, max_iter=steps,
                log_cb=lambda step, m: out.append(m["loss_total"]))
    entries = {k: v for k, v in fcp.launch_counts().items() if v}
    runs = fcp.device_runs(torch.cuda.current_device())
    want = {TRACE_NAME[k]: steps * v for k, v in TRAJ_TRAIN_LAUNCHES.items()}
    if runs != want or len(out) != steps or not np.isfinite(out).all():
        fail(f"{name}: losses {out}, device runs {runs}, expected {want}")
    plans = fcp.last_backward_plans()
    if agree:
        loss = {k: np.array(v, np.float64) for k, v in {"gpu": out, **losses}.items()}
        if any(len(v) != steps or not np.isfinite(v).all() for v in loss.values()):
            fail(f"{name}: losses {loss}")
        rel = np.abs(loss["gpu"] / loss["cpu"] - 1)
        spread = {d: np.maximum.accumulate(np.abs(loss[f"{d}_perturbed"] / loss[d] - 1))
                  for d in ("gpu", "cpu")}
        # the calibrated band is wide (a 1 + 2^-7 batch scale moves the
        # loss ~1.6%): steps 1-3 are also held to a fixed 2^-7 relative
        band = 10 * np.maximum(spread["gpu"], spread["cpu"]) + 1e-4
        band[:3] = np.minimum(band[:3], 2.0 ** -7)
        if not (rel <= band).all():
            fail(f"{name}: GPU vs CPU loss relative difference {rel.tolist()} outside "
                 f"{band.tolist()}")
        agreement = {"perturbation": BF16_SCALE, "loss_cpu": loss["cpu"].tolist(),
                     "rel_diff": rel.tolist(), "band": band.tolist(), "fixed": 2.0 ** -7,
                     "spread": {k: v.tolist() for k, v in spread.items()}}
    # the step's cost on the trained state, as train_phase takes it
    batch = to_device(train_ds.sample_batch(cfg.optim.batch_size), DEV,
                      loss_fields(trainer.state.model))
    noise = torch.Generator()

    def step():
        return train_step(trainer.state, batch, cfg, generator=noise.manual_seed(0),
                          mean_std=trainer.mean_std)

    prof = profile_calls(step, calls=5)
    return {"config": os.path.relpath(path, ROOT), "model_overrides": BF16_TRIPLE,
            "train_seq_len": cfg.model.train_seq_len, "steps": steps, "losses": out,
            "entry_launches_in_run": entries, "device_runs_in_run": runs, "plans": plans,
            **({"agreement": agreement} if agree else {}),
            "ms_per_step": time_ms(step, reps=10, samples=5), "cost": step_cost(prof),
            "profile": prof}


def bf16_train_phase(data_root, model, st, tmodel, gen):
    """35. Training with bf16 conv compute (``compute_dtype: bfloat16`` on
    ``configs/len64_production.yaml``: the JAX package's bf16 parameters +
    moments + compute triple), through the bf16 whole-row dgrad and wgrad:
    (a) both kernels in bf16 at the 8 len-64 levels (batch 8 and 64) and
    the trajectory model's 4 K-31 levels (batch 8, T 128), as phase 5 holds
    and times them at TOL[bf16]; (b) the triple's 32-step call at batch 64,
    the CUDA graph against the same steps eagerly (bit for bit, phase 21's
    gate), then its cost through Trainer.fit (ms a step by events, device
    ms, idle share, peak memory, 8 / 7 / 8 device runs a step; graph only);
    (c) GPU against CPU at batch 4, 4 steps a call, BF16_AGREEMENT_STEPS
    steps, in a band calibrated by batches scaled by BF16_SCALE (1 + 2^-7)
    on both sides and no separate first-call bound: the two sides round
    each level's bf16 output after sums in another order; (d) JAX's
    convergence criterion (:func:`bf16_converge`: at JAX's own small config
    and lr 1e-3, and on the production config at its lr); (e) the training CLI on
    the YAML with ``compute_dtype: bfloat16`` added, 2 calls then
    ``--resume``; and the trajectory model at bf16 compute for a few steps
    (:func:`bf16_trajectory_steps`).  Returns the kernel rows by case and
    the step's, the convergence runs' and the trajectory's rows."""
    t_phase = time.perf_counter()
    seconds, last = {}, [t_phase]

    def part(name):  # the seconds since the last part ended
        t = time.perf_counter()
        seconds[name], last[0] = t - last[0], t

    bf16 = torch.bfloat16
    kernels = {case: [bwd_level_row(f"{n}@bf16_{case}", c, T, batch, gen, dtype=bf16)
                      for n, c, T in level_cases(model, st)]
               for case, batch in (("b8", BATCH), ("b64", PROD_BATCH))}
    kernels["trajectory"] = [
        bwd_level_row(f"traj{i}@bf16_trajectory", getattr(tmodel.encoder, f"conv_{i}"),
                      tmodel.cfg.train_seq_len, BATCH, gen, dtype=bf16)
        for i in range(len(tmodel.encoder.structure.levels))]
    part("a_kernels")
    graph = graph_agreement_phase(data_root, BF16_TRIPLE, "bf16_graph_vs_eager")
    if not graph["bit_equal"]:
        fail(f"bf16 triple: the graphed steps differ from the eager ones: {graph['max_abs_diff']}")
    part("b_graph_vs_eager")
    step = production_step_phase(data_root, calls=1, model=BF16_TRIPLE, eager=False,
                                 phase="bf16_step", profiled=1)
    part("b_step_cost")
    agree = production_agreement_phase(data_root, BF16_AGREEMENT_STEPS, BF16_TRIPLE,
                                       BF16_SCALE, None, "bf16_agreement",
                                       BF16_AGREEMENT_BATCH)
    part("c_agreement")
    converge = bf16_converge(data_root)
    part("d_convergence")
    cli = production_cli_phase(data_root, calls=2, compute_dtype="bfloat16")
    part("e_cli")
    traj = bf16_trajectory_steps(data_root, agree=True)
    part("trajectory")
    g = step["graph_steps_per_call_32"]
    row = {"phase": "bf16_train", "config": os.path.relpath(PRODUCTION_CONFIG, ROOT),
           "model_overrides": BF16_TRIPLE,
           "graph_vs_eager": {k: graph[k] for k in ("bit_equal", "max_abs_diff", "launches")},
           "step": {k: g[k] for k in ("ms_per_step", "device_ms_per_step", "dgrad_ms_per_step",
                                      "wgrad_ms_per_step",
                                      "idle_share",
                                      "peak_memory_bytes", "peak_above_start_bytes",
                                      "device_runs_per_32_steps",
                                      "trace_launches_per_32_steps")},
           "agreement": {k: agree[k] for k in ("batch", "rel_diff", "band", "perturbation",
                                               "loss_gpu", "loss_cpu", "fit_seconds")},
           "convergence": converge, "cli": {k: cli[k] for k in ("resumed", "runs",
                                                               "checkpoints_after_resume")},
           "trajectory": traj, "seconds": seconds, "elapsed_s": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    return kernels, step, converge, traj, cli["checkpoint"]



# the windowed kernels' rows of the summary: (row key, entry suffix, source,
# what it replaces, the grouped cuDNN call timed beside it)
WINDOWED_KINDS = (
    ("fwd", "", "fused_conv_pool.cu", "hm_vae_tpu/ops/pallas_kernels.py:65", "conv1d"),
    ("dgrad", "_dgrad", "fused_conv_pool_bwd.cu", "hm_vae_tpu/models/hm_vae.py:200",
     "torch.nn.grad.conv1d_input"),
    ("wgrad", "_wgrad", "fused_conv_pool_bwd.cu", "hm_vae_tpu/models/hm_vae.py:200",
     "torch.nn.grad.conv1d_weight"))
# (b): 4 windows of one batch at 512 frames, where the top decoder levels'
# padded rows (256 + 14 and 512 + 14 columns) pass a whole-row block's 256
LONG_WINDOWS, LONG_FRAMES, LONG_LEVELS = 4, 512, ("dec2", "dec3")


@contextlib.contextmanager
def backward_dtypes(counts):
    """While open, counts the backward kernels' launches in `counts` by
    entry and dtype (``dgrad_windowed@bfloat16``, ...)."""
    from hm_vae_torch.ops import fused_conv_pool as fcp

    dgrad, wgrad = fcp._dgrad, fcp._wgrad

    def counted(fn, what, at):
        def run(gy, *args, **kw):
            out = fn(gy, *args, **kw)
            key = f"{what}{'_windowed' if args[at] is not None else ''}@" + str(
                gy.dtype).replace("torch.", "")
            counts[key] = counts.get(key, 0) + 1
            return out
        return run

    fcp._dgrad, fcp._wgrad = counted(dgrad, "dgrad", 4), counted(wgrad, "wgrad", 3)
    try:
        yield counts
    finally:
        fcp._dgrad, fcp._wgrad = dgrad, wgrad


def bf16_solve_phase(data_root, lmodel, gen, seq, ck=None, clone_solve=None):
    """36. The test-time solve at ``compute_dtype: bfloat16`` (per-window
    decoder clones through the windowed bf16 forward, dgrad and wgrad):
    (a) the three windowed kernels in bf16 at the 4 decoder levels, 10
    windows of one batch (:func:`windowed_phase`: 0.02 * max|ref| of the
    plain versions and of autograd of the plain forward, of 10 one-window
    launches, two runs bit-equal; timed beside the plain versions and
    cuDNN's grouped bf16 convolution, bounds at bf16 bytes and 989
    TFLOP/s); (b) the windowed span and item kernels, f32 and bf16, at 4
    windows of LONG_FRAMES frames at the top two levels, whose launches
    must run spans and items, the whole-row bf16 wgrad timed beside the
    items; (c) an AGREE_IT-iteration 10-window solve at bf16 compute and
    the production solver dtypes (bf16 clone and moments) on the GPU
    against the CPU (:func:`solve_agreement_phase`, its band never under
    2^-7, phase 35's bf16 floor); (d) the full solves at bf16 compute with those
    dtypes: per-window (2 repetitions), shared and lora (once each), each
    profiled, launches counted by the entries and by the device exactly as
    the f32 solves', beside the f32 per-window solve (2 repetitions, here:
    all after the agreements' last CPU run) and the device time and peak of
    the f32-compute bf16-clone solve (`clone_solve`, phase 18's row, where
    given); (e) ``eval_recovery``
    under ``configs/len64_production.yaml`` with ``compute_dtype:
    bfloat16`` added, on the triple-trained checkpoint `ck` (phase 35's
    CLI; made here when absent), on the synthetic test split: its files
    and summary, its windowed backward launches all bf16, the device's
    runs the entries' sums.  Returns (a)'s rows, (b)'s rows by dtype and
    (d)'s rows."""
    from hm_vae_torch.apps.tasks import LatentOptApps
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import fused_conv_pool as fcp

    t_phase = time.perf_counter()
    seconds, last = {}, [t_phase]

    def part(name):  # the seconds since the last part ended
        t = time.perf_counter()
        seconds[name], last[0] = t - last[0], t

    bf16 = torch.bfloat16
    cfg = latent_config(BF16_COMPUTE)
    st = get_structure(cfg.model)
    model = HMVAE(cfg.model, cfg.optim.init,
                  generator=torch.Generator().manual_seed(SEED)).to(DEV)
    # (a) the solve's shapes
    rows = windowed_phase(model, st, gen, bf16, tag="@bf16")
    part("a_kernels")
    # (b) long windows: dgrad's spans and wgrad's items over windows
    long_rows = {str(dt).replace("torch.", ""): windowed_phase(
        m, st, gen, dt, LONG_WINDOWS, LONG_FRAMES, LONG_LEVELS,
        f"@long{LONG_FRAMES}_{str(dt).replace('torch.', '')}", spans=True)
        for dt, m in ((torch.float32, lmodel), (bf16, model))}
    part("b_long_windows")
    # (c) GPU against CPU
    agree = solve_agreement_phase(seq, "solve_agreement_bf16")
    part("c_agreement")
    # (d) the full solves
    lat = cfg.latent_opt
    n_z = min(lat.prev_epochs + 1, lat.opt_it - 1)
    n_d = lat.opt_it - 1 - n_z
    LatentOptApps(model, latent_config(BF16_COMPUTE, opt_it=3, prev_epochs=0)).interpolate(
        seq, torch.Generator().manual_seed(SEED))  # warm-up: structures
    f32_solve = mode_solve(lmodel, seq, "f32 per_window solve", {},
                           (4 * n_z, 4 * n_z, 0, 4 * (n_d + 1), 4 * n_d, 4 * n_d), reps=2,
                           tiles=solve_tiles(lmodel, torch.float32, n_d))
    tiles = solve_tiles(model, bf16, n_d)
    solves = {mode: mode_solve(model, seq, f"bf16-compute {mode} solve", {**BF16_CLONE, **ov},
                               want, reps=2 if mode == "per_window" else 1,
                               model_overrides=BF16_COMPUTE, device_check=True,
                               tiles=tiles if mode == "per_window" else dict.fromkeys(tiles, 0))
              for mode, ov, want in (
                  ("per_window", {}, (4 * n_z, 4 * n_z, 0, 4 * (n_d + 1), 4 * n_d, 4 * n_d)),
                  ("shared", {"per_window_decoder": False},
                   (4 * (n_z + n_d + 1), 4 * (n_z + n_d), 4 * n_d, 0, 0, 0)),
                  ("lora", LORA, (4 * lat.opt_it, 4 * (n_z + n_d), 0, 0, 0, 0)))}

    def cost(r, host=True):  # host: ms by events and the idle share
        p = r.get("profile", {})
        return {"peak_memory_bytes": r["peak_memory_bytes"],
                "device_ms_per_solve": p.get("device_us_per_call", 0.0) / 1e3,
                **({"ms_per_solve": r["ms_per_solve"], "idle_share": p.get("idle_share")}
                   if host else {})}

    solve_row = {"phase": "solve_bf16_compute", "config": os.path.relpath(LATENT_CONFIG, ROOT),
                 "model_overrides": BF16_COMPUTE, "overrides": BF16_CLONE, "windows": WINDOWS,
                 "opt_it": lat.opt_it, **solves,
                 "cost": {mode: cost(r) for mode, r in solves.items()},
                 "f32_per_window": cost(f32_solve),
                 **({"f32_compute_bf16_clone": cost(clone_solve, host=False)}
                    if clone_solve else {})}
    print(json.dumps(solve_row), flush=True)
    part("d_solves")
    # (e) the user's path: eval_recovery on the triple's checkpoint under its
    #     own config
    if ck is None:
        ck = production_cli_phase(data_root, calls=2, compute_dtype="bfloat16")["checkpoint"]
        part("e_checkpoint")
    with open(PRODUCTION_CONFIG) as f:
        text = f.read()
    if re.search(r"(?m)^compute_dtype:", text):
        fail(f"bf16 eval: {PRODUCTION_CONFIG} already sets compute_dtype")
    config = os.path.join(OUT_DIR, "len64_production_bfloat16.yaml")
    with open(config, "w") as f:
        f.write(text + "\ncompute_dtype: bfloat16\n")
    counts = {}
    fcp.device_runs(torch.cuda.current_device(), reset=True)
    with backward_dtypes(counts):
        ev = eval_cli(data_root, ck, "eval_recovery_bf16", config, [],
                      lambda n: n["fused_conv_pool_dgrad_windowed"]
                      and n["fused_conv_pool_wgrad_windowed"])
    runs = fcp.device_runs(torch.cuda.current_device())
    n = ev["launches"]
    want_runs = {TRACE_NAME[a]: n[a] + n[w] for a, w in zip(LAUNCH_NAMES[:3], LAUNCH_NAMES[3:])}
    want_counts = {f"{k.replace('fused_conv_pool_', '')}@bfloat16": v
                   for k, v in n.items() if v and ("dgrad" in k or "wgrad" in k)}
    if runs != want_runs or counts != want_counts:
        fail(f"bf16 eval: device runs {runs} (expected {want_runs}), backward launches by "
             f"dtype {counts} (expected {want_counts}: every one bf16)")
    ev.update(device_runs=runs, backward_launches_by_dtype=counts,
              checkpoint=os.path.relpath(ck, ROOT), model_overrides=BF16_COMPUTE)
    print(json.dumps(ev), flush=True)
    part("e_eval_recovery")
    print(json.dumps({"phase": "bf16_solve", "seconds": seconds,
                      "agreement": {k: agree[k] for k in ("rel_diff", "band", "floor")},
                      "elapsed_s": time.perf_counter() - t_phase}), flush=True)
    return rows, long_rows, solves


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if sys.argv[1:2] == ["--serve-exported"]:
        serve_exported(sys.argv[2])
        return
    if sys.argv[1:2] == ["--rank-audit"]:  # a rank of phases 30-32, started by torchrun
        rank_audit(sys.argv[2:])
        return
    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    def elapsed(phases):  # and the agreements' CPU runs not yet ended
        print(json.dumps({"phases_done": phases, "elapsed_s": time.perf_counter() - t_start,
                          "cpu_runs_pending": cpu_sides_pending()}), flush=True)

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
    for what in ("dgrad", "dgrad_spans", "dgrad_spans_bf16", "wgrad",
                 "wgrad_nq4") + WGRAD_ITEM_KINDS + WGRAD_TILE_KINDS + DGRAD_TILE_KINDS \
            + BF16_BWD_KINDS:
        r = report["fused_conv_pool_bwd"].get(what, {})
        if not (r.get("hgmma") or r.get("hmma")):
            fail(f"the {what} kernel has no HGMMA or HMMA (tensor-core) instruction")
        if what in BF16_BWD_KINDS and not r.get("hmma"):
            fail(f"the {what} kernel has no HMMA (bf16 mma.sync) instruction: {r}")
        if what in WGRAD_ITEM_KINDS + WGRAD_TILE_KINDS + DGRAD_TILE_KINDS and not r.get("hgmma"):
            fail(f"the {what} kernel has no HGMMA (wgmma) instruction: {r}")
        if r.get("wgmma_serialized"):
            fail(f"ptxas serialized the {what} kernel's wgmma: {r}")

    cfg = load_config(CONFIG)
    st = get_structure(cfg.model)
    gen = torch.Generator().manual_seed(SEED)
    model = HMVAE(cfg.model, cfg.optim.init, generator=gen).to(DEV)
    if sys.argv[1:2] == ["--long-backward"]:  # phase 29 alone
        from hm_vae_torch.models.trajectory import TrajectoryModel

        tcfg = load_config(TRAJ_CONFIG)
        tmodel = TrajectoryModel(tcfg.model, tcfg.optim.init,
                                 generator=torch.Generator().manual_seed(SEED)).to(DEV)
        long_backward_phase(model, st, tmodel, gen)
        print(smi, flush=True)
        return
    if sys.argv[1:2] == ["--bf16-train"]:  # phase 35 alone
        from hm_vae_torch.models.trajectory import TrajectoryModel

        tcfg = load_config(TRAJ_CONFIG)
        tmodel = TrajectoryModel(tcfg.model, tcfg.optim.init,
                                 generator=torch.Generator().manual_seed(SEED)).to(DEV)
        data_root = os.path.join(OUT_DIR, "train_data")
        shutil.rmtree(data_root, ignore_errors=True)
        bf16_train_phase(data_root, model, st, tmodel, gen)
        elapsed("1, 35")
        print(smi, flush=True)
        return
    if sys.argv[1:2] == ["--bf16-solve"]:  # phase 36 alone
        data_root = os.path.join(OUT_DIR, "train_data")
        shutil.rmtree(data_root, ignore_errors=True)
        lcfg = latent_config()
        lmodel = HMVAE(lcfg.model, lcfg.optim.init,
                       generator=torch.Generator().manual_seed(SEED)).to(DEV)
        seq, _ = solve_sequence(np.random.default_rng(SEED))
        bf16_solve_phase(data_root, lmodel, gen, seq)
        elapsed("1, 36")
        print(smi, flush=True)
        return
    # the agreements' CPU runs, to the worker in the order they are held
    #    (the trajectory's once its mean_std exists, after phase 13)
    seq, root_trans = solve_sequence(np.random.default_rng(SEED))
    for phase in AGREEMENTS:
        if not AGREEMENTS[phase][0]:
            submit_cpu_sides(seq, phase)
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
    submit_cpu_sides(seq, "solve_agreement_trajectory", traj, root_trans)
    solve_agreement_phase(seq, "solve_agreement_trajectory", traj, root_trans)
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
    solve_agreement_phase(seq, "solve_agreement_lora")
    lora_solve = {"phase": "solve_lora", "config": os.path.relpath(LATENT_CONFIG, ROOT),
                  "overrides": LORA, "windows": WINDOWS, "opt_it": lat0.opt_it,
                  **mode_solve(lmodel, seq, "lora solve", LORA,
                               (4 * lat0.opt_it, 4 * (n_z + n_d), 0, 0, 0, 0)),
                  "rank_conv_device_us_per_iteration":
                      rank_row["profile"]["device_us_per_call"]}
    print(json.dumps(lora_solve), flush=True)
    # 18. the bf16 clone: GPU against CPU, then the full solve (the launches
    #     of the f32 solve), its clone bytes and time beside the f32 solve's
    solve_agreement_phase(seq, "solve_agreement_bf16_clone")
    bf16_solve = {"phase": "solve_bf16_clone", "config": os.path.relpath(LATENT_CONFIG, ROOT),
                  "overrides": BF16_CLONE, "windows": WINDOWS, "opt_it": lat0.opt_it,
                  **mode_solve(lmodel, seq, "bf16-clone solve", BF16_CLONE,
                               tuple(solve_launches[n] for n in LAUNCH_NAMES)),
                  "clone_bytes": {"bfloat16": clone_bytes(lmodel, torch.bfloat16),
                                  "float32": clone_bytes(lmodel, torch.float32)},
                  # the device's numbers only: the worker may have run
                  # beside phase 10 and not here
                  "f32_solve": {"peak_memory_bytes": solve["per_window"]["peak_memory_bytes"],
                                "device_ms_per_solve": solve["per_window"]["profile"][
                                    "device_us_per_call"] / 1e3}}
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
    # 29. the backward over rows of any length: dgrad and wgrad spans at the
    #     trajectory levels and a stride-2 level, trajectory training at T 1,024
    long_bwd, long_train, long_bwd_row, long_bf16 = long_backward_phase(model, st, tmodel, gen)
    elapsed("29")
    # 30-32. the parallel package over torch.distributed ranks (torchrun):
    #     data-parallel training (two gloo ranks on the card, the CLI, one
    #     NCCL rank in the production graph), eval_recovery --data_parallel 2,
    #     eval_trajectory --sequence_parallel 2
    ddp_train_phase(data_root)
    elapsed("30")
    parallel_solve_phase(vae_ck)
    elapsed("31")
    sp_valid, sp_row = sequence_parallel_phase(data_root, vae_ck, traj_ck, tmodel, gen)
    elapsed("32")
    # 33. the compact parameter layout: training on the card against the CPU
    #     and against the dense layout, resume across layouts, serving
    compact_phase(data_root, vae_ck, x6d)
    elapsed("33")
    # 34. training with adapters, and the kernels at its base convs
    lora_train, lora_train_fwd, lora_train_bwd = lora_train_phase(data_root, model, st, gen)
    elapsed("34")
    # 35. training with bf16 conv compute: the bf16 whole-row dgrad and
    #     wgrad, the triple's graphed call against eager steps and its cost,
    #     GPU against CPU, JAX's convergence criterion, the CLI and a resume
    bf16_rows, bf16_step, bf16_conv, bf16_traj, bf16_ck = bf16_train_phase(
        data_root, model, st, tmodel, gen)
    elapsed("35")
    # 36. the solve at bf16 conv compute: the windowed bf16 kernels at the
    #     solve's shapes, the windowed spans and items over long windows,
    #     GPU against CPU, the full solves, eval_recovery on the triple's
    #     checkpoint under its own config
    bf16_win, bf16_long, bf16_solves = bf16_solve_phase(
        data_root, lmodel, gen, seq, bf16_ck, bf16_solve)
    elapsed("36")
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

    def beside(rows):
        """The whole-row kernel timed beside the routed span (dgrad) or item
        (wgrad) kernel, summed over the levels where it was (every level, or
        none), and dgrad's spans' weight layout."""
        if not any("whole_rows" in r for r in rows):
            return {}
        if not all("whole_rows" in r for r in rows):
            fail(f"the whole-row kernel was timed at some levels only: {rows}")
        return {"whole_rows_ms": sum(r["whole_rows"]["ms"] for r in rows),
                "whole_rows_max_abs_err": max(r["whole_rows"]["max_abs_err"] for r in rows),
                **({"pack_ms": sum(r["pack"]["ms"] for r in rows)} if "pack" in rows[0]
                   else {})}

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
        # every form of the kernels (whole rows, spans and items, f32 and
        # bf16), each held against its plain version in a row of this line
        "build_forms": {k: v for k, v in report["fused_conv_pool_bwd"].items()
                        if k.startswith(what)},
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
    } for what, suffix, src, replaces, lib in WINDOWED_KINDS]}
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
            **total(rows), **(beside(rows) if what != "fwd" else {}),
            "note": f"{'bf16' if 'bf16' in case else 'f32'}, K 31, sums over the 4 "
                    f"trajectory levels; {traj_notes[case]}; "
                    "times: device time from CUDA-graph replays (dgrad's spans with their "
                    "weight layout; whole_rows_ms: dgrad_kernel or wgrad_kernel, timed "
                    "beside the routed spans or items, unrouted); library_ms: "
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
            **total(rows), **(beside(rows) if what else {}),
            "device_launches_per_call": prod_run["device_runs_per_32_steps"][TRACE_NAME[name]],
            "trace_launches_per_call": trace_launches(prod_run["trace_launches_per_32_steps"],
                                                      TRACE_NAME[name]),
            "note": f"f32 (bf16 parameters are cast to f32 before the fold), batch "
                    f"{PROD_BATCH}; sums over the 8 len-64 levels (dgrad: enc0 runs it in this "
                    "timing but not in training); launches: the entry's count over the graphed "
                    f"production step's {prod_run['steps']} steps (the two warm-up steps and the "
                    "capture: a replay calls no entry); device_launches_per_call: the "
                    "kernel's runs a 32-step call (CUDA-graph replays) counted on the device; "
                    "trace_launches_per_call: its launches in the device trace of one such "
                    "call; "
                    "times: device time from CUDA-graph replays (dgrad's with its weight "
                    "layout where it runs spans; whole_rows_ms: dgrad_kernel, or wgrad_kernel "
                    "beside wgrad's items, timed beside it, unrouted); library_ms: "
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
    for what, lib in (("dgrad", "torch.nn.grad.conv1d_input"),
                      ("wgrad", "torch.nn.grad.conv1d_weight")):
        main_rows = long_bwd["b8_t1024"]
        summary["kernels"].append({
            "name": f"fused_conv_pool_{what}@long_rows", "route": "cuda",
            "source": "hm_vae_torch/csrc/fused_conv_pool_bwd.cu",
            "replaces": "hm_vae_tpu/models/trajectory.py:45-50 (JAX autodiff of the level at "
                        "any T; no Pallas backward exists)",
            "launches": long_train["launches_per_step"][f"fused_conv_pool_{what}"],
            **total([r[what] for r in main_rows]), "plan": main_rows[0][what]["plan"],
            "b1_t7200": {**total([r[what] for r in long_bwd["b1_t7200"]]),
                         "plan": long_bwd["b1_t7200"][0][what]["plan"]},
            "b8_t1000": {**total([r[what] for r in long_bwd["b8_t1000"]]),
                         "plan": long_bwd["b8_t1000"][0][what]["plan"]},
            "enc1_b8_t1024": {**total([r[what] for r in long_bwd["enc1_b8_t1024"]]),
                              "plan": long_bwd["enc1_b8_t1024"][0][what]["plan"]},
            "bf16": {case: {**total([r[what] for r in rs]), "plan": rs[0][what]["plan"]}
                     for case, rs in long_bf16.items()},
            "span_vs_whole": {shape: part for shape, r in long_bwd_row["span_vs_whole"].items()
                              if (part := {k: v for k, v in r.items()
                                           if k.startswith("dgrad_") == (what == "dgrad")})},
            "note": "f32, rows past one block's whole-row staging, run as spans (plan); top "
                    "level: sums over the trajectory model's 4 K-31 levels at batch 8, T 1,024; "
                    "\"b1_t7200\", \"b8_t1000\": the same at batch 1, T 7,200 and batch 8, "
                    "T 1,000; \"enc1_b8_t1024\": the len-64 model's stride-2 K-15 level at "
                    "batch 8, T 1,024; \"bf16\": the bf16 spans (dgrad) or items (wgrad) at "
                    "(1, 7,200), (8, 1,024) and enc1, held at 0.02 * max|ref|, library_ms "
                    "cuDNN's in bf16; \"span_vs_whole\": the "
                    "span kernel, unrouted, beside the whole-row kernel at shapes whose rows "
                    "fit whole (dgrad: with its weight packing); launches: per "
                    f"step of the trajectory model's training at train_seq_len {LONG_TRAIN_T} "
                    "(phase 29); times: device time from CUDA-graph replays; library_ms: "
                    f"{lib} on the folded weight, TF32 off"})
    for what, rows, lib in (("", lora_train_fwd, "cuDNN conv1d"),
                            ("_dgrad", [r["dgrad"] for r in lora_train_bwd],
                             "torch.nn.grad.conv1d_input"),
                            ("_wgrad", [r["wgrad"] for r in lora_train_bwd],
                             "torch.nn.grad.conv1d_weight")):
        name = f"fused_conv_pool{what}"
        summary["kernels"].append({
            "name": f"{name}@lora_train", "route": "cuda",
            "source": "hm_vae_torch/csrc/" + ("fused_conv_pool_bwd.cu" if what
                                              else "fused_conv_pool.cu"),
            "replaces": ("hm_vae_tpu/ops/pallas_kernels.py:65" if not what else
                         "hm_vae_tpu/models/hm_vae.py:200 (JAX autodiff of the level; no "
                         "Pallas backward exists)")
                        + " at the trained base conv of a decoder with adapters "
                          "(hm_vae_tpu/models/hm_vae.py:200-226, model.lora_rank > 0)",
            "launches": lora_train["launches_decoder"][name],
            **total(rows),
            "note": f"f32, slope 1.0, no bias, batch {BATCH}, not windowed; sums over the 4 "
                    "decoder levels; launches: counted over one forward and backward of the "
                    f"decoder alone of the lora_rank {LORA_TRAIN_RANK} model (phase 34), which "
                    "with the encoder's make up a training step's; "
                    "times: device time from CUDA-graph replays; library_ms: "
                    f"{lib} on the folded weight, TF32 off"})
    bf16_run = bf16_step["graph_steps_per_call_32"]
    bf16_paths = {
        "b8": ("batch 8; launches: the entries' count over phase 35's "
               f"{BF16_CONVERGE_STEPS} eager steps of the production triple (its "
               "convergence run)",
               bf16_conv["production"]["launches_in_run"]),
        "b64": (f"batch {PROD_BATCH}; launches: the entries' count over the graphed triple's "
                f"{bf16_run['steps']} steps (the two warm-up steps and the capture: a replay "
                "calls no entry); device_launches_per_call: the kernel's runs a 32-step call "
                "counted on the device", bf16_run["entry_launches_in_run"]),
        "trajectory": ("the trajectory model's 4 K-31 levels at batch 8, T 128 (dgrad spans "
                       "of one batch's padded row, wgrad items of one batch's 128 columns); "
                       f"launches: the entries' count over {BF16_TRAJ_STEPS} Trainer steps of "
                       "configs/trajectory_model.yaml at bf16 compute",
                       bf16_traj["entry_launches_in_run"])}
    for what, lib in (("dgrad", "torch.nn.grad.conv1d_input"),
                      ("wgrad", "torch.nn.grad.conv1d_weight")):
        name = f"fused_conv_pool_{what}"
        for case, rows in bf16_rows.items():
            note, launches = bf16_paths[case]
            summary["kernels"].append({
                "name": f"{name}@bf16_{case}", "route": "cuda",
                "source": "hm_vae_torch/csrc/fused_conv_pool_bwd.cu",
                "replaces": ("hm_vae_tpu/models/trajectory.py:45-50" if case == "trajectory"
                             else "hm_vae_tpu/models/hm_vae.py:200")
                            + " (JAX autodiff of the level in bf16, compute_dtype bfloat16: "
                              "hm_vae_tpu/models/hm_vae.py:174-195; no Pallas backward exists)",
                "launches": launches.get(name, 0),
                **total([r[what] for r in rows]),
                **beside([r[what] for r in rows]),
                **({"device_launches_per_call": bf16_run["device_runs_per_32_steps"][
                    TRACE_NAME[name]]} if case == "b64" else {}),
                "note": "bf16 (the kernels' bf16 instantiations, as their plans route "
                        "them: at batch 64 dgrad spans of several batches' rows, its time "
                        "with their weight layout, wgrad items of several batches' rows; at "
                        "the trajectory's (8, 128) spans and items of one batch's row; "
                        "whole_rows_ms the whole-row kernel beside either), sums over the "
                        + ("8 len-64 levels (dgrad: enc0 runs it in this timing but not in "
                           "training), " if case != "trajectory" else "")
                        + note + "; times: device time from CUDA-graph replays; library_ms: "
                        f"{lib} in bf16 on the folded weight"})
    for what, suffix, src, replaces, lib in WINDOWED_KINDS:
        name = f"fused_conv_pool{suffix}_windowed"
        common = {"route": "cuda", "source": f"hm_vae_torch/csrc/{src}",
                  "replaces": f"{replaces} in bf16 (compute_dtype bfloat16, "
                              "hm_vae_tpu/models/hm_vae.py:174-195) under jax.vmap over windows "
                              "(per-window decoder clones, hm_vae_tpu/apps/latent_opt.py:423)"}
        summary["kernels"].append({
            "name": f"{name}@bf16", **common,
            "launches": bf16_solves["per_window"]["launches"][name],
            **total([r[what] for r in bf16_win]),
            "note": f"bf16, {WINDOWS} windows of one batch each (phase 36); times (device time "
                    "from CUDA-graph replays; eager_ms: eager calls) and bounds (bf16 bytes, "
                    "989 TFLOP/s) are sums over the 4 decoder levels; launches: in one "
                    "150-iteration per-window solve at bf16 compute; library_ms: cuDNN's "
                    f"grouped {lib} in bf16 (groups = windows) on the stacked folded weights"})
        for dt, rows in bf16_long.items():
            summary["kernels"].append({
                "name": f"{name}@long{LONG_FRAMES}" + ("_bf16" if dt == "bfloat16" else ""),
                **common, "launches": 0,
                **total([r[what] for r in rows]),
                **({"plan": rows[0][what]["plan"]} if "plan" in rows[0][what] else {}),
                **({"whole_rows_ms": sum(r[what]["whole_rows"]["ms"] for r in rows)}
                   if all("whole_rows" in r[what] for r in rows) else {}),
                "note": f"{dt}, {LONG_WINDOWS} windows of one batch at {LONG_FRAMES} frames, "
                        f"sums over the levels {', '.join(LONG_LEVELS)} (padded rows past "
                        "256 columns: dgrad's span kernel, wgrad's item kernel; whole_rows_ms: "
                        "the whole-row bf16 wgrad beside the items); launches: 0, checked, on "
                        "no driven path (phase 36); times: device time from CUDA-graph "
                        f"replays; library_ms: cuDNN's grouped {lib} in {dt}"})
    # the tile kernels, the routed windowed wgrad and dgrad at the solve's
    # shapes: their levels' rows, the whole-row kernel beside (wgrad's with
    # its clearing, and the clearing alone)
    for what, tag, level_rows, solve_row in (
            (w, t, r, sr) for w in ("wgrad", "dgrad")
            for t, r, sr in (("", windowed, solve), ("_bf16", bf16_win, bf16_solves))):
        tile_rows = [r for r in level_rows if r[what]["plan"]["blocks"]]
        if not tile_rows:
            continue
        dt = tile_rows[0]["dtype"]
        summary["kernels"].append({
            "name": f"{what}_tiles@solve{tag}", "route": "cuda",
            "source": "hm_vae_torch/csrc/fused_conv_pool_bwd.cu",
            "replaces": "hm_vae_tpu/models/hm_vae.py:200 (JAX autodiff of the level"
                        + (" in bf16" if tag else "") + ") under jax.vmap over windows "
                        "(per-window decoder clones, hm_vae_tpu/apps/latent_opt.py:423)",
            "launches": solve_row["per_window"][f"{what}_tiles"],
            **({"device_launches": solve_row["per_window"]["dgrad_tiles_device"]}
               if "dgrad_tiles_device" in solve_row["per_window"] and what == "dgrad" else {}),
            **total([r[what] for r in tile_rows]),
            "whole_rows_ms": sum(r[what]["whole_rows"]["ms"] for r in tile_rows),
            "whole_rows_max_abs_err": max(r[what]["whole_rows"]["max_abs_err"]
                                          for r in tile_rows),
            **({"memset_ms": sum(r[what]["memset_ms"] for r in tile_rows)}
               if what == "wgrad" else {}),
            "levels": [r["level"] for r in tile_rows],
            "plans": [r[what]["plan"] for r in tile_rows],
            "note": f"{dt}, {WINDOWS} windows of one batch each: sums over the decoder levels "
                    f"routed to {what}_tiles_kernel ({what}_tiles_routed); launches: its own, in "
                    "one 150-iteration per-window solve (phase " + ("36" if tag else "10")
                    + "; device_launches: the device's dgrad runs less the plain entry's); "
                    f"times: device time from CUDA-graph replays; whole_rows_ms: {what}_kernel "
                    "at the same levels under its whole-row plan"
                    + (", its wrapper's clearing included; memset_ms: that clearing alone"
                       if what == "wgrad" else "")
                    + "; library_ms: cuDNN's grouped torch.nn.grad.conv1d_"
                    + ("weight" if what == "wgrad" else "input")
                    + f" in {dt} (groups = windows)"})
    pack = {dt: [r["dgrad"]["pack"] for r in rows if "pack" in r["dgrad"]]
            for dt, rows in (("float32", b64_bwd), ("bfloat16", bf16_rows["b64"]))}
    top = "float32" if pack["float32"] else "bfloat16"
    if not pack[top]:
        fail("no dgrad level at the production batch runs the span kernel")
    pack_total = lambda rows: {  # noqa: E731
        **{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms", "bytes")},
        "max_abs_err": 0.0, "library_ms": None, "bound_by": "bytes", "levels": len(rows)}
    summary["kernels"].append({
        "name": "dgrad_span_pack@b64", "route": "cuda",
        "source": "hm_vae_torch/csrc/fused_conv_pool_bwd.cu",
        "replaces": "hm_vae_tpu/models/hm_vae.py:200 (JAX autodiff of the level; no Pallas "
                    "backward exists): the folded weight laid out for dgrad's span kernel, "
                    "once a backward call",
        "launches": (prod_run if top == "float32" else bf16_run)["pack_launches_in_run"],
        **pack_total(pack[top]),
        **({"bfloat16": pack_total(pack["bfloat16"])} if top == "float32" and pack["bfloat16"]
           else {}),
        "note": f"{top}, batch {PROD_BATCH}: sums over the len-64 levels whose dgrad runs "
                "spans (bit for bit its plain version, dgrad_span_pack_reference); launches: "
                "its entry's count over the graphed production step's warm-up and capture "
                f"({top} compute); times: device time from CUDA-graph replays; bound: the "
                "weight read and the layout written once at 3.35 TB/s; no library call lays "
                "a weight out so"})
    summary["kernels"].append({
        "name": "fused_conv_pool@sequence_parallel_valid", "route": "cuda",
        "source": "hm_vae_torch/csrc/fused_conv_pool.cu",
        "replaces": "hm_vae_tpu/ops/pallas_kernels.py:65 (at hm_vae_tpu/parallel/"
                    "sequence_parallel.py:95-127, the VALID conv after the halo exchange)",
        "launches": sp_row["launches_per_rank"][0]["fused_conv_pool"],
        **total(sp_valid), "plan": sp_valid[0]["plan"],
        "note": f"f32, K 31, padding 0: sums over the 4 trajectory levels on one rank's "
                f"halo-extended shard, batch 1, T {SP_T // 2} + 30; launches: rank 0's, in one "
                f"eval_trajectory --sequence_parallel 2 run on takes of {SP_T} and {SP_T + 1} "
                "frames (4 a take, phase 32); times: device time from CUDA-graph replays; "
                "library_ms: cuDNN conv1d on the folded weight, TF32 off"})
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:  # the worker's current run ends; queued ones are dropped
        for pool in CPU_POOL:
            pool.shutdown(wait=False, cancel_futures=True)
