"""The root-trajectory model's K-31 backward at its own short rows on the span
and item kernels, on the CPU (the kernels run on the GPU, where
chip_smoke.py's trajectory rows hold them against their plain versions,
bit-equal on two runs, the whole-row kernels timed beside them):

- the spans' arithmetic at training's (8, 128) and the solve's (10, 64):
  ``dgrad_span_plan``'s plan at each of the four levels (one batch's
  158-column padded row a 256-column span at T 128, two 94-column rows at T
  64; the third M tile part-filled, the fourth idle; the split counted in
  stages, a contiguous run of a group's stages a cluster rank), run by
  ``dgrad_by_rows`` (the kernel's staging, M tiles, taps and rank-ordered
  cluster sums in plain PyTorch) at small widths, in float64 on inputs
  rounded to f32 or bf16, against the plain dgrad in float64 (1e-10), and in
  bf16 against the plain bf16 version at the kernels' 0.02 * max|ref|;
- the items at the same shapes: ``wgrad_span_plan``'s items of one batch's
  128 columns, the ranks of every live tile covering each (batch, column)
  once (``items_of``), and their arithmetic (``wgrad_by_items``: x's
  window as the bulk copies stage it, g chunk by chunk, the ranks' sums in
  rank order) against the plain wgrad the same way;
- both decompositions against ``jax.vjp`` of the JAX package's level (the
  conv, then LeakyReLU) on f32 inputs, at 1e-4 * max(1, max|ref|) (JAX sums
  in f32, the decompositions in float64);
- the span kernel's walk of a group's stages (``start`` and ``next`` in
  ``dgrad_span_kernel``, written out here) against the tests' mirror
  (``rank_stages``): every stage once, the runs differing by one at most;
- the item kernel's blocks an SM, as the planner counts them
  (``wgrad_items_per_sm``) against the kernel's launch bounds and shared
  memory: two in bf16 at one or two m64 tiles a warpgroup (K up to 31)
  where a block fits half an SM, one in f32;
- the routing by ranges (``traj_rows``: fewer than 64 batches, T 64-128;
  dgrad from 4 batches on), and the span plan asking the device's clusters
  only where it counts stages.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_torch.models.trajectory import TrajectoryModel
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg
from test_torch_bwd_long import wgrad_by_items
from test_torch_dgrad_rows import dgrad_by_rows, rank_stages
from test_torch_wgrad_rows import items_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132
K, PAD = 31, 15
SHAPES = ((8, 128), (10, 64))  # training's (batch, T), the solve's trajectory term
# small widths for the decompositions: two row tiles (the second of 16 rows)
P_SMALL, C_SMALL = 80, 16
_LEVELS = []


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels():
    """The structures of the full-width trajectory model's four levels."""
    if not _LEVELS:
        cfg = tcfg.load_config(os.path.join(ROOT, "configs", "trajectory_model.yaml"))
        m = TrajectoryModel(cfg.model, generator=torch.Generator().manual_seed(0))
        _LEVELS.extend(getattr(m.encoder, f"conv_{i}").structure() for i in range(4))
    return _LEVELS


def _esz(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _dgrad_plan(level, B, T, esz):
    s = _levels()[level]
    return fcp.dgrad_span_plan(B, T, K, 1, PAD, s.dgrad_span_start.numel() - 1,
                               s.dgrad_span_max_live, SMS, 1, esz)


def _wgrad_plan(level, B, T, esz):
    s = _levels()[level]
    cols = fcp.wgrad_span_cols(K, 1, esz)
    return fcp.wgrad_span_plan(B, T, s.wgrad_row.numel(), SMS, 1, cols, 1,
                               fcp.wgrad_items_per_sm(K, 1, cols, esz))


def _operands(B, T, dtype, seed):
    """Weight, x, y and gy at small widths, rounded to ``dtype``, in float64."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(P_SMALL, C_SMALL, K, generator=gen).to(dtype).double()
    x = torch.randn(B, C_SMALL, T, generator=gen).to(dtype).double()
    y = fcp.fused_conv_pool_reference(x, w, None, None, None, 1, PAD, "reflect", 0.2)
    gy = torch.randn(y.shape, generator=gen).to(dtype).double()
    return w, x, y.to(dtype).double(), gy


def _close_to_plain_bf16(got, plain):
    err = float((got.to(torch.bfloat16).float() - plain.float()).abs().max())
    assert err <= 0.02 * float(plain.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("level", range(4))
def test_dgrad_spans_at_short_k31_rows_match_the_plain_dgrad(level, B, T, dtype):
    """The level's span plan (whole padded rows a span; its split counted in
    stages, past the level's live row tiles at levels 0-2) run by the
    kernel's arithmetic over the plan's cluster ranks."""
    esz = _esz(dtype)
    plan = _dgrad_plan(level, B, T, esz)
    s = _levels()[level]
    assert s.dgrad_span_max_live < plan.split <= fcp.MAX_SPLIT or level == 3
    per = 256 // (T + 2 * PAD)
    assert plan.span == 256 and plan.nbb == per and plan.groups == -(-B // per)
    assert plan.nbb * fcp.dgrad_span_period(T, K, 1, PAD) <= plan.span
    w, x, y, gy = _operands(B, T, dtype, 100 * level + T)
    g = fcp._act_grad(gy, y, 0.2).to(dtype).double()  # the kernel rounds g once
    got = dgrad_by_rows(g, w, T, 1, PAD, True, plan, fcp.DGRAD_SPAN_KSTEP[esz], plan.split)
    want = fcp.fused_conv_pool_dgrad_reference(g, torch.ones_like(y), w, T, 1, PAD,
                                               "reflect", 0.2)
    torch.testing.assert_close(got, want, atol=1e-10, rtol=0)
    if dtype == torch.bfloat16:
        _close_to_plain_bf16(got, fcp.fused_conv_pool_dgrad_reference(
            gy.to(dtype), y.to(dtype), w.to(dtype), T, 1, PAD, "reflect", 0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("level", range(4))
def test_wgrad_items_at_short_k31_rows_cover_and_match_the_plain_wgrad(level, B, T, dtype):
    """The level's item plan: items of one batch's 128 columns (one an
    entry's batch at these T), every live tile's ranks covering each
    (batch, column) once; the item arithmetic over the plan's ranks."""
    esz = _esz(dtype)
    plan = _wgrad_plan(level, B, T, esz)
    assert plan.sb == 1 and plan.span == 128 and 1 <= plan.split <= min(fcp.MAX_SPLIT, B)
    seen = sum((items_of(plan, B, T, r) for r in range(plan.split)), [])
    assert sorted(seen) == [(b, t) for b in range(B) for t in range(T)]
    assert len(set(seen)) == len(seen)
    w, x, y, gy = _operands(B, T, dtype, 1000 + 100 * level + T)
    g = fcp._act_grad(gy, y, 0.2).to(dtype).double()
    gw, gb = wgrad_by_items(g, x, K, 1, PAD, True, plan.span, plan.split)
    rw, rb = fcp.fused_conv_pool_wgrad_reference(g, torch.ones_like(y), x, K, 1, PAD,
                                                 "reflect", 0.2, None)
    torch.testing.assert_close(gw, rw, atol=1e-10, rtol=0)
    torch.testing.assert_close(gb, rb, atol=1e-10, rtol=0)
    if dtype == torch.bfloat16:
        pw, pb = fcp.fused_conv_pool_wgrad_reference(gy.to(dtype), y.to(dtype), x.to(dtype),
                                                     K, 1, PAD, "reflect", 0.2, None)
        _close_to_plain_bf16(gw, pw)
        _close_to_plain_bf16(gb, pb)


def _tol(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("B,T", SHAPES)
def test_short_k31_row_decompositions_match_jax_vjp(B, T):
    """dgrad's spans and wgrad's items at the level-3 plans, on f32 inputs at
    small widths, against jax.vjp of the JAX level (skeleton_conv_w under
    reflect padding, then LeakyReLU): the input, weight and bias
    gradients at f32's 1e-4 * max(1, max|ref|)."""
    rng = np.random.default_rng(B * 1000 + T)
    x = rng.normal(size=(B, C_SMALL, T)).astype(np.float32)
    w = (rng.normal(size=(P_SMALL, C_SMALL, K)) * 0.1).astype(np.float32)
    b = rng.normal(size=(P_SMALL,)).astype(np.float32)

    def level_fn(x, w, b):
        return jsnn.leaky_relu(jsnn.skeleton_conv_w(x, w, b, 1, PAD, "reflect"), 0.2)

    y, vjp = jax.vjp(level_fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gy = rng.normal(size=y.shape).astype(np.float32)
    gx_ref, gw_ref, gb_ref = (np.asarray(a) for a in vjp(jnp.asarray(gy)))
    g = fcp._act_grad(torch.from_numpy(gy).double(), torch.from_numpy(np.array(y)).double(), 0.2)
    wt = torch.from_numpy(w).double()
    d = _dgrad_plan(3, B, T, 4)
    gx = dgrad_by_rows(g, wt, T, 1, PAD, True, d, fcp.DGRAD_SPAN_KSTEP[4], d.split)
    wp = _wgrad_plan(3, B, T, 4)
    gw, gb = wgrad_by_items(g, torch.from_numpy(x).double(), K, 1, PAD, True, wp.span,
                            wp.split)
    np.testing.assert_allclose(gx.numpy(), gx_ref, atol=_tol(gx_ref), rtol=0)
    np.testing.assert_allclose(gw.numpy(), gw_ref, atol=_tol(gw_ref), rtol=0)
    np.testing.assert_allclose(gb.numpy(), gb_ref, atol=_tol(gb_ref), rtol=0)


def _c_min_blocks(src, esz):
    """The item kernel's minimum blocks an SM from its ``__launch_bounds__``
    in ``csrc/fused_conv_pool_bwd.cu`` (the expression written out here as
    the source has it)."""
    m = re.search(r"__launch_bounds__\(kThreads, ([^)]*\)?[^)]*)\)\s*\nwgrad_span_kernel\(", src)
    assert m, "wgrad_span_kernel's launch bounds"
    assert m.group(1) == "sizeof(T) == 2 ? 2 : 1", m.group(1)
    return 2 if esz == 2 else 1


@pytest.mark.parametrize("esz", [4, 2])
def test_items_per_sm_mirror_the_kernel(esz):
    """``wgrad_items_per_sm`` gives the kernel's launch-bound blocks an SM
    where that many blocks' shared memory (``wgrad_span_layout``, mirrored
    by ``_wgrad_span_smem``) fits an SM, else one, at one and two m64 tiles
    a warpgroup, items of one batch's columns and of several batches'
    rows; the trajectory's short rows in bf16 take two."""
    with open(os.path.join(ROOT, "hm_vae_torch", "csrc", "fused_conv_pool_bwd.cu")) as f:
        blocks = _c_min_blocks(f.read(), esz)
    n = 0
    for k in (3, 15, 31):
        for stride in (1, 2):
            cols = fcp.wgrad_span_cols(k, stride, esz)
            for T, nbb in ((128, 1), (1024, 1), (16, 4), (32, 2)):
                T_out = (T + 2 * ((k - 1) // 2) - k) // stride + 1
                if nbb > 1 and (k > 15 or nbb * T_out > cols):
                    continue
                t_ld = -(-T_out // (16 // esz)) * (16 // esz)
                smem = fcp._wgrad_span_smem(k, stride, cols, esz, nbb, T, T_out, t_ld)
                fits = blocks * (smem + 1024) <= fcp.MAX_SMEM_PER_SM
                assert fcp.wgrad_items_per_sm(k, stride, cols, esz, nbb, T, T_out, t_ld) == \
                    (blocks if fits else 1)
                n += 1
    assert n > 12
    assert fcp.wgrad_items_per_sm(K, 1, 128, esz) == (2 if esz == 2 else 1)


def _c_rank_stages(ksteps, rank, split):
    """The stages (row tile j, k-step ks) that cluster rank ``rank`` of
    ``split`` walks in ``dgrad_span_kernel`` (written out here from the
    C++: ``total``, ``s_lo``, ``start`` and ``next``), over a group whose
    live row tiles have ``ksteps`` k-steps each."""
    total = sum(ksteps)
    s_lo = total * rank // split
    n_stages = total * (rank + 1) // split - s_lo
    j, ks = 0, s_lo
    while j < len(ksteps) and ks >= ksteps[j]:
        ks -= ksteps[j]
        j += 1
    out = []
    for _ in range(n_stages):
        out.append((j, ks))
        ks += 1
        if ks == ksteps[j]:
            j, ks = j + 1, 0
    return out


@pytest.mark.parametrize("esz", [4, 2])
def test_span_stage_runs_mirror_the_kernel(esz):
    """Every group's stages (dense row tiles of P rows: the last one's
    k-steps the rows left) split over 1-8 ranks as the kernel walks them:
    the runs the tests' mirror gives, each stage once, in order, the runs'
    lengths one apart at most."""
    rows_p = fcp.DGRAD_SPAN_KSTEP[esz]
    n = 0
    for P in (16, 64, 84, 108, 168, 336):
        tiles = -(-P // 64)
        ksteps = [min(64 // rows_p, -(-(P - 64 * rt) // rows_p)) for rt in range(tiles)]
        for split in range(1, fcp.MAX_SPLIT + 1):
            runs = [_c_rank_stages(ksteps, r, split) for r in range(split)]
            flat = [st for run in runs for st in run]
            assert flat == [(j, ks) for j in range(tiles) for ks in range(ksteps[j])]
            assert max(map(len, runs)) - min(map(len, runs)) <= 1
            for r, run in enumerate(runs):
                assert rank_stages(P, rows_p, r, split) == [64 * j + rows_p * ks
                                                            for j, ks in run]
            n += 1
    assert n == 6 * 8


# clusters of 1-8 span blocks an H100 SXM (132 SMs) runs at once, as
# cudaOccupancyMaxActiveClusters gave them on the card (PERF.md)
H100_SPAN_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)


@pytest.mark.parametrize("esz", [4, 2])
def test_span_plan_counts_waves_in_clusters(esz):
    """At the trajectory's short rows the span plan's split, counted in
    stages, takes the clusters the card holds at once: the splits the card
    ran at one wave each ((8, 128): 4, 4, 3, 2; (10, 64): 8, 8, 5, 4 in f32,
    8, 8, 4, 4 in bf16, whose row tiles are half as many stages), where
    counting a block an SM would take clusters of 4 and 6 that do not fit
    (traj2: 32 clusters of 4 at (8, 128), 20 of 6 at (10, 64))."""
    want = {(8, 128): (4, 4, 3, 2), (10, 64): (8, 8, 5 if esz == 4 else 4, 4)}
    for (B, T), splits in want.items():
        for level, split in enumerate(splits):
            s = _levels()[level]
            args = (B, T, K, 1, PAD, s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live,
                    SMS, 1, esz)
            plan = fcp.dgrad_span_plan(*args, lambda: H100_SPAN_CLUSTERS)
            assert plan.split == split, (B, T, level, plan)
            units = plan.groups * (s.dgrad_span_start.numel() - 1)
            assert units <= H100_SPAN_CLUSTERS[split - 1]  # one wave
    s = _levels()[2]
    blind = [fcp.dgrad_span_plan(B, T, K, 1, PAD, s.dgrad_span_start.numel() - 1,
                                 s.dgrad_span_max_live, SMS, 1, esz).split
             for B, T in want]
    assert blind == [4, 6]


@pytest.mark.parametrize("esz", [4, 2])
def test_short_k31_rows_route_over_the_timed_ranges(esz):
    """The trajectory's short K-31 rows are routed by ranges of batch and
    frames, the grid the card timed (batches 1-63, T 64-128): wgrad's items
    at every batch, dgrad's spans from 4 batches on (bf16 spans lost to
    whole rows at 1 and 2 batches); past the grid (T 63 or 129, batch 64,
    another K, stride or padding) neither."""
    for B in (1, 2, 3, 4, 10, 16, 63, 64):
        for T in (63, 64, 96, 128, 129):
            inside = B < 64 and 64 <= T <= 128
            assert fcp.traj_rows(B, T, K, 1, PAD) == inside, (B, T)
            assert fcp.wgrad_items_routed(B, T, K, 1, PAD, esz) == inside, (B, T)
            assert fcp.dgrad_rows_routed(B, T, K, 1, PAD, esz) == (inside and B >= 4), (B, T)
    for k, stride, pad in ((29, 1, 14), (31, 2, 15), (31, 1, 0)):
        assert not fcp.traj_rows(8, 128, k, stride, pad)
        assert not fcp.dgrad_rows_routed(8, 128, k, stride, pad, esz)
        assert not fcp.wgrad_items_routed(8, 128, k, stride, pad, esz)


def test_span_plan_asks_for_clusters_only_where_it_counts_stages():
    """``dgrad_plan`` works out once whether a span plan counts stages: at
    the trajectory's routed rows it asks the device's clusters and takes a
    split past the live row tiles; at the production batch's K-15 rows and
    at shapes that keep whole rows it does not ask."""
    asked = []

    def clusters():
        asked.append(1)
        return H100_SPAN_CLUSTERS

    def plan(s, B, T, K, pad):
        return fcp.dgrad_plan(B, T, K, 1, pad, T, s.dgrad_start.numel() - 1, s.dgrad_max_live,
                              SMS, 1, (s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live),
                              4, clusters)

    s = _levels()[0]
    d = plan(s, 8, 128, K, PAD)
    assert asked and d.span == 256 and d.split == 4 > s.dgrad_span_max_live
    asked.clear()
    assert plan(s, 2, 128, K, PAD).span == 0 and not asked  # whole rows
    s15 = fcp.pack_structure(torch.ones(128, 24, dtype=torch.bool), 15, torch.float32, 1, 7)
    d = plan(s15, 64, 64, 15, 7)
    assert d.span == 256 and d.split <= max(1, s15.dgrad_span_max_live) and not asked
