"""wgrad's item kernel over items of several batches' whole rows (the short
rows of a large batch), its plans on the CPU (the kernel runs on the GPU,
where chip_smoke.py's production-batch phases hold it against its plain
version, bit-equal on two runs; its arithmetic against the plain wgrad and
``jax.vjp`` is ``tests/test_torch_bwd_long.py::test_wgrad_rows_items_*``):

- the routing: the len-64 levels at the production batch of 64 take items
  of several batches' whole rows in f32 and bf16 (``wgrad_rows_routed``),
  as many batches an item as fill 128 columns where the block fits shared
  memory (in bf16, where two blocks share an SM), spread evenly; the
  trajectory's K-31 rows at (8, 128) take items of one batch's 128
  columns in f32 and bf16 (``wgrad_items_routed``); batch 8, the solver's
  windows, the lora solve's 10 batches and the trajectory's (10, 64) and
  (64, 64) keep their whole-row plans;
- the plan's coverage: the items that the cluster ranks of each live tile
  take (the kernel's ``item_of``) cover every (batch, column) of the
  batch exactly once, in both element types;
- the layout's limits: the items' 3D boxes and a register's pair of bf16
  columns (the kernel's checks, mirrored by ``wgrad_span_rows``).
"""

import os

import pytest
import torch

from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.models.trajectory import TrajectoryModel
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132
# the len-64 model's levels: (name, T_in, stride), K 15, padding 7
LEVELS = (("enc0", 64, 2), ("enc1", 32, 2), ("enc2", 16, 2), ("enc3", 8, 2),
          ("dec0", 8, 1), ("dec1", 16, 1), ("dec2", 32, 1), ("dec3", 64, 1))
_MODEL = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _structures():
    if "len64" not in _MODEL:
        cfg = tcfg.load_config(os.path.join(ROOT, "configs", "len64_no_aug_hm_vae.yaml"))
        m = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(0))
        st = get_structure(cfg.model)
        convs = [getattr(m.encoder, f"conv_{i}") for i in range(len(st.encoder_levels))]
        convs += [getattr(m.decoder, f"conv_{i}") for i in range(len(st.decoder_levels))]
        _MODEL["len64"] = [c.structure() for c in convs]
    return _MODEL["len64"]


def _t_out(T, K, stride, pad):
    return (T + 2 * pad - K) // stride + 1


def _wgrad_plan(s, B, T, esz=4, windows=1):
    """The wrapper's wgrad plan (``_wgrad``) of a call in elements of
    ``esz`` bytes."""
    K, stride, pad = s.kernel_size, s.stride, s.padding
    T_out = _t_out(T, K, stride, pad)
    t_ld = -(-T_out // (16 // esz)) * (16 // esz)
    cols = fcp.wgrad_span_cols(K, stride, esz)
    rows = fcp.wgrad_routed_rows(B, T, K, stride, pad, esz, cols) if windows == 1 else 0
    smem = lambda sb, split: fcp._wgrad_smem(B, T, K, T_out, t_ld, stride, sb,  # noqa: E731
                                             split, esz)
    per_sm = fcp.wgrad_items_per_sm(K, stride, cols, esz, max(1, rows), T, T_out, t_ld)
    return (fcp.wgrad_plan(B, T_out, s.wgrad_row.numel(), SMS, windows, smem, cols, rows,
                           per_sm),
            fcp.wgrad_whole_plan(B, T_out, s.wgrad_row.numel(), SMS, windows, smem, cols),
            T_out, t_ld, per_sm)


def items_of(plan, B, T_out, rank):
    """The (batch, column) pairs the items of cluster rank ``rank`` take, as
    the kernel's ``item_of`` gives them: a contiguous run of the window's
    items, an item the whole rows of ``plan.sb`` batches (the last fewer),
    or (sb 1) one batch's ``plan.span`` columns."""
    nbb, split, span = plan
    rows = nbb > 1
    nch = 1 if rows else -(-T_out // span)
    items = (-(-B // nbb) if rows else B) * nch
    out = []
    for item in range(items * rank // split, items * (rank + 1) // split):
        if rows:
            b0, nbl = item * nbb, min(nbb, B - item * nbb)
            out += [(b0 + n // T_out, n % T_out) for n in range(nbl * T_out)]
        else:
            b, t_lo = item // nch, item % nch * span
            out += [(b, t) for t in range(t_lo, min(T_out, t_lo + span))]
    return out


@pytest.mark.parametrize("esz", [4, 2])
def test_production_batch_routes_to_items_of_whole_rows(esz):
    """At the production batch of 64 every len-64 level's wgrad takes items
    of several batches' whole rows: as many rows of T_out columns as fill
    128 columns, fewer where the block would pass shared memory (f32 at
    enc2 and enc3) or, in bf16, half an SM, spread evenly over the items;
    every live tile's cluster ranks take every (batch, column) once; the
    block fits shared memory; the whole-row plan is the one from before."""
    for (name, T, stride), s in zip(LEVELS, _structures()):
        assert (s.kernel_size, s.stride, s.padding) == (15, stride, 7)
        assert fcp.wgrad_rows_routed(64, T, 15, stride, 7, esz), name
        plan, whole, T_out, t_ld, per_sm = _wgrad_plan(s, 64, T, esz)
        nbb = plan.sb
        full = min(64, 128 // T_out)
        assert plan.span == 128 and 1 < nbb <= full and nbb * T_out <= 128, (name, plan)
        assert nbb == -(-64 // -(-64 // nbb))  # spread evenly
        smem = fcp._wgrad_span_smem(15, stride, 128, esz, nbb, T, T_out, t_ld)
        assert smem <= fcp.MAX_SMEM
        assert per_sm == (2 if esz == 2 else 1)
        assert per_sm == 1 or smem <= fcp.MAX_SMEM_PER_SM // 2 - 1024
        items = -(-64 // nbb)
        fewer = -(-64 // (items - 1)) if items > 1 else None  # batches an item of one fewer
        if fewer is not None and fewer <= full:  # would pass the block's bytes
            more = fcp._wgrad_span_smem(15, stride, 128, esz, fewer, T, T_out, t_ld)
            assert more > (fcp.MAX_SMEM if esz == 4 else fcp.MAX_SMEM_PER_SM // 2 - 1024)
        assert 1 <= plan.split <= min(fcp.MAX_SPLIT, items)
        # every live tile's cluster ranks split the same items
        seen = sum((items_of(plan, 64, T_out, r) for r in range(plan.split)), [])
        assert sorted(seen) == [(b, t) for b in range(64) for t in range(T_out)]
        assert len(set(seen)) == len(seen)
        assert whole.span == 0  # the whole-row kernel's plan, timed beside


@pytest.mark.parametrize("esz", [4, 2])
def test_one_batch_items_cover_long_rows_once(esz):
    """Items of one batch's columns (rows too long for a block, the
    trajectory at (8, 1,024)): the ranks' items cover every column once."""
    live = torch.ones(64, 16, dtype=torch.bool)
    s = fcp.pack_structure(live, 31, torch.float32, 1, 15)
    plan, _, T_out, _, per_sm = _wgrad_plan(s, 8, 1024, esz)
    assert plan.sb == 1 and plan.span == 128 and T_out == 1024
    # K 31: two m64 tiles a warpgroup; bf16's sums stay in the accumulators
    # and its block in half an SM's shared memory, so two blocks an SM
    assert per_sm == (2 if esz == 2 else 1)
    seen = sum((items_of(plan, 8, T_out, r) for r in range(plan.split)), [])
    assert sorted(seen) == [(b, t) for b in range(8) for t in range(T_out)]


def test_other_shapes_keep_their_wgrad_plans():
    """Batch 8 (both dtypes), the solver's 10 windows and the lora solve's
    10 batches are not routed: wgrad_plan gives them their whole-row plans,
    as before.  The trajectory's K-31 levels take items of one batch's
    columns at their short rows (fewer than 64 batches, T 64-128), where the
    card timed them faster: (8, 128) and (10, 64) in f32 and bf16 (an item
    a batch, the ranks covering every (batch, column) once); (64, 64) keeps
    its whole-row plans."""
    n = 0
    for (name, T, stride), s in zip(LEVELS, _structures()):
        for esz in (4, 2):
            for B, windows in ((8, 1), (1, 10), (10, 1)):
                plan, whole, _, _, _ = _wgrad_plan(s, B, T, esz, windows)
                assert not fcp.wgrad_rows_routed(B, T, 15, stride, 7, esz) or windows > 1
                assert not fcp.wgrad_items_routed(B, T, 15, stride, 7, esz)
                assert plan == whole and plan.span == 0, (name, B, windows)
                n += 1
    tcfg_ = tcfg.load_config(os.path.join(ROOT, "configs", "trajectory_model.yaml"))
    tm = TrajectoryModel(tcfg_.model, generator=torch.Generator().manual_seed(0))
    for i in range(4):
        s = getattr(tm.encoder, f"conv_{i}").structure()
        for B, T in ((8, 128), (10, 64), (64, 64)):
            assert not any(fcp.wgrad_rows_routed(B, T, 31, 1, 15, esz) for esz in (4, 2))
            assert fcp.wgrad_span_rows(B, T, 31, 1, 15) == 0  # K 31: one batch's columns
            for esz in (4, 2):
                routed = B < 64
                assert fcp.wgrad_items_routed(B, T, 31, 1, 15, esz) == routed
                plan, whole, T_out, _, per_sm = _wgrad_plan(s, B, T, esz)
                assert whole.span == 0
                if not routed:
                    assert plan == whole
                    continue
                assert plan == fcp.wgrad_span_plan(B, T_out, s.wgrad_row.numel(), SMS, 1,
                                                   128, 1, per_sm)
                assert plan.sb == 1 and plan.span == 128 and per_sm == (2 if esz == 2 else 1)
                seen = sum((items_of(plan, B, T_out, r) for r in range(plan.split)), [])
                assert sorted(seen) == [(b, t) for b in range(B) for t in range(T_out)]
            n += 1
    assert n == 8 * 2 * 3 + 4 * 3


@pytest.mark.parametrize("T_in,stride,esz,rows", [
    (16, 2, 4, True), (16, 2, 2, True),
    (9, 1, 2, False),    # bf16, T_out 9 odd: a register's pair would straddle two batches
    (10, 2, 4, False),   # f32, T_in 10: x's rows no whole 16-byte granules (3D boxes)
    (12, 2, 4, True),    # f32, T_in 12: 48 bytes, whole granules
    (300, 2, 4, False),  # T_out 150: one row is longer than half an item
])
def test_items_of_rows_take_the_shapes_the_kernel_takes(T_in, stride, esz, rows):
    """``wgrad_span_rows`` gives several batches' rows an item only where
    the kernel's checks take them (its C entry refuses the rest): x's rows
    whole 16-byte granules, in bf16 an even T_out, two rows or more."""
    nbb = fcp.wgrad_span_rows(64, T_in, 15, stride, 7, esz, 128)
    assert (nbb > 1) == rows and (nbb == 0) != rows
