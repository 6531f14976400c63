"""dgrad over long rows (``dgrad_span_kernel``): what the wrapper gives it
and how it cuts a row, on the CPU (the kernel runs on the GPU, where
chip_smoke.py's ``long_backward`` phase holds it against its plain version
and autograd, bit-equal on two runs; its arithmetic is held in float64 by
``tests/test_torch_bwd_long.py``'s ``dgrad_by_span``):

- the weight split once a backward call (``dgrad_span_pack``): for each
  entry (a group of four 8-channel chunks and a row tile live in any), each
  k-step of 8 rows and each tap, a TF32 big and a small plane in wgmma's
  K-major core-matrix order.  The big plane is the folded weight's TF32
  rounding, big + small reproduce every live entry to TF32's remainder,
  the dead tiles are absent, rows past P and channels past C_in are zeros,
  and G windows are packed as G weights: at the trajectory model's four
  levels and at a level with dead tiles and a last group of one chunk;
- the span block's shared memory: within a block at K 15 and 31 and
  strides 1 to 3, two to four stages in flight, the same at every T;
- the spans' bounds (``dgrad_span_shift``): they cover every padded row of a
  sweep of lengths once, each starting at a multiple of stride, and under
  reflect the first and the last span hold both columns of every reflected
  pair, so each span folds its own;
- the plans: every shape that planned spans before (past one block's 16
  column tiles or its shared memory) plans them still, every other shape
  its whole rows.
"""

import os

import pytest
import torch

from hm_vae_torch.models.structure import get_trajectory_structure
from hm_vae_torch.models.trajectory import TrajectoryModel
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg

TRAJ_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "trajectory_model.yaml")
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traj_levels():
    cfg = tcfg.load_config(TRAJ_CONFIG)
    m = TrajectoryModel(cfg.model, generator=torch.Generator().manual_seed(0))
    return [getattr(m.encoder, f"conv_{i}")
            for i in range(len(get_trajectory_structure(cfg.model).levels))]


def _sparse_level(K=15):
    """A folded weight (128, 40, K) zero outside its live tiles: group 0
    (chunks 0-3) live in row tile 0 only, group 1 (chunk 4, a last group of
    one chunk) in row tile 1 only, so that (row tile 1, group 0) and (row
    tile 0, group 1) are dead."""
    live = torch.zeros(128, 40, dtype=torch.bool)
    live[:64, :16] = True
    live[64:, 32:] = True
    s = fcp.pack_structure(live, K, torch.float32, 1, (K - 1) // 2)
    w = torch.randn(128, 40, K, generator=torch.Generator().manual_seed(K)) * live[:, :, None]
    return s, w


N = fcp.DGRAD_SPAN_CHANNELS


def unpack(pk, s):
    """The packing's planes back into (G, 2, row tiles * 64, groups * 32,
    K) (big, small), and the (row tile, group) of each entry."""
    G, E, _, K = pk.shape[:4]
    rt, groups = s.tile_start.numel() - 1, s.dgrad_span_start.numel() - 1
    # (G, E, k-step, K, plane, eight, half, channel, 4 rows) -> (G, plane, E, 64 rows, 32, K)
    t = pk.reshape(G, E, 8, K, 2, N // 8, 2, 8, 4).permute(0, 4, 1, 2, 6, 8, 5, 7, 3)
    t = t.reshape(G, 2, E, 64, N, K)
    out = pk.new_zeros(G, 2, rt, 64, groups, N, K)
    cells = list(zip(s.dgrad_span_row.tolist(), s.dgrad_span_group.tolist()))
    for e, (r, g) in enumerate(cells):
        out[:, :, r, :, g] = t[:, :, e]
    return out.reshape(G, 2, rt * 64, groups * N, K), cells


def _check_pack(s, w):
    P, C, K = w.shape
    pk = fcp.dgrad_span_pack(s, w)
    rt, groups = s.tile_start.numel() - 1, s.dgrad_span_start.numel() - 1
    assert groups == -(-C // N)
    assert pk.shape == (1, s.dgrad_span_row.numel(), 8, K, 2, 8 * N)
    assert pk.dtype == torch.float32
    planes, cells = unpack(pk, s)
    # the entries: every (row tile, group) live in any of its chunks, once,
    # in dgrad_span_row's order, grouped by dgrad_span_start
    chunks = s.live.shape[1]
    live = {(r, c // (N // 8)) for r in range(rt) for c in range(chunks) if s.live[r, c]}
    assert len(cells) == len(set(cells)) and set(cells) == live
    assert [r for r, _ in cells] == s.dgrad_span_row.tolist()
    start = s.dgrad_span_start.tolist()
    assert [g for _, g in cells] == [g for g in range(groups) for _ in range(start[g],
                                                                            start[g + 1])]
    assert s.dgrad_span_max_live == max(b - a for a, b in zip(start, start[1:]))
    padded = torch.zeros(rt * 64, groups * N, K)
    padded[:P, :C] = w
    covered = torch.zeros(rt * 64, groups * N, dtype=torch.bool)
    for r, g in cells:
        covered[64 * r:64 * r + 64, N * g:N * g + N] = True
    big, small = planes[0, 0], planes[0, 1]
    # dead tiles are absent (their entries are structural zeros of the fold)
    assert not big[~covered].any() and not small[~covered].any()
    assert not padded[~covered].any()
    torch.testing.assert_close(big, fcp._tf32(padded), atol=0, rtol=0)
    torch.testing.assert_close(small, fcp._tf32(padded - big), atol=0, rtol=0)
    assert torch.equal(fcp._tf32(small), small)  # both planes are TF32 values
    err = (big + small - padded).abs()
    assert (err <= 2.0 ** -21 * padded.abs()).all()
    assert not planes[:, :, P:].any() and not planes[:, :, :, C:].any()
    return pk


@pytest.mark.parametrize("level", range(4))
def test_span_pack_reproduces_the_trajectory_levels(level):
    conv = _traj_levels()[level]
    s = conv.structure()
    with torch.no_grad():
        w, _ = conv.folded_weight()
    _check_pack(s, w)


def test_span_pack_drops_dead_tiles_and_packs_each_window():
    s, w = _sparse_level()
    pk = _check_pack(s, w)
    assert s.dgrad_span_row.tolist() == [0, 1]  # (1, group 0) and (0, group 1) are dead
    ws = torch.stack([w * (g + 1.5) for g in range(3)])
    pw = fcp.dgrad_span_pack(s, ws)
    assert pw.shape == (3,) + pk.shape[1:]
    for g in range(3):
        assert torch.equal(pw[g:g + 1], fcp.dgrad_span_pack(s, ws[g]))
    with pytest.raises(ValueError, match="does not fit"):
        fcp.dgrad_span_pack(s, w[:, :32])


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("K", [15, 31])
def test_dgrad_span_block_fits_at_any_length(K, stride):
    """Whole M tiles of every phase, four at most: 256 padded columns (192 at
    stride 3), two to four stages of the K taps' planes, the stage's rows of
    gy and y and g's 8 rows in a block, whatever the length."""
    span = fcp.dgrad_span_cols(K, stride)
    assert span == (192 if stride == 3 else 256) and span % (64 * stride) == 0
    smem, stages = fcp._dgrad_span_layout(K, stride, span)
    assert smem <= fcp.MAX_SMEM and 2 <= stages <= fcp.DGRAD_SPAN_MAX_STAGES
    # K 31's planes of 32 channels (62 KB a stage) beside the stage's rows of
    # gy and y and g's planes leave room for two at strides 1 (the
    # trajectory's levels) and 2; K 15 for three at stride 1 (30 KB of
    # planes, 37 KB of rows) and four at strides 2 (enc1's) and 3
    assert stages == {(15, 1): 3, (31, 1): 2, (31, 2): 2, (31, 3): 3}.get((K, stride), 4)
    live = torch.ones(128, 24, dtype=torch.bool)
    s = fcp.pack_structure(live, K, torch.float32, stride, (K - 1) // 2)
    for T in (1000, 4000, 7201, 100000):
        T_out = (T + 2 * s.padding - K) // stride + 1
        d = fcp.dgrad_plan(1, T, K, stride, s.padding, T_out + -T_out % 4,
                           s.dgrad_start.numel() - 1, s.dgrad_max_live, SMS, 1,
                           (s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live))
        assert d.span == span and d.nbb == 1


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_span_bounds_cover_the_row_and_hold_the_reflected_pairs(stride):
    span = fcp.dgrad_span_cols(31, stride)
    for padding in (0, 1, 7, 15):
        for reflect in (False, True):
            for Tp in range(2 * padding + 2, 4 * span + 40, 3):
                shift = fcp.dgrad_span_shift(Tp, span, stride, padding, reflect)
                assert shift % stride == 0 and 0 <= shift < span
                n = -(-(Tp + shift) // span)
                assert n == -(-Tp // span)
                bounds = [0] + [i * span - shift for i in range(1, n)] + [Tp]
                widths = [b - a for a, b in zip(bounds, bounds[1:])]
                assert all(0 < x <= span for x in widths)
                assert all(b % stride == 0 for b in bounds[:-1])
                if reflect and padding and n > 1:
                    # the first span holds columns 0..2p, the last the last 2p + 1
                    assert widths[0] > 2 * padding and widths[-1] > 2 * padding, (Tp, padding)


def _parent_whole_row_smem(T_in, K, t_ld, stride, padding, nbb):
    """A block's bytes at whole rows, as the plan before spans reckoned them."""
    Tp, kmax = T_in + 2 * padding, -(-K // stride)
    T_out = (Tp - K) // stride + 1
    rs = (kmax - 1 + max(-(-Tp // stride), T_out) + 11) // 16 * 16 + 4
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    w_ring = a16(2 * 32 * (16 * K + 8) * 4)
    g2_end = 64 + w_ring + a16(2 * nbb * 32 * t_ld * 4) + nbb * 32 * rs * 8
    out = 16 * nbb * Tp * 4
    return g2_end if out <= w_ring else a16(g2_end) + out


@pytest.mark.parametrize("K", [15, 31])
def test_spans_planned_where_and_only_where_they_were(K):
    live = torch.ones(128, 24, dtype=torch.bool)
    n = 0
    for stride in (1, 2, 3):
        s = fcp.pack_structure(live, K, torch.float32, stride, (K - 1) // 2)
        for T in (8, 16, 64, 100, 128, 200, 226, 227, 240, 256, 300, 1000, 1024, 7200):
            Tp = T + 2 * s.padding
            T_out = (Tp - K) // stride + 1
            t_ld = T_out + -T_out % 4
            tiles = sum(-(-(-(-(Tp - phi) // stride)) // 16) for phi in range(stride))
            before = tiles > 16 or _parent_whole_row_smem(T, K, t_ld, stride, s.padding,
                                                          1) > fcp.MAX_SMEM
            for B in (1, 8):
                d = fcp.dgrad_plan(B, T, K, stride, s.padding, t_ld, s.dgrad_start.numel() - 1,
                                   s.dgrad_max_live, SMS)
                # and the trajectory's short K-31 rows (T 64-128) from 4 batches on,
                # where the card timed spans faster
                routed = (K, stride) == (31, 1) and B == 8 and 64 <= T <= 128
                assert fcp.dgrad_rows_routed(B, T, K, stride, s.padding) == routed
                assert (d.span > 0) == (before or routed), (K, stride, T, B)
                n += before
    assert n > 10
