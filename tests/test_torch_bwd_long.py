"""The backward kernels over padded rows of any length, on the CPU (the
kernels run on the GPU, where chip_smoke.py's ``long_backward`` phase holds
them against their plain versions, bit-equal on two runs):

- the plans: ``dgrad_plan`` and ``wgrad_plan`` at K 31 and T 1,024 and
  7,200 (the trajectory model's four levels, batch 1 and 8), and at
  stride 2 and 3 past 256 / stride padded columns, cut the row into spans
  of whole 64-column M tiles whose stages fit shared memory (dgrad: 256
  padded columns, 192 at stride 3) and the reduction into items of up to
  128 output columns (wgrad: the widest whose two stages fit, the same at
  every T); these raised before spans existed;
- the plans of every existing shape (the len-64 and production models at
  batch 8 and 64, the trajectory model's training and solver shapes, the
  solver's 10 windows) are the plans from before spans, span 0: the same
  launch, the same bits; but the len-64 levels' dgrad at batch 64, routed
  to spans of several batches' whole rows, whose whole-row plan
  (``dgrad_whole_plan``) is still that plan;
- the span decomposition's index arithmetic (dgrad: the spans, the first
  narrower so that the last holds the reflected edge, the g columns a span
  stages from a 16-byte granule with its halo, its M tiles of each stride
  phase, the taps read at the A operand's offset, the sums of a tap added
  in stage order over the cluster ranks' row tiles, then the padding
  folded in the span; wgrad: the items a cluster rank takes,
  each one's x window as its bulk copies stage it (16-byte granules, the
  padding resolved), g chunk by chunk, the ranks' sums in rank order) in
  plain PyTorch against the plain versions, in float64, at long rows in
  both paddings and strides 1 to 3, T_out no multiple of the item width;
- the plain dgrad and wgrad at batch 2, T 1,024, K 31 against ``jax.vjp``
  of the JAX trajectory level (f32, 1e-4 * max(1, max|ref|): the sums run
  over 1,024 columns in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure, get_trajectory_structure
from hm_vae_torch.models.trajectory import TrajectoryModel
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg
from test_torch_dgrad_rows import rank_stages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {n: os.path.join(ROOT, "configs", f"{n}.yaml")
           for n in ("len64_no_aug_hm_vae", "len64_production", "len_64_test_interpolation",
                     "trajectory_model")}
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t_out(s, T):
    return (T + 2 * s.padding - s.kernel_size) // s.stride + 1


def _tol(ref, scale=1e-4):
    return scale * max(1.0, float(np.abs(np.asarray(ref)).max()))


_MODELS = {}


def _traj_convs():
    if "traj" not in _MODELS:
        cfg = tcfg.load_config(CONFIGS["trajectory_model"])
        m = TrajectoryModel(cfg.model, generator=torch.Generator().manual_seed(0))
        _MODELS["traj"] = [getattr(m.encoder, f"conv_{i}")
                           for i in range(len(get_trajectory_structure(cfg.model).levels))]
    return _MODELS["traj"]


def _vae_cases(name):
    """(conv, T_in) of the eight convs of a len-64 config's model."""
    if name not in _MODELS:
        cfg = tcfg.load_config(CONFIGS[name])
        m = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(0))
        st = get_structure(cfg.model)
        cases = [(getattr(m.encoder, f"conv_{i}"), st.enc_timesteps[i])
                 for i in range(len(st.encoder_levels))]
        cases += [(getattr(m.decoder, f"conv_{i}"),
                   st.dec_timesteps[i] * (2 if lvl.upsample else 1))
                  for i, lvl in enumerate(st.decoder_levels)]
        _MODELS[name] = cases
    return _MODELS[name]


def _plans(s, B, T, windows=1):
    """dgrad's and wgrad's f32 plans as the wrappers choose them (wgrad:
    routed to the item kernel where ``wgrad_routed_rows``), but wgrad's
    whole-row plan where the wrapper takes the tile kernel."""
    T_out = _t_out(s, T)
    t_ld = T_out + -T_out % 4
    K, stride, pad = s.kernel_size, s.stride, s.padding
    d = fcp.dgrad_plan(B, T, K, stride, pad, t_ld,
                       s.dgrad_start.numel() - 1, s.dgrad_max_live, SMS, windows)
    cols = fcp.wgrad_span_cols(K, stride)
    rows = fcp.wgrad_routed_rows(B, T, K, stride, pad, 4, cols) if windows == 1 else 0
    w = fcp.wgrad_plan(B, T_out, s.wgrad_row.numel(), SMS, windows,
                       lambda sb, split: fcp._wgrad_smem(B, T, K, T_out, t_ld, stride, sb,
                                                         split),
                       cols, rows)
    return d, w, t_ld


def _check_span_plans(s, B, T, d, w, t_ld):
    """A span plan: one batch a block, the span a multiple of stride within
    the 16 tiles and shared memory, the spans covering the padded row;
    wgrad: items of the widest width whose block fits, over the cluster."""
    Tp = T + 2 * s.padding
    assert d.span > 0 and d.nbb == 1 and d.groups == B and d.span % (64 * s.stride) == 0
    assert d.span == fcp.dgrad_span_cols(s.kernel_size, s.stride)
    assert d.span // 64 <= fcp.DGRAD_SPAN_TILES
    smem, stages = fcp._dgrad_span_layout(s.kernel_size, s.stride, d.span)
    assert smem <= fcp.MAX_SMEM and stages >= 2
    shift = fcp.dgrad_span_shift(Tp, d.span, s.stride, s.padding, s.reflect)
    spans = -(-(Tp + shift) // d.span)
    assert spans == -(-Tp // d.span) and spans * d.span - shift >= Tp
    assert B * spans <= 65535
    assert 1 <= d.split <= min(fcp.MAX_SPLIT, s.dgrad_max_live)
    T_out = _t_out(s, T)
    if w.span == 0:  # x's whole rows of a block fit: the plan from before spans
        assert fcp._wgrad_smem(B, T, s.kernel_size, T_out, t_ld, s.stride, w.sb,
                               w.split) <= fcp.MAX_SMEM
        return
    items = B * -(-T_out // w.span)
    assert w.span == fcp.wgrad_span_cols(s.kernel_size, s.stride) > 64
    assert w.sb == 1 and 1 <= w.split <= min(8, items)
    assert fcp._wgrad_span_smem(s.kernel_size, s.stride, w.span) <= fcp.MAX_SMEM


@pytest.mark.parametrize("B,T", [(1, 1024), (8, 1024), (1, 7200)])
@pytest.mark.parametrize("level", range(4))
def test_long_trajectory_rows_plan_spans(level, B, T):
    s = _traj_convs()[level].structure()
    assert (s.kernel_size, s.stride, s.padding) == (31, 1, 15)
    d, w, t_ld = _plans(s, B, T)
    _check_span_plans(s, B, T, d, w, t_ld)
    # four M tiles of 64 columns, two stages of 31 taps' planes in flight;
    # no split of x's rows fits a block
    assert d.span == 256 and w.span == fcp.WGRAD_SPAN_COLS
    assert fcp._dgrad_span_layout(31, 1, d.span)[1] == 2


@pytest.mark.parametrize("stride,T", [(2, 1024), (2, 256), (3, 1024)])
def test_strided_rows_past_the_old_limit_plan_spans(stride, T):
    live = torch.zeros(128, 24, dtype=torch.bool)
    live[:64, :16] = True
    live[64:, 8:] = True
    s = fcp.pack_structure(live, 15, torch.float32, stride, 7)
    assert T + 14 > 256 // stride  # past one block's 16 column tiles
    d, w, t_ld = _plans(s, 4, T)
    _check_span_plans(s, 4, T, d, w, t_ld)
    # wgrad: a batch's g fragments at T_out 512 or 342 pass a block's shared memory
    assert (w.span > 0) == (T == 1024)


# the plans before spans (the parent's dgrad_plan / wgrad_plan and the
# dgrad layout they read), the reference for every existing shape
def _old_dgrad_smem(T_in, K, t_ld, stride, padding, nbb):
    Tp, kmax = T_in + 2 * padding, -(-K // stride)
    T_out = (Tp - K) // stride + 1
    rs = (kmax - 1 + max(-(-Tp // stride), T_out) + 11) // 16 * 16 + 4
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    w_ring = a16(2 * 32 * (16 * K + 8) * 4)
    g2_end = 64 + w_ring + a16(2 * nbb * 32 * t_ld * 4) + nbb * 32 * rs * 8
    out = 16 * nbb * Tp * 4
    return g2_end if out <= w_ring else a16(g2_end) + out


def _old_dgrad_plan(B, T_in, K, stride, padding, t_ld, pairs, max_live, sms, windows=1):
    Tp = T_in + 2 * padding
    widths = [-(-(Tp - phi) // stride) for phi in range(stride)]
    assert sum(-(-v // 16) for v in widths) <= 16
    best = None
    for nb in range(1, B + 1):
        smem = _old_dgrad_smem(T_in, K, t_ld, stride, padding, nb)
        if nb > 1 and (sum(-(-nb * v // 16) for v in widths) > 8 or smem > fcp.MAX_SMEM):
            continue
        groups = -(-B // nb)
        nbb = -(-B // groups)
        per_sm = 2 if smem <= fcp.MAX_SMEM_PER_SM // 2 - 1024 else 1
        for split in range(1, min(8, max(1, max_live)) + 1):
            blocks = pairs * windows * groups * split
            cost = (-(-blocks // (sms * per_sm)) * (-(-max_live // split) + 1), blocks)
            if best is None or cost < best[0]:
                best = (cost, (nbb, groups, split))
    return best[1]


def _old_wgrad_plan(B, T_out, entries, sms, windows=1, smem=None):
    split = max(1, min(8, B, -(-sms // max(1, entries * windows))))

    def stage(split):
        return max(1, min(-(-B // split), 32 // T_out))

    while smem is not None and split < min(8, B) and smem(stage(split), split) > fcp.MAX_SMEM:
        split += 1
    return stage(split), split


def _existing_shapes():
    for name, batches in (("len64_no_aug_hm_vae", (8, 64)), ("len64_production", (8, 64))):
        for conv, T in _vae_cases(name):
            for B in batches:
                yield conv.structure(), B, T, 1
    for conv, T in _vae_cases("len_64_test_interpolation")[4:]:
        yield conv.structure(), 1, T, 10  # the solver's 10 windows
    for conv in _traj_convs():
        for B, T in ((8, 128), (10, 64), (64, 64), (1, 64)):
            yield conv.structure(), B, T, 1


def test_existing_shapes_keep_their_plans():
    """Every existing shape keeps its plans, but dgrad and wgrad at the
    routed shapes: the len-64 levels at the production batch of 64, where
    dgrad takes spans of several batches' whole rows
    (``dgrad_rows_routed``) and wgrad items of several batches' whole rows
    (``wgrad_rows_routed``); and the trajectory's short K-31 rows (fewer
    than 64 batches, T 64-128: ``traj_rows``), where the card timed the
    span kernels faster (f32 here): wgrad items of one batch's columns at
    (8, 128), (10, 64) and (1, 64) (``wgrad_items_routed``); dgrad spans
    from 4 batches on, at (8, 128) one batch's padded row a span, at (10,
    64) two.  dgrad at (1, 64) and both at (64, 64) are not routed.  The
    solve's windowed wgrad (10 windows of one batch at the decoder levels)
    goes to the tile kernel (``wgrad_tiles_routed``).  The whole-row plans,
    ``dgrad_whole_plan`` and ``wgrad_whole_plan``, are still the ones from
    before at every shape."""
    n = routed = w_routed = traj_d = traj_w = tiles = 0
    for s, B, T, windows in _existing_shapes():
        d, w, t_ld = _plans(s, B, T, windows)
        if fcp.wgrad_tiles_routed(B, T, s.kernel_size, s.stride, s.padding,
                                  s.wgrad_row.numel(), 4, windows):
            assert windows == 10 and B == 1 and s.kernel_size == 15
            tiles += 1
        T_out = _t_out(s, T)
        K = s.kernel_size
        old_d = _old_dgrad_plan(B, T, K, s.stride, s.padding, t_ld,
                                s.dgrad_start.numel() - 1, s.dgrad_max_live, SMS, windows)
        smem = lambda sb, split: fcp._wgrad_smem(B, T, K, T_out, t_ld,  # noqa
                                                 s.stride, sb, split)
        old_w = _old_wgrad_plan(B, T_out, s.wgrad_row.numel(), SMS, windows, smem)
        cols = fcp.wgrad_span_cols(K, s.stride)
        if windows == 1 and fcp.wgrad_rows_routed(B, T, K, s.stride, s.padding):
            assert B == 64 and K == 15
            nbb = fcp.wgrad_span_rows(B, T, K, s.stride, s.padding, 4, cols)
            assert w == fcp.wgrad_span_plan(B, T_out, s.wgrad_row.numel(), SMS, 1, cols, nbb)
            assert w.sb == nbb > 1 and w.span == cols and nbb * T_out <= cols
            w = fcp.wgrad_whole_plan(B, T_out, s.wgrad_row.numel(), SMS, windows, smem, cols)
            w_routed += 1
        elif windows == 1 and fcp.wgrad_items_routed(B, T, K, s.stride, s.padding):
            assert K == 31 and (B, T) in ((8, 128), (10, 64), (1, 64))
            assert w == fcp.wgrad_span_plan(B, T_out, s.wgrad_row.numel(), SMS, 1, cols, 1)
            assert w.sb == 1 and w.span == cols == 128
            w = fcp.wgrad_whole_plan(B, T_out, s.wgrad_row.numel(), SMS, windows, smem, cols)
            traj_w += 1
        assert w == old_w + (0,), (K, B, T, windows)
        if windows == 1 and fcp.dgrad_rows_routed(B, T, K, s.stride, s.padding):
            assert (B == 64 and K == 15) or (K, B, T) in ((31, 8, 128), (31, 10, 64))
            # the trajectory's: its split counted in stages
            assert d == fcp.dgrad_span_plan(B, T, K, s.stride, s.padding,
                                            s.dgrad_span_start.numel() - 1,
                                            s.dgrad_span_max_live, SMS, 1, 4)
            # whole padded rows a span: several at batch 64; at K 31 one at
            # T 128 (158 columns), two at T 64 (94)
            assert d.nbb == 256 // (T + 30) if K == 31 else d.nbb > 1
            assert d.span == fcp.dgrad_span_cols(K, s.stride)
            d = fcp.dgrad_whole_plan(B, T, K, s.stride, s.padding, t_ld,
                                     s.dgrad_start.numel() - 1, s.dgrad_max_live, SMS, windows)
            if K == 31:
                traj_d += 1
            else:
                routed += 1
        assert d == old_d + (0,), (K, B, T, windows)
        assert fcp._dgrad_smem(T, K, t_ld, s.stride, s.padding, d.nbb) == \
            _old_dgrad_smem(T, K, t_ld, s.stride, s.padding, d.nbb)
        n += 1
    assert n == 8 * 4 + 4 + 16
    assert routed == w_routed == 8 * 2
    assert traj_d == 4 * 2 and traj_w == 4 * 3 and tiles == 4


def dgrad_by_span(g, w, T_in, stride, padding, reflect, span, split=1):
    """The span kernel's arithmetic in plain PyTorch (w dense: every row
    tile live).  The padded row is cut into spans of ``span`` columns, the
    first narrower by ``dgrad_span_shift``; a span [u0, u0 + width) stages
    g's columns from the 16-byte granule tb0 = floor4(t0 - off) on (t0 =
    u0 / stride, off = ceil(K / stride) - 1; zeros outside [0, T_out)),
    ``gw`` of them as the layout has it.  Its columns u = u0 + stride*v +
    phi (M tiles of 64 columns v of each stride phase phi) sum, for each
    stage (8 rows p of a row tile; rank r of ``split`` takes its contiguous
    run of the stages, ``rank_stages``) and each tap m (k = phi + stride*m, zero past K), the
    product of the A operand, the staged columns t0 - tb0 + v - m, with the
    tap's slice, added to the tile's sum in stage then tap order; the ranks'
    sums are added in rank order, and the span folds its reflected columns
    and stores gx."""
    B, P, T_out = g.shape
    C, K = w.shape[1], w.shape[2]
    Tp, off = T_in + 2 * padding, -(-K // stride) - 1
    gw = (off + span // stride + 6) // 4 * 4
    shift = fcp.dgrad_span_shift(Tp, span, stride, padding, reflect)
    V = span // stride  # columns v of a phase: span // (64 * stride) M tiles
    assert V % 64 == 0 and stride * V // 64 <= fcp.DGRAD_SPAN_TILES
    gx = g.new_zeros(B, C, T_in)
    for sp in range(-(-(Tp + shift) // span)):
        u0 = 0 if sp == 0 else sp * span - shift
        width = min(Tp, (sp + 1) * span - shift) - u0
        t0 = u0 // stride
        tb0 = (t0 - off) // 4 * 4
        t = torch.arange(tb0, tb0 + gw)
        ok = (t >= 0) & (t < T_out)
        staged = g.new_zeros(B, P, gw)
        staged[:, :, ok] = g[:, :, t[ok]]
        total = None
        for rank in range(split):
            part = g.new_zeros(B, C, span)
            for phi in range(stride):
                v = torch.arange(V)
                sums = g.new_zeros(B, C, V)
                for p0 in rank_stages(P, 8, rank, split):
                    rows = slice(p0, min(P, p0 + 8))
                    for m in range(off + 1):
                        k = phi + stride * m
                        if k >= K:
                            continue
                        cols = t0 - tb0 + v - m
                        assert cols.min() >= 0 and cols.max() < gw
                        sums += torch.einsum("bpv,pc->bcv", staged[:, rows][:, :, cols],
                                             w[rows, :, k])
                keep = stride * v + phi < width
                part[:, :, (stride * v + phi)[keep]] = sums[:, :, keep]
            total = part if total is None else total + part
        for i in range(max(0, u0 - padding), min(T_in, u0 + width - padding)):
            col = total[:, :, i + padding - u0]
            mirrors = []
            if reflect and 1 <= i <= padding:
                mirrors.append(padding - i)
            if reflect and T_in - 1 - padding <= i <= T_in - 2:
                mirrors.append(padding + 2 * (T_in - 1) - i)
            for u in mirrors:
                assert 0 <= u - u0 < width  # the reflected column lies in the same span
                col = col + total[:, :, u - u0]
            gx[:, :, i] = col
    return gx


def span_window(t_lo, nt, T_in, K, stride, padding, reflect):
    """The columns [lo, hi] of x's unpadded row that the output columns
    [t_lo, t_lo + nt) read, the padding resolved (the kernel's
    ``span_window``)."""
    s0 = t_lo * stride - padding
    s1 = s0 + (nt - 1) * stride + K - 1
    lo, hi = max(s0, 0), min(s1, T_in - 1)
    if lo > hi:
        lo, hi = T_in, -1
    if reflect and s0 < 0:
        lo, hi = min(lo, -min(s1, -1)), max(hi, -s0)
    if reflect and s1 >= T_in:
        lo, hi = min(lo, 2 * T_in - 2 - s1), max(hi, 2 * T_in - 2 - max(s0, T_in))
    return lo, hi


def wgrad_by_items(g, x, K, stride, padding, reflect, cols, split=1):
    """The span kernel's wgrad in plain PyTorch: the (b, t) reduction as
    items of one batch's ``cols`` output columns, contiguous runs of them on
    each of ``split`` cluster ranks.  An item stages x's rows over the
    window its taps read, from the 16-byte granule that holds the window's
    first column of the flat x (the stage's ``(Lx + 9) // 4 * 4`` columns
    hold it), and resolves the padding from there; its g is taken chunk by
    chunk; each rank sums its items in order, then the ranks' tiles are
    added in rank order."""
    B, P, T_out = g.shape
    C, T_in = x.shape[1], x.shape[2]
    nch = -(-T_out // cols)
    items = B * nch
    Lx = (cols - 1) * stride + K
    flat = x.reshape(-1)
    parts = []
    for rank in range(split):
        gw, gb = g.new_zeros(P, C, K), g.new_zeros(P)
        for item in range(items * rank // split, items * (rank + 1) // split):
            b, t_lo = item // nch, item % nch * cols
            nt = min(cols, T_out - t_lo)
            lo, hi = span_window(t_lo, nt, T_in, K, stride, padding, reflect)
            assert hi < lo or hi - lo + 1 <= Lx
            # the item's padded columns u = t_lo*stride + j, j < Lx
            s = torch.arange(Lx) + t_lo * stride - padding
            if reflect:
                u = s + padding
                edge = ((s < 0) | (s >= T_in)) & (u < T_in + 2 * padding)
                s = torch.where(edge, torch.where(s < 0, -s, 2 * (T_in - 1) - s), s)
            inside = (s >= lo) & (s <= hi)
            padded = g.new_zeros(C, Lx)
            for c in range(C):
                e0 = (b * C + c) * T_in + lo
                g0 = e0 // 4
                staged = flat[4 * g0:4 * ((e0 + hi - lo) // 4 + 1)]  # the row's bulk copy
                assert staged.numel() <= (Lx + 9) // 4 * 4
                if hi >= lo:
                    padded[c, inside] = staged[s[inside] - lo + e0 % 4]
            for j0 in range(0, nt, fcp.WGRAD_SPAN_CHUNK):
                n = min(fcp.WGRAD_SPAN_CHUNK, nt - j0)
                patches = torch.stack([padded[:, j0 * stride + k:(j0 + n - 1) * stride + k + 1:stride]
                                       for k in range(K)], -1)  # (C, n, K)
                gc = g[b, :, t_lo + j0:t_lo + j0 + n]
                gw += torch.einsum("pt,ctk->pck", gc, patches)
                gb += gc.sum(1)
        parts.append((gw, gb))
    gw, gb = parts[0]
    for w, bias in parts[1:]:
        gw, gb = gw + w, gb + bias
    return gw, gb


@pytest.mark.parametrize("stride,T", [(1, 300), (2, 301), (3, 299)])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_span_arithmetic_matches_the_plain_backward(mode, stride, T):
    K, padding, P, C = (31, 15, 24, 16) if stride == 1 else (15, 7, 24, 16)
    gen = torch.Generator().manual_seed(stride * 1000 + T)
    w = torch.randn(P, C, K, generator=gen, dtype=torch.float64)
    x = torch.randn(2, C, T, generator=gen, dtype=torch.float64)
    y = fcp.fused_conv_pool_reference(x, w, None, None, None, stride, padding, mode, 0.2)
    gy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    g = fcp._act_grad(gy, y, 0.2)
    got = dgrad_by_span(g, w, T, stride, padding, mode == "reflect",
                        fcp.dgrad_span_cols(K, stride))
    want = fcp.fused_conv_pool_dgrad_reference(gy, y, w, T, stride, padding, mode, 0.2)
    torch.testing.assert_close(got, want, atol=1e-10, rtol=0)
    gw, gb = wgrad_by_items(g, x, K, stride, padding, mode == "reflect",
                            fcp.wgrad_span_cols(K, stride))
    rw, rb = fcp.fused_conv_pool_wgrad_reference(gy, y, x, K, stride, padding, mode, 0.2, None)
    torch.testing.assert_close(gw, rw, atol=1e-10, rtol=0)
    torch.testing.assert_close(gb, rb, atol=1e-10, rtol=0)


@pytest.mark.parametrize("T", [1000, 7201, 301])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_dgrad_spans_match_the_plain_dgrad(mode, stride, T):
    """The dgrad span kernel's decomposition at its plan's span, with the
    row tiles of a pair split over two cluster ranks (P 80: a second row
    tile of 16 rows), in float64 against the plain dgrad, at lengths whose
    padded row is no multiple of the span (T 1,000: the last span under
    reflect too short for its edge, the first narrower)."""
    K, padding, P, C, B = (31, 15, 80, 16, 2) if stride == 1 else (15, 7, 80, 16, 2)
    gen = torch.Generator().manual_seed(stride * 100 + T)
    w = torch.randn(P, C, K, generator=gen, dtype=torch.float64)
    x = torch.randn(B, C, T, generator=gen, dtype=torch.float64)
    y = fcp.fused_conv_pool_reference(x, w, None, None, None, stride, padding, mode, 0.2)
    gy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    span = fcp.dgrad_span_cols(K, stride)
    assert (T + 2 * padding) % span
    got = dgrad_by_span(fcp._act_grad(gy, y, 0.2), w, T, stride, padding, mode == "reflect",
                        span, split=2)
    want = fcp.fused_conv_pool_dgrad_reference(gy, y, w, T, stride, padding, mode, 0.2)
    torch.testing.assert_close(got, want, atol=1e-10, rtol=0)


@pytest.mark.parametrize("T", [1000, 7201])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_wgrad_items_match_the_plain_wgrad(mode, stride, T):
    """The span kernel's decomposition at its plan (item width, the split
    over 8 ranks of a level with 3 live tiles) in float64 against the plain
    wgrad, at lengths whose T_out is no multiple of the item width."""
    K, padding, P, C, B = (31, 15, 16, 16, 2) if stride == 1 else (15, 7, 16, 16, 2)
    gen = torch.Generator().manual_seed(stride * 10000 + T)
    w = torch.randn(P, C, K, generator=gen, dtype=torch.float64)
    x = torch.randn(B, C, T, generator=gen, dtype=torch.float64)
    y = fcp.fused_conv_pool_reference(x, w, None, None, None, stride, padding, mode, 0.2)
    gy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    T_out = y.shape[2]
    plan = fcp.wgrad_span_plan(B, T_out, 3, SMS, 1, fcp.wgrad_span_cols(K, stride))
    assert T_out % plan.span and plan.split == 8
    gw, gb = wgrad_by_items(fcp._act_grad(gy, y, 0.2), x, K, stride, padding,
                            mode == "reflect", plan.span, plan.split)
    rw, rb = fcp.fused_conv_pool_wgrad_reference(gy, y, x, K, stride, padding, mode, 0.2, None)
    torch.testing.assert_close(gw, rw, atol=1e-10, rtol=0)
    torch.testing.assert_close(gb, rb, atol=1e-10, rtol=0)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("K", [15, 31])
def test_wgrad_span_block_fits_at_any_length(K, stride):
    """The widest item whose two stages fit a block: 128 columns at
    strides 1 and 2, 96 at stride 3; its shared memory, and so the plan's
    width, the same at every length.  In bf16 (chunks of 64 columns, half
    the bytes) 128 at every stride."""
    cols = fcp.wgrad_span_cols(K, stride)
    assert cols == (128 if stride < 3 else 96) and cols % fcp.WGRAD_SPAN_CHUNK == 0
    assert fcp._wgrad_span_smem(K, stride, cols) <= fcp.MAX_SMEM
    if cols < fcp.WGRAD_SPAN_COLS:
        assert fcp._wgrad_span_smem(K, stride, cols + fcp.WGRAD_SPAN_CHUNK) > fcp.MAX_SMEM
    cols16 = fcp.wgrad_span_cols(K, stride, 2)
    assert cols16 == fcp.WGRAD_SPAN_COLS and fcp._wgrad_span_smem(K, stride, cols16, 2) <= \
        fcp.MAX_SMEM
    live = torch.zeros(128, 24, dtype=torch.bool)
    live[:64, :16] = True
    live[64:, 8:] = True
    s = fcp.pack_structure(live, K, torch.float32, stride, (K - 1) // 2)
    for T in (4000, 7201, 100000):
        d, w, t_ld = _plans(s, 1, T)
        _check_span_plans(s, 1, T, d, w, t_ld)
        assert w.span == cols


@pytest.mark.parametrize("level", [0, 3])
def test_plain_backward_at_t1024_matches_jax_vjp(level):
    """The wrappers' CPU path on the folded level at batch 2, T 1,024,
    against jax.vjp of the JAX level on the raw weight, the weight's and
    bias's gradients carried back through the fold (mask, pool)."""
    conv = _traj_convs()[level]
    spec, s, T = conv.spec, conv.structure(), 1024
    rng = np.random.default_rng(level)
    w, b = conv.weight.detach().numpy(), conv.bias.detach().numpy()
    mask, pool = spec.mask.astype(np.float32), conv.pool.numpy()
    x = rng.normal(size=(2, spec.in_channels, T)).astype(np.float32)

    def level_fn(x, w, b):
        y = jsnn.skeleton_conv_w(x, w * mask[:, :, None], b, 1, spec.padding, "reflect")
        return jsnn.leaky_relu(jsnn.apply_channel_matrix(y, jnp.asarray(pool)), 0.2)

    y, vjp = jax.vjp(level_fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gy = rng.normal(size=y.shape).astype(np.float32)
    gx_ref, gw_ref, gb_ref = (np.asarray(a) for a in vjp(jnp.asarray(gy)))
    with torch.no_grad():
        wf, _ = conv.folded_weight()
    yt, gyt = torch.from_numpy(np.array(y)), torch.from_numpy(gy)
    gx = fcp.fused_conv_pool_dgrad(gyt, yt, wf, s, T).numpy()
    gwf, gbf = fcp.fused_conv_pool_wgrad(gyt, yt, torch.from_numpy(x), s)
    gw = torch.einsum("qo,qck->ock", conv.pool, gwf) * torch.from_numpy(mask)[:, :, None]
    np.testing.assert_allclose(gx, gx_ref, atol=_tol(gx_ref), rtol=0)
    np.testing.assert_allclose(gw.numpy(), gw_ref, atol=_tol(gw_ref), rtol=0)
    np.testing.assert_allclose((conv.pool.T @ gbf).numpy(), gb_ref, atol=_tol(gb_ref), rtol=0)


def wgrad_by_rows(g, x, K, stride, padding, reflect, cols, nbb, split=1,
                  chunk=fcp.WGRAD_SPAN_CHUNK, esz=4):
    """The item kernel's wgrad over items of several batches' whole rows in
    plain PyTorch: item q holds batches [q*nbb, q*nbb + nbl), contiguous
    runs of items on each of ``split`` cluster ranks.  Each batch's 8-channel
    rows of x are staged as the 3D box stages them, dense (its rows whole
    16-byte granules of ``esz``-byte values), and padded by stride phase
    through the padding's table with a period of R = T_out + off columns a
    batch (batch bb's padded column u at (u % stride)*Lh + bb*R + u //
    stride, Lh = nbb*R: x's column or a zero).  Item column n (batch n // T_out) reads x at n + (n //
    T_out)*(R - T_out) from the tap's offset (k % stride)*Lh + k // stride;
    the item's columns are summed ``chunk`` at a time (a chunk's k-steps
    may hold two batches' columns), each chunk's sum added in order; then
    the ranks' tiles in rank order."""
    B, P, T_out = g.shape
    C, T_in = x.shape[1], x.shape[2]
    assert C % 8 == 0 and nbb * T_out <= cols and (T_in * esz) % 16 == 0
    R = T_out + -(-K // stride) - 1
    Lh, U = nbb * R, stride * R
    u = torch.arange(U)
    s = u - padding
    if reflect:
        edge = ((s < 0) | (s >= T_in)) & (u < T_in + 2 * padding)
        s = torch.where(edge, torch.where(s < 0, -s, 2 * (T_in - 1) - s), s)
    dst = (u % stride) * Lh + u // stride
    inside = (s >= 0) & (s < T_in)
    flat = x.reshape(-1)
    items = -(-B // nbb)
    parts = []
    for rank in range(split):
        gw, gb = g.new_zeros(P, C, K), g.new_zeros(P)
        for item in range(items * rank // split, items * (rank + 1) // split):
            b0, nbl = item * nbb, min(nbb, B - item * nbb)
            xs = g.new_zeros(C, stride * Lh)
            for bb in range(nbl):
                for c0 in range(0, C, 8):
                    e0 = ((b0 + bb) * C + c0) * T_in
                    staged = flat[e0:e0 + 8 * T_in]  # the box's rows of this batch
                    src = torch.arange(8)[:, None] * T_in + s[inside][None]
                    xs[c0:c0 + 8, bb * R + dst[inside]] = staged[src]
            nt = nbl * T_out
            for j0 in range(0, nt, chunk):
                n = torch.arange(j0, min(nt, j0 + chunk))
                col = n + n // T_out * (R - T_out)
                patches = torch.stack([xs[:, (k % stride) * Lh + k // stride + col]
                                       for k in range(K)], -1)  # (C, n, K)
                gc = g[b0 + n // T_out, :, n % T_out]  # (n, P)
                gw += torch.einsum("np,cnk->pck", gc, patches)
                gb += gc.sum(0)
        parts.append((gw, gb))
    gw, gb = parts[0]
    for w, bias in parts[1:]:
        gw, gb = gw + w, gb + bias
    return gw, gb


# the len-64 model's levels: (T_in, stride), K 15, padding 7
LEN64_LEVELS = ((64, 2), (32, 2), (16, 2), (8, 2), (8, 1), (16, 1), (32, 1), (64, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
@pytest.mark.parametrize("T_in,stride", LEN64_LEVELS)
def test_wgrad_rows_items_match_the_plain_wgrad(T_in, stride, mode, dtype):
    """Items of several batches' whole rows at each len-64 level's T and
    stride, K 15: a batch of 23 (41 at enc3; the last item ragged), the plan's batches
    an item and its chunk (32 columns in f32, 64 in bf16), the items over
    the plan's cluster ranks (one live tile: as many as items); in float64 on inputs rounded to the dtype (g rounded once, as
    the kernel rounds it) against the plain wgrad in float64 (1e-10: the
    same sums in another order), and in bf16 the output rounded once
    against the plain bf16 version at the kernels' 0.02 * max|ref|."""
    K, padding, P, C = 15, 7, 24, 16
    B = 41 if T_in // stride == 4 else 23  # enc3: up to 32 batches an item
    esz = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator().manual_seed(T_in * 10 + stride)
    x = torch.randn(B, C, T_in, generator=gen).to(dtype).double()
    w = torch.randn(P, C, K, generator=gen).double()
    y = fcp.fused_conv_pool_reference(x, w, None, None, None, stride, padding, mode, 0.2)
    gy = torch.randn(y.shape, generator=gen).to(dtype).double()
    y = y.to(dtype).double()
    g = fcp._act_grad(gy, y, 0.2).to(dtype).double()
    T_out = y.shape[2]
    cols = fcp.wgrad_span_cols(K, stride, esz)
    nbb = fcp.wgrad_span_rows(B, T_in, K, stride, padding, esz, cols)
    # as many rows as fill an item (fewer where the block would not fit
    # shared memory, or in bf16 two blocks an SM), spread evenly over the
    # items; the last item ragged
    full = -(-B // -(-B // min(B, cols // T_out)))
    assert 1 < nbb <= full and B % nbb
    t_ld = -(-T_out // (16 // esz)) * (16 // esz)
    assert fcp.wgrad_items_per_sm(K, stride, cols, esz, nbb, T_in, T_out, t_ld) == 3 - esz // 2
    plan = fcp.wgrad_span_plan(B, T_out, 1, SMS, 1, cols, nbb)
    # one live tile: its items split over the cluster, a rank's run ragged or not
    assert plan.sb == nbb and plan.span == cols and 1 < plan.split <= min(8, -(-B // nbb))
    gw, gb = wgrad_by_rows(g, x, K, stride, padding, mode == "reflect", cols, nbb, plan.split,
                           fcp.WGRAD_SPAN_CHUNK * 4 // esz, esz)
    rw, rb = fcp.fused_conv_pool_wgrad_reference(g, torch.ones_like(y), x, K, stride, padding,
                                                 mode, 0.2, None)
    torch.testing.assert_close(gw, rw, atol=1e-10, rtol=0)
    torch.testing.assert_close(gb, rb, atol=1e-10, rtol=0)
    if dtype == torch.bfloat16:
        pw, pb = fcp.fused_conv_pool_wgrad_reference(gy.to(dtype), y.to(dtype), x.to(dtype), K,
                                                     stride, padding, mode, 0.2, None)
        for got, plain in ((gw, pw), (gb, pb)):
            err = float((got.to(dtype).float() - plain.float()).abs().max())
            assert err <= 0.02 * float(plain.float().abs().max())


@pytest.mark.parametrize("T_in,stride", [(16, 2), (32, 1)])
def test_wgrad_rows_items_match_jax_vjp(T_in, stride):
    """The decomposition into items of several batches' whole rows, at
    small widths (16 channels, 24 rows, batch 23) on f32 inputs, against
    jax.vjp of the JAX package's level (the conv, then LeakyReLU) for the
    weight's and bias's gradients: f32, 1e-4 * max(1, max|ref|) (JAX sums
    the 23 batches' columns in f32, the decomposition in float64)."""
    K, padding, P, C, B = 15, 7, 24, 16, 23
    rng = np.random.default_rng(T_in + stride)
    x = rng.normal(size=(B, C, T_in)).astype(np.float32)
    w = (rng.normal(size=(P, C, K)) * 0.1).astype(np.float32)
    b = rng.normal(size=(P,)).astype(np.float32)

    def level_fn(w, b):
        return jsnn.leaky_relu(jsnn.skeleton_conv_w(jnp.asarray(x), w, b, stride, padding,
                                                    "reflect"), 0.2)

    y, vjp = jax.vjp(level_fn, jnp.asarray(w), jnp.asarray(b))
    gy = rng.normal(size=y.shape).astype(np.float32)
    gw_ref, gb_ref = (np.asarray(a) for a in vjp(jnp.asarray(gy)))
    g = fcp._act_grad(torch.from_numpy(gy).double(), torch.from_numpy(np.array(y)).double(), 0.2)
    cols = fcp.wgrad_span_cols(K, stride)
    nbb = fcp.wgrad_span_rows(B, T_in, K, stride, padding, 4, cols)
    gw, gb = wgrad_by_rows(g, torch.from_numpy(x).double(), K, stride, padding, True, cols, nbb,
                           2)
    np.testing.assert_allclose(gw.numpy(), gw_ref, atol=_tol(gw_ref), rtol=0)
    np.testing.assert_allclose(gb.numpy(), gb_ref, atol=_tol(gb_ref), rtol=0)
