"""dgrad's span kernel over whole padded rows of several batches (the short
rows of a large batch) and its weight's one-pass layout, on the CPU (the
kernels run on the GPU, where chip_smoke.py's production-batch phases hold
them against their plain versions, bit-equal on two runs):

- the spans' arithmetic in plain PyTorch, as the kernel stages and sums it:
  a span holds the whole padded rows of ``nbb`` batches, g staged with a
  period of R columns a batch (its T_out columns after off zeros, zeros up
  to the next batch's), each phase's M tiles of 64 columns v over the
  batches' periods, the taps read at the A operand's offset, a stage's rows
  p (8 in f32, 16 in bf16) summed in stage then tap order over the cluster
  ranks' row tiles, the ranks' sums in rank order, each batch's reflected
  columns folded in the block; held against ``fused_conv_pool_dgrad_reference``
  in float64 at every len-64 level (strides 1 and 2), reflect and zero
  padding, on g and a weight rounded to f32 or to bf16, and in bf16 against
  the plain bf16 version at the kernels' 0.02 * max|ref|;
- the weight's layout: the plain version's f32 planes bit for bit against
  the torch passes it replaced, the one-pass kernel's index arithmetic
  (a block's rows p of 32 channels read once, its K taps' planes written)
  bit for bit against the plain version in f32 and bf16, and the bf16
  layout entry by entry;
- the planner: which shapes route to spans of whole rows (the len-64 levels
  at the production batch of 64, in f32 and bf16; the trajectory's K-31
  rows at (8, 128) and (10, 64) in f32 and bf16, where the card timed
  spans faster) and which keep their plans (batch 8, the
  trajectory's (64, 64), windows, the lora solve's 10 batches), the plans'
  batches a span (the fill of 256 columns),
  and the span layout and period against a transcription of the kernel's
  (``dgrad_span_layout``, ``dgrad_span_period`` in
  ``csrc/fused_conv_pool_bwd.cu``).

The level gradients against JAX on the CPU are
``tests/test_torch_bf16_backward.py::test_bf16_level_grads_match_jax`` and
``tests/test_torch_fused_conv_pool_grad.py``.
"""

import os

import pytest
import torch

from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "len64_no_aug_hm_vae.yaml")
SMS = 132
# the len-64 model's levels: (name, T_in, stride), K 15, padding 7
LEVELS = (("enc0", 64, 2), ("enc1", 32, 2), ("enc2", 16, 2), ("enc3", 8, 2),
          ("dec0", 8, 1), ("dec1", 16, 1), ("dec2", 32, 1), ("dec3", 64, 1))
# whole padded rows of a 256-column span at each level (the fill table)
ROWS_A_SPAN = {"enc0": 3, "enc1": 5, "enc2": 8, "enc3": 11,
               "dec0": 11, "dec1": 8, "dec2": 5, "dec3": 3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rank_stages(P, rows_p, rank, split):
    """The first rows p of the stages that cluster rank ``rank`` of
    ``split`` takes (w dense: every row tile live), as the span kernel
    splits them: the row tiles' stages in order, ``rows_p`` rows p each (a
    row tile's last stage the rows left), a contiguous run a rank, total *
    rank // split on."""
    stages = [p0 for rt in range(-(-P // 64)) for p0 in range(64 * rt, min(P, 64 * rt + 64),
                                                            rows_p)]
    n = len(stages)
    return stages[n * rank // split:n * (rank + 1) // split]


def dgrad_by_rows(g, w, T_in, stride, padding, reflect, plan, rows_p, split):
    """The span kernel's arithmetic over whole rows in plain PyTorch (w
    dense: every row tile live).  Batch group q of the plan holds the
    padded rows of batches [q * nbb, q * nbb + nbl).  g is staged from
    column 0 (t = -off) on with a period of R columns a batch (batch bb's
    column t at off + bb * R + t, zeros elsewhere), ``gw`` columns as the
    layout has them.  M row v of phase phi (an M tile of 64 rows a consumer
    warpgroup) is batch v // R's column v % R; it sums, for each stage
    (``rows_p`` rows p of a row tile; rank r of ``split`` takes row tiles r,
    r + split, ..) and each tap m (k = phi + stride*m, zero past K), the
    product of the A operand, the staged columns off + v - m, with the tap's
    slice, in stage then tap order (rank r of ``split`` takes its contiguous
    run of the stages: :func:`rank_stages`); the ranks' sums are added in
    rank order and each batch's reflected columns fold onto their sources."""
    B, P, T_out = g.shape
    C, K = w.shape[1], w.shape[2]
    Tp, off = T_in + 2 * padding, -(-K // stride) - 1
    esz = 2 if rows_p == 16 else 4
    gran = 16 // esz
    span = plan.span
    gw = (off + span // stride + 2 * gran - 2) // gran * gran
    R = fcp.dgrad_span_period(T_in, K, stride, padding)
    mt = span // (64 * stride)
    assert plan.nbb * R <= 64 * mt and plan.nbb * Tp <= span
    gx = g.new_zeros(B, C, T_in)
    for q in range(plan.groups):
        b0 = q * plan.nbb
        nbl = min(plan.nbb, B - b0)
        if nbl <= 0:
            continue
        t = torch.arange(gw) - off
        bb = torch.div(t, R, rounding_mode="floor")
        tt = t - bb * R
        ok = (t >= 0) & (bb < nbl) & (tt < T_out)
        staged = g.new_zeros(P, gw)
        staged[:, ok] = g[b0 + bb[ok], :, tt[ok]].T
        total = None
        for rank in range(split):
            part = g.new_zeros(C, span)
            for phi in range(stride):
                for tile in range(mt):
                    v = torch.arange(64 * tile, 64 * tile + 64)
                    if v[0] >= nbl * R:
                        continue  # an idle warpgroup
                    sums = g.new_zeros(C, 64)
                    for p0 in rank_stages(P, rows_p, rank, split):
                        rows = slice(p0, min(P, p0 + rows_p))
                        for m in range(off + 1):
                            k = phi + stride * m
                            if k >= K:
                                continue
                            cols = off + v - m
                            assert cols.min() >= 0 and cols.max() < gw
                            sums += torch.einsum("pv,pc->cv", staged[rows][:, cols],
                                                 w[rows, :, k])
                    vb = torch.div(v, R, rounding_mode="floor")
                    u = stride * (v - vb * R) + phi
                    keep = (vb < nbl) & (u < Tp)
                    part[:, (vb * Tp + u)[keep]] = sums[:, keep]
            total = part if total is None else total + part
        for b in range(nbl):
            for i in range(T_in):
                col = total[:, b * Tp + i + padding]
                if reflect and 1 <= i <= padding:
                    col = col + total[:, b * Tp + padding - i]
                if reflect and T_in - 1 - padding <= i <= T_in - 2:
                    col = col + total[:, b * Tp + padding + 2 * (T_in - 1) - i]
                gx[b0 + b, :, i] = col
    return gx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
@pytest.mark.parametrize("level,T_in,stride", LEVELS)
def test_rows_arithmetic_matches_the_plain_dgrad(level, T_in, stride, mode, dtype):
    """A batch of 23 (a ragged last batch group) at each len-64 level's T
    and stride, K 15, two row tiles (the second ragged), two cluster ranks:
    float64 on inputs rounded to the dtype against the plain dgrad in
    float64, and (bf16) g and the output rounded once against the plain
    bf16 version."""
    K, padding, P, C, B = 15, 7, 80, 16, 23
    gen = torch.Generator().manual_seed(T_in * 10 + stride)
    w = torch.randn(P, C, K, generator=gen).to(dtype).double()
    x = torch.randn(B, C, T_in, generator=gen).double()
    y = fcp.fused_conv_pool_reference(x, w, None, None, None, stride, padding, mode, 0.2)
    gy = torch.randn(y.shape, generator=gen).to(dtype).double()
    y = y.to(dtype).double()
    g = fcp._act_grad(gy, y, 0.2).to(dtype).double()  # the kernel rounds g once
    esz = torch.empty((), dtype=dtype).element_size()
    plan = fcp.dgrad_span_plan(B, T_in, K, stride, padding, 1, 2, SMS, 1, esz)
    # as many rows a span as fill it, spread evenly: the last group ragged
    assert plan.span == 256 and plan.groups == -(-B // ROWS_A_SPAN[level])
    assert plan.nbb == -(-B // plan.groups) and B % plan.nbb
    got = dgrad_by_rows(g, w, T_in, stride, padding, mode == "reflect", plan,
                        fcp.DGRAD_SPAN_KSTEP[esz], split=2)
    want = fcp.fused_conv_pool_dgrad_reference(g, torch.ones_like(y), w, T_in, stride,
                                               padding, mode, 0.2)
    torch.testing.assert_close(got, want, atol=1e-10, rtol=0)
    if dtype == torch.bfloat16:
        plain = fcp.fused_conv_pool_dgrad_reference(gy.to(dtype), y.to(dtype), w.to(dtype),
                                                    T_in, stride, padding, mode, 0.2)
        err = float((got.to(dtype).float() - plain.float()).abs().max())
        assert err <= 0.02 * float(plain.float().abs().max())


def _old_dgrad_span_pack(s, weight):
    """The f32 split the parent's wrapper made in eight torch passes."""
    lead, (P, C_in, K) = tuple(weight.shape[:-3]), weight.shape[-3:]
    G = lead[0] if lead else 1
    rt, groups = s.tile_start.numel() - 1, s.dgrad_span_start.numel() - 1
    n = 32
    w = torch.nn.functional.pad(weight.reshape(G, P, C_in, K),
                                (0, 0, 0, groups * n - C_in, 0, rt * 64 - P))
    t = w.reshape(G, rt, 8, 2, 4, groups, n // 8, 8, K).permute(0, 1, 5, 2, 8, 6, 3, 7, 4)
    t = t[:, s.dgrad_span_row, s.dgrad_span_group].reshape(G, -1, 8, K, 8 * n)
    out = t.new_empty(t.shape[:4] + (2, 8 * n))
    big, small = out[..., 0, :], out[..., 1, :]
    torch.bitwise_and(t.view(torch.int32) + 0x1000, -0x2000, out=big.view(torch.int32))
    torch.sub(t, big, out=small)
    small.view(torch.int32).add_(0x1000).bitwise_and_(-0x2000)
    return out


def pack_by_blocks(s, weight):
    """``dgrad_span_pack_kernel``'s index arithmetic in plain PyTorch: block
    (entry e, k-step ks, window) reads rows p0.. of the group's 32 channels
    (zeros past P and C_in) and writes value q of its run: tap k, plane,
    then i = ((c8 * 2 + half) * 8 + cc) * (ks / 2) + pr, the value at row p
    p0 + half * ks / 2 + pr, channel c0 + 8 * c8 + cc (f32: big, or the
    remainder rounded, by the kernel's integer rounding)."""
    G = weight.shape[0] if weight.dim() == 4 else 1
    P, C, K = weight.shape[-3:]
    esz = weight.element_size()
    ks, planes = fcp.DGRAD_SPAN_KSTEP[esz], esz // 2
    pv = fcp.DGRAD_TAP_PLANE // esz
    E = s.dgrad_span_row.numel()
    q = torch.arange(K * planes * pv)
    k, rem = q // (planes * pv), q % (planes * pv)
    plane, i = rem // pv, rem % pv
    half_ = ks // 2
    pr, cc, half, c8 = i % half_, (i // half_) % 8, (i // (8 * half_)) % 2, i // (16 * half_)
    e = torch.arange(E)[:, None, None]
    kstep = torch.arange(64 // ks)[None, :, None]
    p = s.dgrad_span_row.long()[e] * 64 + kstep * ks + half * half_ + pr
    c = s.dgrad_span_group.long()[e] * 32 + c8 * 8 + cc
    inside = (p < P) & (c < C)
    wg = weight.reshape(G, P, C, K)
    v = wg[:, p.clamp(max=P - 1), c.clamp(max=C - 1), k.expand_as(p)]
    v = torch.where(inside, v, torch.zeros((), dtype=weight.dtype))
    if esz == 2:
        return v.reshape(G, E, 64 // ks, K, 1, pv)

    def tf32(a):
        return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    big = tf32(v)
    out = torch.where(plane == 1, tf32(v - big), big)
    return out.reshape(G, E, 64 // ks, K, 2, pv)


_MODEL = {}


def _level_structures():
    if "m" not in _MODEL:
        cfg = tcfg.load_config(CONFIG)
        m = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(0))
        st = get_structure(cfg.model)
        convs = [getattr(m.encoder, f"conv_{i}") for i in range(len(st.encoder_levels))]
        convs += [getattr(m.decoder, f"conv_{i}") for i in range(len(st.decoder_levels))]
        _MODEL["m"] = convs
    return _MODEL["m"]


@pytest.mark.parametrize("level", [1, 4, 7])
def test_span_pack_plain_and_one_pass_layouts(level):
    """At a len-64 level's structure (ragged last row tile, a last group of
    fewer than 32 channels at enc1), a random weight zero outside the live
    tiles, and two windows: the plain f32 layout is the parent's torch
    split bit for bit; the one-pass kernel's arithmetic is the plain
    layout bit for bit in f32 and bf16; the bf16 planes hold the weight's
    values at the documented places."""
    conv = _level_structures()[level]
    s32 = conv.structure()
    live = s32.live_elements()
    P, C = live.shape
    K = s32.kernel_size
    gen = torch.Generator().manual_seed(level)
    w = torch.randn(2, P, C, K, generator=gen) * live[None, :, :, None]
    plain = fcp.dgrad_span_pack(s32, w)
    assert torch.equal(plain, _old_dgrad_span_pack(s32, w))
    assert torch.equal(fcp.dgrad_span_pack(s32, w[1]), plain[1:])
    assert torch.equal(pack_by_blocks(s32, w), plain)
    sp = conv.spec
    s16 = fcp.pack_structure(live, K, torch.bfloat16, sp.stride, sp.padding)
    w16 = w.to(torch.bfloat16)
    p16 = fcp.dgrad_span_pack(s16, w16)
    E = s16.dgrad_span_row.numel()
    assert p16.shape == (2, E, 4, K, 1, 512) and p16.dtype == torch.bfloat16
    assert torch.equal(pack_by_blocks(s16, w16), p16)
    # entry e, k-step ks, tap k: 16 rows p x 32 channels, channels in fours
    # of 8, then the half of the rows, then the channel, then 8 rows
    for e in (0, E - 1):
        rt, grp = int(s16.dgrad_span_row[e]), int(s16.dgrad_span_group[e])
        for ks in (0, 3):
            for k in (0, K - 1):
                plane = p16[1, e, ks, k, 0].reshape(4, 2, 8, 8)
                for c8, half, cc, pr in ((0, 0, 0, 0), (3, 1, 7, 7), (1, 0, 5, 2)):
                    p, c = rt * 64 + ks * 16 + half * 8 + pr, grp * 32 + c8 * 8 + cc
                    want = w16[1, p, c, k] if p < P and c < C else 0
                    assert plane[c8, half, cc, pr] == want
    with pytest.raises(ValueError):
        fcp.dgrad_span_pack(s16, w)  # an f32 weight for a bf16 structure


def _t_ld(T_out, esz):
    gran = 16 // esz
    return -(-T_out // gran) * gran


def _plan(s, B, T, esz=4, windows=1):
    T_out = (T + 2 * s.padding - s.kernel_size) // s.stride + 1
    return fcp.dgrad_plan(B, T, s.kernel_size, s.stride, s.padding, _t_ld(T_out, esz),
                          s.dgrad_start.numel() - 1, s.dgrad_max_live, SMS, windows,
                          (s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live), esz)


@pytest.mark.parametrize("esz", [4, 2])
def test_production_batch_routes_to_spans_of_whole_rows(esz):
    """At the production batch of 64 every len-64 level takes spans of
    several batches' whole rows, as many as fill the span's M tiles, spread
    evenly over the batch groups; the rows of a group fit the span's out
    tile and its stages the shared memory."""
    for (name, T, stride), conv in zip(LEVELS, _level_structures()):
        s = conv.structure()
        assert fcp.dgrad_rows_routed(64, T, 15, stride, 7, esz)
        d = _plan(s, 64, T, esz)
        per = ROWS_A_SPAN[name]
        assert fcp.dgrad_span_rows(T, 15, stride, 7, 256) == per
        assert d.span == 256 and d.groups == -(-64 // per) and d.nbb == -(-64 // d.groups)
        assert d.nbb * fcp.dgrad_span_period(T, 15, stride, 7) <= 256 // stride
        assert d.nbb * (T + 14) <= d.span
        smem, stages = fcp._dgrad_span_layout(15, stride, d.span, esz)
        assert smem <= fcp.MAX_SMEM and stages >= 2
        assert 1 <= d.split <= min(fcp.MAX_SPLIT, s.dgrad_span_max_live)


def test_other_shapes_keep_their_plans():
    """Batch 8 (both dtypes), the solver's 10 windows and the lora solve's
    10 batches keep whole rows: dgrad_plan gives them what it gave before
    (span 0).  The trajectory's K-31 levels take spans at their short rows
    from 4 batches on (fewer than 64, T 64-128), where the card timed them
    faster: (8, 128) (one batch's 158-column padded row a span, 8 batch
    groups) and (10, 64) (two 94-column rows a span, 5 groups), in f32 and
    bf16; (64, 64) keeps whole rows."""
    from hm_vae_torch.models.trajectory import TrajectoryModel

    n = 0
    for (name, T, stride), conv in zip(LEVELS, _level_structures()):
        s = conv.structure()
        for esz in (4, 2):
            for B, windows in ((8, 1), (1, 10), (10, 1)):
                assert not fcp.dgrad_rows_routed(B, T, 15, stride, 7, esz) or windows > 1
                assert _plan(s, B, T, esz, windows).span == 0
                n += 1
    tcfg_ = tcfg.load_config(os.path.join(ROOT, "configs", "trajectory_model.yaml"))
    tm = TrajectoryModel(tcfg_.model, generator=torch.Generator().manual_seed(0))
    routed = {(8, 128): (4, 2), (10, 64): (4, 2), (64, 64): ()}
    for i in range(4):
        s = getattr(tm.encoder, f"conv_{i}").structure()
        for (B, T), dtypes in routed.items():
            for esz in (4, 2):
                assert fcp.dgrad_rows_routed(B, T, 31, 1, 15, esz) == (esz in dtypes)
                d = _plan(s, B, T, esz)
                if esz not in dtypes:
                    assert d.span == 0
                    continue
                per = 256 // (T + 30)  # whole padded rows a span
                # its split counted in stages, up to the cluster's 8 blocks
                assert d == fcp.dgrad_span_plan(B, T, 31, 1, 15, s.dgrad_span_start.numel() - 1,
                                                s.dgrad_span_max_live, SMS, 1, esz)
                assert d.span == 256 and d.nbb == per and d.groups == -(-B // per)
                assert d.nbb * fcp.dgrad_span_period(T, 31, 1, 15) <= d.span
            n += 1
    assert n == 8 * 2 * 3 + 4 * 3


# the kernel's span layout and period (csrc/fused_conv_pool_bwd.cu), written
# out from the C++ here so that the planner's copies are held to them
def _c_dgrad_span_layout(K, stride, span, esz):
    gran, rows_p, planes = 16 // esz, 16 if esz == 2 else 8, 1 if esz == 2 else 2
    off = (K + stride - 1) // stride - 1
    gw = (off + span // stride + 2 * gran - 2) // gran * gran
    gl = gw + (40 - gw % 32) % 32
    wbytes = K * planes * 1024
    raw = 2 * rows_p * gw * esz
    slot = (wbytes + raw + planes * 8 * gl * 4 + 127) & ~127
    stages = min((232448 - (128 + 2 * 1024)) // slot, 4)
    return 128 + 2 * 1024 + stages * slot, stages


def _c_dgrad_span_period(T_in, K, T_out, stride, padding):
    V0 = (T_in + 2 * padding + stride - 1) // stride
    tail = T_out + (K + stride - 1) // stride - 1
    return V0 if V0 > tail else tail


@pytest.mark.parametrize("esz", [4, 2])
def test_span_planner_mirrors_the_kernel(esz):
    n = 0
    for K in (3, 15, 31):
        for stride in (1, 2, 3):
            span = fcp.dgrad_span_cols(K, stride, esz)
            assert fcp._dgrad_span_layout(K, stride, span, esz) == \
                _c_dgrad_span_layout(K, stride, span, esz)
            for T in (8, 16, 33, 64, 128, 150, 1024):
                pad = (K - 1) // 2
                T_out = (T + 2 * pad - K) // stride + 1
                assert fcp.dgrad_span_period(T, K, stride, pad) == \
                    _c_dgrad_span_period(T, K, T_out, stride, pad)
                n += 1
    assert n == 3 * 3 * 7
