"""wgrad's tile kernel (``wgrad_tiles_kernel``: persistent blocks, each a
contiguous run of (window, entry) units, that write every element of every
window's gradient) on the CPU, where the windowed wrapper runs its plain
version and the kernel runs only on the GPU (chip_smoke.py's windowed phases
hold it against the plain version there):

- its plan at the test-time solve's shapes, the four decoder levels of the
  full-width len-64 model at 10 windows of one batch, f32 and bf16: routed
  there, every (window, entry) unit in exactly one block's run, the runs
  inside the unit list, the block within shared memory by the Python layout,
  which equals a transcription of the kernel's ``wgrad_tiles_layout``;
- a CPU walk of that plan as the kernel walks it (each block's run, each
  unit's tile from the plain per-tile formula, the dead chunks it zeroes,
  the bias once per row tile): every element written once and, in f32,
  ``fused_conv_pool_wgrad_windowed_reference`` bit for bit;
- the walk at a small size (row tiles with dead chunks, one with no live
  tile, a partial last row tile; one batch a window at stride 1 under
  reflect padding, two at stride 2 under zeros) against ``jax.vjp`` of ``jax.vmap`` of the JAX package's
  level, in f32 (1e-4 * max(1, max|ref|)) and bf16 (0.02 * max|ref|, both
  sides rounding to bf16);
- negative cases: a walk that drops a unit, or sums a row tile's bias at
  each of its units, fails the check;
- one window, and long windows' rows past 64 columns, keep their plans.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.ops.skeleton_nn import pad_temporal
from hm_vae_torch.utils import config as tcfg

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "len64_no_aug_hm_vae.yaml")
BF16 = torch.bfloat16
SMS, WINDOWS = 132, 10  # an H100's SMs; the solve's windows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DEC = []


def _decoder_levels():
    """(name, conv, input T) of the four decoder convs of the full-width
    len-64 model."""
    if not _DEC:
        cfg = tcfg.load_config(CONFIG)
        m = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(0))
        st = get_structure(cfg.model)
        _DEC.extend((f"dec{i}", getattr(m.decoder, f"conv_{i}"),
                     st.dec_timesteps[i] * (2 if lvl.upsample else 1))
                    for i, lvl in enumerate(st.decoder_levels))
    return _DEC


def _structure(conv, dtype, device=None):
    sp = conv.spec
    return fcp.pack_structure(conv.structure().live_elements(), sp.kernel_size, dtype,
                              sp.stride, sp.padding, sp.padding_mode, conv.negative_slope,
                              **({"device": device} if device else {}))


def _t_out(T, K, stride, pad):
    return (T + 2 * pad - K) // stride + 1


def _plan(s, nb, T, G, esz):
    """The wrapper's tile plan (``_wgrad``) and the block's layout."""
    K, stride = s.kernel_size, s.stride
    T_out = _t_out(T, K, stride, s.padding)
    t_ld = -(-T_out // (16 // esz)) * (16 // esz)
    L = fcp._wgrad_tiles_layout(K, stride, nb, T, T_out, t_ld, s.wgrad_row.numel(), esz)
    return fcp.wgrad_tiles_plan(s.wgrad_row.numel(), G, SMS,
                                fcp.wgrad_tiles_per_sm(L["total"])), L, t_ld


def _c_tiles_layout(K, stride, nb, T_in, T_out, t_ld, entries, esz):
    """``wgrad_tiles_layout`` in ``csrc/fused_conv_pool_bwd.cu``, transcribed:
    (R, Lh, rsx, ks, out, zero, graw, xraw, xs, bt, lists, tab, total)."""
    k_rows, k_cc, k_zero_rows = 64, 8, 16  # kRows, kCC, kZeroRows

    def frag_stride(n):
        return (n + 11) // 16 * 16 + 4

    def half_stride(n):
        return (n + 55) // 64 * 64 + 8

    def align128(n):
        return (n + 127) & ~127

    R = T_out + (K + stride - 1) // stride - 1
    Lh = nb * R
    n = stride * Lh
    rsx = frag_stride(n) if esz == 4 else half_stride(n + 1)
    kw = 8 if esz == 4 else 16
    ks = (nb * T_out + kw - 1) // kw
    gbytes = nb * k_rows * t_ld * esz
    xbytes = nb * k_cc * T_in * esz
    bplane = ks * 2048
    out = 128
    zero = out + 2 * align128(k_rows * k_cc * K * esz)
    graw = zero + align128(k_zero_rows * k_cc * K * esz)
    xraw = graw + align128(2 * gbytes)
    xs = xraw + 2 * align128(xbytes)
    bt = xs + align128(2 * k_cc * rsx * (8 if esz == 4 else 2))
    lists = bt + 2 * (2 if esz == 4 else 1) * bplane
    tab = lists + align128(entries * 8)
    total = tab + align128(stride * R * 8)
    return R, Lh, rsx, ks, out, zero, graw, xraw, xs, bt, lists, tab, total


def tiles_walk(gy, y, x, s, G, plan, drop=None, bias_each_unit=False):
    """The tile kernel's walk of ``plan`` in plain PyTorch: each block's
    run of units in order; a unit (window, entry) writes its live tile from
    the plain per-tile formula (g = gy * act'(y) in gy's dtype, the sums in
    f32 over the window's columns, rounded once), zeros at the dead chunks
    it covers (between its row tile's previous entry and it, and after the
    row tile's last), and, at its row tile's first entry, the bias.  Returns
    the gradients (NaN where nothing was written) and how many times each
    weight entry and bias was written.  ``drop``: a unit left out;
    ``bias_each_unit``: every unit of a row tile adds its bias sum (a walk
    that sums the bias more than once)."""
    dtype = gy.dtype
    B, P, T_out = gy.shape
    C_in, K = x.shape[1], s.kernel_size
    nb = B // G
    C = -(-C_in // 8) * 8
    xc = torch.zeros((B, C, x.shape[2]))
    xc[:, :C_in] = x.float()
    g = fcp._act_grad(gy, y, s.negative_slope).float()
    cols = pad_temporal(xc, s.padding, "reflect" if s.reflect else "constant").unfold(
        2, K, s.stride)  # (B, C, T_out, K)
    wrow, wchunk = s.wgrad_row.tolist(), s.wgrad_chunk.tolist()
    E, nch = len(wrow), C // 8
    gw = torch.full((G, P, C, K), float("nan"), dtype=dtype)
    gb = torch.full((G, P), float("nan"), dtype=dtype)
    wn = torch.zeros((G, P, C), dtype=torch.int32)
    bn = torch.zeros((G, P), dtype=torch.int32)
    for lo, hi in fcp.wgrad_tiles_runs(plan):
        for u in range(lo, hi):
            if u == drop:
                continue
            win, e = divmod(u, E)
            rt, ch = wrow[e], wchunk[e]
            p0, p1 = rt * 64, min(P, rt * 64 + 64)
            first = e == 0 or wrow[e - 1] != rt
            last = e + 1 == E or wrow[e + 1] != rt
            gs = g[win * nb:(win + 1) * nb, p0:p1]
            if ch >= 0:
                xs = cols[win * nb:(win + 1) * nb, ch * 8:ch * 8 + 8]
                gw[win, p0:p1, ch * 8:ch * 8 + 8] = torch.einsum("bpt,bctk->pck", gs, xs).to(dtype)
                wn[win, p0:p1, ch * 8:ch * 8 + 8] += 1
                dead = list(range(0 if first else wchunk[e - 1] + 1, ch))
                dead += list(range(ch + 1, nch)) if last else []
            else:
                dead = list(range(nch))
            for z in dead:
                gw[win, p0:p1, z * 8:z * 8 + 8] = 0
                wn[win, p0:p1, z * 8:z * 8 + 8] += 1
            if bias_each_unit:
                prev = gb[win, p0:p1].float().nan_to_num(0.0)
                gb[win, p0:p1] = (prev + gs.sum((0, 2))).to(dtype)
                bn[win, p0:p1] += 1
            elif first:
                gb[win, p0:p1] = gs.sum((0, 2)).to(dtype)
                bn[win, p0:p1] += 1
    return gw[:, :, :C_in], gb, wn[:, :, :C_in], bn


def check_walk(walk, ref_w, ref_b, exact=True, tol_w=0.0, tol_b=0.0):
    """Every element written exactly once, and the walk's gradients equal
    the reference (bit for bit where ``exact``, else within the tolerances)."""
    gw, gb, wn, bn = walk
    assert int(wn.min()) == int(wn.max()) == 1, "a weight entry not written exactly once"
    assert int(bn.min()) == int(bn.max()) == 1, "a bias not written exactly once"
    if exact:
        assert torch.equal(gw, ref_w.to(gw.dtype)) and torch.equal(gb, ref_b.to(gb.dtype))
    else:
        assert float((gw.float() - ref_w.float()).abs().max()) <= tol_w
        assert float((gb.float() - ref_b.float()).abs().max()) <= tol_b


def _solve_inputs(conv, T, G, dtype, seed):
    rng = np.random.default_rng(seed)
    s = _structure(conv, dtype)
    P, C = s.rows, s.in_channels
    T_out = _t_out(T, s.kernel_size, s.stride, s.padding)
    x = torch.from_numpy(rng.normal(size=(G, C, T)).astype(np.float32)).to(dtype)
    y = torch.from_numpy(rng.normal(size=(G, P, T_out)).astype(np.float32)).to(dtype)
    gy = torch.from_numpy(rng.normal(size=(G, P, T_out)).astype(np.float32)).to(dtype)
    return s, x, y, gy


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("level", range(4))
def test_tiles_plan_at_the_solve(level, dtype):
    """10 windows of one batch at the decoder level: routed to the tile
    kernel; every (window, entry) unit in exactly one block's contiguous
    run, at most one block a unit and the card's resident blocks; the block
    within MAX_SMEM by the Python layout, which equals the kernel's."""
    _, conv, T = _decoder_levels()[level]
    s = _structure(conv, dtype, device="meta")
    sp, esz = conv.spec, 4 if dtype == torch.float32 else 2
    K, stride, pad = sp.kernel_size, sp.stride, sp.padding
    assert fcp.wgrad_tiles_routed(1, T, K, stride, pad, s.wgrad_row.numel(), esz, WINDOWS)
    plan, L, t_ld = _plan(s, 1, T, WINDOWS, esz)
    units = s.wgrad_row.numel() * WINDOWS
    per_sm = fcp.wgrad_tiles_per_sm(L["total"])
    assert plan.units == units and plan.blocks == min(units, SMS * per_sm)
    runs = fcp.wgrad_tiles_runs(plan)
    assert len(runs) == plan.blocks and runs[0][0] == 0 and runs[-1][1] == units
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert all(0 < hi - lo <= -(-units // plan.blocks) for lo, hi in runs)
    covered = np.zeros(units, dtype=np.int64)
    for lo, hi in runs:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    T_out = _t_out(T, K, stride, pad)
    c = _c_tiles_layout(K, stride, 1, T, T_out, t_ld, s.wgrad_row.numel(), esz)
    assert tuple(L[k] for k in ("R", "Lh", "rsx", "ks", "out", "zero", "graw", "xraw", "xs",
                                "bt", "lists", "tab", "total")) == c
    assert L["total"] <= fcp.MAX_SMEM
    # bf16's block fits two an SM; f32's at the two longest levels one
    assert per_sm == (2 if esz == 2 or T <= 16 else 1)


@pytest.mark.parametrize("level", range(4))
def test_tiles_walk_is_the_plain_wgrad_bit_for_bit(level):
    """The walk of the plan at the full-width level, 10 windows of one
    batch, f32: every element written once, the plain windowed wgrad's bits
    (dead tiles zero, each bias once)."""
    _, conv, T = _decoder_levels()[level]
    s, x, y, gy = _solve_inputs(conv, T, WINDOWS, torch.float32, level)
    plan = _plan(s, 1, T, WINDOWS, 4)[0]
    ref_w, ref_b = fcp.fused_conv_pool_wgrad_windowed_reference(
        gy, y, x, s.kernel_size, s.stride, s.padding, WINDOWS, "reflect", s.negative_slope,
        s.live_elements())
    check_walk(tiles_walk(gy, y, x, s, WINDOWS, plan), ref_w, ref_b)


def test_tiles_walk_negative_cases():
    """A walk that drops a unit, or sums a row tile's bias at each of its
    units, fails the check."""
    _, conv, T = _decoder_levels()[1]
    s, x, y, gy = _solve_inputs(conv, T, 3, torch.float32, 11)
    plan = _plan(s, 1, T, 3, 4)[0]
    ref = fcp.fused_conv_pool_wgrad_windowed_reference(
        gy, y, x, s.kernel_size, s.stride, s.padding, 3, "reflect", s.negative_slope,
        s.live_elements())
    check_walk(tiles_walk(gy, y, x, s, 3, plan), *ref)
    for kw in ({"drop": plan.units // 2}, {"bias_each_unit": True}):
        with pytest.raises(AssertionError):
            check_walk(tiles_walk(gy, y, x, s, 3, plan, **kw), *ref)


SMALL = [  # (batches a window, stride, padding mode, T)
    (1, 1, "reflect", 16), (2, 2, "constant", 32)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nb,stride,mode,T", SMALL)
def test_tiles_walk_matches_jax_vmap(nb, stride, mode, T, dtype):
    """At a small level (P 150: row tiles of 64, 64 and 22 rows, the middle
    one with no live tile; C 40, the others' tiles partly dead; K 15), 3
    windows of ``nb`` batches: the walk against ``jax.vjp`` of ``jax.vmap``
    of the JAX level over the windows, the dead tiles zero."""
    G, P, C, K, pad, slope = 3, 150, 40, 15, 7, 0.2
    rng = np.random.default_rng(nb * 10 + stride)
    tiles = rng.random((3, 5)) < 0.6
    tiles[1] = False
    tiles[0, 0] = tiles[2, 4] = True
    live = np.repeat(np.repeat(tiles, 64, 0), 8, 1)[:P, :C]
    s = fcp.pack_structure(torch.from_numpy(live), K, dtype, stride, pad, mode, slope)
    esz = 4 if dtype == torch.float32 else 2
    assert fcp.wgrad_tiles_fits(nb, T, K, stride, pad, s.wgrad_row.numel(), esz)
    T_out = _t_out(T, K, stride, pad)
    bound = 1.0 / np.sqrt(C * K)
    w = (rng.uniform(-bound, bound, (G, P, C, K)) * live[None, :, :, None]).astype(np.float32)
    b = rng.uniform(-bound, bound, (G, P)).astype(np.float32)
    x = rng.normal(size=(G, nb, C, T)).astype(np.float32)
    gy = rng.normal(size=(G, nb, P, T_out)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    cast = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    wt, bt, xt, gyt = cast(w), cast(b), cast(x), cast(gy)
    jx, jw, jb, jgy = (jnp.asarray(t.float().numpy(), jdt) for t in (xt, wt, bt, gyt))

    def f(x, w, b):  # JAX's level, one window
        return jsnn.leaky_relu(jsnn.skeleton_conv_w(x, w, b, stride, pad, mode), slope)

    y_ref, vjp = jax.vjp(jax.vmap(f), jx, jw, jb)
    _, gw_ref, gb_ref = (np.array(g.astype(jnp.float32)) for g in vjp(jgy))
    gw_ref = torch.from_numpy(gw_ref * live[None, :, :, None])
    gb_ref = torch.from_numpy(gb_ref)
    y = torch.from_numpy(np.array(y_ref.astype(jnp.float32))).to(dtype)
    plan = fcp.wgrad_tiles_plan(s.wgrad_row.numel(), G, 4, 1)  # several units a block
    walk = tiles_walk(gyt.reshape(G * nb, P, T_out), y.reshape(G * nb, P, T_out),
                      xt.reshape(G * nb, C, T), s, G, plan)
    if dtype == torch.float32:
        tol_w, tol_b = (1e-4 * max(1.0, float(r.abs().max())) for r in (gw_ref, gb_ref))
    else:
        tol_w, tol_b = (0.02 * float(r.abs().max()) for r in (gw_ref, gb_ref))
    check_walk(walk, gw_ref, gb_ref, exact=False, tol_w=tol_w, tol_b=tol_b)


@pytest.mark.parametrize("level", range(4))
def test_long_windows_and_one_window_keep_their_plans(level):
    """The tile kernel takes several windows of short rows only: not one
    window (the non-windowed entry, or a windowed call of one), not windows
    whose columns pass 64 (the levels of 512- and 1,024-frame windows but
    dec0 at 512, whose rows are the solve's dec3's 64 frames: those keep
    their whole rows or items), in either dtype."""
    _, conv, T = _decoder_levels()[level]
    sp = conv.spec
    K, stride, pad = sp.kernel_size, sp.stride, sp.padding
    E = conv.structure().wgrad_row.numel()
    for esz in (4, 2):
        assert not fcp.wgrad_tiles_routed(1, T, K, stride, pad, E, esz, None)
        assert not fcp.wgrad_tiles_routed(1, T, K, stride, pad, E, esz, 1)
        nb = fcp.WGRAD_TILES_COLS // _t_out(T, K, stride, pad) + 1  # nb x T_out past 64
        assert not fcp.wgrad_tiles_routed(nb, T, K, stride, pad, E, esz, WINDOWS)
        for frames in (512, 1024):
            T_long = T * frames // 64
            # only dec0 at 512 frames keeps a window's row within 64 columns
            assert fcp.wgrad_tiles_routed(1, T_long, K, stride, pad, E, esz, 4) == (
                _t_out(T_long, K, stride, pad) <= fcp.WGRAD_TILES_COLS) == (
                    level == 0 and frames == 512)
