"""dgrad's tile kernel (``dgrad_tiles_kernel``: persistent blocks, each a
contiguous run of (window, 8-channel chunk) units, that stream each unit's
live weight tiles once and write every element of the windows' input
gradients) on the CPU, where the windowed wrapper runs its plain version and
the kernel runs only on the GPU (chip_smoke.py's windowed phases hold it
against the plain version there):

- its plan at the test-time solve's shapes, the four decoder levels of the
  full-width len-64 model at 10 windows of one batch, f32 and bf16: routed
  there, every (window, chunk) unit in exactly one block's run, the runs
  balanced by the live tiles they hold, the block within shared memory by
  the Python layout, which equals a transcription of the kernel's
  ``dgrad_tiles_layout``;
- the per-chunk lists (``dgrad_chunk_start`` / ``dgrad_chunk_row``): each
  chunk's live row tiles, never more tiles than the pair lists read;
- a CPU walk of that plan as the kernel walks it (each block's run, each
  unit's row tiles' Z products, the shift-add, the padding's adjoint, the
  zero rows of a chunk with no live tile): every element written once and,
  in f32, ``fused_conv_pool_dgrad_windowed_reference`` within 1e-6 *
  max(1, max|ref|);
- the walk at a small size (row tiles with a dead chunk, a chunk with no
  live tile, a row tile with none, a partial last row tile; one batch a
  window at stride 1 under reflect padding, two at stride 2 under zeros)
  against ``jax.vjp`` of ``jax.vmap`` of the JAX package's level, in f32
  (1e-4 * max(1, max|ref|)) and bf16 (0.02 * max|ref|, both sides rounding
  to bf16);
- negative cases: a walk that drops a row tile, or skips the reflect fold,
  fails the check;
- one window, several batches through one weight, and long windows keep
  their plans.
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


def _chunks(s):
    return s.dgrad_chunk_start.numel() - 1


def _plan(s, nb, T, G, esz):
    """The wrapper's tile plan (``_dgrad``) and the block's layout."""
    K, stride = s.kernel_size, s.stride
    T_out = _t_out(T, K, stride, s.padding)
    L = fcp._dgrad_tiles_layout(K, s.rows, nb * T_out, _chunks(s), s.dgrad_chunk_row.numel(),
                                esz)
    return fcp.dgrad_tiles_plan(_chunks(s), G, SMS, fcp.dgrad_tiles_per_sm(esz)), L


def _c_tiles_layout(K, P, cols, nch, entries, esz):
    """``dgrad_tiles_layout`` in ``csrc/fused_conv_pool_bwd.cu``, transcribed:
    (nt, zp, ks, stages, wstage, bplane, z, lists, bt, st, total)."""
    k_rows, k_cc, k_max_stages = 64, 8, 6  # kRows, kCC, kDgradTilesMaxStages
    k_max_smem, k_smem_per_sm = 232448, 233472  # kMaxSmem, kSmemPerSM

    def align128(n):
        return (n + 127) & ~127

    row_k, kw = k_cc * K, 8 if esz == 4 else 16
    nt = 8 if cols <= 8 else 16 if cols <= 16 else 32 if cols <= 32 else 64 if cols <= 64 else 0
    zp = (nt + 23) // 32 * 32 + 8
    ks = (P + kw - 1) // kw
    bplane = ks * (nt // 8) * 256
    wstage = align128(k_rows * row_k * esz)
    z = 128
    lists = z + align128(row_k * zp * 4)
    bt = lists + align128((nch + 1 + entries) * 4)
    st = bt + (2 if esz == 4 else 1) * bplane
    budget = k_max_smem if esz == 4 else k_smem_per_sm // 2 - 1024
    fit = (budget - st) // wstage if budget > st else 0
    stages = min(fit, k_max_stages)
    return nt, zp, ks, stages, wstage, bplane, z, lists, bt, st, st + stages * wstage


def _unit_costs(s, G):
    """A unit's cost as the kernel cuts the runs: its chunk's live row tiles
    + 1, units in window-major order."""
    start = s.dgrad_chunk_start.tolist()
    return [start[c + 1] - start[c] + 1 for _ in range(G) for c in range(len(start) - 1)]


def tiles_walk(gy, y, w, s, T_in, G, plan, drop=None, fold=True):
    """The tile kernel's walk of ``plan`` in plain PyTorch: each block's run
    of units (window, chunk) in order; a unit sums its chunk's live row
    tiles' products Z[c*K + k, n] = sum_p Wf[p, c, k] * g[p, n] (g = gy *
    act'(y) in gy's dtype, the window's batches' columns side by side, the
    sums in f32), adds Z[c*K + k, t] onto the padded column t*stride + k,
    folds the padding's adjoint (reflected columns onto their sources) and
    writes its chunk's 8 rows of gx of the window's batches, rounded once
    (zeros where the chunk has no live row tile).  Returns gx (NaN where
    nothing was written) and how many times each element was written.
    ``drop``: a (unit, entry) whose row tile is left out; ``fold``: False
    skips the reflect fold."""
    dtype = gy.dtype
    B, P, T_out = gy.shape
    C_in, K, stride, pad = w.shape[2], s.kernel_size, s.stride, s.padding
    nb, C, Tp = B // G, -(-C_in // 8) * 8, T_in + 2 * pad
    wc = torch.zeros((G, P, C, K))
    wc[:, :, :C_in] = w.float()
    g = fcp._act_grad(gy, y, s.negative_slope).float()
    start, rows = s.dgrad_chunk_start.tolist(), s.dgrad_chunk_row.tolist()
    nch = len(start) - 1
    gx = torch.full((B, C, T_in), float("nan"), dtype=dtype)
    count = torch.zeros((B, C, T_in), dtype=torch.int32)
    taps = stride * torch.arange(T_out)
    for lo, hi in fcp.dgrad_tiles_runs(plan, start):
        for u in range(lo, hi):
            win, c = divmod(u, nch)
            cols = g[win * nb:(win + 1) * nb].permute(1, 0, 2).reshape(P, nb * T_out)
            z = torch.zeros((8 * K, nb * T_out))
            for j in range(start[c], start[c + 1]):
                if (u, j) == drop:
                    continue
                p0, p1 = rows[j] * 64, min(P, rows[j] * 64 + 64)
                z += wc[win, p0:p1, c * 8:c * 8 + 8].reshape(p1 - p0, 8 * K).T @ cols[p0:p1]
            zr = z.reshape(8, K, nb, T_out)
            gxp = torch.zeros((nb, 8, Tp))
            for k in range(K):
                gxp[:, :, taps + k] += zr[:, k].permute(1, 0, 2)
            gxc = gxp[:, :, pad:pad + T_in].clone()
            if s.reflect and pad and fold:
                gxc.index_add_(2, torch.arange(pad, 0, -1), gxp[:, :, :pad])
                gxc.index_add_(2, T_in - 2 - torch.arange(pad), gxp[:, :, pad + T_in:])
            gx[win * nb:(win + 1) * nb, c * 8:c * 8 + 8] = gxc.to(dtype)
            count[win * nb:(win + 1) * nb, c * 8:c * 8 + 8] += 1
    return gx[:, :C_in], count[:, :C_in]


def check_walk(walk, ref, tol):
    """Every element written exactly once, and the walk within ``tol`` of
    the reference."""
    gx, count = walk
    assert int(count.min()) == int(count.max()) == 1, "an element not written exactly once"
    assert float((gx.float() - ref.float()).abs().max()) <= tol


def _solve_inputs(conv, T, G, dtype, seed):
    """Seeded gy, y (G windows of one batch) and G folded weights, zero
    outside the structure's live entries."""
    rng = np.random.default_rng(seed)
    s = _structure(conv, dtype)
    P, C, K = s.rows, s.in_channels, s.kernel_size
    T_out = _t_out(T, K, s.stride, s.padding)
    live = s.live_elements()[None, :, :, None].float()
    w = (torch.from_numpy(rng.normal(size=(G, P, C, K)).astype(np.float32)) * live).to(dtype)
    y = torch.from_numpy(rng.normal(size=(G, P, T_out)).astype(np.float32)).to(dtype)
    gy = torch.from_numpy(rng.normal(size=(G, P, T_out)).astype(np.float32)).to(dtype)
    return s, w, y, gy


STAGES = {4: (6, 6, 5, 4), 2: (6, 5, 5, 4)}  # by element bytes, dec0-3


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("level", range(4))
def test_tiles_plan_at_the_solve(level, dtype):
    """10 windows of one batch at the decoder level: routed to the tile
    kernel; every (window, chunk) unit in exactly one block's contiguous
    run, one block a unit up to the card's resident blocks; each run's live
    tiles (+1 a unit) within one unit's cost of an even share; the block
    within MAX_SMEM (f32) or half an SM (bf16) with 4-6 weight stages by the
    Python layout, which equals the kernel's."""
    _, conv, T = _decoder_levels()[level]
    s = _structure(conv, dtype)
    sp, esz = conv.spec, 4 if dtype == torch.float32 else 2
    K, stride, pad = sp.kernel_size, sp.stride, sp.padding
    E, nch = s.dgrad_chunk_row.numel(), _chunks(s)
    assert fcp.dgrad_tiles_routed(1, T, K, stride, pad, s.rows, nch, E, esz, WINDOWS)
    plan, L = _plan(s, 1, T, WINDOWS, esz)
    units = nch * WINDOWS
    assert plan.units == units
    assert plan.blocks == min(units, SMS * fcp.dgrad_tiles_per_sm(esz))
    runs = fcp.dgrad_tiles_runs(plan, s.dgrad_chunk_start.tolist())
    assert len(runs) == plan.blocks and runs[0][0] == 0 and runs[-1][1] == units
    assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(runs, runs[1:]))
    covered = np.zeros(units, dtype=np.int64)
    for lo, hi in runs:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    costs = _unit_costs(s, WINDOWS)
    share, most = sum(costs) / plan.blocks, max(costs)
    assert all(share - most < sum(costs[lo:hi]) < share + most for lo, hi in runs)
    T_out = _t_out(T, K, stride, pad)
    c = _c_tiles_layout(K, s.rows, T_out, nch, E, esz)
    assert tuple(L[k] for k in ("nt", "zp", "ks", "stages", "wstage", "bplane", "z", "lists",
                                "bt", "st", "total")) == c
    assert L["nt"] == T_out and L["stages"] == STAGES[esz][level]
    assert L["total"] <= (fcp.MAX_SMEM if esz == 4 else fcp.MAX_SMEM_PER_SM // 2 - 1024)


@pytest.mark.parametrize("level", range(4))
def test_chunk_lists_are_each_chunks_live_row_tiles(level):
    """``dgrad_chunk_start`` / ``dgrad_chunk_row``: chunk c's entries are
    the row tiles where ``bwd_live`` has it, ascending; the same lists in a
    bf16 structure; never more tiles than the pair lists read (a pair's
    row tile reads both chunks, a dead one as zeros)."""
    _, conv, _ = _decoder_levels()[level]
    s, s16 = _structure(conv, torch.float32), _structure(conv, BF16)
    start, rows = s.dgrad_chunk_start.tolist(), s.dgrad_chunk_row.tolist()
    live = s.bwd_live
    assert len(start) == live.shape[1] + 1 and start[-1] == int(live.sum())
    for c in range(live.shape[1]):
        assert rows[start[c]:start[c + 1]] == live[:, c].nonzero()[:, 0].tolist()
    for f in ("dgrad_chunk_start", "dgrad_chunk_row"):
        assert torch.equal(getattr(s, f), getattr(s16, f)), f
    assert len(rows) <= 2 * s.dgrad_row.numel()


@pytest.mark.parametrize("level", range(4))
def test_tiles_walk_is_the_plain_dgrad(level):
    """The walk of the plan at the full-width level, 10 windows of one
    batch, f32: every element written once, within 1e-6 * max(1, max|ref|)
    of the plain windowed dgrad."""
    _, conv, T = _decoder_levels()[level]
    s, w, y, gy = _solve_inputs(conv, T, WINDOWS, torch.float32, level)
    plan = _plan(s, 1, T, WINDOWS, 4)[0]
    ref = fcp.fused_conv_pool_dgrad_windowed_reference(gy, y, w, T, s.stride, s.padding,
                                                       "reflect", s.negative_slope)
    check_walk(tiles_walk(gy, y, w, s, T, WINDOWS, plan), ref,
               1e-6 * max(1.0, float(ref.abs().max())))


def test_tiles_walk_negative_cases():
    """A walk that drops a row tile, or skips the reflect fold, fails the
    check."""
    _, conv, T = _decoder_levels()[1]
    s, w, y, gy = _solve_inputs(conv, T, 3, torch.float32, 11)
    plan = _plan(s, 1, T, 3, 4)[0]
    ref = fcp.fused_conv_pool_dgrad_windowed_reference(gy, y, w, T, s.stride, s.padding,
                                                       "reflect", s.negative_slope)
    tol = 1e-6 * max(1.0, float(ref.abs().max()))
    check_walk(tiles_walk(gy, y, w, s, T, 3, plan), ref, tol)
    start = s.dgrad_chunk_start.tolist()
    c = next(c for c in range(len(start) - 1) if start[c + 1] > start[c])
    for kw in ({"drop": (_chunks(s) + c, start[c])}, {"fold": False}):
        with pytest.raises(AssertionError):
            check_walk(tiles_walk(gy, y, w, s, T, 3, plan, **kw), ref, tol)


SMALL = [  # (batches a window, stride, padding mode, T)
    (1, 1, "reflect", 16), (2, 2, "constant", 32)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nb,stride,mode,T", SMALL)
def test_tiles_walk_matches_jax_vmap(nb, stride, mode, T, dtype):
    """At a small level (P 150: row tiles of 64, 64 and 22 rows, the middle
    one with no live tile; C 40, chunk 3 with no live tile, the others'
    tiles partly dead; K 15), 3 windows of ``nb`` batches: the walk against
    ``jax.vjp`` of ``jax.vmap`` of the JAX level over the windows."""
    G, P, C, K, pad, slope = 3, 150, 40, 15, 7, 0.2
    rng = np.random.default_rng(nb * 10 + stride)
    tiles = rng.random((3, 5)) < 0.6
    tiles[1] = False
    tiles[:, 3] = False
    tiles[0, 0] = tiles[2, 4] = True
    live = np.repeat(np.repeat(tiles, 64, 0), 8, 1)[:P, :C]
    s = fcp.pack_structure(torch.from_numpy(live), K, dtype, stride, pad, mode, slope)
    esz = 4 if dtype == torch.float32 else 2
    assert s.dgrad_chunk_start.tolist()[3] == s.dgrad_chunk_start.tolist()[4]
    assert fcp.dgrad_tiles_fits(nb, T, K, stride, pad, P, _chunks(s), s.dgrad_chunk_row.numel(),
                                esz)
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
    gx_ref = torch.from_numpy(np.array(vjp(jgy)[0].astype(jnp.float32))).reshape(G * nb, C, T)
    y = torch.from_numpy(np.array(y_ref.astype(jnp.float32))).to(dtype)
    plan = fcp.dgrad_tiles_plan(_chunks(s), G, 2, 1)  # several units a block
    walk = tiles_walk(gyt.reshape(G * nb, P, T_out), y.reshape(G * nb, P, T_out), wt, s, T, G,
                      plan)
    mx = float(gx_ref.abs().max())
    check_walk(walk, gx_ref, 1e-4 * max(1.0, mx) if dtype == torch.float32 else 0.02 * mx)
    # the dead chunk's rows are zeros
    assert float(walk[0][:, 24:32].float().abs().max()) == 0.0


@pytest.mark.parametrize("level", range(4))
def test_one_window_one_weight_and_long_windows_keep_their_plans(level):
    """The tile kernel takes several windows of short rows only: not one
    window (a windowed call of one), not the calls of several batches
    through one weight (the z phase's and the lora solve's: no windows),
    not windows whose columns pass 64 (the levels of 512- and 1,024-frame
    windows but dec0 at 512, whose rows are the solve's dec3's 64 frames:
    those keep their whole rows or spans), in either dtype; dec0 at 512
    frames in bf16 only (in f32 its B tile, 336 rows p x 64 columns in two
    planes, leaves no room for two weight stages)."""
    _, conv, T = _decoder_levels()[level]
    sp = conv.spec
    K, stride, pad = sp.kernel_size, sp.stride, sp.padding
    s = _structure(conv, torch.float32)
    P, nch, E = s.rows, _chunks(s), s.dgrad_chunk_row.numel()
    for esz in (4, 2):
        assert not fcp.dgrad_tiles_routed(1, T, K, stride, pad, P, nch, E, esz, None)
        assert not fcp.dgrad_tiles_routed(10, T, K, stride, pad, P, nch, E, esz, None)
        assert not fcp.dgrad_tiles_routed(1, T, K, stride, pad, P, nch, E, esz, 1)
        nb = fcp.DGRAD_TILES_COLS // _t_out(T, K, stride, pad) + 1  # nb x T_out past 64
        assert not fcp.dgrad_tiles_routed(nb, T, K, stride, pad, P, nch, E, esz, WINDOWS)
        for frames in (512, 1024):
            T_long = T * frames // 64
            assert fcp.dgrad_tiles_routed(1, T_long, K, stride, pad, P, nch, E, esz, 4) == (
                level == 0 and frames == 512 and esz == 2)


def test_kernel_trace_patches_the_tile_kernel():
    """kernel_trace.py --kernel dgrad_tiles stamps the tile kernel at fixed
    anchors, each found exactly once: twelve timer reads."""
    import kernel_trace

    assert kernel_trace.patched_source("base", "dgrad_tiles").count("gtime()") == 12


def test_tile_launch_checks_its_limits():
    """An explicit tile plan at a shape the kernel does not take (a window's
    columns past 64, K past 15) raises before any launch; a plan that does
    not cover the windows' chunks too."""
    _, conv, T = _decoder_levels()[3]  # dec3: T_out 64, one batch a window
    s, w, y, gy = _solve_inputs(conv, T, 2, torch.float32, 3)
    nch = _chunks(s)
    y2, gy2 = y.repeat(2, 1, 1), gy.repeat(2, 1, 1)  # two batches a window: 128 columns
    with pytest.raises(ValueError, match="does not take"):
        fcp.dgrad_tiles(gy2, y2, w, s, T, 2, fcp.DgradTilesPlan(4, 2 * nch), fcp.dgrad_tiles)
    with pytest.raises(ValueError, match="does not cover"):
        fcp.dgrad_tiles(gy, y, w, s, T, 2, fcp.DgradTilesPlan(4, nch), fcp.dgrad_tiles)
    s31 = fcp.pack_structure(s.live_elements(), 31, torch.float32, 1, 15, "reflect", 0.2)
    assert not fcp.dgrad_tiles_fits(1, 64, 31, 1, 15, s.rows, nch, s.dgrad_chunk_row.numel())
    with pytest.raises(ValueError, match="does not take"):
        fcp.dgrad_tiles(gy, y, w.new_zeros(2, s.rows, s.in_channels, 31), s31, 64, 2,
                        fcp.DgradTilesPlan(4, 2 * nch), fcp.dgrad_tiles)
    assert fcp.dgrad_tiles.launches == 0
