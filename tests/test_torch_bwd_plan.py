"""What the port's backward kernels read and how they split their work, on
the CPU (the kernels themselves run only on the GPU, where chip_smoke.py
holds them against their plain versions):

- dgrad's formulation in plain PyTorch: the padded columns split by stride
  phase, each phase a stride-1 product over its taps with g shifted by the
  tap, then the reflect padding's adjoint, against ``jax.vjp`` of the JAX
  package's XLA level at every level of the full-width len-64 model, in
  both paddings;
- the work plans (``dgrad_plan``, ``wgrad_plan``) with the kernels' split of
  a cluster's work (``cluster_share``): every live row tile of a chunk
  pair, every batch and every live tile is covered exactly once, in a fixed
  order, within the kernels' limits;
- wgrad's entries, which keep a row tile with no live tile for its bias
  gradient, and the wrappers' alignment padding;
- the same plans at the trajectory model's four levels (K 31, stride 1,
  C_in 72 / 84 / 108 / 168), at its training shape (batch 8, T 128: a
  padded row of 158 columns, two tiles a warp) and the solver's (10
  windows, T 64), each within the kernels' shared memory.

Tolerance (f32): 1e-4 * max(1, max|ref|): the sums run in another order.
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

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "len64_no_aug_hm_vae.yaml")
TRAJ_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "trajectory_model.yaml")
BATCH, SMS = 8, 132  # the training batch; an H100's SMs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_LEVELS = []


def _levels():
    """(name, conv, input T) of the eight convs of the full-width model."""
    if not _LEVELS:
        cfg = tcfg.load_config(CONFIG)
        m = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(0))
        st = get_structure(cfg.model)
        _LEVELS.extend((f"enc{i}", getattr(m.encoder, f"conv_{i}"), st.enc_timesteps[i])
                       for i in range(len(st.encoder_levels)))
        _LEVELS.extend((f"dec{i}", getattr(m.decoder, f"conv_{i}"),
                        st.dec_timesteps[i] * (2 if lvl.upsample else 1))
                       for i, lvl in enumerate(st.decoder_levels))
    return _LEVELS


def _t_out(s, T):
    return (T + 2 * s.padding - s.kernel_size) // s.stride + 1


def cluster_share(n, rank, split, interleaved):
    """What block ``rank`` of a ``split``-block cluster takes of ``n`` items,
    as the kernels compute it (hm_vae_torch/csrc/fused_conv_pool_bwd.cu):
    dgrad's live row tiles one in ``split`` (interleaved), wgrad's batches
    a contiguous run."""
    if interleaved:
        return range(rank, n, split)
    return range(n * rank // split, n * (rank + 1) // split)


def dgrad_by_phase(g, w, T_in, stride, padding, reflect):
    """The dgrad kernel's arithmetic in plain PyTorch: padded column
    u = stride*v + phi sums, over taps k = phi + stride*m and rows p,
    w[p, c, k] * g[b, p, v - m]; then each reflected edge column is added
    onto the input step it was copied from."""
    B, _, T_out = g.shape
    C, K = w.shape[1], w.shape[2]
    Tp = T_in + 2 * padding
    gxp = g.new_zeros(B, C, Tp)
    for phi in range(stride):
        V = -(-(Tp - phi) // stride)
        for m, k in enumerate(range(phi, K, stride)):
            hi = min(V, T_out + m)  # v - m < T_out
            if hi > m:
                part = torch.einsum("pc,bpt->bct", w[:, :, k], g[:, :, :hi - m])
                gxp[:, :, phi + stride * m:phi + stride * (hi - 1) + 1:stride] += part
    gx = gxp[:, :, padding:padding + T_in].clone()
    if reflect:
        for i in range(T_in):
            if 1 <= i <= padding:
                gx[:, :, i] += gxp[:, :, padding - i]
            if T_in - 1 - padding <= i <= T_in - 2:
                gx[:, :, i] += gxp[:, :, padding + 2 * (T_in - 1) - i]
    return gx


@pytest.mark.parametrize("level", range(8))
@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_dgrad_phase_split_matches_jax(mode, level):
    name, conv, T = _levels()[level]
    sp = conv.spec
    with torch.no_grad():
        wf, bf = conv.folded_weight()
    rng = np.random.default_rng(100 + level)
    x = rng.normal(size=(2, wf.shape[1], T)).astype(np.float32)
    w = wf.detach().numpy()
    b = np.zeros(w.shape[0], np.float32) if bf is None else bf.detach().numpy()

    def f(x):
        return jsnn.leaky_relu(jsnn.skeleton_conv_w(x, jnp.asarray(w), jnp.asarray(b),
                                                    sp.stride, sp.padding, mode),
                               conv.negative_slope)

    y, vjp = jax.vjp(f, jnp.asarray(x))
    gy = rng.normal(size=y.shape).astype(np.float32)
    (gx_ref,) = vjp(jnp.asarray(gy))
    g = fcp._act_grad(torch.from_numpy(gy), torch.from_numpy(np.array(y)),
                      conv.negative_slope)
    ours = dgrad_by_phase(g, wf.detach(), T, sp.stride, sp.padding, mode == "reflect")
    ref = np.asarray(gx_ref)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())),
                               rtol=0, err_msg=f"{name} {mode}")


@pytest.mark.parametrize("level", range(8))
def test_dgrad_plan_covers_every_row_tile_once(level):
    """Each chunk pair's live row tiles go to the blocks of its cluster one
    in `split`, in ascending order, each exactly once; the batch groups cover
    the batches once; a group's 16-column tiles fit the eight warps and the
    block fits in shared memory."""
    _, conv, T = _levels()[level]
    s = conv.structure()
    pairs = s.dgrad_start.numel() - 1
    nbb, groups, split = fcp.dgrad_plan(BATCH, T, s.kernel_size, s.stride, s.padding,
                                        _t_out(s, T), pairs, s.dgrad_max_live, SMS)
    assert 1 <= split <= min(fcp.MAX_SPLIT, s.dgrad_max_live)
    assert groups == -(-BATCH // nbb) and (groups - 1) * nbb < BATCH
    Tp = T + 2 * s.padding
    tiles = sum(-(-nbb * -(-(Tp - phi) // s.stride) // 16) for phi in range(s.stride))
    assert tiles <= fcp.BWD_WARPS
    assert fcp._dgrad_smem(T, s.kernel_size, _t_out(s, T), s.stride, s.padding,
                           nbb) <= fcp.MAX_SMEM
    start, rows = s.dgrad_start.tolist(), s.dgrad_row.tolist()
    for q in range(pairs):
        live = start[q + 1] - start[q]
        shares = [list(cluster_share(live, r, split, interleaved=True))
                  for r in range(split)]
        assert sorted(sum(shares, [])) == list(range(live))
        assert all(sh == sorted(sh) for sh in shares)
        assert rows[start[q]:start[q + 1]] == sorted(set(rows[start[q]:start[q + 1]]))
    batches = [b for grp in range(groups) for b in range(grp * nbb, min(BATCH, (grp + 1) * nbb))]
    assert batches == list(range(BATCH))


@pytest.mark.parametrize("level", range(8))
def test_wgrad_plan_covers_every_batch_and_tile_once(level):
    """The entries are the live tiles, by row tile, each once; the cluster's
    blocks take contiguous batch runs that cover the batches once, in order;
    a stage holds at most 32 columns unless one batch is longer; the first
    entry of each row tile writes its bias gradient."""
    _, conv, T = _levels()[level]
    s = conv.structure()
    T_out = _t_out(s, T)
    entries = s.wgrad_row.numel()
    sb, split = fcp.wgrad_plan(BATCH, T_out, entries, SMS)
    assert 1 <= split <= min(fcp.MAX_SPLIT, BATCH)
    assert sb == 1 or sb * T_out <= fcp.WGRAD_STAGE_COLS
    shares = [list(cluster_share(BATCH, r, split, interleaved=False)) for r in range(split)]
    assert sum(shares, []) == list(range(BATCH)) and all(shares)
    pairs = list(zip(s.wgrad_row.tolist(), s.wgrad_chunk.tolist()))
    live = s.live.nonzero().tolist()
    assert [list(p) for p in pairs if p[1] >= 0] == live  # row-major, each once
    rows = [r for r, _ in pairs]
    assert rows == sorted(rows) and set(rows) == set(range(s.live.shape[0]))
    writers = [e for e in range(len(rows)) if e == 0 or rows[e - 1] != rows[e]]
    assert [rows[e] for e in writers] == list(range(s.live.shape[0]))


def test_wgrad_entries_keep_a_row_tile_without_live_tiles():
    """A row tile with no live tile still gets one entry (chunk -1): its bias
    gradient is the sum of g whatever the weight."""
    live = torch.zeros(192, 20, dtype=torch.bool)
    live[:64, :3] = True
    live[128:, 12:] = True
    s = fcp.pack_structure(live, 3, torch.float32, 1, 1)
    assert list(zip(s.wgrad_row.tolist(), s.wgrad_chunk.tolist())) == [
        (0, 0), (1, -1), (2, 1), (2, 2)]
    # dgrad: chunks 0-1 are live in row tiles 0 and 2, chunk 2 in row tile 2
    assert s.dgrad_start.tolist() == [0, 2, 3] and s.dgrad_row.tolist() == [0, 2, 2]
    assert s.dgrad_max_live == 2


@pytest.mark.parametrize("dim,multiple", [(1, 8), (2, 4)])
def test_aligned_pads_with_zeros_only_when_needed(dim, multiple):
    t = torch.arange(2 * 12 * 6, dtype=torch.float32).reshape(2, 12, 6)
    out = fcp._aligned(t, dim, multiple)
    assert out.shape[dim] % multiple == 0 and out.data_ptr() % 16 == 0
    assert torch.equal(out.narrow(dim, 0, t.shape[dim]), t)
    assert not out.narrow(dim, t.shape[dim], out.shape[dim] - t.shape[dim]).any()
    ok = torch.zeros(2, 16, 8)
    assert fcp._aligned(ok, dim, multiple) is ok


_TRAJ = []


def _traj_levels():
    """The structures of the full-width trajectory model's four levels."""
    if not _TRAJ:
        cfg = tcfg.load_config(TRAJ_CONFIG)
        m = TrajectoryModel(cfg.model, generator=torch.Generator().manual_seed(0))
        _TRAJ.extend(getattr(m.encoder, f"conv_{i}").structure()
                     for i in range(len(get_trajectory_structure(cfg.model).levels)))
    return _TRAJ


@pytest.mark.parametrize("B,T", [(8, 128), (10, 64)], ids=["train", "solver"])
@pytest.mark.parametrize("level", range(4))
def test_plans_at_the_trajectory_shapes(level, B, T):
    """dgrad: one batch a group where the padded row needs more than one
    tile a warp, every group and live row tile covered once, the block in
    shared memory; wgrad: the batches covered once, the block in shared
    memory."""
    s = _traj_levels()[level]
    assert (s.kernel_size, s.stride, s.padding) == (31, 1, 15)
    assert s.in_channels == (72, 84, 108, 168)[level]
    T_out = _t_out(s, T)
    assert T_out == T
    pairs = s.dgrad_start.numel() - 1
    assert pairs == -(-s.in_channels // 16)  # C_in 84, 108: a last single chunk
    nbb, groups, split = fcp.dgrad_plan(B, T, 31, 1, 15, T_out, pairs, s.dgrad_max_live, SMS)
    Tp = T + 30
    tiles = -(-nbb * Tp // 16)
    assert tiles <= fcp.BWD_WARPS * fcp.DGRAD_TILES
    assert nbb == 1 or tiles <= fcp.BWD_WARPS
    if T == 128:
        assert Tp == 158 and nbb == 1 and tiles == 10
    assert fcp._dgrad_smem(T, 31, T_out, 1, 15, nbb) <= fcp.MAX_SMEM
    assert 1 <= split <= min(fcp.MAX_SPLIT, s.dgrad_max_live)
    assert [b for g in range(groups) for b in range(g * nbb, min(B, (g + 1) * nbb))] == list(
        range(B))
    sb, wsplit = fcp.wgrad_plan(B, T_out, s.wgrad_row.numel(), SMS)
    assert sb == 1 and 1 <= wsplit <= min(fcp.MAX_SPLIT, B)
    assert fcp._wgrad_smem(B, T, 31, T_out, T_out, 1, sb, wsplit) <= fcp.MAX_SMEM
    shares = [list(cluster_share(B, r, wsplit, interleaved=False)) for r in range(wsplit)]
    assert sum(shares, []) == list(range(B)) and all(shares)


def test_plans_reject_what_the_kernels_cannot_take():
    """A padded row beyond 16 tiles, or K past wgrad's 32 tap tiles."""
    with pytest.raises(ValueError, match="T_in \\+ 2\\*padding <= 256"):
        fcp.dgrad_plan(1, 240, 31, 1, 15, 240, 2, 1, SMS)
    live = torch.ones(64, 8, dtype=torch.bool)
    s = fcp.pack_structure(live, 33, torch.float32, 1, 16)
    gy = torch.zeros(1, 64, 8)
    with pytest.raises(ValueError, match="K <= 31"):
        fcp._bwd_checks(s, gy, gy)
