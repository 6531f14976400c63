"""The windowed forms of the port's ``fused_conv_pool`` level on the CPU: G
windows of a batch, each through its own folded weight (the test-time
solver's per-window decoder clones).

- the windowed plain forward, dgrad and wgrad (through
  ``WindowedFusedConvPoolFn`` and the wrappers) against ``jax.vmap`` of the
  JAX package's XLA level and its ``jax.vjp``, at the four decoder levels of
  the full-width len-64 model, G = 3;
- one window is today's plain functions and packing, bit for bit;
- the windowed work plans cover every window's batches exactly once, no
  batch group or cluster share crossing a window;
- a decode through per-window decoder parameters against ``jax.vmap`` of
  the flax decode over the windows' parameter trees.

The CUDA kernels compute the same functions on the GPU, where chip_smoke.py
holds them against these plain versions.  Tolerance (f32): 1e-4 * max(1,
max|ref|), the sums run in another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.models import hm_vae as jhm
from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.models.hm_vae import HMVAE, windowed_linear
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "len64_no_aug_hm_vae.yaml")
G, SMS = 3, 132  # windows; an H100's SMs
LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


_DEC = []


def _decoder_levels():
    """(name, conv, input T) of the four decoder convs of the full-width model."""
    if not _DEC:
        cfg = tcfg.load_config(CONFIG)
        m = HMVAE(cfg.model, cfg.optim.init, generator=torch.Generator().manual_seed(0))
        st = get_structure(cfg.model)
        _DEC.extend((f"dec{i}", getattr(m.decoder, f"conv_{i}"),
                     st.dec_timesteps[i] * (2 if lvl.upsample else 1))
                    for i, lvl in enumerate(st.decoder_levels))
    return _DEC


def _windows(conv, rng):
    """G folded weights and biases: the conv's own fold, scaled per window,
    with the structure's zeros."""
    wf, bf = (None if t is None else t.detach() for t in conv.folded_weight())
    scale = 1.0 + 0.3 * rng.normal(size=(G, 1, 1, 1))
    w = (wf.numpy()[None] * scale).astype(np.float32)
    b = None if bf is None else (bf.numpy()[None] * scale[:, :, 0, 0]).astype(np.float32)
    return w, b


def _t_out(s, T):
    return (T + 2 * s.padding - s.kernel_size) // s.stride + 1


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("level", range(4))
def test_windowed_level_and_grads_match_jax_vmap(level, n):
    name, conv, T = _decoder_levels()[level]
    s, sp = conv.structure(), conv.spec
    rng = np.random.default_rng(level)
    w, b = _windows(conv, rng)
    x = rng.normal(size=(G * n, w.shape[2], T)).astype(np.float32)
    mode = "reflect" if s.reflect else "constant"

    def f(x, w, b):
        return jsnn.leaky_relu(jsnn.skeleton_conv_w(x, w, b, sp.stride, sp.padding, mode),
                               conv.negative_slope)

    bj = jnp.zeros(w.shape[:2]) if b is None else jnp.asarray(b)
    y_ref, vjp = jax.vjp(jax.vmap(f), jnp.asarray(x).reshape(G, n, *x.shape[1:]),
                         jnp.asarray(w), bj)
    gy = rng.normal(size=y_ref.shape).astype(np.float32)
    gx_ref, gw_ref, gb_ref = (np.asarray(g) for g in vjp(jnp.asarray(gy)))

    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    bt = None if b is None else torch.from_numpy(b).requires_grad_()
    counters = (fcp.fused_conv_pool_windowed, fcp.fused_conv_pool_dgrad_windowed,
                fcp.fused_conv_pool_wgrad_windowed)
    for c in counters:
        c.launches = 0
    y = fcp.WindowedFusedConvPoolFn.apply(xt, wt, bt, s)
    y.backward(torch.from_numpy(gy).reshape(y.shape))
    assert all(c.launches == 0 for c in counters)  # the CPU runs the plain versions
    live = s.live_elements().numpy()[None, :, :, None]
    checks = [("y", y.detach().numpy(), np.asarray(y_ref).reshape(y.shape)),
              ("dgrad", xt.grad.numpy(), gx_ref.reshape(x.shape)),
              ("wgrad", wt.grad.numpy(), gw_ref * live)]
    if b is not None:
        checks.append(("bias grad", bt.grad.numpy(), gb_ref))
    for what, got, ref in checks:
        np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0, err_msg=f"{name} {what}")
    # the wrappers, called directly, and the windowed packing's plain path
    g, yd = torch.from_numpy(gy).reshape(y.shape), y.detach()
    gx = fcp.fused_conv_pool_dgrad_windowed(g, yd, wt.detach(), s, T)
    gw, gb = fcp.fused_conv_pool_wgrad_windowed(g, yd, xt.detach(), s, G)
    assert torch.equal(gx, xt.grad) and torch.equal(gw, wt.grad)
    assert gb.shape == (G, w.shape[1])
    packed = fcp.repack(s, wt.detach(), None if bt is None else bt.detach())
    assert packed.windows == G
    np.testing.assert_allclose(fcp.fused_conv_pool_windowed(xt.detach(), packed).numpy(),
                               checks[0][2], atol=_tol(checks[0][2]), rtol=0)


@pytest.mark.parametrize("level", range(4))
def test_one_window_is_todays_level_bit_for_bit(level):
    """G = 1: the windowed plain functions, packing and unpacking give the
    single-weight functions' bits."""
    name, conv, T = _decoder_levels()[level]
    s = conv.structure()
    mode = "reflect" if s.reflect else "constant"
    wf, bf = (None if t is None else t.detach() for t in conv.folded_weight())
    gen = torch.Generator().manual_seed(level)
    x = torch.randn((2, wf.shape[1], T), generator=gen)
    args = (s.stride, s.padding, mode, s.negative_slope)
    y = fcp.fused_conv_pool_reference(x, wf, bf, None, None, *args)
    bw = None if bf is None else bf[None]
    assert torch.equal(fcp.fused_conv_pool_windowed_reference(x, wf[None], bw, *args), y)
    gy = torch.randn(y.shape, generator=gen)
    assert torch.equal(
        fcp.fused_conv_pool_dgrad_windowed_reference(gy, y, wf[None], T, *args),
        fcp.fused_conv_pool_dgrad_reference(gy, y, wf, T, *args))
    live = s.live_elements()
    gw1, gb1 = fcp.fused_conv_pool_wgrad_windowed_reference(
        gy, y, x, s.kernel_size, s.stride, s.padding, 1, mode, s.negative_slope, live)
    gw, gb = fcp.fused_conv_pool_wgrad_reference(gy, y, x, s.kernel_size, *args, live)
    assert torch.equal(gw1[0], gw) and torch.equal(gb1[0], gb)
    one, shared = fcp.repack(s, wf[None], bw), fcp.repack(s, wf, bf)
    assert shared.windows is None and one.windows == 1
    assert torch.equal(one.tiles[0], shared.tiles) and torch.equal(one.bias[0], shared.bias)
    w1, b1 = fcp.unpack_level(one)
    assert torch.equal(w1[0], fcp.unpack_level(shared)[0]) and w1.shape == (1,) + wf.shape
    assert b1 is None or b1.shape == (1, wf.shape[0])


def test_windowed_packing_round_trips_each_window():
    _, conv, _ = _decoder_levels()[2]
    rng = np.random.default_rng(7)
    w, _ = _windows(conv, rng)
    b = rng.normal(size=w.shape[:2]).astype(np.float32)
    packed = fcp.repack(conv.structure(), torch.from_numpy(w), torch.from_numpy(b))
    for g in range(G):
        single = fcp.repack(conv.structure(), torch.from_numpy(w[g]), torch.from_numpy(b[g]))
        assert torch.equal(packed.tiles[g], single.tiles)
        assert torch.equal(packed.bias[g], single.bias)
    uw, ub = fcp.unpack_level(packed)
    assert torch.equal(uw, torch.from_numpy(w)) and torch.equal(ub, torch.from_numpy(b))
    with pytest.raises(ValueError, match="windowed packing"):
        fcp.fused_conv_pool_packed(torch.zeros(G, w.shape[2], 32), packed)
    with pytest.raises(ValueError, match="windowed packing"):
        fcp.fused_conv_pool_windowed(torch.zeros(G, w.shape[2], 32),
                                     fcp.repack(conv.structure(), torch.from_numpy(w[0]), None))


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("level", range(4))
def test_windowed_plans_cover_each_window_once(level, n):
    """dgrad: a window's batch groups cover its batches once and never reach
    into the next window (the kernel's index math); wgrad: each window's
    cluster shares cover its batches once.  At G = 1 the plans are today's."""
    _, conv, T = _decoder_levels()[level]
    s = conv.structure()
    T_out, pairs = _t_out(s, T), s.dgrad_start.numel() - 1
    for windows in (1, 10):
        nbb, gpw, split = fcp.dgrad_plan(n, T, s.kernel_size, s.stride, s.padding, T_out,
                                         pairs, s.dgrad_max_live, SMS, windows)
        assert 1 <= nbb <= n and gpw == -(-n // nbb) and 1 <= split <= fcp.MAX_SPLIT
        seen = []
        for y in range(windows * gpw):
            win = y // gpw
            b0 = win * n + (y - win * gpw) * nbb
            nbl = min(nbb, (win + 1) * n - b0)
            assert nbl >= 1
            rows = list(range(b0, b0 + nbl))
            assert all(r // n == win for r in rows)
            seen += rows
        assert seen == list(range(windows * n))
        sb, wsplit = fcp.wgrad_plan(n, T_out, s.wgrad_row.numel(), SMS, windows)
        assert 1 <= wsplit <= min(fcp.MAX_SPLIT, n) and (sb == 1 or sb * T_out <= 32)
        shares = [list(range(z * n + n * r // wsplit, z * n + n * (r + 1) // wsplit))
                  for z in range(windows) for r in range(wsplit)]
        assert sum(shares, []) == list(range(windows * n)) and all(shares)
    assert fcp.dgrad_plan(n, T, s.kernel_size, s.stride, s.padding, T_out, pairs,
                          s.dgrad_max_live, SMS, 1) == fcp.dgrad_plan(
        n, T, s.kernel_size, s.stride, s.padding, T_out, pairs, s.dgrad_max_live, SMS)
    assert fcp.wgrad_plan(n, T_out, s.wgrad_row.numel(), SMS, 1) == fcp.wgrad_plan(
        n, T_out, s.wgrad_row.numel(), SMS)


def test_windowed_linear_is_each_windows_linear():
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(G * 2, 7, 5, generator=gen)
    w, b = torch.randn(G, 9, 5, generator=gen), torch.randn(G, 9, generator=gen)
    out = windowed_linear(z, w, b)
    for g in range(G):
        ref = torch.nn.functional.linear(z[2 * g:2 * g + 2], w[g], b[g])
        torch.testing.assert_close(out[2 * g:2 * g + 2], ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(windowed_linear(z, w[0], b[0]), torch.nn.functional.linear(z, w[0], b[0]))


def test_decode_with_per_window_params_matches_jax_vmap():
    """HMVAE.decode through G windows' decoder parameters (every leaf with a
    window axis) against jax.vmap of the flax decode over the windows'
    parameter trees; and shared parameters give the model's own decode."""
    jc, tc = jcfg.ModelConfig(**LEN8), tcfg.ModelConfig(**LEN8)
    jm = jhm.HMVAE(jc)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24, 6)))
    rng = np.random.default_rng(3)
    scale = [1.0 + 0.2 * rng.normal() for _ in range(G)]
    trees = [jax.tree.map(lambda a, s=s: np.asarray(a) * np.float32(s), params)
             for s in scale]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *[t["params"]["decoder"] for t in trees])
    st = get_structure(tc)
    z = [rng.normal(size=(G, st.z_edges[i], st.z_dims[i])).astype(np.float32)
         for i in range(tc.num_layers)]

    def dec1(p, zs):
        zb = [a[None] for a in zs]
        return jm.apply({"params": {"decoder": p}}, zb, method=jhm.HMVAE.decode)[0]

    ref = np.asarray(jax.vmap(dec1)(stacked, [jnp.asarray(a) for a in z]))
    model = HMVAE(tc)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tc), strict=False)
    per = [params_from_flax(t, tc) for t in trees]
    dec = {k[len("decoder."):]: torch.stack([p[k] for p in per])
           for k in per[0] if k.startswith("decoder.")}
    zt = [torch.from_numpy(a) for a in z]
    with torch.no_grad():
        ours = model.decode(zt, params=dec).numpy()
        own = model.decode(zt)
        shared = model.decode(zt, params={k: v for k, v in model.decoder.named_parameters()})
    np.testing.assert_allclose(ours, ref, atol=_tol(ref), rtol=0)
    assert torch.equal(own, shared)
