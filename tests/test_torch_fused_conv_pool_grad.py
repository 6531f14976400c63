"""The backward of the port's ``fused_conv_pool`` on the CPU: the plain
dgrad, wgrad and bias grad through ``FusedConvPoolFn`` against ``jax.vjp`` of
the JAX package's level, at every level of the full-width len-64 model and of
a len-8 config, both paddings; the raw parameters' gradients through the
mask/pool/unpool fold against the flax ``SkeletonConv``; a float64
gradcheck; and the structure + value repack against ``pack_level``.  The
CUDA kernels compute the same functions on the GPU, where chip_smoke.py
holds them against these plain versions.

Tolerance (f32): 1e-4 * max(1, max|ref|), as the forward: the sums run in
another order."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.models import hm_vae as jhm
from hm_vae_tpu.models import structure as jst
from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.models.hm_vae import HMVAE, SkeletonConv
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.utils import config as tcfg

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "len64_no_aug_hm_vae.yaml")
LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
B = 2


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


def _model(name):
    cfg = (tcfg.load_config(CONFIG).model if name == "len64" else tcfg.ModelConfig(**LEN8))
    return HMVAE(cfg, generator=torch.Generator().manual_seed(0)), cfg


_MODELS = {}


def _levels(name):
    """(name, conv, input T) of the eight convs, and the model config."""
    if name not in _MODELS:
        m, cfg = _model(name)
        st = get_structure(cfg)
        cases = [(f"enc{i}", getattr(m.encoder, f"conv_{i}"), st.enc_timesteps[i])
                 for i in range(len(st.encoder_levels))]
        cases += [(f"dec{i}", getattr(m.decoder, f"conv_{i}"),
                   st.dec_timesteps[i] * (2 if lvl.upsample else 1))
                  for i, lvl in enumerate(st.decoder_levels)]
        _MODELS[name] = (cases, cfg)
    return _MODELS[name]


@pytest.mark.parametrize("level", range(8))
@pytest.mark.parametrize("model,mode", [("len64", "reflect"), ("len64", "constant"),
                                        ("len8", "reflect")])
def test_folded_level_grads_match_jax(model, mode, level):
    name, conv, T = _levels(model)[0][level]
    with torch.no_grad():
        wf, bf = conv.folded_weight()
    s0, sp = conv.structure(), conv.spec
    s = fcp.pack_structure(s0.live_elements(), sp.kernel_size, torch.float32, sp.stride,
                           sp.padding, mode, conv.negative_slope)
    rng = np.random.default_rng(level)
    x = rng.normal(size=(B, wf.shape[1], T)).astype(np.float32)
    w = wf.detach().numpy()
    b = np.zeros(w.shape[0], np.float32) if bf is None else bf.detach().numpy()

    def f(x, w, b):
        return jsnn.leaky_relu(jsnn.skeleton_conv_w(x, w, b, sp.stride, sp.padding, mode),
                               conv.negative_slope)

    y_ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gy = rng.normal(size=y_ref.shape).astype(np.float32)
    gx_ref, gw_ref, gb_ref = (np.asarray(g) for g in vjp(jnp.asarray(gy)))

    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    fcp.fused_conv_pool_dgrad.launches = fcp.fused_conv_pool_wgrad.launches = 0
    y = fcp.FusedConvPoolFn.apply(xt, wt, None if bf is None else bt, s)
    y.backward(torch.from_numpy(gy))
    assert fcp.fused_conv_pool_dgrad.launches == fcp.fused_conv_pool_wgrad.launches == 0
    live = s.live_elements().numpy()[:, :, None]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=_tol(y_ref), rtol=0)
    checks = [("dgrad", xt.grad, gx_ref), ("wgrad", wt.grad, gw_ref * live)]
    if bf is not None:
        checks.append(("bias grad", bt.grad, gb_ref))
    for what, got, ref in checks:
        np.testing.assert_allclose(got.numpy(), ref, atol=_tol(ref), rtol=0,
                                   err_msg=f"{model} {name} {mode} {what}")
    # the dead tiles hold structural zeros: the weight has none there
    assert (w * (1 - live) == 0).all() and (wt.grad.numpy() * (1 - live) == 0).all()


def _flax_level(spec_j, conv, lvl_j, enc):
    """The flax SkeletonConv of one level (pool after, or unpool folded in)
    and its LeakyReLU, as a function of (x, weight, bias)."""
    module = jhm.SkeletonConv(spec_j, "float32",
                              pool_matrix=lvl_j.pool_matrix if enc else None,
                              unpool_matrix=None if enc else lvl_j.unpool_matrix)
    slope = conv.negative_slope

    def f(x, w, b):
        params = {"weight": w} if b is None else {"weight": w, "bias": b}
        return jsnn.leaky_relu(module.apply({"params": params}, x), slope)

    return f


@pytest.mark.parametrize("level", range(8))
def test_raw_parameter_grads_match_flax_level(level):
    """Autograd through the fold (mask, pool, unpool) carries the kernels'
    folded-weight gradient back to the raw weight and bias as JAX's
    autodiff of its level does."""
    cases, cfg = _levels("len64")
    name, conv, T = cases[level]
    st_j = jst.get_structure(jcfg.ModelConfig(**{f: getattr(cfg, f) for f in (
        "latent_d", "shallow_latent_d", "kernel_size", "train_seq_len")}))
    enc = name.startswith("enc")
    lvl_j = (st_j.encoder_levels if enc else st_j.decoder_levels)[int(name[3:])]
    f = _flax_level(lvl_j.conv, conv, lvl_j, enc)
    rng = np.random.default_rng(10 + level)
    c_in = conv.weight.shape[1] if conv.unpool is None else conv.unpool.shape[1]
    x = rng.normal(size=(B, c_in, T)).astype(np.float32)
    w = conv.weight.detach().numpy()
    b = None if conv.bias is None else conv.bias.detach().numpy()
    y_ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    gy = rng.normal(size=y_ref.shape).astype(np.float32)
    refs = vjp(jnp.asarray(gy))

    conv.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = conv(xt)
    y.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=_tol(y_ref), rtol=0)
    got = [xt.grad, conv.weight.grad] + ([] if b is None else [conv.bias.grad])
    for what, g, r in zip(("x", "weight", "bias"), got, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=_tol(r), rtol=0, err_msg=f"{name} {what}")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_gradcheck_float64(stride, mode):
    P, C, T, K, pad = 66, 11, 9, 3, 1
    gen = torch.Generator().manual_seed(stride)
    live = torch.rand(P, C, generator=gen) > 0.2
    live[:, 8:] = False  # a whole dead channel chunk
    s = fcp.pack_structure(live, K, torch.float32, stride, pad, mode, 0.2)
    mask = s.live_elements()[:, :, None].double()
    w = (torch.randn(P, C, K, dtype=torch.float64, generator=gen) * mask).requires_grad_()
    b = torch.randn(P, dtype=torch.float64, generator=gen, requires_grad=True)
    x = torch.randn(2, C, T, dtype=torch.float64, generator=gen, requires_grad=True)

    def level(x, w, b):  # the dead tiles are structural zeros: hold them so
        return fcp.FusedConvPoolFn.apply(x, w * mask, b, s)

    assert torch.autograd.gradcheck(level, (x, w, b), fast_mode=True)


def test_structure_and_repack_give_pack_level_tiles():
    """Serving packs from the structure now: on the serving weights the live
    tiles and their values are exactly pack_level's (live from values)."""
    m, _ = _model("len64")
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for conv in (c for c in m.modules() if isinstance(c, SkeletonConv)):
                conv.dtype = dtype
                w, b = conv.folded_weight()
                sp = conv.spec
                ref = fcp.pack_level(w, b, sp.stride, sp.padding, sp.padding_mode,
                                     conv.negative_slope)
                ours = conv.packed_operands()
                for f in ("tiles", "bias", "tile_start", "tile_chunk"):
                    assert torch.equal(getattr(ours, f), getattr(ref, f)), f
                assert ours.max_live == ref.max_live


def test_trained_zero_keeps_its_tile():
    """A tile whose values become zero stays in the structure (decided
    from the mask, pool and unpool), where pack_level would drop it."""
    m, _ = _model("len8")
    conv = m.encoder.conv_0
    s = conv.structure()
    with torch.no_grad():
        conv.weight.zero_()
        w, b = conv.folded_weight()
    packed = fcp.repack(s, w, b)
    assert packed.tiles.shape[0] == s.tile_chunk.numel() > 0
    assert fcp.pack_level(w, b, 1, 1).tiles.shape[0] == 0
    # wgrad's entries with a chunk are the live tiles, by row tile
    by_row = {(int(r), int(c)) for r, c in zip(s.wgrad_row, s.wgrad_chunk) if c >= 0}
    assert by_row == {(r, int(c)) for r in range(s.tile_start.numel() - 1)
                      for c in s.tile_chunk[int(s.tile_start[r]):int(s.tile_start[r + 1])]}
    # the dgrad lists are the row tiles live in either chunk of each pair
    by_pair = {(int(s.dgrad_row[e]), q) for q in range(s.dgrad_start.numel() - 1)
               for e in range(int(s.dgrad_start[q]), int(s.dgrad_start[q + 1]))}
    assert by_pair == {(r, c // fcp.DGRAD_CHUNKS) for r, c in by_row}


def test_backward_wrappers_take_float32_only():
    """On a non-CPU device the wrappers check before they launch: a weight
    or x whose dtype is not gy's raises, one window or several, instead of
    falling back.  bf16 over rows past whole-row staging plans the span
    kernel's bf16 form (dgrad) and the item kernel's (wgrad: items of one
    batch's columns that fit a block)."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    s = fcp.pack_structure(torch.ones(64, 8, dtype=torch.bool), 3, torch.bfloat16, 1, 1,
                           device="meta")
    T = 1024  # past one block's whole-row staging: spans and items
    d = fcp.dgrad_plan(1, T, 3, 1, 1, T, s.dgrad_start.numel() - 1, s.dgrad_max_live, 132, 1,
                       (s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live), esz=2)
    assert d.span == fcp.dgrad_span_cols(3, 1, 2) and d.nbb == 1
    w = fcp.wgrad_plan(1, T, s.wgrad_row.numel(), 132, 1,
                       lambda sb, split: fcp._wgrad_smem(1, T, 3, T, T, 1, sb, split, 2),
                       fcp.wgrad_span_cols(3, 1, 2))
    assert w.sb == 1 and w.span == fcp.wgrad_span_cols(3, 1, 2) == 128
    assert fcp._wgrad_span_smem(3, 1, w.span, 2) <= fcp.MAX_SMEM
    gy = meta(2, 64, 4)  # two windows of one batch
    with pytest.raises(TypeError, match="weight has dtype torch.float32"):
        fcp.fused_conv_pool_dgrad_windowed(gy, gy, torch.empty((2, 64, 8, 3), device="meta"),
                                           s, 4)
    with pytest.raises(TypeError, match="x has dtype torch.float32"):
        fcp.fused_conv_pool_wgrad_windowed(gy, gy, torch.empty((2, 8, 4), device="meta"), s, 2)
    with pytest.raises(TypeError, match="weight has dtype torch.float32"):
        fcp.fused_conv_pool_dgrad(gy, gy, torch.empty((64, 8, 3), device="meta"), s, 4)
