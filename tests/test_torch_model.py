"""The port's HMVAE against the flax model on shared weights (CPU, f32).

The flax model is initialised, its parameters go through
``params_from_flax``, and encode, decode and the posterior-mean
reconstruction (6D, rotation matrices, FK positions) are compared:
len-8 (atol 5e-4), len-64 at batch 2 (atol 5e-3 * max(1, max|ref|), as
tests/test_torch_oracle.py) and an ``extra_conv=1`` variant.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.apps.inference import VAEInference as JInference
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.utils import config as jcfg
from hm_vae_tpu.utils.torch_import import export_hmvae_params
from hm_vae_torch.apps.inference import VAEInference
from hm_vae_torch.models.hm_vae import HMVAE, SkeletonConv, prior_z_list, split_stats
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import (
    params_from_flax, state_dict_from_reference, load_reference_checkpoint)

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)


def _x6d(B, T, seed):
    from hm_vae_tpu.ops import rotations as jrot

    aa = np.random.default_rng(seed).normal(size=(B, T, 24, 3)).astype(np.float32) * 0.5
    return np.array(jrot.rotmat_to_rot6d(jrot.aa_to_rotmat(jnp.asarray(aa))))


def _pair(model_kw, B, seed=0):
    """(flax model, flax variables, port model, input) on shared weights."""
    jm_cfg, tm_cfg = jcfg.ModelConfig(**model_kw), tcfg.ModelConfig(**model_kw)
    x = _x6d(B, jm_cfg.train_seq_len, seed)
    jm = JHMVAE(jm_cfg)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    tm = HMVAE(tm_cfg)
    tm.load_state_dict(params_from_flax(params, tm_cfg), strict=True)
    return jm, variables, tm, x


def _check_forward(model_kw, B, tol):
    jm, variables, tm, x = _pair(model_kw, B)
    _, jz = jm.apply(variables, jnp.asarray(x), method=JHMVAE.encode)
    with torch.no_grad():
        _, tz = tm.encode(torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(jz, tz)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol(np.asarray(a)), rtol=0,
                                   err_msg=f"z stats level {i}")
    jcfg_full = jcfg.Config(model=jm.cfg)
    tcfg_full = tcfg.Config(model=tm.cfg)
    refs = JInference(jm, variables, jcfg_full).mean_reconstruction(jnp.asarray(x))
    outs = VAEInference(tm, tcfg_full, device="cpu").mean_reconstruction(x)
    for name, a, b in zip(("rot6d", "rotmat", "pose"), refs, outs):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol(np.asarray(a)), rtol=0,
                                   err_msg=name)
    return jm, variables, tm, x


def test_len8_matches_flax():
    _check_forward(LEN8, 3, lambda ref: 5e-4)


def test_len8_extra_conv_matches_flax():
    _check_forward(dict(LEN8, extra_conv=1), 2, lambda ref: 5e-4)


def test_len64_matches_flax():
    jm, variables, tm, x = _check_forward(
        dict(latent_d=24, shallow_latent_d=12, kernel_size=15, train_seq_len=64), 2,
        lambda ref: 5e-3 * max(1.0, float(np.abs(ref).max())))
    # decode of injected latents (noise fed to both sides from numpy)
    rng = np.random.default_rng(7)
    st = get_structure(tm.cfg)
    zs = [rng.normal(size=(2, e, d)).astype(np.float32) for e, d in zip(st.z_edges, st.z_dims)]
    ref = np.asarray(jm.apply(variables, [jnp.asarray(z) for z in zs], method=JHMVAE.decode))
    with torch.no_grad():
        ours = tm.decode([torch.from_numpy(z) for z in zs]).numpy()
    np.testing.assert_allclose(ours, ref, atol=5e-3 * max(1.0, float(np.abs(ref).max())))


def test_reference_checkpoint_keys_round_trip(tmp_path):
    jm, variables, tm, _ = _pair(LEN8, 1)
    sd = export_hmvae_params(jax.tree.map(np.asarray, variables), jm.cfg)
    path = tmp_path / "gen_00000001.pt"
    torch.save({"state_dict": {k: torch.tensor(np.asarray(v))
                               for k, v in sd.items()}}, path)
    got = state_dict_from_reference(load_reference_checkpoint(str(path)), tm.cfg)
    want = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    bad = dict(sd)
    bad["enc.layers.0.1.weight"] = bad["enc.layers.0.1.weight"] + 1.0
    with pytest.raises(ValueError, match="wrong architecture"):
        state_dict_from_reference(bad, tm.cfg)


def test_unported_options_raise():
    """Both parameter layouts are ported; an unknown one raises ValueError."""
    for kw in (dict(param_layout="sparse"),):
        with pytest.raises(ValueError, match="param_layout"):
            HMVAE(tcfg.ModelConfig(**LEN8, **kw))


def test_init_bounds_and_prior_layout():
    cfg = tcfg.ModelConfig(**LEN8)
    m = HMVAE(cfg, "default", generator=torch.Generator().manual_seed(0))
    st = get_structure(cfg)
    w = m.encoder.conv_0.weight.detach()
    bounds = np.repeat(st.encoder_levels[0].conv.block_bounds,
                       w.shape[0] // st.encoder_levels[0].conv.n_edges)
    assert (w.abs().amax(dim=(1, 2)).numpy() <= bounds + 1e-7).all()
    head = m.encoder.latent_head_0
    assert head.weight.abs().max() <= 1.0 / np.sqrt(head.in_features) + 1e-7
    assert (head.bias == 0).all()
    for init in ("gaussian", "xavier", "kaiming", "orthogonal"):
        HMVAE(cfg, init, generator=torch.Generator().manual_seed(0))
    zs = prior_z_list(cfg, 3, torch.Generator().manual_seed(1))
    assert [tuple(z.shape) for z in zs] == [(3, e, d) for e, d in zip(st.z_edges, st.z_dims)]
    assert all((z == 0).all() for z in zs[1:-1]) and zs[0].std() > 0.5
    mu, logvar = split_stats(torch.zeros(2, 14, 12), cfg, 0)
    assert mu.shape == logvar.shape == (2, 14, 6)


def test_conv_operands_and_folded_weight_agree():
    """The packed operands unpack to the JAX module's single folded weight,
    and the packed level computes the same as the raw weight + mask + pool
    (or the unpool folded into the weight)."""
    cfg = tcfg.ModelConfig(**LEN8)
    m = HMVAE(cfg, generator=torch.Generator().manual_seed(3))
    from hm_vae_torch.ops.fused_conv_pool import (fused_conv_pool_packed,
                                                  fused_conv_pool_reference, unpack_level)

    with torch.no_grad():
        for conv in (c for c in m.modules() if isinstance(c, SkeletonConv)):
            packed = conv.packed_operands()
            fw, fb = conv.folded_weight()
            w2, b2 = unpack_level(packed)
            torch.testing.assert_close(w2, fw, atol=0, rtol=0)
            torch.testing.assert_close(b2, fb, atol=0, rtol=0)
            w = conv.weight if conv.mask is None else conv.weight * conv.mask[:, :, None]
            if conv.unpool is not None:
                w = torch.einsum("ock,cp->opk", w, conv.unpool)
            x = torch.randn(2, w.shape[1], 8, generator=torch.Generator().manual_seed(4))
            s = conv.spec
            ours = fused_conv_pool_packed(x, packed)
            ref = fused_conv_pool_reference(x, w, conv.bias, None, conv.pool, s.stride,
                                            s.padding, s.padding_mode, conv.negative_slope)
            torch.testing.assert_close(ours, ref, atol=1e-5, rtol=0)


def test_bf16_compute_tracks_f32():
    """compute_dtype bfloat16 on the CPU plain path stays near the f32 model
    on the same weights (bf16 rounds at every level)."""
    cfg = tcfg.ModelConfig(**LEN8)
    m32 = HMVAE(cfg, generator=torch.Generator().manual_seed(5))
    m16 = HMVAE(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    m16.load_state_dict(m32.state_dict())
    x = torch.from_numpy(_x6d(2, 8, 6))
    with torch.no_grad():
        a, b = m32(x)[1], m16(x)[1]
    assert b.dtype == torch.float32
    torch.testing.assert_close(b, a, atol=0.05 * max(1.0, float(a.abs().max())), rtol=0)
