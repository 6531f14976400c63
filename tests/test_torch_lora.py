"""The port's rank-r decoder adapters and the solver's lora scope against the
JAX package on the CPU, at len-8 size, from the same numpy parameters:

- a decode with ``lora_a == 0`` equals the base decode exactly, in both
  packages (``tests/test_latent_opt.py::test_lora_module_zero_adapter_is_exact``
  is the JAX side), and the port's is within 5e-4 of JAX's (as
  tests/test_torch_model.py holds the len-8 decode);
- a decode with nonzero adapters (numpy draws loaded into both packages),
  shared and one adapter per window, within 5e-4 of JAX's;
- ``_lora_reg`` against JAX's on the same tree, shared and per window
  (``jax.vmap``), within 1e-6 relative;
- the lora solve against ``make_latent_optimizer``, JAX's own
  ``PRNGKey(0)`` ``lora_b`` draws injected as ``lora_init``, with per-window
  adapters and a shared one, ``lora_lr_mult`` 1 and 10: every iteration's
  loss within 1e-5 relative, ``last_6d`` within 1e-5, ``final_loss`` within
  1e-5 relative (f32 sums in another order);
- ``lora_rank: 0`` under the lora scope raises ``ValueError``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from hm_vae_tpu.apps import latent_opt as jlo
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.apps import latent_opt as tlo
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

from test_torch_latent_opt import LAT, LEN8, _setup

RANK = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _z(cfg, B, seed):
    st = get_structure(cfg)
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, st.z_edges[i], st.z_dims[i])).astype(np.float32)
            for i in range(cfg.num_layers)]


def _lora_pair(model_kw, seed=0, adapters=False):
    """The JAX model with adapters, its variables (numpy; nonzero ``lora_a``
    drawn from numpy with ``adapters``) and the port model on them."""
    jc = jcfg.ModelConfig(**model_kw, lora_rank=RANK)
    jm = JHMVAE(jc)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, jc.train_seq_len, 24, 6)))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, v["params"]))
    if adapters:
        rng = np.random.default_rng(seed + 1)
        for p in flat:
            if p[-1] == "lora_a":
                flat[p] = (0.3 * rng.normal(size=flat[p].shape)).astype(np.float32)
    params = traverse_util.unflatten_dict(flat)
    tc = tcfg.ModelConfig(**model_kw, lora_rank=RANK)
    tm = HMVAE(tc)
    tm.load_state_dict(params_from_flax(params, tc), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("extra_conv", [0, 1])
def test_zero_adapter_decode_is_the_base_decode_exactly(extra_conv):
    kw = dict(LEN8, extra_conv=extra_conv)
    jm, params, tm = _lora_pair(kw)
    assert not any(m.lora_a is not None for m in tm.encoder.modules()
                   if hasattr(m, "lora_a"))
    base_j = JHMVAE(jcfg.ModelConfig(**kw))
    base_params = {part: {k: {n: a for n, a in leaf.items() if not n.startswith("lora_")}
                          for k, leaf in params[part].items()} for part in params}
    base_t = HMVAE(tcfg.ModelConfig(**kw))
    base_t.load_state_dict(params_from_flax(base_params, base_t.cfg), strict=True)
    z = _z(tm.cfg, 2, 3)
    zj = [jnp.asarray(a) for a in z]
    ref_lora = np.asarray(jm.apply({"params": params}, zj, method=JHMVAE.decode))
    ref_base = np.asarray(base_j.apply({"params": base_params}, zj, method=JHMVAE.decode))
    np.testing.assert_array_equal(ref_lora, ref_base)
    with torch.no_grad():
        zt = [torch.from_numpy(a) for a in z]
        ours_lora, ours_base = tm.decode(zt), base_t.decode(zt)
    torch.testing.assert_close(ours_lora, ours_base, rtol=0, atol=0)
    np.testing.assert_allclose(ours_lora.numpy(), ref_lora, atol=5e-4, rtol=0)


@pytest.mark.parametrize("windows", [None, 3], ids=["shared", "per_window"])
@pytest.mark.parametrize("extra_conv", [0, 1])
def test_adapter_decode_matches_jax(extra_conv, windows):
    """Nonzero adapters; per window: G adapters (and biases) stacked, window
    g's batch through adapter g, against JAX on each window's parameters."""
    kw = dict(LEN8, extra_conv=extra_conv)
    jm, params, tm = _lora_pair(kw, adapters=True)
    z = _z(tm.cfg, 2 * (windows or 1), 5)
    if windows is None:
        ref = np.asarray(jm.apply({"params": params}, [jnp.asarray(a) for a in z],
                                  method=JHMVAE.decode))
        with torch.no_grad():
            ours = tm.decode([torch.from_numpy(a) for a in z]).numpy()
        np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=0)
        return
    rng = np.random.default_rng(11)
    flat = traverse_util.flatten_dict(params["decoder"])
    # the convs' adapters and biases one per window, their weights shared
    own = {p for p in flat if p[0].startswith("conv") and p[-1] != "weight"}
    per = {p: np.stack([(v * (1 + 0.2 * rng.normal(size=v.shape))).astype(np.float32)
                        for _ in range(windows)]) if p in own else v
           for p, v in flat.items()}
    refs = []
    for g in range(windows):
        dec_g = traverse_util.unflatten_dict(
            {p: v[g] if p in own else v for p, v in per.items()})
        refs.append(np.asarray(jm.apply({"params": dict(params, decoder=dec_g)},
                                        [jnp.asarray(a[2 * g:2 * g + 2]) for a in z],
                                        method=JHMVAE.decode)))
    sd = params_from_flax({"encoder": params["encoder"],
                           "decoder": traverse_util.unflatten_dict(per)}, tm.cfg)
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    with torch.no_grad():
        ours = tm.decode([torch.from_numpy(a) for a in z], params=dec).numpy()
    np.testing.assert_allclose(ours, np.concatenate(refs), atol=5e-4, rtol=0)


@pytest.mark.parametrize("per_window", [False, True])
def test_lora_reg_matches_jax(per_window):
    rng = np.random.default_rng(2)
    G = 3 if per_window else None
    lead = (G,) if per_window else ()

    def draw(*shape):
        return rng.normal(size=lead + shape).astype(np.float32)

    tree = {"conv_0": {"lora_a": draw(7, RANK), "lora_b": draw(RANK, 5, 2), "bias": draw(7)},
            "conv_1": {"lora_a": draw(4, RANK), "lora_b": draw(RANK, 6, 3), "bias": draw(4)},
            "latent_dec_0": {"kernel": draw(5, 4), "bias": draw(4)}}
    tree0 = jax.tree.map(lambda a: (a + rng.normal(size=a.shape)).astype(np.float32), tree)
    fn = jax.vmap(jlo._lora_reg) if per_window else jlo._lora_reg
    ref = np.asarray(fn(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, tree0)))

    def port(t):
        out = {}
        for mod, leaves in t.items():
            for k, v in leaves.items():
                if k == "kernel":
                    out[f"{mod}.weight"] = torch.from_numpy(np.swapaxes(v, -1, -2).copy())
                else:
                    out[f"{mod}.{k}"] = torch.from_numpy(v)
        return out

    ours = tlo._lora_reg(port(tree), port(tree0), per_window).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


def _jax_lora_b(jm, rank, z):
    """The adapters' lora_b the JAX solver draws (``model.init(PRNGKey(0),
    z[:1], method=HMVAE.decode)``), by the port's decoder names."""
    jl = JHMVAE(dataclasses.replace(jm.cfg, lora_rank=rank), jm.init_type)
    v = jl.init(jax.random.PRNGKey(0), [jnp.asarray(a[:1]) for a in z], method=JHMVAE.decode)
    flat = traverse_util.flatten_dict(v["params"]["decoder"])
    return {".".join(p): np.asarray(a) for p, a in flat.items() if p[-1] == "lora_b"}


@pytest.mark.parametrize("mult", [1.0, 10.0])
@pytest.mark.parametrize("per_window", [True, False], ids=["per_window", "shared"])
def test_lora_solve_matches_jax(per_window, mult):
    s = _setup()
    lat = dict(LAT, opt_lr=1e-2, finetune_scope="lora", lora_rank=RANK, lora_lr_mult=mult,
               per_window_decoder=per_window)
    jc = jcfg.Config(model=jcfg.ModelConfig(**LEN8), latent_opt=jcfg.LatentOptConfig(**lat))
    tc = tcfg.Config(model=tcfg.ModelConfig(**LEN8), latent_opt=tcfg.LatentOptConfig(**lat))
    ref = jax.tree.map(np.asarray, jlo.make_latent_optimizer(s["jm"], jc)(
        s["params"], {k: jnp.asarray(v) for k, v in s["targets"].items()},
        jnp.asarray(s["mask"]), [jnp.asarray(a) for a in s["z"]],
        [jnp.asarray(a) for a in s["zr"]]))
    lora_b = _jax_lora_b(s["jm"], RANK, s["z"])
    assert set(lora_b) == {f"conv_{i}.lora_b" for i in range(4)}
    ours = tlo.make_latent_optimizer(s["tm"], tc, lora_init=lora_b)(
        s["targets"], s["mask"], s["z"], s["zr"])
    np.testing.assert_allclose(ours.loss_history.numpy(), ref.loss_history, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ours.last_6d.numpy(), ref.last_6d, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.final_loss.numpy(), ref.final_loss, rtol=1e-5, atol=0)
    # the decoder phase moved the adapters: the loss left the z phase's path
    n_z = tc.latent_opt.prev_epochs + 1
    assert ours.loss_history[-1] < ours.loss_history[n_z - 1]


def test_lora_rank_zero_raises():
    tc = tcfg.Config(model=tcfg.ModelConfig(**LEN8), latent_opt=tcfg.LatentOptConfig(
        **LAT, finetune_scope="lora", lora_rank=0))
    with pytest.raises(ValueError, match="lora_rank"):
        tlo.make_latent_optimizer(_setup()["tm"], tc)
