"""The port's training loss against the JAX package's on shared weights and
noise (CPU, f32, a len-8 model): ``hmvae_forward``'s total, every metric and
every leaf gradient against ``jax.value_and_grad``, on both sides of the KL
curriculum's ``iteration_interval``; the batch's wire forms; and the
curriculum's ``grad is None`` heads.

The JAX side draws its noise from ``jax.random`` keys; the test draws the
same numbers (``jax.random.split`` + ``normal``) and injects them into the
port.  Tolerance: 1e-4 * max(1, max|ref|) (f32 sums in another order,
through Gram-Schmidt and FK)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.models.hm_vae import split_stats as jsplit
from hm_vae_tpu.ops import rotations as jrot
from hm_vae_tpu.train import losses as jlosses
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.train import losses as tlosses
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
LOSS = dict(iteration_interval=5)
B = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(ref):
    return 1e-4 * max(1.0, float(np.abs(np.asarray(ref)).max()))


@pytest.fixture(scope="module")
def pair():
    jc = jcfg.Config(model=jcfg.ModelConfig(**LEN8), loss=jcfg.LossConfig(**LOSS))
    tc = tcfg.Config(model=tcfg.ModelConfig(**LEN8), loss=tcfg.LossConfig(**LOSS))
    aa = np.random.default_rng(0).normal(size=(B, 8, 24, 3)).astype(np.float32) * 0.4
    mats = np.asarray(jrot.aa_to_rotmat(jnp.asarray(aa)))
    batch = {"rot_6d": np.asarray(jrot.rotmat_to_rot6d(jnp.asarray(mats))), "rot_mat": mats,
             "aa": aa}
    jm = JHMVAE(jc.model)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(batch["rot_6d"]))
    tm = HMVAE(tc.model)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, variables["params"]),
                                        tc.model))
    return jc, tc, jm, variables, tm, batch


def _jax_eps(jm, variables, batch, rng, cfg):
    """The noise JAX's hmvae_forward draws from ``rng``."""
    _, stats = jm.apply(variables, jnp.asarray(batch["rot_6d"]), method=JHMVAE.encode)
    keys = jax.random.split(rng, cfg.model.num_layers)
    return [np.array(jax.random.normal(keys[i], jsplit(s, cfg.model, i)[0].shape))
            for i, s in enumerate(stats)]


def _flat_grads(tree):
    """flax gradient tree -> port names (Dense kernels transposed)."""
    return {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, tree),
                                                        tcfg.ModelConfig(**LEN8)).items()}


@pytest.mark.parametrize("step", [2, 5])
def test_loss_metrics_and_grads_match_jax(pair, step):
    jc, tc, jm, variables, tm, batch = pair
    rng = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(batch[k]) for k in ("rot_6d", "rot_mat")}

    def loss(params, step):
        return jlosses.hmvae_forward(jm, {"params": params}, jb, rng, step, jc)

    (total_ref, metrics_ref), grads_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], jnp.asarray(step))
    eps = [torch.from_numpy(e) for e in _jax_eps(jm, variables, batch, rng, jc)]

    tm.zero_grad(set_to_none=True)
    tb = {k: torch.tensor(batch[k]) for k in ("rot_6d", "rot_mat")}
    total, metrics = tlosses.hmvae_forward(tm, tb, torch.tensor(step), tc, eps=eps)
    total.backward()
    assert set(metrics) == set(metrics_ref)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(metrics_ref[k]), rtol=0,
                                   atol=_tol(metrics_ref[k]), err_msg=k)
    active = step >= LOSS["iteration_interval"]
    unread = {"encoder.latent_head_1", "encoder.latent_head_2", "decoder.latent_dec_1",
              "decoder.latent_dec_2"}
    gated = set() if active else {"encoder.latent_head_0"}
    for name, ref in _flat_grads(grads_ref).items():
        p = tm.get_parameter(name)
        if name.rsplit(".", 1)[0] in unread:
            # never read by the decoder: no gradient in torch, an all-zero
            # leaf in JAX
            assert p.grad is None and not ref.any(), name
        elif name.rsplit(".", 1)[0] in gated:
            # the curriculum's gate before the boundary: all zeros, as in JAX
            assert p.grad is not None and not p.grad.any() and not ref.any(), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=_tol(ref),
                                       err_msg=name)


@pytest.mark.parametrize("wire", ["rot_mat", "rot_6d", "aa"])
def test_wire_forms_match_jax(pair, wire):
    """One wire field alone: the other representation derives from it."""
    jc, tc, jm, variables, tm, batch = pair
    rng = jax.random.PRNGKey(3)
    fwd = jax.jit(lambda p, b: jlosses.hmvae_forward(jm, {"params": p}, b, rng, 9, jc))
    total_ref, _ = fwd(variables["params"], {wire: jnp.asarray(batch[wire])})
    eps = [torch.from_numpy(e) for e in _jax_eps(jm, variables, batch, rng, jc)]
    with torch.no_grad():
        total, _ = tlosses.hmvae_forward(tm, {wire: torch.from_numpy(batch[wire])},
                                         torch.tensor(9), tc,
                                         eps=eps)
    np.testing.assert_allclose(float(total), float(total_ref), rtol=0, atol=_tol(total_ref))


def test_noise_from_generator_and_no_sampling(pair):
    """Noise drawn from a CPU generator is the same as injecting the same
    draws; with kl_w 0 (or sample=False) the latents are the means."""
    import dataclasses

    _, tc, _, _, tm, batch = pair
    tb = {"rot_mat": torch.from_numpy(batch["rot_mat"])}
    step0 = torch.tensor(0)
    with torch.no_grad():
        _, stats = tm.encode(tlosses.ground_truth(tb)[0])
        eps = tlosses.draw_eps(stats, tc, torch.Generator().manual_seed(4))
        a, _ = tlosses.hmvae_forward(tm, tb, step0, tc, eps=eps)
        b, _ = tlosses.hmvae_forward(tm, tb, step0, tc, generator=torch.Generator().manual_seed(4))
        assert torch.equal(a, b)
        no_kl = dataclasses.replace(tc, loss=dataclasses.replace(tc.loss, kl_w=0.0))
        m1, _ = tlosses.hmvae_forward(tm, tb, step0, no_kl, generator=torch.Generator())
        m2, _ = tlosses.hmvae_forward(tm, tb, step0, tc, sample=False)
        mean = tlosses.hmvae_forward(tm, tb, step0, no_kl, sample=False)[0]
    assert torch.equal(m1, mean) and not torch.equal(m2, a)
