"""Training a VAE with adapters (``model.lora_rank > 0``) in the port's
Trainer against the JAX package's ``make_train_step`` on the CPU, at len-8
size:

- three ``Trainer.fit`` steps of a model with ``lora_rank`` 2 from the JAX
  ``HMVAE(lora_rank=2)``'s weights (``lora_a`` drawn nonzero from numpy in
  both, so that every adapter has a gradient), on the same batches, no
  noise (``kl_w`` 0): the first step's gradients at every leaf, adapters
  included, within 1e-4 * max(1, max|ref|) (tests/test_torch_losses.py's
  tolerance: the last decoder level's weight gradient differs by ~4e-5 of
  its scale with or without adapters, random weights amplifying f32 order);
  the first step's loss within 1e-5 relative of JAX's, and every step's
  within the band of tests/test_torch_train.py's trajectory test: 10x the
  spread of a port run from the weights scaled by 1 + 1e-7, + 1e-5 (Adam
  turns last-place differences into +-lr updates; a 1e-7 perturbation moves
  the third loss by ~1e-4 here); every adapter moves;
- the checkpoint keeps the adapters under the port's names
  (``decoder.conv_*.lora_a`` / ``lora_b``) beside the reference names; a
  resume restores them and their moments bit for bit; JAX's
  ``import_hmvae_params`` reads the reference names and leaves the adapters
  out.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from scipy.spatial.transform import Rotation as R

from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.train import losses as jlosses
from hm_vae_tpu.train import train_step as jts
from hm_vae_tpu.utils import config as jcfg
from hm_vae_tpu.utils.torch_import import import_hmvae_params, load_reference_checkpoint
from hm_vae_torch.train.losses import hmvae_forward
from hm_vae_torch.train.trainer import Trainer
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8, lora_rank=2)
B, STEPS = 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(ref, scale=1e-4):
    return scale * max(1.0, float(np.abs(ref).max()))


def _cfg(mod, tmp=None):
    kw = dict(model=mod.ModelConfig(**LEN8),
              loss=mod.LossConfig(kl_w=0.0, iteration_interval=2),
              optim=mod.OptimConfig(lr=1e-3, batch_size=B, max_iter=STEPS))
    if tmp is not None:
        kw.update(data=mod.DataConfig(data_root=os.path.join(tmp, "data"), synthetic=True,
                                      synthetic_num_seqs=6),
                  run=mod.RunConfig(log_iter=1, validation_iter=10 ** 9,
                                    snapshot_save_iter=10 ** 9, image_save_iter=10 ** 9))
    return mod.Config(**kw)


def _batches():
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        rm = R.from_rotvec(rng.normal(scale=0.4, size=(B * 8 * 24, 3))).as_matrix().astype(
            np.float32).reshape(B, 8, 24, 3, 3)
        out.append({"rot_6d": np.concatenate((rm[..., :, 0], rm[..., :, 1]), axis=-1),
                    "rot_mat": rm})
    return out


class _Fixed:
    def __init__(self, batches):
        self.batches = batches

    def iter_batches(self, batch_size):
        return itertools.cycle(self.batches)


def _jax_init():
    """The JAX state with every ``lora_a`` drawn nonzero (numpy)."""
    jc = _cfg(jcfg)
    jm = JHMVAE(jc.model)
    state = jts.create_state(jm, jc, jax.random.PRNGKey(0))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, state.params))
    rng = np.random.default_rng(7)
    n = 0
    for k, v in flat.items():
        if k[-1] == "lora_a":
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
            n += 1
    assert n == 4  # one adapter a decoder conv
    params = jax.tree.map(jnp.asarray, traverse_util.unflatten_dict(flat))
    return jm, jc, jts.TrainState(params=params, opt_state=state.opt_state, step=state.step)


def test_lora_trainer_steps_match_jax(tmp_path):
    jm, jc, state = _jax_init()
    batches = _batches()
    init = params_from_flax(jax.tree.map(np.asarray, state.params), jc.model)
    assert sum(k.endswith((".lora_a", ".lora_b")) for k in init) == 8
    # the first step's gradients, at the init
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (_, _), jg = jax.value_and_grad(
        lambda p: jlosses.hmvae_forward(jm, p, b0, jax.random.PRNGKey(0), state.step, jc),
        has_aux=True)(state.params)
    jg = params_from_flax(jax.tree.map(np.asarray, jg), jc.model)
    step = jax.jit(jts.make_train_step(jm, jc))
    ref = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        ref.append(float(m["loss_total"]))

    tc = _cfg(tcfg, str(tmp_path))

    def port(scale):
        trainer = Trainer(tc, str(tmp_path / f"run{scale}"), device="cpu")
        trainer.state.model.load_state_dict({k: v * scale for k, v in init.items()})
        losses = []
        trainer.fit(_Fixed(batches), max_iter=STEPS,
                    log_cb=lambda s, m: losses.append(m["loss_total"]))
        assert len(losses) == STEPS and trainer.state.step == STEPS
        return trainer.state.model, np.array(losses)

    model = Trainer(tc, str(tmp_path / "grads"), device="cpu").state.model
    model.load_state_dict(init)
    loss, _ = hmvae_forward(model, {k: torch.from_numpy(v) for k, v in batches[0].items()},
                            torch.zeros((), dtype=torch.int64), tc)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert sum(n.endswith(("lora_a", "lora_b")) for n in grads) == 8
    for n, g in grads.items():
        want = jg[n].numpy()
        np.testing.assert_allclose(g.numpy(), want, atol=_tol(want), rtol=0, err_msg=n)
    (model, ours), (_, perturbed) = port(1.0), port(1.0 + 1e-7)
    ref = np.array(ref)
    err = np.abs(ours / ref - 1)
    band = 10 * np.maximum.accumulate(np.abs(perturbed / ours - 1)) + 1e-5
    assert err[0] <= 1e-5 and (err <= band).all(), (err, band)
    moved = [n for n, p in model.named_parameters()
             if n.endswith(("lora_a", "lora_b")) and not torch.equal(p.detach(), init[n])]
    assert len(moved) == 8


def test_lora_checkpoint_names_resume_and_jax_import(tmp_path):
    tc = _cfg(tcfg, str(tmp_path))
    trainer = Trainer(tc, str(tmp_path / "run"), device="cpu")
    trainer.fit(_Fixed(_batches()), max_iter=STEPS)
    path = trainer.save()
    sd = torch.load(path, weights_only=True)["state_dict"]
    adapters = sorted(k for k in sd if k.endswith(("lora_a", "lora_b")))
    assert adapters == sorted(f"decoder.conv_{i}.lora_{s}" for i in range(4) for s in "ab")
    own = trainer.state.model.state_dict()
    for k in adapters:
        assert torch.equal(sd[k], own[k]), k
    assert "dec.layers.0.1.weight" in sd  # beside the reference names
    again = Trainer(tc, str(tmp_path / "run"), device="cpu")
    assert again.resume() == STEPS
    for k, v in again.state.model.state_dict().items():
        assert torch.equal(v, own[k]), k
    opt, opt2 = trainer.state.optimizer, again.state.optimizer
    for (n, p), (_, q) in zip(trainer.state.model.named_parameters(),
                              again.state.model.named_parameters()):
        for k, t in opt.state[p].items():
            assert torch.equal(t, opt2.state[q][k]), (n, k)
    # JAX's reference-name reader: the adapters are not read
    tree = import_hmvae_params(load_reference_checkpoint(path), jcfg.ModelConfig(**LEN8))
    flat = traverse_util.flatten_dict(tree["params"])
    assert not any(k[-1].startswith("lora") for k in flat)
    back = params_from_flax(tree, tc.model)
    for k, v in back.items():
        assert torch.equal(v, own[k]), k
    assert set(own) - set(back) == set(adapters)
