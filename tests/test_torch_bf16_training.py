"""Training at ``compute_dtype: bfloat16`` (the JAX package's bf16 params +
moments + compute mode) on the CPU, through the backward wrappers' plain
versions (the bf16 kernels run only on the GPU: ``chip_smoke.py`` phase 35
trains the same mode through them):

- one training step of a len-8 model at bf16 compute: the loss and every
  leaf's gradient against ``jax.value_and_grad`` of the JAX model on the
  same weights, batch and noise, and a deliberately broken plain dgrad
  (the reflect padding's adjoint left out) falling outside the tolerance;
- 40 steps of the triple (bf16 parameters, moments and compute) against
  the port's own f32 run, by the JAX package's criterion
  (``tests/test_train_step.py``'s ``test_bf16_params_track_f32_training``).

Tolerance of a training step: a leaf's gradient within twice the distance
between JAX's own bf16-compute and f32-compute gradients of that leaf at
the same point, + 1e-4 * max(1, max|ref|) (the f32 rule); the loss within
1e-2 relative (bf16 rounds every level's output).
"""

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
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.train import losses as tlosses
from hm_vae_torch.train.train_step import create_state, train_step
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP_B = 3


def _configs(compute_dtype):
    model = dict(LEN8, compute_dtype=compute_dtype)
    jc = jcfg.Config(model=jcfg.ModelConfig(**model), loss=jcfg.LossConfig(iteration_interval=5))
    tc = tcfg.Config(model=tcfg.ModelConfig(**model), loss=tcfg.LossConfig(iteration_interval=5))
    return jc, tc


@pytest.fixture(scope="module")
def step_case():
    """JAX's loss and gradients at bf16 and at f32 compute on one point
    (weights, batch, noise, step 9: the KL curriculum on), and the port's
    model on the same weights at bf16 compute."""
    jc16, tc16 = _configs("bfloat16")
    jc32, _ = _configs("float32")
    aa = np.random.default_rng(0).normal(size=(STEP_B, 8, 24, 3)).astype(np.float32) * 0.4
    mats = np.asarray(jrot.aa_to_rotmat(jnp.asarray(aa)))
    batch = {"rot_6d": np.asarray(jrot.rotmat_to_rot6d(jnp.asarray(mats))), "rot_mat": mats}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(7)
    out = {}
    for key, jc in (("bf16", jc16), ("f32", jc32)):
        jm = JHMVAE(jc.model)
        if key == "bf16":
            variables = jm.init(jax.random.PRNGKey(1), jb["rot_6d"])

        def loss(params, jm=jm, jc=jc):
            return jlosses.hmvae_forward(jm, {"params": params}, jb, rng, 9, jc)

        (total, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
        out[key] = (float(total), {k: v.numpy() for k, v in params_from_flax(
            jax.tree.map(lambda a: np.asarray(a, np.float32), grads), tc16.model).items()})
        if key == "bf16":
            _, stats = jm.apply(variables, jb["rot_6d"], method=JHMVAE.encode)
            keys = jax.random.split(rng, jc.model.num_layers)
            eps = [torch.from_numpy(np.array(jax.random.normal(
                keys[i], jsplit(st, jc.model, i)[0].shape))) for i, st in enumerate(stats)]
    params = params_from_flax(jax.tree.map(np.asarray, variables["params"]), tc16.model)
    return tc16, params, batch, eps, out


def _port_step(tc, params, batch, eps):
    tm = HMVAE(tc.model)
    tm.load_state_dict(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, _ = tlosses.hmvae_forward(tm, tb, torch.tensor(9), tc, eps=eps)
    total.backward()
    return float(total), {n: p.grad for n, p in tm.named_parameters()}


def _leaf_errors(grads, out):
    """Per leaf read by the step: (|port - jax bf16|, its tolerance)."""
    errs = {}
    for name, ref in out["bf16"][1].items():
        g = grads[name]
        if g is None:  # a head the decoder never reads: JAX's gradient is zero
            assert not ref.any(), name
            continue
        ref32 = out["f32"][1][name]
        tol = 2 * float(np.abs(ref - ref32).max()) + 1e-4 * max(1.0, float(np.abs(ref).max()))
        errs[name] = (float(np.abs(g.float().numpy() - ref).max()), tol)
    return errs


def test_bf16_training_step_matches_jax(step_case):
    tc, params, batch, eps, out = step_case
    total, grads = _port_step(tc, params, batch, eps)
    assert abs(total / out["bf16"][0] - 1) < 1e-2, (total, out["bf16"][0])
    # every conv's gradient came through the bf16 backward: the folded
    # weights are bf16, the raw parameters f32
    assert all(g is None or g.dtype == torch.float32 for g in grads.values())
    errs = _leaf_errors(grads, out)
    assert len(errs) > 10
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    assert not bad, bad


def test_a_broken_bf16_dgrad_falls_outside_the_step_tolerance(step_case, monkeypatch):
    """The tolerance is tight enough to see a fault: a plain dgrad that
    leaves out the reflect padding's adjoint moves some leaf's gradient
    beyond it."""
    tc, params, batch, eps, out = step_case
    reference = fcp.fused_conv_pool_dgrad_reference

    def without_reflect_edges(gy, y, weight, T_in, stride, padding, padding_mode="reflect",
                              negative_slope=0.2):
        return reference(gy, y, weight, T_in, stride, padding, "constant", negative_slope)

    monkeypatch.setattr(fcp, "fused_conv_pool_dgrad_reference", without_reflect_edges)
    _, grads = _port_step(tc, params, batch, eps)
    errs = _leaf_errors(grads, out)
    assert any(e > tol for e, tol in errs.values())


def _run(compute_dtype, param_dtype, steps=40):
    """`steps` training steps of the len-8 model at lr 1e-3 on one fixed
    batch (fresh noise each step), as the JAX package's criterion runs
    them; the losses and the final state."""
    cfg = tcfg.Config(model=tcfg.ModelConfig(**LEN8, compute_dtype=compute_dtype),
                      loss=tcfg.LossConfig(iteration_interval=5),
                      optim=tcfg.OptimConfig(lr=1e-3, batch_size=4, param_dtype=param_dtype,
                                             moment_dtype=param_dtype))
    state = create_state(cfg, "cpu")
    aa = np.random.default_rng(1).normal(size=(4, 8, 24, 3)).astype(np.float32) * 0.3
    batch = {"aa": torch.from_numpy(aa)}
    losses = [float(train_step(state, batch, cfg, generator=torch.Generator().manual_seed(100 + i))
                    ["loss_total"]) for i in range(steps)]
    return np.asarray(losses), state


def test_triple_tracks_f32_training():
    """bf16 parameters, moments and conv compute follow the f32 run's loss:
    the JAX package's criterion for its MAX-PERF triple."""
    f32, _ = _run("float32", "float32")
    bf16, state = _run("bfloat16", "bfloat16")
    assert all(p.dtype == BF16 for p in state.model.parameters())
    assert np.isfinite(bf16).all() and np.isfinite(f32).all()
    assert bf16[-1] < f32[0] * 0.9 and bf16[-1] < bf16[0] * 0.9
    assert abs(bf16[-10:].mean() - f32[-10:].mean()) < 0.15 * f32[-10:].mean()
