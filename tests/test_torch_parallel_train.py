"""Data-parallel training over two gloo ranks on the CPU, against the JAX
package's single-device step (GSPMD's result does not depend on the number
of devices, so neither may the port's):

- the len-8 VAE: three ``train_step`` calls, and one three-step
  ``MultiStep`` call (``graph=False``, as under gloo), each rank on its half
  of the same global batches and of the global noise that JAX's
  ``make_train_step`` draws from its keys, from the JAX init; the
  parameters within JAX's own data-parallel tolerance
  (``tests/test_sharding.py``: atol 1e-5) of JAX's three single-device
  steps, and the two ranks' parameters bit-equal;
- the small trajectory model likewise, against JAX's ``trajectory_losses``
  + its optimizer on one device;
- ``Trainer.fit`` under two ranks and a resume: only rank 0 writes
  checkpoints and the metric log, both ranks log the same (all-reduced)
  metrics and hold the same parameters, and a resume on both ranks
  restores them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from hm_vae_tpu.models import trajectory as jtr
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.train import losses as jlosses
from hm_vae_tpu.train import train_step as jts
from hm_vae_tpu.train.optim import make_optimizer as jmake_optimizer
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.ops import fk as fk_mod
from hm_vae_torch.train.losses import eps_shapes
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax, trajectory_params_from_flax

import torch_ranks

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
SMALL_TRAJ = dict(model_name="TrajectoryModel", latent_d=12, kernel_size=3, train_seq_len=8,
                  trajectory_input_joint_pos=True)
B, K = 4, 3
ATOL = 1e-5  # tests/test_sharding.py: GSPMD's data-parallel step vs one device


def _rotmats(shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return R.from_rotvec(rng.normal(scale=0.4, size=(n * 24, 3))).as_matrix().astype(
        np.float32).reshape(tuple(shape) + (24, 3, 3))


def _vae_cfgs():
    kw = dict(loss={"iteration_interval": 1}, optim={"lr": 1e-3, "batch_size": B})
    return tuple(mod.Config(model=mod.ModelConfig(**LEN8),
                            loss=mod.LossConfig(**kw["loss"]),
                            optim=mod.OptimConfig(**kw["optim"]))
                 for mod in (jcfg, tcfg))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The one-process reference runs here, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(ref, scale=1e-5):
    return scale * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("multi", [False, True], ids=["train_step", "multistep"])
def test_vae_steps_on_two_ranks_match_jax_single_device(tmp_path, multi):
    """JAX's three steps on one device from its init; the port's from the
    same weights on two ranks (each its half of the batches and of JAX's
    noise) and in one process.  Adam turns a last-place difference in a
    near-zero gradient into a +-lr update, so the port's parameters are
    held to JAX's data-parallel tolerance against the port's one-process
    run (the same arithmetic, another summation order), and to JAX through
    the first step's gradient (averaged over the ranks, at the same
    weights: 1e-5 * max(1, max|ref|), as tests/test_torch_losses.py) and
    the last step's loss (rtol 1e-4, as tests/test_sharding.py)."""
    jc, tc = _vae_cfgs()
    jm = JHMVAE(jc.model)
    state = jts.create_state(jm, jc, jax.random.PRNGKey(0))
    init = {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, state.params), tc.model).items()}
    rm = _rotmats((K, B, 8), 1)
    six = np.concatenate((rm[..., :, 0], rm[..., :, 1]), axis=-1)
    batches = {"rot_6d": six, "rot_mat": rm}
    step = jax.jit(jts.make_train_step(jm, jc))
    grad = jax.jit(jax.value_and_grad(
        lambda p, b, r, t: jlosses.hmvae_forward(jm, p, b, r, t, jc), has_aux=True))
    shapes = eps_shapes(tc, B)
    eps = [np.zeros((K,) + s, np.float32) for s in shapes]
    for k in range(K):
        rng = jax.random.PRNGKey(100 + k)
        # the noise JAX's hmvae_forward draws from rng, level by level
        for i, key in enumerate(jax.random.split(rng, tc.model.num_layers)):
            eps[i][k] = np.asarray(jax.random.normal(key, shapes[i]))
        jb = {f: jnp.asarray(v[k]) for f, v in batches.items()}
        (_, jmet), g = grad(state.params, jb, rng, state.step)
        if k == 0:
            jgrads = params_from_flax(jax.tree.map(np.asarray, g), tc.model)
        state, _ = step(state, jb, rng)

    one = torch_ranks.train_steps(0, 1, tc, init, batches, eps, None, multi)
    (p0, g0, m0), (p1, g1, m1) = torch_ranks.run_ranks(
        torch_ranks.train_steps, 2, tmp_path, tc, init, batches, eps, None, multi)
    assert p0.keys() == p1.keys() == one[0].keys() and m0 == m1
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)  # both ranks, same bits
        np.testing.assert_allclose(p0[name], one[0][name], atol=ATOL, rtol=0, err_msg=name)
    assert g0.keys() == one[1].keys()
    for name, g in g0.items():
        np.testing.assert_array_equal(g, g1[name], err_msg=name)
        if not multi:
            ref = jgrads[name].numpy()
            np.testing.assert_allclose(g, ref, atol=_tol(ref), rtol=0, err_msg=name)
    for k, v in m0.items():
        np.testing.assert_allclose(v, float(jmet[k]), rtol=1e-4, atol=0, err_msg=k)
    moved = [n for n in p0 if not np.array_equal(init[n], p0[n])]
    assert len(moved) > len(p0) // 2


def _mean_std(seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(scale=0.1, size=579),
                     rng.uniform(0.5, 1.5, size=579)]).astype(np.float32)


def test_trajectory_steps_on_two_ranks_match_jax_single_device(tmp_path):
    """As the VAE's: JAX's trajectory_losses and optimizer on one device,
    three steps; the port on two ranks against its one-process run (atol
    1e-5) and against JAX's first-step gradient and last loss."""
    loss = dict(rec_root_v_w=1.0, rec_root_trans_w=0.5)
    jc = jcfg.Config(model=jcfg.ModelConfig(**SMALL_TRAJ), loss=jcfg.LossConfig(**loss),
                     optim=jcfg.OptimConfig(lr=1e-3, batch_size=B))
    tc = tcfg.Config(model=tcfg.ModelConfig(**SMALL_TRAJ), loss=tcfg.LossConfig(**loss),
                     optim=tcfg.OptimConfig(lr=1e-3, batch_size=B))
    jm = jtr.TrajectoryModel(jc.model)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 24, 3)))
    init = {k: v.numpy() for k, v in trajectory_params_from_flax(
        jax.tree.map(np.asarray, params), tc.model).items()}
    ms = _mean_std(2)
    rng = np.random.default_rng(3)
    rm = _rotmats((K, B, 8), 4)
    pose = fk_mod.fk_numpy(rm)
    batches = {"rot_mat": rm, "rot_pos": pose, "joint_pos": (pose * 1.3 - 0.1).astype(np.float32),
               "root_v": rng.normal(scale=0.3, size=(K, B, 8, 3)).astype(np.float32)}
    tx = jmake_optimizer(jc.optim)
    opt = tx.init(params)
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.trajectory_losses(jm, p, b, jc, ms), has_aux=True))
    for k in range(K):
        (_, jmet), g = grad(params, {f: jnp.asarray(v[k]) for f, v in batches.items()})
        if k == 0:
            jgrads = trajectory_params_from_flax(jax.tree.map(np.asarray, g), tc.model)
        updates, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, updates)

    one = torch_ranks.train_steps(0, 1, tc, init, batches, None, ms, False)
    (p0, g0, m0), (p1, g1, m1) = torch_ranks.run_ranks(torch_ranks.train_steps, 2, tmp_path,
                                                       tc, init, batches, None, ms, False)
    assert p0.keys() == jgrads.keys() and m0 == m1
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)
        np.testing.assert_array_equal(g0[name], g1[name], err_msg=name)
        np.testing.assert_allclose(p0[name], one[0][name], atol=ATOL, rtol=0, err_msg=name)
        ref = jgrads[name].numpy()
        np.testing.assert_allclose(g0[name], ref, atol=_tol(ref), rtol=0, err_msg=name)
        assert not np.array_equal(p0[name], init[name]), name
    for k, v in m0.items():
        np.testing.assert_allclose(v, float(jmet[k]), rtol=1e-4, atol=0, err_msg=k)


def test_trainer_fit_and_resume_on_two_ranks_write_once(tmp_path):
    tmp = str(tmp_path)
    cfg = tcfg.Config(
        model=tcfg.ModelConfig(**LEN8),
        loss=tcfg.LossConfig(iteration_interval=4),
        optim=tcfg.OptimConfig(lr=1e-3, batch_size=B, max_iter=6),
        data=tcfg.DataConfig(data_root=os.path.join(tmp, "data"), synthetic=True,
                             synthetic_num_seqs=6),
        run=tcfg.RunConfig(log_iter=2, validation_iter=4, snapshot_save_iter=3))
    out = os.path.join(tmp, "run")
    (w0, log0, fin0, step0, trained0, resumed0), (w1, log1, fin1, step1, trained1, resumed1) = \
        torch_ranks.run_ranks(torch_ranks.fit_resume, 2, tmp_path, cfg, out, 5)
    assert w1 == []  # rank 1 writes no checkpoint and no metric
    assert [w for w in w0 if w.endswith(".pt")] == ["gen_00000003.pt", "gen_00000005.pt"]
    assert [w for w in w0 if w.startswith("metrics@")] == ["metrics@2", "metrics@4",
                                                          "metrics@4"]  # train, then val
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "gen_00000003.pt", "gen_00000005.pt"]
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 3
    assert [s for s, _ in log0] == [2, 4] and log0 == log1 and fin0 == fin1
    assert step0 == step1 == 5
    for name in trained0:
        np.testing.assert_array_equal(trained0[name], trained1[name], err_msg=name)
        np.testing.assert_array_equal(resumed0[name], trained0[name], err_msg=name)
        np.testing.assert_array_equal(resumed1[name], trained0[name], err_msg=name)
