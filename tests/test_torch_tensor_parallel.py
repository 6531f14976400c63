"""Tensor parallelism over a ``model`` axis (``run.model_parallel``) under
gloo ranks on the CPU, against the JAX package's single-device step and its
GSPMD step on a (data, model) mesh, at len-8 size:

- two ranks at model_parallel 2 (data 1), three ``train_step`` calls of the
  VAE from the JAX init on the same global batches and on the noise JAX's
  ``hmvae_forward`` draws from its keys: the first step's gradients (the
  sharded heads' gathered) within 1e-5 * max(1, max|ref|) of JAX's
  single-device ``make_train_step`` at the same weights, every step's loss
  within 1e-4 relative (tests/test_sharding.py); the two ranks' parameters
  the same bits, and the same bits as the port's one-process step, after
  the first step and after three, gradients too (the forward's gather is
  exact, and a head's input gradient is the full product through its
  exactly gathered weight: partial sums would differ in the last place,
  which Adam's first step shows where a gradient is near its eps);
- the same bits under ``param_dtype: bfloat16``: the heads hashed at their
  global positions, so that the stochastically rounded steps are the
  one-process steps' bits;
- four ranks, data 2 x model 2: against JAX's ``make_sharded_train_step``
  at ``make_mesh(4, model_parallel=2)``, every step's loss within 1e-4
  relative, and the parameters the same bits as two data-parallel ranks'
  (model_parallel 1);
- ``Trainer.fit``, a checkpoint and a resume at model_parallel 2 (rank 0
  writes; the checkpoint holds full tensors), resumed in one process at
  model_parallel 1, trained on at 2 from a one-process checkpoint: every
  resume the same bits, and the step after it the one-process step's bits
  (moments included); ``make_groups`` raises where model_parallel does not divide
  the world.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.parallel import sharding as jsh
from hm_vae_tpu.train import losses as jlosses
from hm_vae_tpu.train import train_step as jts
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.data.dataset import make_loaders
from hm_vae_torch.parallel.sharding import make_groups, shard_dim
from hm_vae_torch.train.losses import eps_shapes
from hm_vae_torch.train.trainer import Trainer
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

import torch_ranks

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
B, K = 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(ref, scale=1e-5):
    return scale * max(1.0, float(np.abs(ref).max()))


def _cfgs(param_dtype="float32"):
    kw = dict(loss={"iteration_interval": 1},
              optim={"lr": 1e-3, "batch_size": B, "param_dtype": param_dtype})
    return tuple(mod.Config(model=mod.ModelConfig(**LEN8), loss=mod.LossConfig(**kw["loss"]),
                            optim=mod.OptimConfig(**kw["optim"]))
                 for mod in (jcfg, tcfg))


def _inputs(tc):
    rng = np.random.default_rng(1)
    rm = R.from_rotvec(rng.normal(scale=0.4, size=(K * B * 8 * 24, 3))).as_matrix().astype(
        np.float32).reshape(K, B, 8, 24, 3, 3)
    batches = {"rot_6d": np.concatenate((rm[..., :, 0], rm[..., :, 1]), axis=-1),
               "rot_mat": rm}
    shapes = eps_shapes(tc, B)
    eps = [np.zeros((K,) + s, np.float32) for s in shapes]
    for k in range(K):  # the noise JAX's hmvae_forward draws from PRNGKey(100 + k)
        for i, key in enumerate(jax.random.split(jax.random.PRNGKey(100 + k),
                                                 tc.model.num_layers)):
            eps[i][k] = np.asarray(jax.random.normal(key, shapes[i]))
    return batches, eps


def _init(jm, jc, state=None):
    state = state or jts.create_state(jm, jc, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), state.params)
    return state, {k: v.numpy() for k, v in params_from_flax(params, tcfg.ModelConfig(**LEN8))
                   .items()}


def test_shard_rule_and_groups():
    assert shard_dim("encoder.latent_head_0.weight", (12, 40), 2) == 0
    assert shard_dim("decoder.latent_dec_3.bias", (384,), 4) == 0
    assert shard_dim("decoder.latent_dec_3.bias", (6,), 4) is None  # does not divide
    assert shard_dim("encoder.conv_0.weight", (96, 144, 3), 2) is None
    assert shard_dim("encoder.latent_head_0.weight", (12, 40), 1) is None
    g = make_groups(1)
    assert (g.data, g.model, g.data_count, g.model_count) == (None, None, 1, 1)
    with pytest.raises(ValueError, match="model_parallel=2 does not divide the 1 ranks"):
        make_groups(2)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_two_model_ranks_match_jax_and_one_process(tmp_path, param_dtype):
    jc, tc = _cfgs(param_dtype)
    jm = JHMVAE(jc.model)
    state, init = _init(jm, jc)
    batches, eps = _inputs(tc)
    one = torch_ranks.tp_train_steps(0, 1, tc, init, batches, eps, 1)
    r0, r1 = torch_ranks.run_ranks(torch_ranks.tp_train_steps, 2, tmp_path, tc, init, batches,
                                   eps, 2)
    assert r0[4] == (0, 0, 16) and r1[4] == (0, 1, 16)  # every head shards at len 8
    sharded = [n for n in init if n.split(".")[1].startswith("latent_")]
    for i in (0, 1, 2):  # first params, last params, first grads: both ranks the same bits
        assert r0[i].keys() == r1[i].keys()
        for n in r0[i]:
            np.testing.assert_array_equal(r0[i][n], r1[i][n], err_msg=n)
    assert r0[3] == r1[3] == one[3]
    for i in (0, 1, 2):  # and the one-process step's
        assert r0[i].keys() == one[i].keys()
        for n in r0[i]:
            np.testing.assert_array_equal(r0[i][n], one[i][n], err_msg=n)
    moved = [n for n in sharded if not np.array_equal(r0[0][n], init[n])]
    assert len(moved) >= 4
    if param_dtype == "bfloat16":
        return
    # JAX's single-device step on the same weights, batches and noise
    step = jax.jit(jts.make_train_step(jm, jc))
    grad = jax.jit(jax.value_and_grad(
        lambda p, b, r, t: jlosses.hmvae_forward(jm, p, b, r, t, jc), has_aux=True))
    losses = []
    for k in range(K):
        jb = {f: jnp.asarray(v[k]) for f, v in batches.items()}
        rng = jax.random.PRNGKey(100 + k)
        if k == 0:
            _, g = grad(state.params, jb, rng, state.step)
            jgrads = params_from_flax(jax.tree.map(np.asarray, g), tc.model)
        state, m = step(state, jb, rng)
        losses.append(float(m["loss_total"]))
    assert r0[2].keys() <= jgrads.keys()
    for n, g in r0[2].items():
        ref = jgrads[n].numpy()
        np.testing.assert_allclose(g, ref, atol=_tol(ref), rtol=0, err_msg=n)
    np.testing.assert_allclose(r0[3], losses, rtol=1e-4, atol=0)


def test_data2_model2_ranks_match_jax_sharded_step(tmp_path):
    jc, tc = _cfgs()
    jm = JHMVAE(jc.model)
    mesh = jsh.make_mesh(4, model_parallel=2)
    jstate, shardings = jsh.create_sharded_state(jm, jc, jax.random.PRNGKey(0), mesh)
    assert jstate.params["params"]["encoder"]["latent_head_0"]["kernel"].sharding.spec == \
        jax.sharding.PartitionSpec(None, "model")
    _, init = _init(jm, jc, jstate)
    batches, eps = _inputs(tc)
    step = jsh.make_sharded_train_step(jm, jc, mesh, shardings)
    losses = []
    for k in range(K):
        jb = jsh.device_put_batch({f: v[k] for f, v in batches.items()}, mesh)
        jstate, m = step(jstate, jb, jax.random.PRNGKey(100 + k))
        losses.append(float(m["loss_total"]))
    ranks = torch_ranks.run_ranks(torch_ranks.tp_train_steps, 4, tmp_path, tc, init, batches,
                                  eps, 2)
    assert [r[4][:2] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks[1:]:
        assert r[3] == ranks[0][3]
        for n in r[1]:
            np.testing.assert_array_equal(r[1][n], ranks[0][1][n], err_msg=n)
    np.testing.assert_allclose(ranks[0][3], losses, rtol=1e-4, atol=0)
    # the model axis adds nothing to the data axis's arithmetic: the same
    # bits as two data-parallel ranks (whose tolerance against one process
    # is tests/test_torch_parallel_train.py's)
    dp = torch_ranks.run_ranks(torch_ranks.tp_train_steps, 2, tmp_path, tc, init, batches,
                               eps, 1)[0]
    assert dp[3] == ranks[0][3]
    for n, v in ranks[0][1].items():
        np.testing.assert_array_equal(v, dp[1][n], err_msg=n)


def _trainer_cfg(tmp, mp):
    return tcfg.Config(
        model=tcfg.ModelConfig(**LEN8),
        loss=tcfg.LossConfig(iteration_interval=2),
        optim=tcfg.OptimConfig(lr=1e-3, batch_size=B),
        data=tcfg.DataConfig(data_root=os.path.join(tmp, "data"), synthetic=True,
                             synthetic_num_seqs=6),
        run=tcfg.RunConfig(log_iter=2, validation_iter=3, snapshot_save_iter=10 ** 9,
                           image_save_iter=10 ** 9, model_parallel=mp))


def test_trainer_resumes_across_model_parallel(tmp_path):
    tmp = str(tmp_path)
    out = os.path.join(tmp, "run")
    cfg2 = _trainer_cfg(tmp, 2)
    a0, a1 = torch_ranks.run_ranks(torch_ranks.tp_fit_resume, 2, tmp_path, cfg2, out, 4)
    assert a0[0] == ["gen_00000004.pt"] and a1[0] == []  # rank 0 writes
    assert a0[1:3] == a1[1:3] == (0, 4)
    for n in a0[3]:
        np.testing.assert_array_equal(a0[3][n], a1[3][n], err_msg=n)
        np.testing.assert_array_equal(a0[4][n], a0[3][n], err_msg=n)  # resumed at 2
    # the full checkpoint resumes in one process at model_parallel 1 ...
    one = Trainer(_trainer_cfg(tmp, 1), out, device="cpu")
    assert one.resume() == 4
    for n, p in one.state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), a0[3][n], err_msg=n)
    one.save(5)  # ... and a one-process checkpoint resumes at model_parallel 2
    b0, b1 = torch_ranks.run_ranks(torch_ranks.tp_fit_resume, 2, tmp_path, cfg2, out, 6)
    assert b0[1:3] == b1[1:3] == (5, 6)
    for n in b0[3]:
        np.testing.assert_array_equal(b0[4][n], b0[3][n], err_msg=n)
    # the step from 5 to 6 in one process, from the same checkpoint and the
    # same sampler stream (data index 0 in both): the same bits as at 2
    assert one.resume(os.path.join(out, "checkpoints", "gen_00000005.pt")) == 5
    before = {n: p.detach().clone() for n, p in one.state.model.named_parameters()}
    one.fit(make_loaders(one.cfg)[0], max_iter=6)
    for n, p in one.state.model.named_parameters():
        assert not torch.equal(p.detach(), before[n]) or n.split(".")[1].startswith("latent_"), n
        np.testing.assert_array_equal(p.detach().numpy(), b0[3][n], err_msg=n)
