"""The port's root-trajectory model (``hm_vae_torch.models.trajectory``) and
everything that runs it, on the CPU, against the JAX package's, from the same
weights (``trajectory_params_from_flax``) and numpy inputs:

- the structure at full width (``configs/trajectory_model.yaml``): masks,
  pool matrices, channel bases, exactly;
- the forward at full width (K 31) at T 32 and 37, and at a small width:
  1e-5 * max(1, max|ref|) (f32 sums in another order, and the pool folded
  into the conv's weight);
- the trajectory accumulation and world placement: 1e-6;
- ``trajectory_losses``, its value (1e-5 relative) and its leaf gradients
  (1e-4 * max(1, max|ref|)), against ``jax.value_and_grad``, with
  ``joint_pos`` in the batch and derived by FK under a zero std;
- the plain backward of each full-width level at K 31, T 128 and 64 (the
  training and solver lengths), against ``jax.vjp`` of the JAX level (conv,
  pool, LeakyReLU): the input gradient, and the folded weight's gradient
  taken back to the raw weight and bias: 1e-4 * max(1, max|ref|);
- the reference-name bridge both ways, and the Trainer's checkpoint read by
  ``import_trajectory_params``;
- 20 ``Trainer`` steps against the JAX Trainer from the same init and
  batches, inside the band of ``test_torch_train.py``;
- ``TrajectoryRunner`` on 6D and on positions: 1e-5 * max(1, max|ref|);
- a solve with the keyframe trajectory loss, per-window and shared clones,
  against ``make_latent_optimizer(..., trajectory=..., key_frames=...)``, and
  ``interpolate_single_window`` with ``root_trans``: the tolerances of
  ``test_torch_latent_opt.py`` / ``test_torch_tasks.py``;
- ``eval_trajectory`` and ``eval_recovery
  --try_interpolation_w_trajectory_single_window`` on the CPU;
- ``TrajectoryRunner`` and a loaded CPU bundle's ``trajectory`` at batch 2,
  T 4,000 (past the forward kernel's former row limit): 1e-5 * max(1,
  max|ref|); both models at ``lora_rank=4`` (ignored, as in JAX); the
  forward launch's staging plan at long rows.
"""

import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation as R

import hm_vae_tpu.apps.tasks as jtasks
import hm_vae_torch.apps.tasks as ttasks
from hm_vae_tpu.apps import latent_opt as jlo
from hm_vae_tpu.apps.tasks import _targets_from_rotmat_np as jtargets
from hm_vae_tpu.models import trajectory as jtr
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.models.structure import get_trajectory_structure as jstructure
from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_tpu.train.trainer import Trainer as JTrainer
from hm_vae_tpu.utils import config as jcfg
from hm_vae_tpu.utils.torch_import import import_trajectory_params, load_reference_checkpoint
from hm_vae_torch.apps import latent_opt as tlo
from hm_vae_torch.cli import eval_recovery, eval_trajectory
from hm_vae_torch.cli import train as train_cli
from hm_vae_torch.data.dataset import make_loaders
from hm_vae_torch.models import trajectory as ttr
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure, get_trajectory_structure
from hm_vae_torch.ops import fused_conv_pool as fcp
from hm_vae_torch.train.trainer import Trainer
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import (params_from_flax, trajectory_params_from_flax,
                                        trajectory_reference_state_dict,
                                        trajectory_state_dict_from_reference)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = os.path.join(ROOT, "configs", "trajectory_model.yaml")
SMALL = dict(model_name="TrajectoryModel", latent_d=12, kernel_size=3, train_seq_len=8,
             trajectory_input_joint_pos=True)
LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(ref, scale=1e-5):
    return scale * max(1.0, float(np.abs(np.asarray(ref)).max()))


_MODELS = {}


def _models(kind):
    """(JAX model, its params, the port model on the same weights, the two
    ModelConfigs) at full width ("full") or small width ("small")."""
    if kind not in _MODELS:
        if kind == "full":
            jc, tc = jcfg.load_config(FULL).model, tcfg.load_config(FULL).model
        else:
            jc, tc = jcfg.ModelConfig(**SMALL), tcfg.ModelConfig(**SMALL)
        jm = jtr.TrajectoryModel(jc)
        params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 16 if kind == "full" else 8, 24, 3)))
        tm = ttr.TrajectoryModel(tc)
        tm.load_state_dict(trajectory_params_from_flax(jax.tree.map(np.asarray, params), tc),
                           strict=False)
        _MODELS[kind] = (jm, params, tm, jc, tc)
    return _MODELS[kind]


def _mean_std(seed=0, zero_coord_std=False):
    rng = np.random.default_rng(seed)
    ms = np.stack([rng.normal(scale=0.1, size=579),
                   rng.uniform(0.5, 1.5, size=579)]).astype(np.float32)
    if zero_coord_std:
        ms[1, 360:363] = 0.0  # the root joint's position: zero spread
    return ms


def _rotmats(shape, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return R.from_rotvec(rng.normal(scale=scale, size=(n * 24, 3))).as_matrix().astype(
        np.float32).reshape(tuple(shape) + (24, 3, 3))


# ---------------------------------------------------------------------------
# structure and forward


def test_structure_matches_jax_at_full_width():
    j = jstructure(jcfg.load_config(FULL).model)
    t = get_trajectory_structure(tcfg.load_config(FULL).model)
    assert t.channel_base == j.channel_base == [3, 6, 12, 24, 48]
    assert t.d_model == j.d_model and t.out_edges == j.out_edges == 7
    assert len(t.levels) == len(j.levels) == 4
    for a, b in zip(t.levels, j.levels):
        for f in ("in_channels", "out_channels", "kernel_size", "stride", "padding",
                  "padding_mode", "bias", "n_edges"):
            assert getattr(a.conv, f) == getattr(b.conv, f), f
        assert np.array_equal(a.conv.mask, b.conv.mask)
        assert np.array_equal(a.conv.block_bounds, b.conv.block_bounds)
        assert np.array_equal(a.pool_matrix, b.pool_matrix)
        assert a.pooled_edges == b.pooled_edges
    # the level shapes the kernels take: C_in 72, 84, 108, 168 -> pooled rows
    assert [(lv.conv.in_channels, lv.pool_matrix.shape[0]) for lv in t.levels] == [
        (72, 84), (84, 108), (108, 168), (168, 336)]


@pytest.mark.parametrize("kind,T", [("full", 32), ("full", 37), ("small", 8), ("small", 13)])
def test_forward_matches_jax(kind, T):
    jm, params, tm, _, _ = _models(kind)
    x = np.random.default_rng(T).normal(size=(2, T, 24, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
        packed = tm(torch.from_numpy(x), tm.conv_operands()).numpy()
    assert ours.shape == ref.shape == (2, T, 3)
    np.testing.assert_allclose(ours, ref, atol=_tol(ref), rtol=0)
    np.testing.assert_allclose(packed, ref, atol=_tol(ref), rtol=0)


def test_accumulation_and_world_placement_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(2, 10, 3)).astype(np.float32)
    pose = rng.normal(size=(2, 10, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(ttr.accumulate_root_trajectory(torch.from_numpy(v)).numpy(),
                               np.asarray(jtr.accumulate_root_trajectory(jnp.asarray(v))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        ttr.add_trajectory(torch.from_numpy(pose), torch.from_numpy(v)).numpy(),
        np.asarray(jtr.add_trajectory(jnp.asarray(pose), jnp.asarray(v))), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the training loss and its gradients


def _loss_batch(T, seed, with_joint_pos):
    rng = np.random.default_rng(seed)
    rm = _rotmats((2, T), seed)
    from hm_vae_torch.ops import fk as fk_mod

    pose = fk_mod.fk_numpy(rm)
    b = {"rot_mat": rm, "root_v": rng.normal(scale=0.3, size=(2, T, 3)).astype(np.float32)}
    if with_joint_pos:
        b.update(rot_pos=pose, joint_pos=(pose * 1.3 - 0.1).astype(np.float32))
    return b


@pytest.mark.parametrize("kind,with_joint_pos", [("small", True), ("small", False),
                                                 ("full", True)])
def test_losses_and_leaf_grads_match_jax(kind, with_joint_pos):
    jm, params, tm, _, tc = _models(kind)
    T = 8 if kind == "small" else 20
    batch = _loss_batch(T, 3, with_joint_pos)
    ms = _mean_std(1, zero_coord_std=not with_joint_pos)
    loss_cfg = dict(rec_root_v_w=1.0, rec_root_trans_w=0.5)
    jc = jcfg.Config(model=jm.cfg, loss=jcfg.LossConfig(**loss_cfg))
    tcf = tcfg.Config(model=tc, loss=tcfg.LossConfig(**loss_cfg))
    (ref, jmet), jgrads = jax.value_and_grad(
        lambda p: jtr.trajectory_losses(jm, p, {k: jnp.asarray(v) for k, v in batch.items()},
                                        jc, ms), has_aux=True)(params)
    tm.zero_grad(set_to_none=True)
    loss, met = ttr.trajectory_losses(tm, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      tcf, ms)
    loss.backward()
    for k in ("loss_total", "loss_rec_root_v", "loss_rec_root_trans"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, atol=0, err_msg=k)
    want = trajectory_params_from_flax(jax.tree.map(np.asarray, jgrads), tc)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=_tol(want[name].numpy(), 1e-4), rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the plain backward at the kernels' trajectory shapes


@pytest.mark.parametrize("T", [128, 64])
@pytest.mark.parametrize("level", range(4))
def test_plain_backward_at_k31_matches_jax_vjp(level, T):
    """The wrappers' CPU path (the kernels' plain versions) on the folded
    level, against jax.vjp of the JAX level on the raw weight: the input
    gradient, and the folded weight's and bias's gradients carried back
    through the fold (mask, pool)."""
    _, _, tm, _, _ = _models("full")
    conv = getattr(tm.encoder, f"conv_{level}")
    spec, s = conv.spec, conv.structure()
    assert s.kernel_size == 31 and s.stride == 1
    rng = np.random.default_rng(10 * level + T)
    w = conv.weight.detach().numpy()
    b = conv.bias.detach().numpy()
    mask, pool = spec.mask.astype(np.float32), conv.pool.numpy()
    x = rng.normal(size=(2, spec.in_channels, T)).astype(np.float32)

    def level_fn(x, w, b):
        y = jsnn.skeleton_conv_w(x, w * mask[:, :, None], b, 1, spec.padding, "reflect")
        return jsnn.leaky_relu(jsnn.apply_channel_matrix(y, jnp.asarray(pool)), 0.2)

    y, vjp = jax.vjp(level_fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    gy = rng.normal(size=y.shape).astype(np.float32)
    gx_ref, gw_ref, gb_ref = (np.asarray(a) for a in vjp(jnp.asarray(gy)))

    with torch.no_grad():
        wf, bf = conv.folded_weight()
    yt, gyt = torch.from_numpy(np.asarray(y)), torch.from_numpy(gy)
    gx = fcp.fused_conv_pool_dgrad(gyt, yt, wf, s, T).numpy()
    gwf, gbf = fcp.fused_conv_pool_wgrad(gyt, yt, torch.from_numpy(x), s)
    gw = (torch.einsum("qo,qck->ock", conv.pool, gwf) * torch.from_numpy(mask)[:, :, None])
    gb = conv.pool.T @ gbf
    np.testing.assert_allclose(gx, gx_ref, atol=_tol(gx_ref, 1e-4), rtol=0)
    np.testing.assert_allclose(gw.numpy(), gw_ref, atol=_tol(gw_ref, 1e-4), rtol=0)
    np.testing.assert_allclose(gb.numpy(), gb_ref, atol=_tol(gb_ref, 1e-4), rtol=0)
    assert fcp.fused_conv_pool_dgrad.launches == fcp.fused_conv_pool_wgrad.launches == 0


# ---------------------------------------------------------------------------
# weights, training


def test_reference_names_round_trip():
    jm, params, tm, jc, tc = _models("small")
    sd = trajectory_reference_state_dict(tm.state_dict(), tc)
    assert {k for k in sd if k.startswith("enc.layers.0.")} == {
        "enc.layers.0.0.weight", "enc.layers.0.0.bias", "enc.layers.0.0.mask",
        "enc.layers.0.1.weight"}
    flax = import_trajectory_params({k: v.numpy() for k, v in sd.items()}, jc)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(1, 8, 24, 3)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(jm.apply(flax, x)), np.asarray(jm.apply(params, x)),
                               atol=1e-6, rtol=0)
    back = trajectory_state_dict_from_reference(sd, tc)
    own = tm.state_dict()
    assert back.keys() == {k for k in own if not k.endswith(("mask", "pool", "unpool"))}
    assert all(torch.equal(v, own[k]) for k, v in back.items())
    sd["enc.layers.2.1.weight"] = sd["enc.layers.2.1.weight"] + 1.0
    with pytest.raises(ValueError, match="wrong architecture"):
        trajectory_state_dict_from_reference(sd, tc)


def _train_cfg(mod, tmp, **optim):
    return mod.Config(
        model=mod.ModelConfig(**SMALL),
        loss=mod.LossConfig(rec_root_v_w=1.0, rec_root_trans_w=1.0, kl_w=0.0),
        optim=mod.OptimConfig(**{"lr": 1e-4, "batch_size": 4, "max_iter": 6, **optim}),
        data=mod.DataConfig(data_root=os.path.join(tmp, "data"), synthetic=True,
                            synthetic_num_seqs=6),
        run=mod.RunConfig(log_iter=1, validation_iter=10 ** 6, snapshot_save_iter=10 ** 6))


class _Fixed:
    """A dataset yielding the same batches to both trainers."""

    def __init__(self, batches):
        self.batches = batches

    def iter_batches(self, batch_size):
        return itertools.cycle(self.batches)


def test_trainer_tracks_jax_trainer_and_checkpoints_load_into_jax(tmp_path):
    """20 steps from the same init on the same batches and stats; the band
    of test_torch_train.py (a port run from the init scaled by 1 + 1e-7);
    then the checkpoint in the reference's names, read by the JAX importer,
    and resume."""
    tmp = str(tmp_path)
    tc = _train_cfg(tcfg, tmp)
    train_ds, _, _ = make_loaders(tc)
    ms = np.stack([train_ds.mean, train_ds.std])
    batches = [{k: v for k, v in train_ds.sample_batch(4).items()
                if k in ("joint_pos", "rot_pos", "root_v", "rot_6d")} for _ in range(20)]
    jt = JTrainer(_train_cfg(jcfg, tmp), os.path.join(tmp, "jrun"), mean_std=ms)
    init = trajectory_params_from_flax(jax.tree.map(np.asarray, jt.state.params), tc.model)
    ref = []
    jt.fit(_Fixed(batches), None, max_iter=20, log_cb=lambda s, m: ref.append(m["loss_total"]))

    def port(scale):
        tt = Trainer(tc, os.path.join(tmp, f"trun{scale}"), device="cpu", mean_std=ms)
        tt.state.model.load_state_dict({k: v * scale for k, v in init.items()}, strict=False)
        out = []
        tt.fit(_Fixed(batches), None, max_iter=20, log_cb=lambda s, m: out.append(m["loss_total"]))
        return tt, np.array(out)

    tt, ours = port(1.0)
    perturbed = port(1.0 + 1e-7)[1]
    ref = np.array(ref)
    assert len(ref) == len(ours) == len(perturbed) == 20
    err = np.abs(ours / ref - 1)
    band = 10 * np.maximum.accumulate(np.abs(perturbed / ours - 1)) + 1e-5
    assert (err[:5] <= 1e-5).all(), err
    assert (err <= band).all(), (err, band)

    path = tt.save()
    flax = import_trajectory_params(load_reference_checkpoint(path), jt.cfg.model)
    back = trajectory_params_from_flax(jax.tree.map(np.asarray, flax), tc.model)
    own = tt.state.model.state_dict()
    assert all(torch.equal(v, own[k]) for k, v in back.items())
    again = Trainer(tc, os.path.join(tmp, "trun1.0"), device="cpu", mean_std=ms)
    assert again.resume() == 20
    assert all(torch.equal(v, own[k]) for k, v in again.state.model.state_dict().items())


def test_trainer_needs_the_dataset_stats(tmp_path):
    tmp = str(tmp_path)
    tc = _train_cfg(tcfg, tmp)
    train_ds, _, _ = make_loaders(tc)
    trainer = Trainer(tc, os.path.join(tmp, "run"), device="cpu")  # no mean_std
    with pytest.raises(ValueError, match="mean/std"):
        trainer.fit(train_ds, None, max_iter=1)


# ---------------------------------------------------------------------------
# serving


@pytest.mark.parametrize("kind", ["small", "full"])
def test_runner_matches_jax(kind):
    jm, params, tm, _, _ = _models(kind)
    ms = _mean_std(2)
    T = 8 if kind == "small" else 40
    rm = _rotmats((2, T), 7)
    six = np.concatenate((rm[..., :, 0], rm[..., :, 1]), axis=-1)
    jr = jtr.TrajectoryRunner(jm, params, ms)
    tr = ttr.TrajectoryRunner(tm, ms)
    for data in (six, np.asarray(jtr.fk_mod.fk_from_rot6d(jnp.asarray(six),
                                                          jtr.fk_mod.default_offsets()))):
        jw, jv = (np.asarray(a) for a in jr(jnp.asarray(data)))
        tw, tv = tr(data)
        np.testing.assert_allclose(tv.numpy(), jv, atol=_tol(jv), rtol=0)
        np.testing.assert_allclose(tw.numpy(), jw, atol=_tol(jw), rtol=0)
    # sequence parallelism takes a process group (sp_group), not a mesh
    # (tests/test_torch_sequence_parallel.py)
    with pytest.raises(TypeError, match="sp_mesh"):
        ttr.TrajectoryRunner(tm, ms, sp_mesh=object())


# ---------------------------------------------------------------------------
# the solver's keyframe trajectory loss

LAT = dict(opt_it=8, opt_lr=1e-3, opt_step_size=3, prev_epochs=3, reg_w=0.5,
           reg_w_decoder=1000.0, interpolation_window=3, optimize_trajectory=True,
           reg_w_trajectory=2.0)
KEYS = (0, 3, 6, 7)
_VAE = {}


def _vae():
    if not _VAE:
        jm = JHMVAE(jcfg.ModelConfig(**LEN8))
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24, 6)))
        mc = tcfg.ModelConfig(**LEN8)
        tm = HMVAE(mc)
        tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), mc), strict=False)
        _VAE.update(jm=jm, params=params, tm=tm, st=get_structure(mc))
    return _VAE


@pytest.mark.parametrize("per_window", [True, False], ids=["per_window", "shared"])
def test_solve_with_keyframe_trajectory_loss_matches_jax(per_window):
    v = _vae()
    jtm, jtp, ttm, _, _ = _models("small")
    ms = _mean_std(3)
    B, rng = 3, np.random.default_rng(4)
    targets = jtargets(_rotmats((B, 8), 5))
    root_trans = np.cumsum(rng.normal(scale=0.2, size=(B, 8, 3)), axis=1).astype(np.float32)
    mask = np.tile(np.array([1, 0, 0, 1, 0, 0, 1, 1], np.float32)[None, :, None], (B, 1, 24))
    st = v["st"]
    z = [rng.normal(size=(B, st.z_edges[i], st.z_dims[i])).astype(np.float32) if i in (0, 3)
         else np.zeros((B, st.z_edges[i], st.z_dims[i]), np.float32) for i in range(4)]
    lat = dict(LAT, per_window_decoder=per_window)
    jc = jcfg.Config(model=jcfg.ModelConfig(**LEN8), latent_opt=jcfg.LatentOptConfig(**lat))
    tc = tcfg.Config(model=tcfg.ModelConfig(**LEN8), latent_opt=tcfg.LatentOptConfig(**lat))
    ref = jax.tree.map(np.asarray, jlo.make_latent_optimizer(
        v["jm"], jc, trajectory=(jtm, jtp, ms), key_frames=KEYS)(
        v["params"], {**{k: jnp.asarray(a) for k, a in targets.items()},
                      "root_trans": jnp.asarray(root_trans)},
        jnp.asarray(mask), [jnp.asarray(a) for a in z],
        [jnp.zeros_like(jnp.asarray(a)) for a in z]))
    plain = jax.tree.map(np.asarray, jlo.make_latent_optimizer(v["jm"], jc)(
        v["params"], {k: jnp.asarray(a) for k, a in targets.items()}, jnp.asarray(mask),
        [jnp.asarray(a) for a in z], [jnp.zeros_like(jnp.asarray(a)) for a in z]))
    assert not np.allclose(ref.loss_history, plain.loss_history, rtol=1e-3)  # the term acts
    ttm.zero_grad(set_to_none=True)
    ours = tlo.make_latent_optimizer(v["tm"], tc, trajectory=(ttm, ms), key_frames=KEYS)(
        {**targets, "root_trans": root_trans}, mask, z, [np.zeros_like(a) for a in z])
    np.testing.assert_allclose(ours.loss_history.numpy(), ref.loss_history, rtol=1e-5, atol=0)
    for f, tol in (("last_6d", 1e-5), ("last_rotmat", 1e-4), ("last_pose", 1e-4)):
        np.testing.assert_allclose(getattr(ours, f).numpy(), getattr(ref, f), atol=tol, rtol=0,
                                   err_msg=f)
    np.testing.assert_allclose(ours.final_loss.numpy(), ref.final_loss, rtol=1e-5, atol=0)
    # the trajectory model is a frozen copy: its own parameters get no gradient
    assert all(p.grad is None for p in ttm.parameters())


def test_trajectory_solve_needs_key_frames():
    tc = tcfg.Config(model=tcfg.ModelConfig(**LEN8), latent_opt=tcfg.LatentOptConfig(**LAT))
    with pytest.raises(ValueError, match="key_frames"):
        tlo.make_latent_optimizer(_vae()["tm"], tc, trajectory=(_models("small")[2], _mean_std()))


def test_interpolate_single_window_with_root_trans_matches_jax(monkeypatch):
    v = _vae()
    jtm, jtp, ttm, _, _ = _models("small")
    ms = _mean_std(5)
    lat = dict(opt_it=4, opt_lr=1e-3, opt_step_size=2, prev_epochs=1, reg_w=0.0,
               reg_w_decoder=1000.0, interpolation_window=3, optimize_trajectory=True,
               reg_w_trajectory=1.0)
    jc = jcfg.Config(model=jcfg.ModelConfig(**LEN8), latent_opt=jcfg.LatentOptConfig(**lat))
    tc = tcfg.Config(model=tcfg.ModelConfig(**LEN8), latent_opt=tcfg.LatentOptConfig(**lat))
    st = v["st"]

    def draws(wrap):
        rng = np.random.default_rng(11)

        def init_z(_key, cfg, batch):
            return [wrap(rng.normal(size=(batch, st.z_edges[i], st.z_dims[i])).astype(np.float32)
                         if i in (0, 3) else np.zeros((batch, st.z_edges[i], st.z_dims[i]),
                                                      np.float32)) for i in range(4)]
        return init_z

    monkeypatch.setattr(jtasks, "init_z", draws(jnp.asarray))
    monkeypatch.setattr(ttasks, "init_z", draws(torch.from_numpy))
    wins = _rotmats((2, 8), 9)
    rt = np.cumsum(np.random.default_rng(2).normal(scale=0.2, size=(2, 8, 3)), axis=1).astype(
        np.float32)
    ref = jtasks.LatentOptApps(v["jm"], v["params"], jc, trajectory=(jtm, jtp, ms)) \
        .interpolate_single_window(jnp.asarray(wins), jax.random.PRNGKey(0),
                                   root_trans=jnp.asarray(rt))
    apps = ttasks.LatentOptApps(v["tm"], tc, trajectory=(ttm, ms))
    ours = apps.interpolate_single_window(wins, torch.Generator(), root_trans=rt)
    for k in ("rot_6d", "rot_mat", "pose", "mask"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the entry points


def _cli_configs(tmp):
    """A small VAE (len 16, K 3) with a short solve and a small trajectory
    model, both on one synthetic dataset."""
    data = os.path.join(tmp, "data")
    vae = dict(model_name="TwoHierSAVAEModel", latent_d=6, shallow_latent_d=6, kernel_size=3,
               train_seq_len=16, batch_size=4, synthetic=True, synthetic_num_seqs=10,
               data_root=data, opt_it=3, prev_epochs=1, interpolation_window=3,
               replace_frame_with_gt=True)
    traj = dict(SMALL, train_seq_len=16, batch_size=4, synthetic=True, synthetic_num_seqs=10,
                data_root=data, rec_root_v_w=1, rec_root_trans_w=1)
    paths = []
    for name, c in (("vae", vae), ("traj", traj)):
        p = os.path.join(tmp, f"{name}.yaml")
        with open(p, "w") as f:
            yaml.safe_dump(c, f)
        paths.append(p)
    return paths, data


def test_eval_trajectory_and_trajectory_interpolation_clis(tmp_path):
    """Checkpoints from the port's training CLI, then eval_trajectory (prior
    samples, a saved rotation sequence, GT windows) and eval_recovery's
    trajectory-guided single-window interpolation, on the CPU."""
    tmp = str(tmp_path)
    (vp, tp), data = _cli_configs(tmp)
    for p in (vp, tp):
        train_cli.main(["--config", p, "--output_path", tmp, "--device", "cpu", "--max_iter", "2"])
    ck = {n: os.path.join(tmp, "outputs", n, "checkpoints", "gen_00000002.pt")
          for n in ("vae", "traj")}
    seq = os.path.join(tmp, "seq.npy")
    np.save(seq, _rotmats((21,), 3))
    eval_trajectory.main(["--config", vp, "--test_model", ck["vae"], "--trajectory_config", tp,
                          "--trajectory_test_model", ck["traj"], "--output_path", tmp,
                          "--num_samples", "2", "--pred_trajectory_for_single_window",
                          "--debug_trajectory", "--seq_generation_npy_path", seq,
                          "--device", "cpu"])
    d = os.path.join(tmp, "eval_trajectory", "vae")
    for tag, n, T in (("sampled_single_window", 2, 16), ("debug_gt_window", 4, 16),
                      ("seq_traj", 1, 21)):
        for b in range(n):
            a = np.load(os.path.join(d, f"{tag}_{b}.npy"))
            tr = np.load(os.path.join(d, f"{tag}_{b}_trans.npy"))
            assert a.shape == (T, 24, 9) and tr.shape == (T, 3), tag
            assert np.isfinite(a).all() and np.array_equal(tr, a[:, 0, 6:])

    base = ["--config", vp, "--test_model", ck["vae"], "--output_path", tmp, "--device", "cpu",
            "--max_seqs", "2", "--chunk", "2"]
    eval_recovery.main(base + ["--trajectory_config", tp, "--trajectory_test_model", ck["traj"],
                               "--try_interpolation_w_trajectory_single_window"])
    d = os.path.join(tmp, "eval_interpolation_w_trajectory_single_window", "vae")
    with open(os.path.join(d, "summary.json")) as f:
        summary = json.load(f)
    assert summary["num_seqs"] >= 1 and np.isfinite(summary["mpjpe"])
    trans = sorted(f for f in os.listdir(d) if f.endswith("_root_trans_opt_res.npy"))
    assert len(trans) == summary["num_seqs"]
    assert all(np.load(os.path.join(d, f)).shape == (16, 24, 3) for f in trans)
    with pytest.raises(SystemExit):  # the task needs a trajectory model
        eval_recovery.main(base + ["--try_interpolation_w_trajectory_single_window"])


@pytest.mark.parametrize("extra,match", [
    # --sequence_parallel runs under torchrun (tests/test_torch_sequence_parallel.py);
    # one process asked for two ranks says how to start them
    (["--sequence_parallel", "2"], "--nproc_per_node 2 -m hm_vae_torch.cli.eval_trajectory"),
])
def test_eval_trajectory_unported_flags_raise(tmp_path, extra, match):
    with pytest.raises(ValueError, match=match):
        eval_trajectory.main(["--config", os.path.join(ROOT, "configs", "len8_smoke.yaml"),
                              "--trajectory_config", FULL, "--output_path", str(tmp_path),
                              "--device", "cpu"] + extra)


def test_eval_trajectory_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_trajectory.main(["--config", os.path.join(ROOT, "configs", "len8_smoke.yaml"),
                              "--trajectory_config", FULL, "--output_path", str(tmp_path)])


def test_no_kernel_launches_on_the_cpu():
    _, _, tm, _, _ = _models("small")
    fcp.fused_conv_pool.launches = fcp.fused_conv_pool_dgrad.launches = 0
    x = torch.randn(2, 8, 24, 3, requires_grad=True)
    tm(x).sum().backward()
    assert fcp.fused_conv_pool.launches == fcp.fused_conv_pool_dgrad.launches == 0


# ---------------------------------------------------------------------------
# sequences of any length, and lora_rank


def test_runner_and_loaded_bundle_match_jax_at_batch_2_t_4000(tmp_path):
    """The semantics the card must reach past the forward kernel's old row
    limit: the full-width model (K 31) on two 4,000-frame sequences, by
    ``TrajectoryRunner`` and by the CPU-exported ``trajectory`` function of
    a bundle loaded back, against the JAX package's runner: root_v within
    1e-5 * max(1, max|ref|); the world poses, a cumulative sum over 4,000
    steps taken in another order, within 1e-5 * max(1, max|ref|) too."""
    from hm_vae_torch.apps.export import export_bundle, load_exported

    jm, params, tm, _, _ = _models("full")
    ms = _mean_std(3)
    rm = _rotmats((2, 4000), 11, scale=0.3)
    six = np.concatenate((rm[..., :, 0], rm[..., :, 1]), axis=-1)
    jw, jv = (np.asarray(a) for a in jtr.TrajectoryRunner(jm, params, ms)(jnp.asarray(six)))
    tw, tv = ttr.TrajectoryRunner(tm, ms)(six)
    assert tuple(tv.shape) == jv.shape == (2, 4000, 3)
    np.testing.assert_allclose(tv.numpy(), jv, atol=_tol(jv), rtol=0)
    np.testing.assert_allclose(tw.numpy(), jw, atol=_tol(jw), rtol=0)

    vae = HMVAE(tcfg.ModelConfig(**LEN8))
    cfg = dataclasses.replace(tcfg.Config(), model=tcfg.ModelConfig(**LEN8))
    export_bundle(str(tmp_path / "bundle"), vae, cfg, trajectory=(tm, ms))
    fn = load_exported(str(tmp_path / "bundle"))["trajectory"]
    pose = jtr.fk_mod.fk_from_rot6d(jnp.asarray(six), jtr.fk_mod.default_offsets())
    got = fn(torch.from_numpy(np.array(pose)))
    np.testing.assert_allclose(got.numpy(), jv, atol=_tol(jv), rtol=0)


@pytest.mark.parametrize("kind", ["small", "full"])
def test_lora_rank_is_ignored_as_in_jax(kind, tmp_path):
    """Both packages build the trajectory model at ``lora_rank=4`` with the
    rank-0 parameters (the adapters are the VAE decoder's) and compute the
    same outputs on the same weights (1e-5 * max(1, max|ref|)); the Trainer
    accepts the rank for the trajectory model."""
    _, _, tm0, jc0, tc0 = _models(kind)
    jc, tc = dataclasses.replace(jc0, lora_rank=4), dataclasses.replace(tc0, lora_rank=4)
    jm = jtr.TrajectoryModel(jc)
    T = 8 if kind == "small" else 40
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, T, 24, 3)))
    rank0 = jtr.TrajectoryModel(jc0).init(jax.random.PRNGKey(2), jnp.zeros((1, T, 24, 3)))
    assert (jax.tree.map(np.shape, params) == jax.tree.map(np.shape, rank0))
    tm = ttr.TrajectoryModel(tc)
    assert set(tm.state_dict()) == set(tm0.state_dict())
    tm.load_state_dict(trajectory_params_from_flax(jax.tree.map(np.asarray, params), tc),
                       strict=False)
    x = np.random.default_rng(4).normal(size=(2, T, 24, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=_tol(ref), rtol=0)
    if kind == "small":
        cfg = _train_cfg(tcfg, str(tmp_path))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, lora_rank=4))
        Trainer(cfg, str(tmp_path / "run"), device="cpu", mean_std=_mean_std())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_plan_stages_windows_of_long_rows(dtype):
    """The forward launch's plan (``forward_plan``: the planner that ``launch``
    in ``csrc/fused_conv_pool.cu`` runs, built for the host) at the
    trajectory model's K-31 levels: rows that do not fit shared memory
    whole, or fit only with more tap segments, are staged as windows of the 94 columns a block's 64 outputs read, whose
    bytes do not grow with T and fit at any length; the rows of the earlier
    operating points (T 16-300, and the len-64 levels) stay whole; f32
    splits a chunk's 31 taps into 2 segments, bf16 keeps 1."""
    plan = lambda B, T: fcp.forward_plan(dtype, B, T, 31, 64, T, 1, 15)  # noqa: E731
    cases = ((1, 7200), (4, 2048), (2, 4096), (1, 10 ** 6), (3, 10 ** 5),
             (2, 600 if dtype == torch.float32 else 330))  # whole would need more segments
    long = [plan(B, T) for B, T in cases]
    assert all(p["rows"] == "window" and p["window"] == 94 and p["fits"] for p in long)
    # a block's bytes depend on the batches it can touch (1, or 2), not on T
    for one in (True, False):
        assert len({p["smem"] for (B, _), p in zip(cases, long) if (B == 1) == one}) == 1
    for B, T in ((8, 128), (1, 300), (10, 64), (1, 16), (8, 94)):
        assert plan(B, T)["rows"] == "whole" and plan(B, T)["fits"]
    want = 2 if dtype == torch.float32 else 1
    assert {p["segments"] for p in long} | {plan(8, 128)["segments"]} == {want}
    # the len-64 levels (K 15) stay whole rows at every batch
    for B, T, stride in ((8, 64, 2), (237, 64, 1), (64, 32, 2), (8, 8, 1)):
        p = fcp.forward_plan(dtype, B, T, 15, 256, (T + 14 - 15) // stride + 1, stride, 7)
        assert p["rows"] == "whole" and p["segments"] == 1 and p["fits"]
