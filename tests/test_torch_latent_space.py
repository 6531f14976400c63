"""The port's latent-space probes (``hm_vae_torch/apps/latent_space.py``) and
their CLI against the JAX package's, and ``scripts/jax_checkpoint_to_pt.py``:
a JAX Trainer's orbax checkpoint, written here, converted to a ``gen_*.pt``
that the port loads to the JAX model's outputs.  CPU, small widths."""

import importlib.util
import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hm_vae_tpu.apps import latent_space as jls
from hm_vae_tpu.apps.inference import VAEInference as JInference
from hm_vae_tpu.cli import explore_latent as jexplore
from hm_vae_tpu.models.trajectory import TrajectoryRunner as JRunner
from hm_vae_tpu.train.trainer import Trainer as JTrainer
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.apps import latent_space as tls
from hm_vae_torch.apps.inference import VAEInference
from hm_vae_torch.cli import explore_latent as texplore
from hm_vae_torch.data.dataset import make_loaders
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.models.trajectory import TrajectoryModel, TrajectoryRunner
from hm_vae_torch.ops import fk
from hm_vae_torch.ops import rotations as rot
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import load_reference_checkpoint, state_dict_from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE = dict(model_name="TwoHierSAVAEModel", latent_d=6, shallow_latent_d=6, kernel_size=3,
           train_seq_len=8, batch_size=4, synthetic=True, synthetic_num_seqs=6, lr=1e-3)
TRAJ = dict(model_name="TrajectoryModel", latent_d=12, kernel_size=3, train_seq_len=8,
            trajectory_input_joint_pos=True, rec_root_v_w=1.0, rec_root_trans_w=1.0,
            kl_w=0.0, batch_size=4, synthetic=True, synthetic_num_seqs=6, lr=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops run fastest on one thread when the test workers share
    the machine's cores; restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_pt", os.path.join(ROOT, "scripts", "jax_checkpoint_to_pt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Fixed:
    """A dataset yielding the same batches over and over."""

    def __init__(self, batches):
        self.batches = batches

    def iter_batches(self, batch_size):
        return itertools.cycle(self.batches)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{kind: (JAX config, JAX trainer, orbax checkpoint, converted gen_*.pt,
    config path, mean_std)} for the HM-VAE and the trajectory model: each JAX Trainer
    takes 3 steps on synthetic batches and writes its checkpoint, which the
    script converts."""
    tmp = tmp_path_factory.mktemp("ckpt")
    keys = {"vae": ("rot_6d", "rot_mat"), "traj": ("joint_pos", "rot_pos", "root_v", "rot_6d")}
    out = {}
    for kind, cfg in (("vae", VAE), ("traj", TRAJ)):
        path = str(tmp / f"{kind}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump({**cfg, "data_root": str(tmp / "data"), "log_iter": 10 ** 6,
                            "validation_iter": 10 ** 6, "snapshot_save_iter": 10 ** 6}, f)
        train_ds = make_loaders(tcfg.load_config(path))[0]
        ms = np.stack([train_ds.mean, train_ds.std])
        batches = [{k: v for k, v in train_ds.sample_batch(4).items() if k in keys[kind]}
                   for _ in range(3)]
        jc = jcfg.load_config(path)
        jt = JTrainer(jc, str(tmp / f"jrun_{kind}"), mean_std=ms if kind == "traj" else None)
        jt.fit(_Fixed(batches), None, max_iter=3)
        ck = jt.save()
        pt = _script().convert(path, ck, str(tmp / f"gen_{kind}.pt"))
        out[kind] = (jc, jt, ck, pt, path, ms)
    return out


def test_converted_vae_checkpoint_reconstructs_as_the_jax_model(checkpoints):
    jc, jt, ck, pt, path, _ = checkpoints["vae"]
    assert os.path.isdir(ck) and pt.endswith(".pt")
    cfg = tcfg.load_config(path)
    model = HMVAE(cfg.model)
    model.load_state_dict(state_dict_from_reference(load_reference_checkpoint(pt), cfg.model))
    x = rot.rotmat_to_rot6d(rot.aa_to_rotmat(torch.from_numpy(
        np.random.default_rng(0).normal(size=(3, 8, 24, 3)).astype(np.float32) * 0.3))).numpy()
    got = VAEInference(model, cfg, device="cpu").mean_reconstruction(x)
    want = JInference(jt.model, jt.state.params, jc).mean_reconstruction(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_converted_trajectory_checkpoint_predicts_as_the_jax_model(checkpoints):
    jc, jt, ck, pt, path, ms = checkpoints["traj"]
    cfg = tcfg.load_config(path)
    model = TrajectoryModel(cfg.model)
    model.load_state_dict(state_dict_from_reference(load_reference_checkpoint(pt), cfg.model))
    aa = np.random.default_rng(1).normal(size=(2, 40, 24, 3)).astype(np.float32) * 0.3
    pose = fk.fk_from_rotmat(rot.aa_to_rotmat(torch.from_numpy(aa)),
                             fk.default_offsets()).numpy()  # positions in metres
    with torch.no_grad():
        got = TrajectoryRunner(model, ms)._predict(torch.from_numpy(pose))
    want = JRunner(jt.model, jt.state.params, ms)._predict(jnp.asarray(pose))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def infers(checkpoints):
    """The JAX inference and the port's on the converted weights."""
    jc, jt, _, pt, path, _ = checkpoints["vae"]
    cfg = tcfg.load_config(path)
    model = HMVAE(cfg.model)
    model.load_state_dict(state_dict_from_reference(load_reference_checkpoint(pt), cfg.model))
    return JInference(jt.model, jt.state.params, jc), VAEInference(model, cfg, device="cpu")


def _rand6d(seed):
    aa = np.random.default_rng(seed).normal(size=(2, 8, 24, 3)).astype(np.float32) * 0.3
    return rot.rotmat_to_rot6d(rot.aa_to_rotmat(torch.from_numpy(aa))).numpy()


def _close(got, want, tol=1e-4):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("level", [0, 1, 3])
def test_level_swap_matches_jax(infers, level):
    j, t = infers
    a, b = _rand6d(1), _rand6d(2)
    _close(tls.level_swap(t, a, b, level), jls.level_swap(j, jnp.asarray(a), jnp.asarray(b),
                                                          level))


@pytest.mark.parametrize("levels", [None, (3,)])
def test_latent_lerp_matches_jax(infers, levels):
    j, t = infers
    a, b = _rand6d(3), _rand6d(4)
    got = tls.latent_lerp(t, a, b, num=3, levels=levels)
    want = jls.latent_lerp(j, jnp.asarray(a), jnp.asarray(b), num=3, levels=levels)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g, w)


def test_decode_given_z_matches_jax_and_checks_shapes(infers):
    j, t = infers
    st = get_structure(t.cfg.model)
    rng = np.random.default_rng(5)
    zs = [rng.normal(size=(2, st.z_edges[i], st.z_dims[i])).astype(np.float32)
          for i in range(t.cfg.model.num_layers)]
    _close(tls.decode_given_z(t, zs), jls.decode_given_z(j, zs))
    with pytest.raises(ValueError, match="do not match"):
        tls.decode_given_z(t, zs[:-1])
    with pytest.raises(ValueError, match="do not match"):
        tls.decode_given_z(t, [zs[0][:, :-1]] + zs[1:])


def test_level_sweep_consumed_levels_match_jax_and_middles_are_the_baseline(infers):
    """The port draws its z from the generator level by level; JAX's
    decode_full of those z is each consumed level's decode, and a middle
    level decodes as the all-zero baseline."""
    j, t = infers
    out = tls.level_sweep(t, torch.Generator().manual_seed(7), batch=2, scale=0.5)
    nl = t.cfg.model.num_layers
    assert set(out) == {"baseline"} | {f"level_{i}" for i in range(nl)}
    zeros = [np.zeros(z.shape, np.float32) for z in tls._zero_z_list(t.cfg.model, 2)]
    _close(out["baseline"], j.decode_full([jnp.asarray(z) for z in zeros]))
    gen = torch.Generator().manual_seed(7)
    for lvl in range(nl):
        z = 0.5 * torch.randn(zeros[lvl].shape, generator=gen)
        if 0 < lvl < nl - 1:
            for a, b in zip(out[f"level_{lvl}"], out["baseline"]):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
        else:
            zs = list(zeros)
            zs[lvl] = z.numpy()
            _close(out[f"level_{lvl}"], j.decode_full([jnp.asarray(v) for v in zs]))
            assert float((out[f"level_{lvl}"][2] - out["baseline"][2]).abs().max()) > 1e-4


def test_explore_latent_cli_writes_the_jax_files(checkpoints, tmp_path):
    """Both CLIs on the same synthetic data root and weights (the orbax
    checkpoint and its conversion): the same files and index; every probe
    but the random sweeps agrees within 1e-4."""
    jc, jt, ck, pt, path, _ = checkpoints["vae"]
    st = get_structure(tcfg.load_config(path).model)
    zs = [np.random.default_rng(i).normal(size=(1, st.z_edges[i], st.z_dims[i]))
          .astype(np.float32) for i in range(len(st.z_edges))]
    z_path = str(tmp_path / "z.npz")
    np.savez(z_path, **{f"z{i}": z for i, z in enumerate(zs)})
    args = ["--config", path, "--check_hier_latent_space", "--vis_given_z_vec", z_path,
            "--num_samples", "2", "--num_lerp", "3"]
    jexplore.main(args + ["--output_path", str(tmp_path / "jax"), "--test_model", ck])
    texplore.main(args + ["--output_path", str(tmp_path / "port"), "--test_model", pt,
                          "--device", "cpu"])
    name = os.path.splitext(os.path.basename(path))[0]
    dirs = [str(tmp_path / side / "latent_space" / name) for side in ("jax", "port")]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    index = []
    for d in dirs:
        with open(os.path.join(d, "index.json")) as f:
            index.append(json.load(f))
    assert index[0] == index[1]
    assert {"given_z", "sweep_baseline", "sweep_level_0", "sweep_level_3", "swap_shallow_from_b",
            "swap_deep_from_b", "lerp_0", "lerp_2"} <= set(index[1])
    for probe in index[1]:
        for suffix in ("_pose.npy", "_rot.npy"):
            a, b = (np.load(os.path.join(d, probe + suffix)) for d in dirs)
            assert a.shape == b.shape and np.isfinite(b).all()
            if probe not in ("sweep_level_0", "sweep_level_3"):  # the noise differs
                np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)
