"""The test-time solver's window batch split over two gloo ranks
(``LatentOptApps(..., group=)`` and its ``_dispatch``) on the CPU, at len-8
size, 5 windows (padded to 6 by cycling, as the JAX package pads), with a z
phase and a decoder phase:

- against the JAX package's ``LatentOptApps._dispatch`` on a 2-device mesh
  from the same weights, targets, mask and z: every iteration's loss (the
  padded batch's mean) within 1e-5 relative, ``last_6d`` within 1e-5,
  rotations and positions within 1e-4, ``final_loss`` within 1e-5 relative
  (the tolerances of tests/test_torch_latent_opt.py: f32 sums in another
  order; Gram-Schmidt amplifies a 6D difference by the inverse of the
  vectors' short length at random weights);
- against the port's one-process solve of the same padded batch, trimmed:
  the same tolerances;
- per-window clones (no collective inside the solve) and the shared clone
  (its batch-mean loss, gradient and ``track_best`` scalar normalised by
  the global padded batch and all-reduced every iteration);
- both ranks gather the same result;
- ``eval_recovery --data_parallel 2`` (interpolation with per-window and
  shared clones, and ``--test_model_rec``'s batches split by rows) against
  the one-process run: rank 0 writes every file, the results agree.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from hm_vae_tpu.apps.tasks import LatentOptApps as JApps
from hm_vae_tpu.apps.tasks import _targets_from_rotmat_np as jtargets
from hm_vae_tpu.models.hm_vae import HMVAE as JHMVAE
from hm_vae_tpu.parallel import sharding as jsh
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.apps import latent_opt as tlo
from hm_vae_torch.cli import eval_recovery
from hm_vae_torch.cli import train as train_cli
from hm_vae_torch.models.hm_vae import HMVAE
from hm_vae_torch.models.structure import get_structure
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import params_from_flax

import torch_ranks

LEN8 = dict(latent_d=6, shallow_latent_d=6, kernel_size=3, train_seq_len=8)
LAT = dict(opt_it=8, opt_lr=1e-3, opt_step_size=3, prev_epochs=3, reg_w=0.5,
           reg_w_decoder=1000.0, interpolation_window=3)
B, B_PAD = 5, 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    jm = JHMVAE(jcfg.ModelConfig(**LEN8))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24, 6)))
    mc = tcfg.ModelConfig(**LEN8)
    state_dict = {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, params), mc).items()}
    rng = np.random.default_rng(0)
    rotm = R.from_rotvec(rng.normal(scale=0.4, size=(B * 8 * 24, 3))).as_matrix()
    targets = jtargets(rotm.astype(np.float32).reshape(B, 8, 24, 3, 3))
    mask = np.tile(np.array([1, 0, 0, 1, 0, 0, 1, 1], np.float32)[None, :, None], (B, 1, 24))
    mask[:, :, 23] = 0.0
    st = get_structure(mc)
    z = [rng.normal(size=(B, st.z_edges[i], st.z_dims[i])).astype(np.float32)
         for i in range(mc.num_layers)]
    zr = [0.1 * a for a in z]
    return jm, params, state_dict, targets, mask, z, zr


def _check(got, ref, what):
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-5, atol=0,
                               err_msg=f"{what} loss_history")
    for f, tol in (("last_6d", 1e-5), ("last_rotmat", 1e-4), ("last_pose", 1e-4),
                   ("best_6d", 1e-5), ("best_pose", 1e-4)):
        assert got[f].shape == ref[f].shape, (what, f)
        np.testing.assert_allclose(got[f], ref[f], atol=tol, rtol=0, err_msg=f"{what} {f}")
    np.testing.assert_allclose(got["final_loss"], ref["final_loss"], rtol=1e-5, atol=0,
                               err_msg=f"{what} final_loss")


@pytest.mark.parametrize("lat", [dict(per_window_decoder=True),
                                 dict(per_window_decoder=False),
                                 dict(per_window_decoder=False, track_best=True)],
                         ids=["per_window", "shared", "shared_track_best"])
def test_two_rank_solve_matches_jax_dispatch_on_two_devices(tmp_path, lat):
    jm, params, state_dict, targets, mask, z, zr = _setup()
    kw = {**LAT, **lat}
    jc = jcfg.Config(model=jcfg.ModelConfig(**LEN8), latent_opt=jcfg.LatentOptConfig(**kw))
    tc = tcfg.Config(model=tcfg.ModelConfig(**LEN8), latent_opt=tcfg.LatentOptConfig(**kw))

    apps = JApps(jm, params, jc, mesh=jsh.make_mesh(2, model_parallel=1))
    ref = apps._dispatch(apps.solve, {k: jnp.asarray(v) for k, v in targets.items()},
                         jnp.asarray(mask), [jnp.asarray(a) for a in z],
                         [jnp.asarray(a) for a in zr])
    ref = {f.name: np.asarray(getattr(ref, f.name)) for f in dataclasses.fields(ref)}
    assert ref["last_6d"].shape[0] == B

    # the port in one process on the cyclically padded batch, trimmed
    pad = np.arange(B_PAD) % B
    tm = HMVAE(tcfg.ModelConfig(**LEN8))
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=False)
    one = tlo.make_latent_optimizer(tm, tc)({k: v[pad] for k, v in targets.items()},
                                            mask[pad], [a[pad] for a in z], [a[pad] for a in zr])
    one = {k: v.numpy()[:B] if k != "loss_history" else v.numpy()
           for k, v in vars(one).items()}

    r0, r1 = torch_ranks.run_ranks(torch_ranks.solve, 2, tmp_path, tc, state_dict, targets,
                                   mask, z, zr)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)  # every rank, the same result
    _check(r0, ref, "vs JAX")
    _check(r0, one, "vs one process")


def _cli_config(tmp):
    """The len-8 smoke config at len 16, with a short solve (as
    tests/test_torch_tasks.py's evaluation CLI tests)."""
    text = open(os.path.join(ROOT, "configs", "len8_smoke.yaml")).read()
    text = text.replace("train_seq_len: 8", "train_seq_len: 16")
    path = os.path.join(tmp, "len16_eval.yaml")
    with open(path, "w") as f:
        f.write(text + "opt_it: 3\nprev_epochs: 1\nprev_epochs_completion: 1\n"
                       "synthetic_num_seqs: 10\n")
    return path


@pytest.mark.parametrize("task,extra", [
    ("eval_long_seq_interpolation", ["--final_try_long_seq_interpolation"]),
    ("eval_long_seq_interpolation", ["--final_try_long_seq_interpolation",
                                     "--batch_across_seqs", "--shared_decoder_clone"]),
    ("eval_reconstruction", ["--test_model_rec"]),
], ids=["interpolation", "shared_clone", "reconstruction"])
def test_eval_recovery_data_parallel_on_two_ranks(tmp_path, task, extra):
    """``eval_recovery --data_parallel 2`` under two ranks against the
    one-process run on the same checkpoint and test split: the same files,
    written by rank 0 only, each sequence's result within the solver's
    tolerances (1e-4 on the arrays), the summary within 1e-5 relative."""
    tmp = str(tmp_path)
    cfg = _cli_config(tmp)
    data = os.path.join(tmp, "data")
    train_cli.main(["--config", cfg, "--output_path", tmp, "--data_root", data,
                    "--device", "cpu", "--max_iter", "2"])
    ck = os.path.join(tmp, "outputs", "len16_eval", "checkpoints", "gen_00000002.pt")
    base = ["--config", cfg, "--data_root", data, "--device", "cpu", "--test_model", ck,
            "--max_seqs", "3"] + extra
    eval_recovery.main(base + ["--output_path", os.path.join(tmp, "one")])
    two = os.path.join(tmp, "two")
    w0, w1 = torch_ranks.run_ranks(torch_ranks.cli, 2, tmp_path,
                                   "hm_vae_torch.cli.eval_recovery",
                                   base + ["--output_path", two, "--data_parallel", "2"])
    assert w1 == [] and "summary.json" in w0  # rank 0 writes every file
    d1, d2 = (os.path.join(root, task, "len16_eval") for root in (os.path.join(tmp, "one"), two))
    files = sorted(f for f in os.listdir(d1) if f.endswith((".npy", ".json")))
    assert files == sorted(f for f in os.listdir(d2) if f.endswith((".npy", ".json")))
    assert files == w0 and len(files) >= 2
    for f in files:
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(os.path.join(d2, f)),
                                       np.load(os.path.join(d1, f)), atol=1e-4, rtol=0,
                                       err_msg=f)
    with open(os.path.join(d1, "summary.json")) as f1, open(os.path.join(d2, "summary.json")) as f2:
        s1, s2 = json.load(f1), json.load(f2)
    assert s1.keys() == s2.keys() and s1["num_seqs"] == s2["num_seqs"]
    for k in s1:
        np.testing.assert_allclose(s2[k], s1[k], rtol=1e-5, atol=1e-7, err_msg=k)
