"""Sequence parallelism over gloo ranks on the CPU
(``hm_vae_torch.parallel.sequence_parallel``):

- ``halo_exchange`` on 4 ranks: each rank's halo-extended shard equals the
  slice of the globally padded sequence (reflect without edge repeat, and
  zeros), bit for bit; a halo longer than a shard allows raises;
- ``sp_accumulate_root_trajectory`` on 4 ranks against the one-process
  cumsum (step 0 zeroed), 1e-6 absolute (f32 sums in another order);
- ``make_sp_trajectory_fn`` on 4 ranks against the JAX package's on a
  4-device mesh, from the same small trajectory model's weights, in both
  padding modes: T divisible by the ranks, and T = 30 with
  ``pad_incomplete`` (JAX pads and trims the same way) within f32
  tolerance (1e-5 * max(1, max|ref|)); strict at T = 30 and a shard no
  longer than the halo raise, as in JAX; against the one-process
  ``TrajectoryRunner`` too, all frames where T divides, all but the last
  num_levels * halo frames with ``pad_incomplete``;
- ``eval_trajectory --sequence_parallel 2`` against the one-process run,
  rank 0 writing the files; ``--sequence_parallel_strict`` raising.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.spatial.transform import Rotation as R

from hm_vae_tpu.models import trajectory as jtr
from hm_vae_tpu.parallel import sequence_parallel as jsp
from hm_vae_tpu.parallel import sharding as jsh
from hm_vae_tpu.utils import config as jcfg
from hm_vae_torch.cli import eval_trajectory
from hm_vae_torch.models import trajectory as ttr
from hm_vae_torch.ops import fk as fk_mod
from hm_vae_torch.utils import config as tcfg
from hm_vae_torch.utils.weights import trajectory_params_from_flax

import torch_ranks

SMALL = dict(model_name="TrajectoryModel", latent_d=12, kernel_size=3, train_seq_len=8,
             trajectory_input_joint_pos=True)
RANKS = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(ref, scale=1e-5):
    return scale * max(1.0, float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_halo_exchange_is_the_global_padding(tmp_path, mode):
    x = np.random.default_rng(0).normal(size=(2, 3, 24)).astype(np.float32)
    h, Tl = 3, 24 // RANKS
    padded = F.pad(torch.from_numpy(x), (h, h), mode=mode).numpy()
    out = torch_ranks.run_ranks(torch_ranks.halo, RANKS, tmp_path, x, h, mode)
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got, padded[..., r * Tl:(r + 1) * Tl + 2 * h])
    too_long = torch_ranks.run_ranks(torch_ranks.halo, RANKS, tmp_path, x, Tl, mode)
    assert all("needs T_local >= 7" in r for r in too_long)


def test_distributed_accumulation_is_the_cumsum(tmp_path):
    root_v = np.random.default_rng(1).normal(size=(2, 24, 3)).astype(np.float32)
    want = np.cumsum(np.concatenate([np.zeros_like(root_v[:, :1]), root_v[:, 1:]], 1), 1)
    out = torch_ranks.run_ranks(torch_ranks.accumulate, RANKS, tmp_path, root_v)
    np.testing.assert_allclose(np.concatenate(out, axis=1), want, atol=1e-6, rtol=0)


def _pose(T, seed):
    rng = np.random.default_rng(seed)
    rm = R.from_rotvec(rng.normal(scale=0.4, size=(2 * T * 24, 3))).as_matrix().astype(
        np.float32).reshape(2, T, 24, 3, 3)
    root = np.cumsum(rng.normal(scale=0.02, size=(2, T, 1, 3)), axis=1).astype(np.float32)
    return (fk_mod.fk_numpy(rm) + root).astype(np.float32)


@pytest.mark.parametrize("padding_mode", ["reflection", "zeros"])
def test_sp_trajectory_on_four_ranks_matches_jax_on_four_devices(tmp_path, padding_mode):
    jc = jcfg.ModelConfig(**SMALL, padding_mode=padding_mode)
    tc = tcfg.ModelConfig(**SMALL, padding_mode=padding_mode)
    jm = jtr.TrajectoryModel(jc)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 24, 3)))
    state_dict = {k: v.numpy() for k, v in trajectory_params_from_flax(
        jax.tree.map(np.asarray, params), tc).items()}
    rng = np.random.default_rng(4)
    ms = np.stack([rng.normal(scale=0.1, size=579),
                   rng.uniform(0.5, 1.5, size=579)]).astype(np.float32)
    mesh = jsh.make_mesh(RANKS, model_parallel=1)
    long_pose, odd_pose, short_pose = _pose(32, 5), _pose(30, 6), _pose(4, 7)
    cases = [(long_pose, False), (odd_pose, True), (odd_pose, False), (short_pose, True)]
    out, launches = torch_ranks.run_ranks(torch_ranks.sp_trajectory, RANKS, tmp_path, tc,
                                          state_dict, ms, cases)[0]
    assert launches == 0  # the CPU runs the kernel's plain version

    tm = ttr.TrajectoryModel(tc)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=False)
    one = ttr.TrajectoryRunner(tm, ms)
    halo, levels = (SMALL["kernel_size"] - 1) // 2, 4
    for (pose, pad_incomplete), got in zip(cases[:2], out[:2]):
        ref = jsp.make_sp_trajectory_fn(jm, params, ms, mesh, pad_incomplete=pad_incomplete)(
            jnp.asarray(pose))
        ref = [np.asarray(a) for a in ref]
        plain = [a.numpy() for a in one(torch.from_numpy(pose))]
        T = pose.shape[1]
        keep = T - levels * halo if pad_incomplete else T
        for g, j, p, what in zip(got, ref, plain, ("world", "root_v")):
            assert g.shape == j.shape == p.shape
            np.testing.assert_allclose(g, j, atol=_tol(j), rtol=0, err_msg=f"{what} vs JAX")
            np.testing.assert_allclose(g[:, :keep], p[:, :keep], atol=_tol(p), rtol=0,
                                       err_msg=f"{what} vs one process")
    assert "not divisible by 4 shards" in out[2]
    assert "shard length 1 <= halo 1" in out[3]
    with pytest.raises(ValueError, match="not divisible"):
        jsp.make_sp_trajectory_fn(jm, params, ms, mesh)(jnp.asarray(odd_pose))
    with pytest.raises(ValueError, match="<= halo"):
        jsp.make_sp_trajectory_fn(jm, params, ms, mesh, pad_incomplete=True)(
            jnp.asarray(short_pose))


def test_eval_trajectory_sequence_parallel_on_two_ranks(tmp_path):
    """``eval_trajectory --sequence_parallel 2`` under two ranks on a
    70-frame sequence (the full trajectory model, K 31: a 15-frame halo in
    35-frame shards) against the one-process run: rank 0 writes the files,
    the world positions agree within f32 tolerance; ``--sequence_parallel_
    strict`` at 71 frames raises on both ranks."""
    tmp = str(tmp_path)
    rm = R.from_rotvec(np.random.default_rng(8).normal(scale=0.3, size=(71 * 24, 3))
                       ).as_matrix().astype(np.float32).reshape(71, 24, 3, 3)
    for T in (70, 71):
        np.save(os.path.join(tmp, f"take{T}.npy"), rm[:T])
    base = ["--config", os.path.join(ROOT, "configs", "len8_smoke.yaml"),
            "--trajectory_config", os.path.join(ROOT, "configs", "trajectory_model.yaml"),
            "--data_root", os.path.join(tmp, "data"), "--device", "cpu"]
    take = ["--seq_generation_npy_path", os.path.join(tmp, "take70.npy")]
    eval_trajectory.main(base + take + ["--output_path", os.path.join(tmp, "one")])
    w0, w1 = torch_ranks.run_ranks(
        torch_ranks.cli, 2, tmp_path, "hm_vae_torch.cli.eval_trajectory",
        base + take + ["--output_path", os.path.join(tmp, "two"), "--sequence_parallel", "2"])
    assert w1 == [] and w0 == ["take70_traj_0.npy", "take70_traj_0_trans.npy"]
    for f in w0:
        one, two = (np.load(os.path.join(tmp, r, "eval_trajectory", "len8_smoke", f))
                    for r in ("one", "two"))
        assert one.shape[0] == 70
        np.testing.assert_allclose(two, one, atol=_tol(one), rtol=0, err_msg=f)
    with pytest.raises(AssertionError, match="T=71 not divisible by 2 shards"):
        torch_ranks.run_ranks(
            torch_ranks.cli, 2, tmp_path, "hm_vae_torch.cli.eval_trajectory",
            base + ["--seq_generation_npy_path", os.path.join(tmp, "take71.npy"),
                    "--output_path", os.path.join(tmp, "strict"), "--sequence_parallel", "2",
                    "--sequence_parallel_strict"])
