"""Random root rotation on the device (CPU here) against the JAX package:
``rotmat_to_aa`` (including angles within 1e-3 of pi and near 0) and
``apply_root_rot`` on the same rotations, for every wire field and a (K, B)
prefix; the draws are rotations; the stream is keyed by the step, so a
resumed run replays it.

Tolerances: 1e-6 absolute (f32 rotations of unit scale, the same
expressions; the JAX package writes 3x3 products as elementwise sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.data import device_aug as jaug
from hm_vae_tpu.data import layout
from hm_vae_tpu.ops import rotations as jrot
from hm_vae_torch.data import device_aug as taug
from hm_vae_torch.ops import rotations as trot

TOL = 1e-6


def _axes(rng, n):
    a = rng.normal(size=(n, 3))
    return a / np.linalg.norm(a, axis=1, keepdims=True)


@pytest.mark.parametrize("band", ["uniform", "near_pi", "near_zero", "exact"])
def test_rotmat_to_aa_matches_jax(band):
    rng = np.random.default_rng({"uniform": 0, "near_pi": 1, "near_zero": 2, "exact": 3}[band])
    n = 512
    angle = {"uniform": lambda: rng.uniform(0, np.pi, n),
             "near_pi": lambda: np.pi - rng.uniform(0, 1e-3, n),
             "near_zero": lambda: rng.uniform(0, 1e-3, n),
             "exact": lambda: np.repeat([0.0, np.pi / 2, np.pi], n // 3 + 1)[:n]}[band]()
    aa = (_axes(rng, n) * angle[:, None]).astype(np.float32)
    R = np.asarray(jrot.aa_to_rotmat(jnp.asarray(aa)))
    ref = np.asarray(jrot.rotmat_to_aa(jnp.asarray(R)))
    got = trot.rotmat_to_aa(torch.from_numpy(R.copy())).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=4 * TOL)
    # the round trip recovers the rotation (the axis is defined up to sign at pi)
    back = trot.aa_to_rotmat(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, R, rtol=0, atol=1e-4)


def _batch(rng, prefix):
    T = 5
    return {"aa": (rng.normal(size=prefix + (T, 24, 3)) * 0.7).astype(np.float32),
            "rot_6d": rng.normal(size=prefix + (T, 24, 6)).astype(np.float32),
            "rot_mat": rng.normal(size=prefix + (T, 24, 3, 3)).astype(np.float32),
            "root_v": rng.normal(size=prefix + (T, 3)).astype(np.float32),
            "joint_pos": rng.normal(size=prefix + (T, 24, 3)).astype(np.float32)}


@pytest.mark.parametrize("prefix", [(4,), (3, 2)])
@pytest.mark.parametrize("field", ["aa", "rot_6d", "rot_mat", "root_v", "joint_pos"])
def test_apply_root_rot_matches_jax(prefix, field):
    rng = np.random.default_rng(len(prefix))
    batch = _batch(rng, prefix)
    R = np.asarray(jaug.random_rotation_matrices(jax.random.PRNGKey(1), prefix))
    ms = np.stack([rng.normal(size=579), np.abs(rng.normal(size=579)) + 0.5]).astype(np.float32)
    mean, std = ms[0][layout.ROOT_V], ms[1][layout.ROOT_V]
    ref = jaug.apply_root_rot({field: jnp.asarray(batch[field])}, jnp.asarray(R),
                              jnp.asarray(mean), jnp.asarray(std))[field]
    got = taug.apply_root_rot({field: torch.from_numpy(batch[field])}, torch.from_numpy(R.copy()),
                              torch.from_numpy(mean), torch.from_numpy(std))[field]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=4 * TOL)
    if field != "root_v":  # only the root joint moves
        joints = -3 if field == "rot_mat" else -2
        np.testing.assert_array_equal(np.delete(got.numpy(), 0, joints),
                                      np.delete(batch[field], 0, joints))


def test_augment_matches_jax_given_the_same_rotations(monkeypatch):
    """make_root_rot_augment end to end (the stats' zero std read as 1),
    with JAX's draw injected on both sides."""
    rng = np.random.default_rng(5)
    batch = _batch(rng, (2, 3))
    ms = np.stack([rng.normal(size=579), np.abs(rng.normal(size=579))]).astype(np.float32)
    ms[1][layout.ROOT_V][1] = 0.0
    key = jax.random.PRNGKey(3)
    R = np.asarray(jaug.random_rotation_matrices(key, (2, 3)))
    ref = jaug.make_root_rot_augment(ms)({k: jnp.asarray(v) for k, v in batch.items()}, key)
    monkeypatch.setattr(taug, "random_rotation_matrices",
                        lambda gen, shape, device="cpu": torch.from_numpy(R))
    got = taug.make_root_rot_augment(ms, 91)({k: torch.from_numpy(v) for k, v in batch.items()},
                                             7)
    for k in batch:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=4 * TOL,
                                   err_msg=k)


def test_draws_are_rotations():
    R = taug.random_rotation_matrices(taug.aug_generator(91, 0), (64, 8)).double()
    eye = R @ R.transpose(-1, -2)
    assert R.shape == (64, 8, 3, 3)
    assert torch.allclose(eye, torch.eye(3, dtype=torch.float64).expand_as(eye), atol=1e-6)
    assert torch.allclose(torch.linalg.det(R), torch.ones(64, 8, dtype=torch.float64),
                          atol=1e-6)
    # uniform on SO(3): E[R] = 0
    assert R.mean((0, 1)).abs().max() < 0.1


def test_stream_is_keyed_by_the_step():
    """The same (seed, step) draws the same rotations whatever came before,
    so a resumed run replays the augmentation of an uninterrupted one."""
    aug = taug.make_root_rot_augment(None, 91)
    b = {"rot_6d": torch.randn(4, 5, 24, 6, generator=torch.Generator().manual_seed(0))}
    run = [aug(b, s)["rot_6d"] for s in range(5)]
    resumed = [aug(b, s)["rot_6d"] for s in range(3, 5)]
    assert torch.equal(run[3], resumed[0]) and torch.equal(run[4], resumed[1])
    assert not torch.equal(run[3], run[4])
    other = taug.make_root_rot_augment(None, 92)(b, 3)["rot_6d"]
    assert not torch.equal(run[3], other)


def test_root_v_needs_the_stats():
    aug = taug.make_root_rot_augment(None, 91)
    with pytest.raises(ValueError, match="mean/std"):
        aug({"aa": torch.zeros(2, 3, 24, 3), "root_v": torch.zeros(2, 3, 3)}, 0)
