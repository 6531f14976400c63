"""Port's rotation, FK and skeleton-NN ops against ``hm_vae_tpu.ops`` (f32,
CPU, atol 1e-5), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_vae_tpu.ops import fk as jfk
from hm_vae_tpu.ops import rotations as jrot
from hm_vae_tpu.ops import skeleton_nn as jsnn
from hm_vae_torch.ops import fk as tfk
from hm_vae_torch.ops import rotations as trot
from hm_vae_torch.ops import skeleton_nn as tsnn

ATOL = 1e-5


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _aa(rng, shape, scale=0.8):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_rot6d_rotmat_roundtrip():
    rng = np.random.default_rng(0)
    six = rng.normal(size=(4, 5, 24, 6)).astype(np.float32)
    _close(trot.rot6d_to_rotmat(torch.from_numpy(six)), jrot.rot6d_to_rotmat(jnp.asarray(six)))
    mats = np.array(jrot.aa_to_rotmat(jnp.asarray(_aa(rng, (3, 24, 3)))))
    _close(trot.rotmat_to_rot6d(torch.from_numpy(mats)), jrot.rotmat_to_rot6d(jnp.asarray(mats)))
    _close(trot.rot6d_ours_to_vibe(torch.from_numpy(six)),
           jrot.rot6d_ours_to_vibe(jnp.asarray(six)))


def test_normalize_clamps_short_vectors():
    v = np.array([[3.0, 4.0, 0.0], [1e-8, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    _close(trot.normalize(torch.from_numpy(v)), jrot.normalize(jnp.asarray(v)))


@pytest.mark.parametrize("scale", [0.8, 3.0, 1e-5, 0.0])
def test_aa_to_rotmat(scale):
    """Includes angles below 1e-4 (the first-order branch) and exact zero."""
    rng = np.random.default_rng(1)
    aa = _aa(rng, (64, 3), scale)
    _close(trot.aa_to_rotmat(torch.from_numpy(aa)), jrot.aa_to_rotmat(jnp.asarray(aa)))


def test_fk_positions_and_global_rotations():
    rng = np.random.default_rng(2)
    mats = np.array(jrot.aa_to_rotmat(jnp.asarray(_aa(rng, (3, 7, 24, 3)))))
    offsets = rng.normal(size=(24, 3)).astype(np.float32) * 0.2
    pos, grot = tfk.fk_from_rotmat(torch.from_numpy(mats), offsets, return_global_rot=True)
    jpos, jgrot = jfk.fk_from_rotmat(jnp.asarray(mats), jnp.asarray(offsets),
                                     return_global_rot=True)
    _close(pos, jpos)
    _close(grot, jgrot)
    # pos[0] = offset[0]; default offsets are the vendored asset
    _close(pos[..., 0, :], np.broadcast_to(offsets[0], pos[..., 0, :].shape))
    np.testing.assert_array_equal(tfk.default_offsets(), jfk.default_offsets())
    assert tfk.level_schedule(tfk.SMPL24_PARENTS) == jfk.level_schedule(jfk.SMPL24_PARENTS)


@pytest.mark.parametrize("mode", ["reflect", "constant", "reflection", "zeros"])
def test_pad_temporal(mode):
    x = np.random.default_rng(3).normal(size=(2, 5, 9)).astype(np.float32)
    _close(tsnn.pad_temporal(torch.from_numpy(x), 4, mode),
           jsnn.pad_temporal(jnp.asarray(x), 4, mode))
    _close(tsnn.pad_temporal(torch.from_numpy(x), 0, mode), x)


@pytest.mark.parametrize("t_in", [1, 4, 8, 32])
def test_upsample_linear(t_in):
    x = np.random.default_rng(4).normal(size=(2, 6, t_in)).astype(np.float32)
    np.testing.assert_array_equal(tsnn.linear_upsample_matrix(t_in, 2),
                                  jsnn.linear_upsample_matrix(t_in, 2))
    _close(tsnn.upsample_linear(torch.from_numpy(x), 2), jsnn.upsample_linear(jnp.asarray(x), 2))
    if t_in > 1:  # the half-pixel convention of torch's own linear upsample
        ref = torch.nn.functional.interpolate(torch.from_numpy(x), scale_factor=2,
                                              mode="linear", align_corners=False)
        _close(tsnn.upsample_linear(torch.from_numpy(x), 2), ref.numpy())


def test_channel_matrix_conv_and_leaky():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 10)).astype(np.float32)
    m = rng.normal(size=(7, 12)).astype(np.float32)
    _close(tsnn.apply_channel_matrix(torch.from_numpy(x), torch.from_numpy(m)),
           jsnn.apply_channel_matrix(jnp.asarray(x), jnp.asarray(m)))
    w = (rng.normal(size=(8, 12, 5)) * 0.2).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    for stride in (1, 2):
        _close(tsnn.skeleton_conv_w(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), stride, 2, "reflect"),
               jsnn.skeleton_conv_w(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    stride, 2, "reflect"))
    _close(tsnn.leaky_relu(torch.from_numpy(x), 0.2), jsnn.leaky_relu(jnp.asarray(x), 0.2))
