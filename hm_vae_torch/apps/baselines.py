"""SLERP / LERP interpolation baselines (host-side scipy and numpy, eval only).

The port's own copy of ``hm_vae_tpu.apps.baselines``.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R, Slerp


def slerp_rotations(rot_data: np.ndarray, temporal_mask: np.ndarray) -> np.ndarray:
    """Spherical interpolation of per-joint rotations (T, J, 3, 3) between
    the keyframes of ``temporal_mask`` (T,) (1 = keyframe); the final frame
    is always a keyframe, so the interpolation covers [0, T-1]."""
    T, J = rot_data.shape[:2]
    key_idx = np.nonzero(temporal_mask)[0]
    if key_idx[-1] != T - 1:
        key_idx = np.concatenate([key_idx, [T - 1]])
    times = np.arange(T)
    out = np.empty_like(rot_data)
    for j in range(J):
        out[:, j] = Slerp(key_idx, R.from_matrix(rot_data[key_idx, j]))(times).as_matrix()
    return out.astype(rot_data.dtype)


def lerp_root_trajectory(root_trans: np.ndarray, temporal_mask: np.ndarray) -> np.ndarray:
    """Linear interpolation of the (T, 3) root trajectory at keyframes."""
    T = root_trans.shape[0]
    key_idx = np.nonzero(temporal_mask)[0]
    times = np.arange(T)
    out = np.empty_like(root_trans)
    for d in range(root_trans.shape[1]):
        out[:, d] = np.interp(times, key_idx, root_trans[key_idx, d])
    return out
