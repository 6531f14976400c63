"""Forward kinematics over a joint tree, one batched step per tree depth.

Port of ``hm_vae_tpu.ops.fk``.  Joints are grouped by depth
(:func:`level_schedule`); each step gathers the parents' global rotations and
positions by index and applies one batched 3x3 product.  (The JAX package
selects parents with one-hot products, a TPU workaround.)

``pos[0] = offset[0]`` and ``pos[j] = pos[parent] + R_global[parent] @ offset[j]``.
"""

from __future__ import annotations

import functools
import os
from typing import List, Tuple

import numpy as np
import torch

from .topology import ASSETS_DIR, SMPL24_PARENTS


@functools.lru_cache(maxsize=None)
def level_schedule(parents: Tuple[int, ...]) -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]:
    """``(joint_indices, parent_indices)`` per tree depth, root excluded."""
    depth = [0] * len(parents)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    levels: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
    for d in range(1, max(depth) + 1):
        joints = tuple(j for j in range(len(parents)) if depth[j] == d)
        if joints:
            levels.append((joints, tuple(parents[j] for j in joints)))
    return tuple(levels)


@functools.lru_cache(maxsize=None)
def _level_index(parents: Tuple[int, ...], device: torch.device):
    """:func:`level_schedule` as index tensors on ``device``, made once (as
    normal tensors, so that they serve inside and outside inference mode)."""
    with torch.inference_mode(False):
        return tuple((torch.tensor(j, device=device), torch.tensor(p, device=device))
                     for j, p in level_schedule(parents))


@functools.lru_cache(maxsize=None)
def default_offsets() -> np.ndarray:
    """Rest-pose bone offsets (24, 3) vendored from the reference assets."""
    return np.load(os.path.join(ASSETS_DIR, "skeleton_offsets.npy")).astype(np.float32)


@functools.lru_cache(maxsize=None)
def offsets_on(device: torch.device) -> torch.Tensor:
    """:func:`default_offsets` as an f32 tensor on ``device``, made once (a
    normal tensor, as :func:`_level_index`'s), so that a step captured in a
    CUDA graph copies nothing from the host."""
    with torch.inference_mode(False):
        return torch.from_numpy(default_offsets()).to(device)


def fk_from_rotmat(
    rotmats: torch.Tensor,
    offsets,
    parents: Tuple[int, ...] = SMPL24_PARENTS,
    return_global_rot: bool = False,
):
    """(..., J, 3, 3) local rotations -> (..., J, 3) positions
    (and the (..., J, 3, 3) global rotations when asked)."""
    J = len(parents)
    off = torch.as_tensor(offsets, dtype=rotmats.dtype, device=rotmats.device)
    lead = rotmats.shape[:-3]
    r = rotmats.reshape((-1, J, 3, 3))
    g = r.clone()
    pos = off[0].expand(r.shape[0], J, 3).clone()
    for j, p in _level_index(tuple(parents), r.device):
        g_par = g[:, p]
        g[:, j] = g_par @ r[:, j]
        pos[:, j] = pos[:, p] + (g_par @ off[j].unsqueeze(-1)).squeeze(-1)
    pos = pos.reshape(lead + (J, 3))
    if return_global_rot:
        return pos, g.reshape(lead + (J, 3, 3))
    return pos


def fk_numpy(rotmats: np.ndarray, offsets: np.ndarray | None = None,
             parents: Tuple[int, ...] = SMPL24_PARENTS) -> np.ndarray:
    """Host-side numpy FK for data preparation, (..., J, 3, 3) ->
    (..., J, 3): the same level-batched steps, in the rotations' dtype."""
    if offsets is None:
        offsets = default_offsets()
    off = np.asarray(offsets, dtype=rotmats.dtype)
    J = len(parents)
    lead = rotmats.shape[:-3]
    r = rotmats.reshape((-1, J, 3, 3))
    g = np.zeros_like(r)
    g[:, 0] = r[:, 0]
    pos = np.zeros(r.shape[:-2] + (3,), dtype=r.dtype)
    pos[:, 0] = off[0]
    for joints, par in level_schedule(tuple(parents)):
        j = np.asarray(joints)
        p = np.asarray(par)
        g[:, j] = g[:, p] @ r[:, j]
        pos[:, j] = pos[:, p] + np.einsum("nlij,lj->nli", g[:, p], off[j])
    return pos.reshape(lead + (J, 3))
