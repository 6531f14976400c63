"""Random root rotation on the device, per batch.

Port of ``hm_vae_tpu.data.device_aug``: a uniform random rotation
(Graphics Gems, the reference's ``rand_rotation_matrix`` with deflection 1)
per sample, premultiplied onto the root joint's orientation and the root
velocity of a batch the native sampler left unaugmented, so that augmented
configs keep the compact wire.  Per wire field:

- ``rot_mat``: the root's matrix premultiplied by R;
- ``rot_6d``: the root's two columns rotated (the 6D rep is the first two
  matrix columns);
- ``aa``: ``log(R @ exp(aa))`` at the root;
- ``root_v``: de-standardised with the dataset stats, rotated,
  re-standardised (the wire carries it normalised).

The other fields stay as they are, as in the reference.  Everything runs as
torch ops on the batch's device, over any leading prefix ((B,) batches or
(K, B) superbatches).

The draws: ``jax.random``'s bits cannot be reproduced in torch.  Here the
uniforms come from a CPU generator keyed by (``seed``, ``step``), the step
at which the batch is consumed (the Trainer passes ``run.seed + 91`` as the
JAX Trainer keys its stream), so a resumed run replays the stream and every
device draws the same rotations.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import rotations as rot
from . import layout


def aug_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of the rotations of the batch consumed at ``step``:
    ``seed`` and ``step`` mixed into the 32 bits torch's CPU generator
    reads."""
    return torch.Generator().manual_seed((seed * 0x9E3779B1 + step) & 0xFFFFFFFF)


def random_rotation_matrices(generator: torch.Generator, shape, device="cpu") -> torch.Tensor:
    """Uniform random rotations (shape, 3, 3) on ``device``, Graphics Gems:
    R = (V V^T - I) Rz with V the random reflection vector and Rz a random
    z-rotation; the uniforms are drawn on the CPU from ``generator``."""
    shape = tuple(shape)
    u = torch.rand((3,) + shape, generator=generator)
    device = torch.device(device)
    if device.type == "cuda":
        u = u.pin_memory().to(device, non_blocking=True)
    theta = u[0] * (2.0 * math.pi)
    phi = u[1] * (2.0 * math.pi)
    z = u[2] * 2.0
    r = torch.sqrt(z)
    V = torch.stack([torch.sin(phi) * r, torch.cos(phi) * r, torch.sqrt(2.0 - z)], dim=-1)
    st, ct = torch.sin(theta), torch.cos(theta)
    zero, one = torch.zeros_like(ct), torch.ones_like(ct)
    Rz = torch.stack([torch.stack([ct, st, zero], -1), torch.stack([-st, ct, zero], -1),
                      torch.stack([zero, zero, one], -1)], dim=-2)
    H = V[..., :, None] * V[..., None, :] - torch.eye(3, device=device)
    return H @ Rz


def apply_root_rot(batch: Dict[str, torch.Tensor], R: torch.Tensor,
                   rv_mean: Optional[torch.Tensor], rv_std: Optional[torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The rotations R (prefix, 3, 3) premultiplied onto the batch's root
    quantities (fields (prefix, T, ...)); a new dict, the input untouched."""
    out = dict(batch)
    Rt = R[..., None, :, :]  # over T
    if "rot_mat" in batch:
        rm = batch["rot_mat"]
        new = rm.clone()
        new[..., 0, :, :] = Rt @ rm[..., 0, :, :]
        out["rot_mat"] = new
    if "rot_6d" in batch:
        r6 = batch["rot_6d"]
        root = r6[..., 0, :]
        c0 = (Rt @ root[..., :3, None])[..., 0]
        c1 = (Rt @ root[..., 3:, None])[..., 0]
        new = r6.clone()
        new[..., 0, :] = torch.cat([c0, c1], dim=-1)
        out["rot_6d"] = new
    if "aa" in batch:
        aa = batch["aa"]
        root_m = rot.aa_to_rotmat(aa[..., 0, :].float())
        new = aa.clone()
        new[..., 0, :] = rot.rotmat_to_aa(Rt @ root_m).to(aa.dtype)
        out["aa"] = new
    if "root_v" in batch:
        rv = batch["root_v"]
        raw = rv * rv_std + rv_mean
        out["root_v"] = ((Rt @ raw[..., None])[..., 0] - rv_mean) / rv_std
    return out


def make_root_rot_augment(mean_std: Optional[np.ndarray], seed: int):
    """``augment(batch, step) -> batch``: rotations drawn from
    :func:`aug_generator` (``seed``, ``step``) over the batch's prefix,
    applied on its device.  ``mean_std`` (2, 579) gives root_v's stats (a
    zero std read as 1); without it a batch carrying root_v raises, since
    rotating a standardised velocity would be wrong."""
    if mean_std is not None:
        ms = np.asarray(mean_std, np.float32)
        rv_mean = torch.from_numpy(ms[0][layout.ROOT_V].copy())
        std = ms[1][layout.ROOT_V].copy()
        std[std == 0] = 1.0
        rv_std = torch.from_numpy(std)
    else:
        rv_mean = rv_std = None
    on_device: Dict[torch.device, tuple] = {}

    def augment(batch: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        if "root_v" in batch and rv_mean is None:
            raise ValueError("root-rotation augmentation of a batch with root_v needs the "
                             "dataset mean/std: the wire's root_v is standardised")
        for f, ndims in (("aa", 3), ("rot_6d", 3), ("rot_mat", 4)):
            if f in batch:
                ref = batch[f]
                prefix = ref.shape[:-ndims]
                break
        else:
            raise ValueError("the batch carries no rotation field (aa / rot_6d / rot_mat)")
        dev = ref.device
        if rv_mean is not None and dev not in on_device:
            on_device[dev] = (rv_mean.to(dev), rv_std.to(dev))
        stats = on_device.get(dev, (None, None))
        R = random_rotation_matrices(aug_generator(seed, step), prefix, dev)
        return apply_root_rot(batch, R, *stats)

    return augment
