"""Rotation-representation transforms (6D <-> matrix, axis-angle -> matrix).

Port of ``hm_vae_tpu.ops.rotations``; batch-shape agnostic.  Conventions:

- the 6D representation is the first two columns of the rotation matrix,
  flattened ``[col0(3), col1(3)]``;
- 6D -> matrix is Gram-Schmidt with x = norm(a), z = norm(x × b), y = z × x,
  columns (x, y, z);
- axis-angle -> matrix is Rodrigues with a first-order branch near angle 0.

The JAX package writes 3x3 products as elementwise sums for the TPU's vector
unit; here they are plain ``torch.linalg.cross`` and ``@``.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def normalize(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """``v / max(||v||, eps)`` along the last axis."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(eps)


def rot6d_to_rotmat(poses: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3)."""
    x = normalize(poses[..., 0:3])
    z = normalize(torch.linalg.cross(x, poses[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack((x, y, z), dim=-1)


def rotmat_to_rot6d(rotmat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): first two columns flattened."""
    return torch.cat((rotmat[..., :, 0], rotmat[..., :, 1]), dim=-1)


def rot6d_ours_to_vibe(poses: torch.Tensor) -> torch.Tensor:
    """Our 6D (two stacked columns) -> VIBE's layout (a (3, 2) matrix read
    row-major): a transpose of the 2x3 block."""
    two_cols = poses.reshape(poses.shape[:-1] + (2, 3))
    return two_cols.transpose(-1, -2).reshape(poses.shape)


def aa_to_rotmat(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) via Rodrigues,
    ``R = cos I + (1-cos) a a^T + sin [a]_x``; below an angle of 1e-4 the
    first-order ``R = I + [aa]_x``."""
    angle = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    safe_angle = angle.clamp_min(eps)
    axis = aa / safe_angle
    x, y, z = axis.unbind(-1)
    angle, safe_angle = angle[..., 0], safe_angle[..., 0]
    small = angle < 1e-4
    s = torch.where(small, safe_angle, torch.sin(angle))
    c = torch.cos(angle)
    d = torch.where(small, torch.zeros_like(c), 1.0 - c)
    cc = torch.where(small, torch.ones_like(c), c)
    xx, yy, zz = d * x * x, d * y * y, d * z * z
    xy, xz, yz = d * x * y, d * x * z, d * y * z
    sx, sy, sz = s * x, s * y, s * z
    row0 = torch.stack([cc + xx, xy - sz, xz + sy], dim=-1)
    row1 = torch.stack([xy + sz, cc + yy, yz - sx], dim=-1)
    row2 = torch.stack([xz - sy, yz + sx, cc + zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat_to_aa(rotmat: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), a robust SO(3)
    log map (the C++ sampler's sidecar computes the same):
    ``theta = atan2(|skew|, tr - 1)``, well conditioned over all of [0, pi];
    near pi the axis comes from the symmetric part
    (``a_i^2 = (R_ii - cos) / (1 - cos)``, signs fixed off the largest
    component and the skew part), elsewhere from the skew part.  Both
    branches are computed with guarded denominators and selected by
    ``torch.where``."""
    r = rotmat
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    vx = r[..., 2, 1] - r[..., 1, 2]
    vy = r[..., 0, 2] - r[..., 2, 0]
    vz = r[..., 1, 0] - r[..., 0, 1]
    vn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    theta = torch.atan2(vn, tr - 1.0)

    # skew-part axis; theta / vn -> 1/2 as theta -> 0
    k = torch.where(vn < 1e-12, torch.full_like(vn, 0.5), theta / vn.clamp_min(eps))
    aa_skew = k[..., None] * torch.stack([vx, vy, vz], dim=-1)

    # symmetric-part axis near pi
    cos_t = ((tr - 1.0) / 2.0).clamp(-1.0, 1.0)
    d = (1.0 - cos_t).clamp_min(eps)

    def sq(x):
        return torch.sqrt(x.clamp_min(0.0))

    ax = sq((r[..., 0, 0] - cos_t) / d)
    ay = sq((r[..., 1, 1] - cos_t) / d)
    az = sq((r[..., 2, 2] - cos_t) / d)
    sxy = r[..., 0, 1] + r[..., 1, 0]
    sxz = r[..., 0, 2] + r[..., 2, 0]
    syz = r[..., 1, 2] + r[..., 2, 1]
    two_d = 2.0 * d
    ay_x = sxy / (two_d * ax).clamp_min(eps)
    az_x = sxz / (two_d * ax).clamp_min(eps)
    ax_y = sxy / (two_d * ay).clamp_min(eps)
    az_y = syz / (two_d * ay).clamp_min(eps)
    ax_z = sxz / (two_d * az).clamp_min(eps)
    ay_z = syz / (two_d * az).clamp_min(eps)
    cx = (ax >= ay) & (ax >= az)
    cy = (~cx) & (ay >= az)
    axf = torch.where(cx, ax, torch.where(cy, ax_y, ax_z))
    ayf = torch.where(cx, ay_x, torch.where(cy, ay, ay_z))
    azf = torch.where(cx, az_x, torch.where(cy, az_y, az))
    flip = torch.where(vx * axf + vy * ayf + vz * azf < 0, -1.0, 1.0)
    aa_sym = (theta * flip)[..., None] * torch.stack([axf, ayf, azf], dim=-1)
    return torch.where(theta[..., None] < 3.0, aa_skew, aa_sym)
