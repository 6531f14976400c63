"""Evaluation metrics: MPJPE, PA-MPJPE, acceleration, trajectory errors.

Port of ``hm_vae_tpu.apps.metrics`` as torch functions (batched; numpy
inputs are taken as tensors); the mesh metrics pose the SMPL body model of
``utils/smpl.py`` on its device.
"""

from __future__ import annotations

import torch


def _t(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.as_tensor(a)


def mpjpe(pred, gt) -> torch.Tensor:
    """Mean per-joint position error: (..., J, 3) -> scalar (same units)."""
    return torch.linalg.vector_norm(_t(pred) - _t(gt), dim=-1).mean()


def pa_mpjpe(pred, gt) -> torch.Tensor:
    """Procrustes-aligned MPJPE of (B, J, 3): the optimal similarity
    transform per sample (Umeyama), then MPJPE."""
    pred, gt = _t(pred), _t(gt)
    mu_p = pred.mean(dim=-2, keepdim=True)
    mu_g = gt.mean(dim=-2, keepdim=True)
    X, Y = pred - mu_p, gt - mu_g
    C = torch.einsum("bji,bjk->bik", Y, X)  # covariance (B, 3, 3)
    U, s, Vt = torch.linalg.svd(C)
    det = torch.linalg.det(U @ Vt)  # reflection fix
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    Rm = torch.einsum("bij,bj,bjk->bik", U, D, Vt)
    var_x = (X ** 2).sum(dim=(-1, -2))
    scale = (s[..., :2].sum(dim=-1) + s[..., 2] * det) / var_x.clamp_min(1e-8)
    aligned = scale[:, None, None] * torch.einsum("bij,bkj->bki", Rm, X) + mu_g
    return torch.linalg.vector_norm(aligned - gt, dim=-1).mean()


def trajectory_ade(pred_trans, gt_trans) -> torch.Tensor:
    """Average displacement error of (..., T, 3) root trajectories."""
    return torch.linalg.vector_norm(_t(pred_trans) - _t(gt_trans), dim=-1).mean()


def trajectory_fde(pred_trans, gt_trans) -> torch.Tensor:
    """Final displacement error: the distance at the last step."""
    return torch.linalg.vector_norm(_t(pred_trans)[..., -1, :] - _t(gt_trans)[..., -1, :],
                                    dim=-1).mean()


def vertex_error(pred_verts, gt_verts) -> torch.Tensor:
    """Mean per-vertex position error over (..., V, 3) mesh vertices: the
    mesh-space analogue of :func:`mpjpe` (VIBE's ``compute_error_verts``)."""
    return torch.linalg.vector_norm(_t(pred_verts) - _t(gt_verts), dim=-1).mean()


def vertex_error_from_rotmats(smpl_model, pred_rotmat, gt_rotmat, pred_transl=None,
                              gt_transl=None) -> float:
    """Pose ``smpl_model`` (a :class:`~hm_vae_torch.utils.smpl.SMPLBodyModel`,
    on its device) with both (T, 24, 3, 3) rotation sets and compare the
    meshes; a Python float."""
    return float(vertex_error(smpl_model(pred_rotmat, transl=pred_transl),
                              smpl_model(gt_rotmat, transl=gt_transl)))


def accel(joints) -> torch.Tensor:
    """Mean acceleration magnitude of (T, J, 3) joints."""
    j = _t(joints)
    return torch.linalg.vector_norm(j[2:] - 2 * j[1:-1] + j[:-2], dim=-1).mean()


def accel_error(pred, gt) -> torch.Tensor:
    """Mean acceleration error between (T, J, 3) trajectories."""
    p, g = _t(pred), _t(gt)
    ap = p[2:] - 2 * p[1:-1] + p[:-2]
    ag = g[2:] - 2 * g[1:-1] + g[:-2]
    return torch.linalg.vector_norm(ap - ag, dim=-1).mean()
