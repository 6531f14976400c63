"""SMPL body model (linear blend skinning) for mesh export and mesh metrics.

Port of ``hm_vae_tpu.utils.smpl``.  The reference's ``save_mesh_obj``
(``utils_common.py:592-690``) drives VIBE's SMPL wrapper around the licensed
SMPL body model to turn rotation matrices + root translation into per-frame
``.obj`` meshes.  The model files are licensed and not vendored: a
**user-provided** SMPL npz plugs in here.

Required arrays in the npz (standard SMPL layout, names as in the official
release):
  v_template    (V, 3)        template vertices
  shapedirs     (V, 3, n_b)   shape blendshapes
  posedirs      (V, 3, 9*(J-1)) pose-corrective blendshapes (optional)
  J_regressor   (J, V)        joint regressor
  weights       (V, J)        skinning weights
  kintree_table (2, J) or parents (J,)  kinematic tree
  f / faces     (F, 3)        triangle faces

:class:`SMPLBodyModel` holds them as float64 buffers on its device (the card
unless told otherwise) and runs the forward pass there in float64, as the
JAX package computes in float64, returning float32: the blend shapes and
the skinning as batched products over all frames, the kinematic chain as a
loop over the joints.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from .device import resolve_device


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float64) if not torch.is_tensor(a) else a,
                           dtype=torch.float64, device=device)


class SMPLBodyModel(nn.Module):
    """A user-provided SMPL npz as buffers on ``device``, and its LBS forward."""

    def __init__(self, model_path: str, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        blob = np.load(model_path, allow_pickle=True)
        get = lambda *names: next(  # noqa: E731
            (np.asarray(blob[n], np.float64) for n in names if n in blob), None)
        arrays = {n: get(n) for n in ("v_template", "shapedirs", "J_regressor", "weights")}
        faces = next((np.asarray(blob[n]) for n in ("f", "faces") if n in blob), None)
        if any(a is None for a in arrays.values()) or faces is None:
            raise ValueError(f"{model_path} is missing required SMPL arrays "
                             "(v_template/shapedirs/J_regressor/weights/f)")
        self.faces = faces.astype(np.int64)
        if "parents" in blob:
            parents = np.asarray(blob["parents"], np.int64)
        else:
            parents = np.asarray(blob["kintree_table"], np.int64)[0].copy()
        parents[0] = -1
        self.parents = tuple(int(p) for p in parents)
        self.n_joints, self.n_verts = arrays["J_regressor"].shape[0], arrays["v_template"].shape[0]
        for name, a in arrays.items():
            self.register_buffer(name, _f64(a, device))
        posedirs = get("posedirs")
        # (9(J-1), V*3): the pose correctives as one product over all frames
        self.register_buffer("posedirs", None if posedirs is None or not posedirs.size else
                             _f64(posedirs.reshape(self.n_verts * 3, -1).T.copy(), device))

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def _betas(self, betas) -> torch.Tensor:
        if betas is None:
            return torch.zeros(self.shapedirs.shape[-1], dtype=torch.float64, device=self.device)
        return _f64(betas, self.device)

    def joints_of(self, betas=None) -> torch.Tensor:
        """The rest joints (J, 3) of a shape, float32."""
        return (self.J_regressor @ (self.v_template + self.shapedirs @ self._betas(betas))).float()

    @torch.no_grad()
    def forward(self, rotmats, transl=None, betas=None) -> torch.Tensor:
        """(T, J, 3, 3) rotations [+ (T, 3) translation, (n_b,) betas] ->
        (T, V, 3) vertices, float32 on the model's device (the SMPL paper's
        and smplx's semantics: the reference wrapper's ``pose2rot=False``)."""
        R = _f64(rotmats, self.device)
        T, J = R.shape[0], self.n_joints
        v_shaped = self.v_template + self.shapedirs @ self._betas(betas)  # (V, 3)
        joints = self.J_regressor @ v_shaped  # (J, 3)
        v_posed = v_shaped.expand(T, -1, -1)
        if self.posedirs is not None:
            eye = torch.eye(3, dtype=torch.float64, device=self.device)
            pose_feat = (R[:, 1:] - eye).reshape(T, -1)  # (T, 9(J-1))
            v_posed = v_posed + (pose_feat @ self.posedirs).reshape(T, self.n_verts, 3)

        # the kinematic chain: G_j = G_parent(j) [R_j | joints_j - joints_parent]
        rel = joints.clone()
        rel[1:] -= joints[list(self.parents[1:])]
        local = torch.zeros((T, J, 4, 4), dtype=torch.float64, device=self.device)
        local[:, :, :3, :3] = R
        local[:, :, :3, 3] = rel
        local[:, :, 3, 3] = 1.0
        G = [local[:, 0]]
        for j in range(1, J):
            G.append(G[self.parents[j]] @ local[:, j])
        G = torch.stack(G, dim=1)[:, :, :3]  # (T, J, 3, 4): the last row is (0 0 0 1)

        # remove the rest-pose joint location: G_k' = G_k - pack(G_k j_k)
        G = torch.cat((G[..., :3], G[..., 3:] - G[..., :3] @ joints[:, :, None]), dim=-1)
        # skinning: per-vertex blend of the joints' transforms, one product
        A = (self.weights @ G.reshape(T, J, 12)).reshape(T, self.n_verts, 3, 4)
        verts = (A[..., :3] @ v_posed[..., None])[..., 0] + A[..., 3]
        if transl is not None:
            verts = verts + _f64(transl, self.device)[:, None, :]
        return verts.float()


def write_obj(vertices: np.ndarray, faces: np.ndarray, path: str) -> None:
    """Plain .obj writer (write_obj_file, utils_common.py:582-590)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("".join("v %.6f %.6f %.6f\n" % tuple(v) for v in np.asarray(vertices).tolist()))
        f.write("".join("f %d %d %d\n" % (a + 1, b + 1, c + 1)
                        for a, b, c in np.asarray(faces).tolist()))


def export_mesh_sequence(out_folder: str, rot_mat, root_trans, model: SMPLBodyModel,
                         temporal_mask: Optional[np.ndarray] = None, betas=None) -> str:
    """Per-frame SMPL .obj export with the reference's folder layout
    (``utils_common.py:592-690``): ``our_wo_root_objs/%05d.obj`` for every
    frame, ``k_objs/%05d_k.obj`` for mask==1 keyframes, and the temporal mask
    npy under ``mask/``.  Returns the frames' folder."""
    verts = model(rot_mat, transl=root_trans, betas=betas).cpu().numpy()
    obj_dir = os.path.join(out_folder, "our_wo_root_objs")
    os.makedirs(obj_dir, exist_ok=True)
    k_dir = os.path.join(out_folder, "k_objs")
    if temporal_mask is not None:
        os.makedirs(k_dir, exist_ok=True)
    for t in range(verts.shape[0]):
        write_obj(verts[t], model.faces, os.path.join(obj_dir, f"{t:05d}.obj"))
        if temporal_mask is not None and temporal_mask[t] == 1:
            write_obj(verts[t], model.faces, os.path.join(k_dir, f"{t:05d}_k.obj"))
    if temporal_mask is not None:
        mask_dir = os.path.join(out_folder, "mask")
        os.makedirs(mask_dir, exist_ok=True)
        np.save(os.path.join(mask_dir, "temporal_mask.npy"), np.asarray(temporal_mask))
    return obj_dir
