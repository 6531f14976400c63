"""Host-side visualization: 3D skeleton animations, static frames, OBJ export.

Port of ``hm_vae_tpu.utils.viz`` (the drawing is the same code):
functional parity with ``show3Dpose_animation[_multiple|_with_mask]``
(``utils_common.py:200-500``): renders (K, T, 24, 3) pose sequences as an
animation (mp4 if ffmpeg is available, else gif via pillow), with optional
per-joint visibility masks drawn in a distinct colour.  matplotlib is
imported inside the drawing functions: where it is missing they raise its
``ImportError``.  ``save_skeleton_obj`` exports the stick figure;
``save_mesh_obj`` (``utils_common.py:592-690``) poses a user-provided SMPL
body model (``utils/smpl.py``; the model files are licensed and not
vendored).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# SMPL-24 bone connections (utils_common.py:56-58)
CONNECTIONS = [
    (0, 1), (0, 2), (0, 3), (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9),
    (7, 10), (8, 11), (9, 12), (9, 13), (9, 14), (12, 15), (13, 16), (14, 17),
    (16, 18), (17, 19), (18, 20), (19, 21), (20, 22), (21, 23),
]
LEFT_BONES = np.array(
    [0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 1, 0, 1],
    dtype=bool,
)


def _draw_pose(ax, pose: np.ndarray, mask: Optional[np.ndarray], radius: float):
    lcolor, rcolor = "#E76F51", "#F4A261"
    for bi, (i, j) in enumerate(CONNECTIONS):
        xs, ys, zs = [np.array([pose[i, c], pose[j, c]]) for c in range(3)]
        ax.plot(xs, ys, zs, lw=2, c=lcolor if LEFT_BONES[bi] else rcolor)
    if mask is None:
        ax.scatter(pose[:, 0], pose[:, 1], pose[:, 2], marker="o", s=8)
    else:
        vis = mask > 0
        ax.scatter(pose[vis, 0], pose[vis, 1], pose[vis, 2], marker="o", s=8)
        ax.scatter(pose[~vis, 0], pose[~vis, 1], pose[~vis, 2],
                   c="#FF0000", marker="o", s=8)
    root = pose[0]
    ax.set_xlim3d([-radius + root[0], radius + root[0]])
    ax.set_ylim3d([-radius + root[1], radius + root[1]])
    ax.set_zlim3d([-radius + root[2], radius + root[2]])
    ax.set_axis_off()


def save_animation(
    seqs: np.ndarray,
    dest_path: str,
    mask: Optional[np.ndarray] = None,
    fps: int = 30,
    radius: float = 1.0,
    elev: float = 0.0,
    azim: float = 120.0,
) -> str:
    """Render (K, T, 24, 3) sequences side by side to mp4/gif.

    Returns the written path (extension may change based on codec support).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, FFMpegWriter, PillowWriter

    seqs = np.asarray(seqs)
    if seqs.ndim == 3:
        seqs = seqs[None]
    K, T = seqs.shape[:2]

    fig = plt.figure(figsize=(6 * K, 6))
    axes = [fig.add_subplot(1, K, k + 1, projection="3d") for k in range(K)]
    for ax in axes:
        ax.view_init(elev=elev, azim=azim)

    def update(t):
        for k, ax in enumerate(axes):
            ax.cla()
            ax.view_init(elev=elev, azim=azim)
            m = mask[t] if mask is not None else None
            _draw_pose(ax, seqs[k, t], m, radius)
        return axes

    anim = FuncAnimation(fig, update, frames=T, interval=1000 // fps)
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    try:
        anim.save(dest_path, writer=FFMpegWriter(fps=fps))
    except Exception:
        dest_path = os.path.splitext(dest_path)[0] + ".gif"
        anim.save(dest_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return dest_path


def save_frame(pose: np.ndarray, dest_path: str,
               mask: Optional[np.ndarray] = None, radius: float = 1.0) -> str:
    """Render a single (24, 3) pose to an image (vis_single_frame parity)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.view_init(elev=0, azim=120)
    _draw_pose(ax, np.asarray(pose), mask, radius)
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    fig.savefig(dest_path)
    plt.close(fig)
    return dest_path


def save_skeleton_obj(pose: np.ndarray, dest_path: str,
                      bone_radius: float = 0.01) -> str:
    """Export a (24, 3) pose as a wavefront OBJ stick figure.

    Each bone becomes a thin 4-sided prism; joints become vertices.  This is
    the mesh-free stand-in for the reference's SMPL ``save_mesh_obj``
    (``utils_common.py:592-690``), which needs the non-redistributable SMPL
    model files.
    """
    pose = np.asarray(pose)
    verts = []
    faces = []
    for (i, j) in CONNECTIONS:
        a, b = pose[i], pose[j]
        d = b - a
        n = np.linalg.norm(d)
        if n < 1e-8:
            continue
        d = d / n
        # build two perpendicular vectors
        up = np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        u = np.cross(d, up)
        u /= np.linalg.norm(u)
        v = np.cross(d, u)
        base = len(verts)
        for p in (a, b):
            for s in (u + v, u - v, -u - v, -u + v):
                verts.append(p + bone_radius * s)
        quads = [
            (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7),
            (0, 3, 2, 1), (4, 5, 6, 7),
        ]
        for q in quads:
            faces.append(tuple(base + k + 1 for k in q))  # OBJ is 1-indexed
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    with open(dest_path, "w") as f:
        for vtx in verts:
            f.write(f"v {vtx[0]:.6f} {vtx[1]:.6f} {vtx[2]:.6f}\n")
        for fc in faces:
            f.write("f " + " ".join(str(i) for i in fc) + "\n")
    return dest_path


def save_mesh_obj(out_folder, rot_mat, root_trans, temporal_mask=None,
                  smpl_model_path=None, betas=None, device="cuda"):
    """SMPL mesh export parity with ``utils_common.py:592-690``: one .obj a
    frame (``export_mesh_sequence``'s layout), posed on ``device``.

    Needs a user-provided SMPL body model npz (the official files are
    licensed and not vendored): pass ``smpl_model_path`` or set
    ``HM_VAE_SMPL_MODEL``.  Without one, raises with a pointer to
    ``save_skeleton_obj`` (the model-free export).
    """
    from .smpl import SMPLBodyModel, export_mesh_sequence

    path = smpl_model_path or os.environ.get("HM_VAE_SMPL_MODEL")
    if not path:
        raise ValueError(
            "SMPL mesh export needs the SMPL body model file (licensed, not vendored). "
            "Pass smpl_model_path= / set HM_VAE_SMPL_MODEL to a local SMPL npz, or use "
            "save_skeleton_obj for a model-free export.")
    return export_mesh_sequence(out_folder, rot_mat, root_trans,
                                SMPLBodyModel(path, device=device),
                                temporal_mask=temporal_mask, betas=betas)
