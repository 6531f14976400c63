"""The 579-dim per-frame feature layout and named slice constants.

A copy of ``hm_vae_tpu.data.layout``.  Layout
(``utils/process_all_data_motion.py:155-158`` of the reference):
``[24*6 rot6d | 24*9 rotmat | 24*3 coords | 24*3 linear_v | 24*3 dup linear_v
(slot reserved for angular_v) | 3 root_v]`` = 144+216+72+72+72+3 = 579.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.topology import ASSETS_DIR

N_JOINTS = 24

ROT6D_DIM = N_JOINTS * 6          # 144
ROTMAT_DIM = N_JOINTS * 9         # 216
COORD_DIM = N_JOINTS * 3          # 72
VEL_DIM = N_JOINTS * 3            # 72
ROOT_V_DIM = 3

ROT6D = slice(0, ROT6D_DIM)                                    # 0:144
ROTMAT = slice(ROT6D_DIM, ROT6D_DIM + ROTMAT_DIM)              # 144:360
COORD = slice(ROTMAT.stop, ROTMAT.stop + COORD_DIM)            # 360:432
LINEAR_V = slice(COORD.stop, COORD.stop + VEL_DIM)             # 432:504
ANGULAR_V = slice(LINEAR_V.stop, LINEAR_V.stop + VEL_DIM)      # 504:576
ROOT_V = slice(ANGULAR_V.stop, ANGULAR_V.stop + ROOT_V_DIM)    # 576:579

FRAME_DIM = ROOT_V.stop  # 579

# canonical batch field order = the reference's 7-tuple contract
BATCH_FIELDS = (
    "rot_6d", "rot_mat", "rot_pos", "joint_pos", "linear_v", "angular_v",
    "root_v",
)


def load_mean_std(path: str | None = None) -> np.ndarray:
    """(2, 579) mean/std with zero stds replaced by 1."""
    if not path:
        path = os.path.join(ASSETS_DIR, "all_amass_data_mean_std.npy")
    ms = np.load(path).astype(np.float32)
    ms[1, ms[1] == 0] = 1.0
    return ms


def reference_split_path(split: str) -> str:
    """The vendored historical split manifest of ``split``: the reference's
    literal train/val/test file inventories (10818/363/140 entries), a copy
    of the JAX package's, so that the paper-era index -> name mapping is
    reproducible.  :func:`hm_vae_torch.data.amass_prep.process_amass_root`
    applies the same split rule but walks the file system, so its order can
    differ."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"unknown split: {split!r}")
    return os.path.join(ASSETS_DIR, "splits", f"{split}_all_amass_motion_data.json")
