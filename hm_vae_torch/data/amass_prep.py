"""Offline AMASS preparation: SMPL-H npz archives -> 579-dim per-frame npy.

A copy of ``hm_vae_tpu.data.amass_prep`` (numpy and scipy on the host; its
output is the JAX package's, bit for bit), after the reference's
``utils/process_all_data_motion.py``:
- SMPL 24-joint extraction from 52-joint SMPL-H poses (indices incl. the two
  index fingers 22->25, 23->40; ``:20-25``);
- optional integer-stride resampling from ``mocap_framerate`` to a target fps
  (``:103-110``);
- sequences shorter than 30 frames dropped (``:114``);
- aa -> rotmat -> 6D -> FK coords, first-difference linear/root velocities,
  579-dim concat (``:123-158``), one npy per sequence.

Also computes the train-split mean/std and the split jsons
(``utils/divide_train_val_json.py``: split *by AMASS subset*).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops import fk as fk_mod
from . import layout

# SMPL-H joint indices holding the SMPL-24 set (process_all_data_motion.py:20-25)
SMPLH_JOINTS_FOR_SMPL24 = np.array([
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 37,
])
_POSE_COLS = np.arange(0, 156).reshape((-1, 3))[SMPLH_JOINTS_FOR_SMPL24].reshape(-1)

ALL_SUBSETS = (
    "ACCAD", "BioMotionLab_NTroje", "CMU", "EKUT", "Eyes_Japan_Dataset",
    "HumanEva", "KIT", "MPI_HDM05", "MPI_Limits", "MPI_mosh", "SFU",
    "SSM_synced", "TCD_handMocap", "TotalCapture", "Transitions_mocap",
)
# split by subset (divide_train_val_json.py:6-10)
VAL_SUBSETS = ("HumanEva", "MPI_HDM05", "SFU", "MPI_mosh")
TEST_SUBSETS = ("Transitions_mocap", "SSM_synced")

MIN_SEQ_LEN = 30


def _aa_to_rotmat_np(aa: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R

    flat = aa.reshape(-1, 3)
    return R.from_rotvec(flat).as_matrix().reshape(aa.shape[:-1] + (3, 3))


def convert_sequence(
    poses: np.ndarray,
    trans: np.ndarray,
    mocap_framerate: Optional[float] = None,
    target_fps: Optional[int] = 30,
) -> Optional[np.ndarray]:
    """One raw AMASS sequence -> (T, 579) frame array (or None if too short).

    poses: (N, 156) SMPL-H axis-angle; trans: (N, 3) root translation.
    """
    pose24 = poses[:, _POSE_COLS]  # (N, 72)
    if target_fps is not None and mocap_framerate:
        stride = max(int(mocap_framerate) // target_fps, 1)
    else:
        stride = 1
    pose24 = pose24[::stride]
    trans = trans[::stride]
    T = pose24.shape[0]
    if T < MIN_SEQ_LEN:
        return None

    mats = _aa_to_rotmat_np(pose24.reshape(T, 24, 3)).astype(np.float32)
    rot6d = np.concatenate((mats[..., :, 0], mats[..., :, 1]), axis=-1)
    coords = fk_mod.fk_numpy(mats)

    linear_v = np.diff(coords, axis=0, prepend=coords[:1])
    root_v = np.diff(trans, axis=0, prepend=trans[:1]).astype(np.float32)

    frame = np.concatenate(
        [
            rot6d.reshape(T, -1),
            mats.reshape(T, -1),
            coords.reshape(T, -1),
            linear_v.reshape(T, -1),
            linear_v.reshape(T, -1),  # angular_v slot: duplicated linear_v
            root_v,
        ],
        axis=1,
    ).astype(np.float32)
    assert frame.shape[1] == layout.FRAME_DIM
    return frame


def process_amass_root(
    amass_dir: str,
    dest_dir: str,
    subsets: Sequence[str] = ALL_SUBSETS,
    target_fps: Optional[int] = 30,
    verbose: bool = True,
) -> Dict[str, List[str]]:
    """Walk ``amass_dir/<subset>/<subject>/*.npz`` and write per-sequence npys.

    Returns {split: [names]} and writes train/val/test jsons + mean_std.npy
    computed over the *train* split into ``dest_dir``.
    """
    seq_dir = os.path.join(dest_dir, "seqs")
    os.makedirs(seq_dir, exist_ok=True)
    split_names: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    sum_x = np.zeros(layout.FRAME_DIM, np.float64)
    sum_x2 = np.zeros(layout.FRAME_DIM, np.float64)
    count = 0

    for subset in subsets:
        sub_dir = os.path.join(amass_dir, subset)
        if not os.path.isdir(sub_dir):
            continue
        split = (
            "val" if subset in VAL_SUBSETS
            else "test" if subset in TEST_SUBSETS else "train"
        )
        for subject in sorted(os.listdir(sub_dir)):
            sdir = os.path.join(sub_dir, subject)
            if not os.path.isdir(sdir):
                continue
            for action in sorted(os.listdir(sdir)):
                if not action.endswith(".npz") or action.endswith("shape.npz"):
                    continue
                data = np.load(os.path.join(sdir, action))
                if "poses" not in data or "trans" not in data:
                    continue
                frame = convert_sequence(
                    data["poses"], data["trans"],
                    float(data["mocap_framerate"]) if "mocap_framerate" in data else None,
                    target_fps,
                )
                if frame is None:
                    continue
                name = f"{subset}_{subject}_{action[:-4]}.npy"
                np.save(os.path.join(seq_dir, name), frame)
                split_names[split].append(name)
                if split == "train":
                    sum_x += frame.sum(axis=0)
                    sum_x2 += (frame.astype(np.float64) ** 2).sum(axis=0)
                    count += frame.shape[0]
        if verbose:
            print(f"{subset}: -> {split}, total {sum(len(v) for v in split_names.values())} seqs")

    if count:
        mean = sum_x / count
        std = np.sqrt(np.maximum(sum_x2 / count - mean**2, 0.0))
        np.save(os.path.join(dest_dir, "mean_std.npy"),
                np.stack([mean, std]).astype(np.float32))
    for split, names in split_names.items():
        with open(os.path.join(dest_dir, f"{split}.json"), "w") as f:
            json.dump({str(i): n for i, n in enumerate(names)}, f)
    return split_names
