"""Synthetic motion sequences in the 579-dim AMASS layout.

A numpy copy of ``hm_vae_tpu.data.synthetic``: smooth random joint rotations
(random angular velocity integrated over time), real FK for coordinates,
frames assembled as the reference's offline converter assembles them, so the
training path sees the true layout and normalisation.  The same seed writes
the same files as the JAX package's generator.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from ..ops import fk as fk_mod
from . import layout


def _smooth_rotmats(rng: np.random.Generator, T: int, n_joints: int) -> np.ndarray:
    """Smooth random rotation trajectories via integrated axis-angle steps."""
    from scipy.spatial.transform import Rotation as R

    base = R.random(n_joints, random_state=int(rng.integers(1 << 31)))
    vel = rng.normal(scale=0.06, size=(n_joints, 3))
    mats = np.empty((T, n_joints, 3, 3), dtype=np.float32)
    cur = base
    for t in range(T):
        mats[t] = cur.as_matrix()
        vel = 0.98 * vel + rng.normal(scale=0.01, size=(n_joints, 3))
        cur = R.from_rotvec(vel) * cur
    return mats


def synth_sequence(rng: np.random.Generator, T: int) -> np.ndarray:
    """One (T, 579) sequence with FK-consistent features."""
    J = layout.N_JOINTS
    mats = _smooth_rotmats(rng, T, J)
    rot6d = np.concatenate((mats[..., :, 0], mats[..., :, 1]), axis=-1)  # (T,J,6)
    coords = fk_mod.fk_numpy(mats)
    linear_v = np.diff(coords, axis=0, prepend=coords[:1])
    root_step = rng.normal(scale=0.02, size=(T, 3)).astype(np.float32)
    root_step[0] = 0.0
    frame = np.concatenate(
        [rot6d.reshape(T, -1), mats.reshape(T, -1), coords.reshape(T, -1),
         linear_v.reshape(T, -1),
         linear_v.reshape(T, -1),  # the angular_v slot duplicates linear_v
         root_step], axis=1).astype(np.float32)
    assert frame.shape[1] == layout.FRAME_DIM
    return frame


def generate_dataset(out_dir: str, num_seqs: int = 16, min_len: int = 80,
                     max_len: int = 240, seed: int = 0, splits=(0.8, 0.1, 0.1)) -> None:
    """Write ``out_dir/seqs/*.npy``, train/val/test index jsons and
    ``mean_std.npy``: the directory contract of the processed AMASS data."""
    rng = np.random.default_rng(seed)
    seq_dir = os.path.join(out_dir, "seqs")
    os.makedirs(seq_dir, exist_ok=True)
    names: List[str] = []
    all_frames = []
    for i in range(num_seqs):
        T = int(rng.integers(min_len, max_len + 1))
        seq = synth_sequence(rng, T)
        name = f"synth_{i:04d}.npy"
        np.save(os.path.join(seq_dir, name), seq)
        names.append(name)
        all_frames.append(seq)

    frames = np.concatenate(all_frames, axis=0)
    mean_std = np.stack([frames.mean(axis=0), frames.std(axis=0)])
    np.save(os.path.join(out_dir, "mean_std.npy"), mean_std.astype(np.float32))

    n_train = max(1, int(num_seqs * splits[0]))
    n_val = max(1, int(num_seqs * splits[1]))
    split_names = {
        "train": names[:n_train],
        "val": names[n_train:n_train + n_val] or names[:1],
        "test": names[n_train + n_val:] or names[:1],
    }
    for split, lst in split_names.items():
        with open(os.path.join(out_dir, f"{split}.json"), "w") as f:
            json.dump({str(i): n for i, n in enumerate(lst)}, f)
