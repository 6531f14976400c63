"""Host-side data pipeline: window sampling, normalisation, augmentation.

A numpy copy of ``hm_vae_tpu.data.dataset`` (``MotionDataset``,
``EvalMotionDataset``, ``PrefetchIterator``, ``make_loaders``): sequences are memory-resident numpy
arrays, a batch is a dict keyed by :data:`layout.BATCH_FIELDS`, augmentations
are vectorised per batch, and a background thread assembles the next
batches while the device computes.

With ``use_native_loader`` (the default) and no augmentation on the host,
``make_loaders`` samples the train split with the native C++ sampler
(:mod:`.native_loader`), as the JAX package does; a failed build of the
sampler raises (the JAX package falls back to numpy with a warning).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..utils.config import Config
from . import layout

FPS_AUG_STRIDES = (1, 2, 3, 4, 5, 6, 8, 10, 12)


def random_rotation_matrices(rng: np.random.Generator, n: int) -> np.ndarray:
    """Uniform random rotations, Graphics-Gems method, vectorised."""
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(0, 2, n)
    r = np.sqrt(z)
    V = np.stack([np.sin(phi) * r, np.cos(phi) * r, np.sqrt(2.0 - z)], axis=1)
    st, ct = np.sin(theta), np.cos(theta)
    Rz = np.zeros((n, 3, 3))
    Rz[:, 0, 0], Rz[:, 0, 1] = ct, st
    Rz[:, 1, 0], Rz[:, 1, 1] = -st, ct
    Rz[:, 2, 2] = 1.0
    H = np.einsum("ni,nj->nij", V, V) - np.eye(3)
    return (H @ Rz).astype(np.float32)


class MotionDataset:
    """In-memory sequence store + batch sampler."""

    def __init__(self, seq_dir: str, index_json: str, mean_std: np.ndarray,
                 train_seq_len: int, fps_aug: bool = False, random_root_rot: bool = False,
                 seed: int = 0):
        with open(index_json) as f:
            ids = json.load(f)
        self.names = [ids[k] for k in sorted(ids, key=int)]
        self.seqs: List[np.ndarray] = [
            np.load(os.path.join(seq_dir, n)).astype(np.float32) for n in self.names]
        self.mean = mean_std[0]
        self.std = np.where(mean_std[1] == 0, 1.0, mean_std[1])
        self.train_seq_len = train_seq_len
        self.fps_aug = fps_aug
        self.random_root_rot = random_root_rot
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.seqs)

    def _sample_window(self, idx: int, rng=None) -> np.ndarray:
        """(T_win, 579) raw window with fps augmentation and retries."""
        rng = self.rng if rng is None else rng
        L = self.train_seq_len
        for _ in range(20):
            seq = self.seqs[idx]
            if self.fps_aug:
                for _ in range(10):
                    stride = int(rng.choice(FPS_AUG_STRIDES))
                    cand = seq[::stride]
                    if cand.shape[0] >= L:
                        seq = cand
                        break
            if seq.shape[0] >= L:
                t0 = int(rng.integers(0, seq.shape[0] - L + 1))
                return seq[t0: t0 + L]
            idx = int(rng.integers(0, len(self.seqs)))
        raise ValueError("no sequence long enough for train_seq_len")

    def sample_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        idxs = self.rng.integers(0, len(self.seqs), batch_size)
        raw = np.stack([self._sample_window(int(i)) for i in idxs])  # (B,T,579)
        return self._finalize(raw)

    def _finalize(self, raw: np.ndarray) -> Dict[str, np.ndarray]:
        B, T, _ = raw.shape
        norm = (raw - self.mean) / self.std
        batch = {
            "rot_6d": raw[..., layout.ROT6D].reshape(B, T, 24, 6),
            "rot_mat": raw[..., layout.ROTMAT].reshape(B, T, 24, 3, 3),
            "rot_pos": raw[..., layout.COORD].reshape(B, T, 24, 3),
            "joint_pos": norm[..., layout.COORD].reshape(B, T, 24, 3),
            "linear_v": norm[..., layout.LINEAR_V].reshape(B, T, 24, 3),
            "angular_v": norm[..., layout.ANGULAR_V].reshape(B, T, 24, 3),
            "root_v": norm[..., layout.ROOT_V],
        }
        if self.random_root_rot:
            self._augment_root_rot(batch, raw)
        return batch

    def _augment_root_rot(self, batch: Dict[str, np.ndarray], raw: np.ndarray):
        """Random global orientation: a per-sample uniform rotation onto the
        root joint's rotation and the root velocity, 6D rebuilt from the
        rotated matrices."""
        R = random_rotation_matrices(self.rng, raw.shape[0])  # (B,3,3)
        rot_mat = batch["rot_mat"].copy()
        rot_mat[:, :, 0] = np.einsum("bij,btjk->btik", R, rot_mat[:, :, 0])
        batch["rot_mat"] = rot_mat
        batch["rot_6d"] = np.concatenate((rot_mat[..., :, 0], rot_mat[..., :, 1]), axis=-1)
        aug_root_v = np.einsum("bij,btj->bti", R, raw[..., layout.ROOT_V])
        batch["root_v"] = ((aug_root_v - self.mean[layout.ROOT_V])
                           / self.std[layout.ROOT_V])

    def iter_batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.sample_batch(batch_size)

    def ordered_batches(self, batch_size: int, max_batches: int = 50,
                        seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Deterministic validation batches: sequences in index order, windows
        from a fresh per-call rng, augmentation off, so every pass of every
        run evaluates the same windows."""
        rng = np.random.default_rng(seed)
        n = len(self.seqs)
        total = min(max_batches * batch_size, max(n, batch_size))
        for b0 in range(0, total - batch_size + 1, batch_size):
            fps, self.fps_aug = self.fps_aug, False
            aug, self.random_root_rot = self.random_root_rot, False
            try:
                raw = np.stack([self._sample_window((b0 + j) % n, rng)
                                for j in range(batch_size)])
                yield self._finalize(raw)
            finally:
                self.fps_aug = fps
                self.random_root_rot = aug


class EvalMotionDataset:
    """Full-sequence eval loader with per-joint visibility masks: unnormalised
    rot6d / rotmat / positions, their masked copies and the (T, 24) mask.

    ``mask_dir``: a folder of precomputed per-frame (T, 24) mask npys named
    like the sequences; otherwise ``missing='random'`` draws masks with
    ``missing_joint_prob`` from this instance's seed, and ``'upper'`` /
    ``'lower'`` hide those joints.
    """

    UPPER_JOINTS = (0, 3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23)
    LOWER_JOINTS = (1, 2, 4, 5, 7, 8, 10, 11)

    def __init__(self, seq_dir: str, index_json: str, missing: str = "none",
                 missing_joint_prob: float = 0.0, mask_dir: Optional[str] = None,
                 seed: int = 0):
        with open(index_json) as f:
            ids = json.load(f)
        self.names = [ids[k] for k in sorted(ids, key=int)]
        self.seq_dir = seq_dir
        self.missing = missing
        self.missing_joint_prob = missing_joint_prob
        self.mask_dir = mask_dir
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        seq = np.load(os.path.join(self.seq_dir, self.names[i])).astype(np.float32)
        T = seq.shape[0]
        rot6d = seq[:, layout.ROT6D].reshape(T, 24, 6)
        rotmat = seq[:, layout.ROTMAT].reshape(T, 24, 3, 3)
        pos = seq[:, layout.COORD].reshape(T, 24, 3)
        mask = np.ones((T, 24), dtype=np.float32)
        if self.missing == "upper":
            mask[:, list(self.UPPER_JOINTS)] = 0.0
        elif self.missing == "lower":
            mask[:, list(self.LOWER_JOINTS)] = 0.0
        elif self.mask_dir is not None:
            mask = np.load(os.path.join(self.mask_dir, self.names[i])).astype(np.float32)[:T]
        elif self.missing == "random":
            mask = (self.rng.random((T, 24)) >= self.missing_joint_prob).astype(np.float32)
        return {"name": self.names[i], "rot_6d": rot6d, "rot_mat": rotmat, "rot_pos": pos,
                "masked_6d": rot6d * mask[..., None], "masked_rot": rotmat * mask[..., None, None],
                "masked_pos": pos * mask[..., None], "mask": mask,
                "root_v": seq[:, layout.ROOT_V]}


class PrefetchIterator:
    """Background-thread prefetch of host batches (bounded queue)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()


def resolve_split_json(cfg: Config, split: str, data_dir: Optional[str] = None) -> str:
    """The ``split`` manifest: ``DataConfig.{split}_json`` as a path (as
    given, then relative to the data dir), else the prep-generated
    ``{split}.json``.  An explicitly configured manifest that does not
    exist raises.  ``"reference"`` selects the vendored historical manifest
    (:func:`~hm_vae_torch.data.layout.reference_split_path`)."""
    d = data_dir or cfg.data.data_root
    field = getattr(cfg.data, f"{split}_json", "")
    if field == "reference":
        return layout.reference_split_path(split)
    candidates = (field, os.path.join(d, field)) if field else ()
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    default = type(cfg.data).__dataclass_fields__[f"{split}_json"].default
    if field and field != default:
        raise FileNotFoundError(
            f"configured data.{split}_json does not exist (tried {list(candidates)})")
    return os.path.join(d, f"{split}.json")


def make_loaders(cfg: Config, data_dir: Optional[str] = None):
    """(train, val, test) datasets from a processed or synthetic data dir:
    the train split a :class:`~.native_loader.NativeMotionLoader` under
    ``use_native_loader`` without host augmentation, else a
    :class:`MotionDataset` as val and test are.  With ``cfg.data.synthetic``
    (or no train manifest) a synthetic dataset is generated there from
    ``cfg.run.seed`` first.

    Under several ranks (:mod:`..parallel.multihost`) the data root is
    shared: the primary rank generates synthetic data while the others wait
    at a barrier; each rank's train sampler draws from its own stream
    (``process_seed``: windows are drawn iid, so distinct streams are the
    data partition) keyed by its data index (the model ranks of one data row
    under ``run.model_parallel`` draw the same windows), and val and test keep the base seeds, so that every
    rank enumerates the same ordered windows (the Trainer takes its rows of
    them)."""
    import torch.distributed as dist

    from ..parallel import multihost as mh
    from . import synthetic

    d = data_dir or cfg.data.data_root
    if cfg.data.synthetic or not os.path.exists(resolve_split_json(cfg, "train", d)):
        os.makedirs(d, exist_ok=True)
        if not os.path.exists(os.path.join(d, "train.json")):
            if mh.is_primary():
                synthetic.generate_dataset(d, num_seqs=cfg.data.synthetic_num_seqs,
                                           seed=cfg.run.seed)
            if mh.process_count() > 1:
                dist.barrier()
    seq_dir = os.path.join(d, "seqs")
    ms_path = os.path.join(d, "mean_std.npy")
    mean_std = (np.load(ms_path).astype(np.float32) if os.path.exists(ms_path)
                else layout.load_mean_std(cfg.data.mean_std_path))
    mean_std[1, mean_std[1] == 0] = 1.0
    # with device_augment (the default) the Trainer rotates the root on the
    # device (data/device_aug.py), so the host samplers stay unaugmented and
    # the native sampler serves the train split; device_augment: false keeps
    # the rotation in the numpy sampler
    host_aug = cfg.data.random_root_rot_flag and not cfg.data.device_augment

    def mk(split, seed):
        return MotionDataset(seq_dir, resolve_split_json(cfg, split, d), mean_std,
                             cfg.model.train_seq_len, fps_aug=cfg.data.fps_aug_flag,
                             random_root_rot=host_aug, seed=seed)

    mp = cfg.run.model_parallel
    train_seed = mh.process_seed(cfg.run.seed, mh.data_index(mp), mh.data_count(mp))
    if cfg.data.use_native_loader and not host_aug:
        from .native_loader import NativeMotionLoader

        train = NativeMotionLoader(seq_dir, resolve_split_json(cfg, "train", d), mean_std,
                                   cfg.model.train_seq_len, fps_aug=cfg.data.fps_aug_flag,
                                   seed=train_seed)
    else:
        train = mk("train", train_seed)
    return train, mk("val", cfg.run.seed + 1), mk("test", cfg.run.seed + 2)
