"""Trainer: model and optimizer state, the run loop, checkpoints, on one device.

Port of ``hm_vae_tpu.train.trainer`` (``Trainer``, ``build_trainer``):

- log, validation (ordered, <= 50 batches), snapshot and resume cadences,
  each firing when the step counter crosses a multiple of its interval;
- the NaN guard: a non-finite logged loss restores the latest checkpoint
  (and fails loudly if there is none, or if that checkpoint itself
  produces one);
- the SIGTERM preemption checkpoint;
- checkpoints as ``checkpoints/gen_%08d.pt`` in the reference's own layout:
  ``{"state_dict": <reference names, f32>, "optimizer": ..., "step": ...}``,
  so the reference's loaders and the JAX package's ``import_hmvae_params``
  read them.

Trains the VAE or, with ``model_name: TrajectoryModel``, the root-trajectory
model on the dataset's ``mean_std`` (``build_trainer`` passes it; without it
a trajectory step raises, as in the JAX package), its checkpoints in the
reference ``TrajectoryModel``'s names.

Runs on ``cuda`` unless told otherwise.  Not ported, each raising or logging:
a model with adapters (``model.lora_rank > 0``; no config trains one), a
device mesh and multi-host runs, ``steps_per_call >
1`` (the TPU's scan dispatch; CUDA graphs are not measured yet), random root
rotation on the device (``device_augment``), the native loader's compact
wire and superbatches (the numpy sampler runs instead), asynchronous
checkpoints (written synchronously), and image saving.

The noise of step i comes from a CPU generator seeded by (``run.seed``, i),
so the same run draws the same noise on any device and after a resume.
"""

from __future__ import annotations

import logging
import os
import re
import signal
from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import MotionDataset, PrefetchIterator, make_loaders
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.logging import MetricWriter, make_result_folders
from ..utils.weights import reference_state_dict, state_dict_from_reference
from .train_step import TrainState, create_state, eval_step, loss_fields, to_device, train_step

log = logging.getLogger(__name__)

_CKPT = re.compile(r"gen_(\d{8,})\.pt")


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's noise."""
    return torch.Generator().manual_seed(((seed + 17) << 32) + step)


class Trainer:
    def __init__(self, cfg: Config, output_dir: str = "outputs/run", device="cuda",
                 mean_std: Optional[np.ndarray] = None):
        name = cfg.model.model_name
        if name not in ("TwoHierSAVAEModel", "TrajectoryModel"):
            raise ValueError(f"unknown model_name: {name}")
        if cfg.run.steps_per_call > 1:
            raise NotImplementedError(
                "steps_per_call > 1 (several steps per dispatch) is not ported: its GPU "
                "counterpart, CUDA graphs, is not measured yet")
        if cfg.model.lora_rank > 0:
            raise NotImplementedError(
                "model.lora_rank > 0: the adapters are the test-time solver's (finetune_scope "
                "lora); training a model with them is not ported (ROADMAP Queue 1 item 6b)")
        if cfg.run.model_parallel > 1:
            raise NotImplementedError("model_parallel > 1: the port trains on one device")
        if cfg.data.random_root_rot_flag and cfg.data.device_augment:
            raise NotImplementedError("random_root_rot on the device is not ported: set "
                                      "device_augment: false for the numpy augmentation")
        if cfg.run.matmul_precision != "default":
            log.warning("run.matmul_precision=%s is ignored: the port computes f32 in f32",
                        cfg.run.matmul_precision)
        if cfg.run.async_checkpoint:
            log.warning("asynchronous checkpoints are not ported: writing them synchronously")
        self.cfg = cfg
        self.mean_std = mean_std
        self.device = resolve_device(device)
        self.output_dir = output_dir
        self.ckpt_dir, self.image_dir = make_result_folders(output_dir)
        self.writer = MetricWriter(os.path.join(output_dir, "logs"))
        self.state: TrainState = create_state(cfg, self.device)
        self._fields = loss_fields(self.state.model)
        self._preempted = False
        n = sum(p.numel() for p in self.state.model.parameters())
        log.info("%s: %.2fM params on %s", name, n / 1e6, self.device)

    # ------------------------------------------------------------------
    # checkpoints
    def save(self, step: Optional[int] = None) -> str:
        step = self.state.step if step is None else step
        path = os.path.join(os.path.abspath(self.ckpt_dir), f"gen_{step:08d}.pt")
        blob = {"state_dict": reference_state_dict(self.state.model.state_dict(),
                                                   self.cfg.model),
                "optimizer": self.state.optimizer.state_dict(), "step": step}
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written checkpoint
        keep = self.cfg.run.keep_checkpoints
        if keep > 0:
            for stale in self._checkpoint_names()[:-keep]:
                os.remove(os.path.join(self.ckpt_dir, stale))
        return path

    def _checkpoint_names(self):
        if not os.path.isdir(self.ckpt_dir):
            return []
        names = [d for d in os.listdir(self.ckpt_dir) if _CKPT.fullmatch(d)]
        return sorted(names, key=lambda n: int(_CKPT.fullmatch(n).group(1)))

    def latest_checkpoint(self) -> Optional[str]:
        names = self._checkpoint_names()
        return os.path.join(os.path.abspath(self.ckpt_dir), names[-1]) if names else None

    def _load_weights(self, sd) -> None:
        model = self.state.model
        params = state_dict_from_reference(sd, self.cfg.model)
        dtypes = {k: v.dtype for k, v in model.state_dict().items()}
        model.load_state_dict({k: v.to(dtypes[k]) for k, v in params.items()})

    def resume(self, path: Optional[str] = None) -> int:
        """Restore params, optimizer state and step; returns the step."""
        path = path or self.latest_checkpoint()
        if path is None:
            return 0
        blob = torch.load(path, map_location="cpu", weights_only=True)
        self._load_weights(blob["state_dict"])
        self.state.optimizer.load_state_dict(blob["optimizer"])
        self.state.step = int(blob["step"])
        return self.state.step

    def load_params(self, path: str) -> None:
        """Weights only, as the reference's ``load_ckpt``: the optimizer
        state and the step stay fresh.  Reads any reference-layout
        ``gen_*.pt``."""
        blob = torch.load(path, map_location="cpu", weights_only=False)
        self._load_weights(blob.get("state_dict", blob))

    # ------------------------------------------------------------------
    def _val_pass(self, val_ds: MotionDataset, step: int) -> None:
        cfg = self.cfg
        vals = []
        for vi, vb in enumerate(val_ds.ordered_batches(cfg.optim.batch_size, max_batches=50,
                                                       seed=cfg.run.seed)):
            vm = eval_step(self.state, to_device(vb, self.device, self._fields), cfg,
                           generator=step_generator(cfg.run.seed, 10_000_000 + vi),
                           mean_std=self.mean_std)
            vals.append({k: float(v) for k, v in vm.items()})
        if vals:  # a val split smaller than one batch yields none
            self.writer.write(step, {f"val_{k}": float(np.mean([v[k] for v in vals]))
                                     for k in vals[0]})

    def fit(self, train_ds: MotionDataset, val_ds: Optional[MotionDataset] = None,
            max_iter: Optional[int] = None, log_cb=None,
            test_ds: Optional[MotionDataset] = None) -> Dict[str, float]:
        cfg = self.cfg
        max_iter = cfg.optim.max_iter if max_iter is None else max_iter
        it = PrefetchIterator(train_ds.iter_batches(cfg.optim.batch_size),
                              depth=cfg.data.num_prefetch)
        metrics: Dict[str, torch.Tensor] = {}
        nan_restored_from = -1
        images_logged = False
        self._preempted = False
        prev_handler, handler_installed = None, False
        if cfg.run.preemption_checkpoint:
            def on_sigterm(signum, frame):
                self._preempted = True
            try:
                prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
                handler_installed = True
            except ValueError:  # not the main thread
                log.warning("preemption checkpointing disabled: fit() is not running in "
                            "the main thread")
        try:
            i = self.state.step
            while i < max_iter:
                prev_i = i
                if self._preempted:
                    self.save(i)
                    self.writer.write(i, {"preempt_checkpoint_step": i})
                    log.warning("SIGTERM received: checkpointed at step %d, exiting fit "
                                "cleanly (resume with --resume)", i)
                    break
                metrics = train_step(self.state, to_device(next(it), self.device, self._fields),
                                     cfg, generator=step_generator(cfg.run.seed, i),
                                     mean_std=self.mean_std)
                i = self.state.step

                def crossed(interval):
                    return (i // interval) > (prev_i // interval)

                if crossed(cfg.run.log_iter):
                    host = {k: float(v) for k, v in metrics.items()}
                    if cfg.run.nan_guard and not np.isfinite(host["loss_total"]):
                        restored = self.resume()
                        self.writer.write(i, {"nan_guard_restored_to": restored})
                        if restored == 0:
                            raise FloatingPointError(f"non-finite loss at step {i} and no "
                                                     "checkpoint to restore")
                        if restored == nan_restored_from:
                            raise FloatingPointError(
                                f"non-finite loss recurred after restoring to step {restored} "
                                "— checkpoint is corrupt; restore an earlier one manually")
                        nan_restored_from = restored
                        i = restored
                        continue
                    self.writer.write(i, host)
                    if log_cb:
                        log_cb(i, host)
                if val_ds is not None and crossed(cfg.run.validation_iter):
                    self._val_pass(val_ds, i)
                if crossed(cfg.run.snapshot_save_iter):
                    self.save(i)
                if test_ds is not None and crossed(cfg.run.image_save_iter) and not images_logged:
                    log.warning("image saving is not ported (needs utils/viz.py): skipped")
                    images_logged = True
        finally:
            if handler_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
            it.close()
        return {k: float(v) for k, v in metrics.items()}


def build_trainer(cfg: Config, output_dir: str, device="cuda") -> tuple:
    """(trainer, train_ds, val_ds, test_ds), the trainer on the training
    split's mean/std."""
    train_ds, val_ds, test_ds = make_loaders(cfg)
    ms = np.stack([train_ds.mean, train_ds.std])
    return Trainer(cfg, output_dir, device=device, mean_std=ms), train_ds, val_ds, test_ds

