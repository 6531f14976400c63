"""Trainer: model and optimizer state, the run loop, checkpoints, on one device.

Port of ``hm_vae_tpu.train.trainer`` (``Trainer``, ``build_trainer``):

- the iterator as the JAX Trainer picks it: the native sampler's compact
  superbatches on the config's wire (``compact_transfer``, ``wire_format``),
  its full superbatches, its compact single batches, or the prefetching
  batch iterator;
- ``steps_per_call`` steps a call (:class:`~.train_step.MultiStep`: a CUDA
  graph of the step replayed K times on CUDA), the remaining steps at the
  end one row of a superbatch at a time;
- double-buffered ingest: on CUDA the next call's superbatch is copied to
  the device on a copy stream (from pinned host buffers, f16 on the wire
  with ``transfer_dtype: float16``) while the current call runs; the
  upcast to f32 and the random root rotation (``random_root_rot_flag`` with
  ``device_augment``, :mod:`..data.device_aug`) run on the device;
- log, validation (ordered, <= 50 batches), snapshot and resume cadences,
  each firing when the step crosses a multiple of its interval within a
  call;
- the NaN guard: a non-finite logged loss restores the latest checkpoint
  (and fails loudly if there is none, or if that checkpoint itself
  produces one);
- the SIGTERM preemption checkpoint;
- checkpoints as ``checkpoints/gen_%08d.pt`` in the reference's own layout:
  ``{"state_dict": <reference names, f32>, "optimizer": ..., "step": ...}``,
  so the reference's loaders and the JAX package's ``import_hmvae_params``
  read them, pruned to the newest ``keep_checkpoints``; with
  ``async_checkpoint`` a device-side snapshot is taken after the call and a
  background thread copies it to the host and writes it
  (:meth:`Trainer.wait_for_saves` joins it and re-raises its error).

Trains the VAE or, with ``model_name: TrajectoryModel``, the root-trajectory
model on the dataset's ``mean_std`` (``build_trainer`` passes it; without it
a trajectory step raises, as in the JAX package), its checkpoints in the
reference ``TrajectoryModel``'s names.

Runs on ``cuda`` unless told otherwise.  Every ``run.image_save_iter`` steps
of a VAE run with a test split it saves animations (``_save_visualizations``,
which needs matplotlib).  A VAE with adapters (``model.lora_rank > 0``, a
nested ``model: {lora_rank: N}``) trains its base weights and adapters
together, as the JAX Trainer does (the trajectory model ignores the rank);
its checkpoints keep the adapters under the port's names
(``decoder.conv_*.lora_a``, ``lora_b``) beside the reference names.  Under
``model.param_layout: compact`` the masked convs train their live entries
only (:mod:`..models.param_layout`); checkpoints are dense either way, so
``resume`` and ``load_params`` read a checkpoint of either layout, the Adam
moments converted with the weights.

Parallel over ranks (:mod:`..parallel.multihost`, a process group
initialized before the Trainer is made), on the JAX Trainer's (data, model)
grid (:func:`~..parallel.sharding.make_groups`): ``run.model_parallel`` (mp)
must divide the world, the data degree is ``world // mp``, and
``optim.batch_size`` stays global, each data row loading its
``local_batch_size`` rows from its own sampling stream (the model ranks of
a row draw the same rows and noise); the latent heads are sharded over the
model group; the step averages the gradients over the data group, inside
the CUDA graph under NCCL, eagerly under gloo (whose collectives cannot be
captured); the noise is the global batch's, each data row taking its rows.
The metrics logged are the data group's mean; the metric log, checkpoints
and images are written by the primary rank only, checkpoints with full
tensors (the sharded heads and their moments gathered on every rank first),
so that a checkpoint of any ``model_parallel`` resumes at any other; a
resume reads the newest checkpoint on every rank and takes its part;
validation takes each data row's ``process_shard`` rows of the same ordered
batches and averages the metrics over the data group.

The noise of step i comes from a CPU generator seeded by (``run.seed``, i),
and the rotations of a batch consumed at step i from one seeded by
(``run.seed + 91``, i), so the same run draws the same noise and rotations on
any device and after a resume.
"""

from __future__ import annotations

import logging
import os
import re
import signal
import sys
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataset import MotionDataset, PrefetchIterator, make_loaders
from ..models.param_layout import convert_optimizer_state
from ..models.trajectory import TrajectoryModel
from ..parallel import multihost as mh
from ..parallel.sharding import (allreduce_mean, gather_state, make_groups, model_shards,
                                 rank_rows, shard_state)
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.logging import MetricWriter, NullMetricWriter, make_result_folders
from ..utils.weights import reference_state_dict, state_dict_from_reference
from .losses import draw_noise, eps_shapes
from .train_step import (MultiStep, TrainState, build_model, cast_params, create_state, eval_step,
                         loss_fields, to_device, train_step)

log = logging.getLogger(__name__)

_CKPT = re.compile(r"gen_(\d{8,})\.pt")
_MOMENTS = ("exp_avg", "exp_avg_sq")
_ADAPTERS = (".lora_a", ".lora_b")


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's noise.  Its seed mixes ``seed`` and
    ``step`` into the 32 bits torch's CPU generator reads (it drops the
    rest: ``(seed << 32) + step`` would ignore the seed)."""
    return torch.Generator().manual_seed(((seed + 17) * 0x9E3779B1 + step) & 0xFFFFFFFF)


def _compact_single_iter(ds, bs, need_root_v, threads, wire):
    while True:
        yield ds.sample_compact(bs, need_root_v, threads, wire=wire)


def _to_host(obj):
    """Tensors of a nested state on the host (a checkpoint's contents)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _clone(obj):
    """A device-side copy of a nested state's tensors."""
    if torch.is_tensor(obj):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


class Trainer:
    def __init__(self, cfg: Config, output_dir: str = "outputs/run", device="cuda",
                 mean_std: Optional[np.ndarray] = None):
        name = cfg.model.model_name
        if name not in ("TwoHierSAVAEModel", "TrajectoryModel"):
            raise ValueError(f"unknown model_name: {name}")
        if cfg.run.matmul_precision != "default":
            log.warning("run.matmul_precision=%s is ignored: the port computes f32 in f32",
                        cfg.run.matmul_precision)
        self.cfg = cfg
        self.mean_std = mean_std
        self.device = resolve_device(device)
        self.output_dir = output_dir
        self.groups = make_groups(cfg.run.model_parallel)  # ValueError where mp does not divide
        self.data_group = self.groups.data
        self.world = mh.process_count()
        self.primary = mh.is_primary()
        if self.primary:
            self.ckpt_dir, self.image_dir = make_result_folders(output_dir)
            self.writer = MetricWriter(os.path.join(output_dir, "logs"))
        else:  # the primary rank writes every file
            self.ckpt_dir, self.image_dir = (os.path.join(output_dir, d)
                                             for d in ("checkpoints", "images"))
            self.writer = NullMetricWriter()
        self.state: TrainState = create_state(cfg, self.device, model_group=self.groups.model)
        self.shards = model_shards(self.state.model)  # name -> (dim, start, full)
        self._names = [n for n, _ in self.state.model.named_parameters()]
        self._fields = loss_fields(self.state.model)
        self._preempted = False
        self._multi: Optional[MultiStep] = None
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        self._augment = None
        if cfg.data.random_root_rot_flag and cfg.data.device_augment:
            from ..data.device_aug import make_root_rot_augment

            self._augment = make_root_rot_augment(mean_std, cfg.run.seed + 91)
        self._wire_dtype = np.float16 if cfg.data.transfer_dtype == "float16" else np.float32
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        n = sum(p.numel() for p in self.state.model.parameters())
        log.info("%s: %.2fM params on %s", name, n / 1e6, self.device)
        if self.world > 1:
            g = self.groups
            log.info("rank %d of %d, backend %s: data %d of %d (rows %s of batch %d), model "
                     "%d of %d (%d sharded leaves)", mh.process_index(), self.world,
                     dist.get_backend(), g.data_index, g.data_count,
                     rank_rows(cfg.optim.batch_size, self.data_group), cfg.optim.batch_size,
                     g.model_index, g.model_count, len(self.shards))

    # ------------------------------------------------------------------
    # checkpoints
    def _blob(self, model_sd, optim_sd, step: int) -> dict:
        """A checkpoint from full tensors: the reference's dense names, the
        optimizer's moments dense too."""
        if self.cfg.model.param_layout != "dense":
            optim_sd = convert_optimizer_state(optim_sd, self._names, self.cfg.model, "dense")
        return {"state_dict": reference_state_dict(model_sd, self.cfg.model),
                "optimizer": optim_sd, "step": step}

    def _full_state(self):
        """The model's and the optimizer's state dicts with full tensors: a
        sharded leaf and its moments gathered over the model group (a
        collective: every rank calls it; new tensors), the rest the live
        state's own tensors."""
        model_sd = self.state.model.state_dict()
        optim_sd = self.state.optimizer.state_dict()
        if not self.shards:
            return model_sd, optim_sd
        group = self.groups.model
        model_sd = gather_state(model_sd, self.shards, group)
        state = {}
        for i, st in sorted(optim_sd["state"].items()):
            shard = self.shards.get(self._names[i])
            if shard is not None:
                st = {**st, **gather_state({k: st[k] for k in _MOMENTS},
                                           {k: shard for k in _MOMENTS}, group)}
            state[i] = st
        return model_sd, {**optim_sd, "state": state}

    def _local_optimizer_state(self, optim_sd) -> dict:
        """A checkpoint's optimizer state (full, dense) as this rank holds
        it: in the model's layout, a sharded leaf's moments cut to its rows."""
        if self.cfg.model.param_layout != "dense":
            optim_sd = convert_optimizer_state(optim_sd, self._names, self.cfg.model,
                                               self.cfg.model.param_layout)
        if not self.shards:
            return optim_sd
        params = dict(self.state.model.named_parameters())
        state = {}
        for i, st in optim_sd["state"].items():
            name = self._names[int(i)]
            if name in self.shards:
                st = {**st, **shard_state({k: st[k] for k in _MOMENTS},
                                          {k: self.shards[name] for k in _MOMENTS},
                                          {k: params[name].shape[0] for k in _MOMENTS})}
            state[i] = st
        return {**optim_sd, "state": state}

    def _write_checkpoint(self, path: str, blob: dict) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written checkpoint
        keep = self.cfg.run.keep_checkpoints
        if keep > 0:
            for stale in self._checkpoint_names()[:-keep]:
                os.remove(os.path.join(self.ckpt_dir, stale))

    def save(self, step: Optional[int] = None) -> str:
        """Write ``gen_<step>.pt``; with ``async_checkpoint`` the host copy
        and the write run in a background thread (see
        :meth:`wait_for_saves`), from a device-side snapshot taken now."""
        step = self.state.step if step is None else step
        path = os.path.join(os.path.abspath(self.ckpt_dir), f"gen_{step:08d}.pt")
        full = self._full_state()  # every rank: the sharded leaves are gathered
        if not self.primary:  # every rank holds the same (full) state
            return path
        if not self.cfg.run.async_checkpoint:
            self._write_checkpoint(path, _to_host(self._blob(*full, step)))
            return path
        self.wait_for_saves()
        # the next calls update the state in place: copy it first, on the
        # compute stream after the steps that wrote it
        snap = _clone(full)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))

        def write():
            try:
                host = snap
                if done is not None:
                    # a stream of its own: the compute stream's later work
                    # does not hold the copy back
                    stream = torch.cuda.Stream(self.device)
                    with torch.cuda.stream(stream):
                        stream.wait_event(done)
                        host = _to_host(snap)
                    stream.synchronize()
                self._write_checkpoint(path, self._blob(host[0], host[1], step))
            except BaseException as e:  # re-raised by wait_for_saves
                self._save_error = e

        # not a daemon: an interpreter exiting right after a save waits for it
        self._save_thread = threading.Thread(target=write, daemon=False)
        self._save_thread.start()
        return path

    def wait_for_saves(self) -> None:
        """Block until the asynchronous checkpoint write in flight, if any,
        has finished, and re-raise its error if it failed."""
        t = self._save_thread
        if t is not None:
            t.join()
            self._save_thread = None
        err, self._save_error = self._save_error, None
        if err is not None:
            raise RuntimeError("asynchronous checkpoint write failed") from err

    def _checkpoint_names(self):
        if not os.path.isdir(self.ckpt_dir):
            return []
        names = [d for d in os.listdir(self.ckpt_dir) if _CKPT.fullmatch(d)]
        return sorted(names, key=lambda n: int(_CKPT.fullmatch(n).group(1)))

    def latest_checkpoint(self) -> Optional[str]:
        names = self._checkpoint_names()
        return os.path.join(os.path.abspath(self.ckpt_dir), names[-1]) if names else None

    def _load_weights(self, sd) -> None:
        """A reference-layout state dict (full, dense) into the model: in its
        layout, a sharded leaf cut to this rank's rows.  Adapters the
        checkpoint lacks keep their values; adapters the model lacks are
        not read."""
        model = self.state.model
        own = model.state_dict()
        params = state_dict_from_reference(sd, self.cfg.model)
        params = shard_state(params, self.shards, {n: own[n].shape[0] for n in self.shards})
        params = {k: v for k, v in params.items() if k in own or not k.endswith(_ADAPTERS)}
        params.update({k: v for k, v in own.items()
                       if k.endswith(_ADAPTERS) and k not in params})
        model.load_state_dict({k: v.to(own[k].dtype) for k, v in params.items()})

    def resume(self, path: Optional[str] = None) -> int:
        """Restore params, optimizer state and step (into the existing
        tensors) from a checkpoint of either layout and any
        ``model_parallel``; returns the step.  Under several ranks every rank
        calls it and reads the same checkpoint, after the primary's writes."""
        self.wait_for_saves()  # an asynchronous save in flight may be the newest
        if self.world > 1:
            dist.barrier()
        path = path or self.latest_checkpoint()
        if path is None:
            return 0
        blob = torch.load(path, map_location="cpu", weights_only=True)
        self._load_weights(blob["state_dict"])
        self.state.optimizer.load_state_dict(self._local_optimizer_state(blob["optimizer"]))
        self.state.set_step(int(blob["step"]))
        return self.state.step

    def load_params(self, path: str) -> None:
        """Weights only, as the reference's ``load_ckpt``: the optimizer
        state and the step stay fresh.  Reads any reference-layout
        ``gen_*.pt``."""
        self.wait_for_saves()
        blob = torch.load(path, map_location="cpu", weights_only=False)
        self._load_weights(blob.get("state_dict", blob))

    # ------------------------------------------------------------------
    # ingest
    def _to_wire(self, host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The loss's fields of a host batch, in the wire dtype."""
        out = {k: np.asarray(v) for k, v in host.items() if k in self._fields}
        if self._wire_dtype == np.float16:
            out = {k: v if v.dtype == np.float16 else v.astype(np.float16)
                   for k, v in out.items()}
        return out

    def _stage(self, host: Dict[str, np.ndarray], step: int, stream=None):
        """Start the copy of a host batch (in the wire dtype) to the device:
        on CUDA on the copy stream (asynchronous from pinned buffers), the
        copy's event handed to ``stream`` (the native sampler's buffer
        stream) so that the buffer is not refilled before it lands."""
        host = self._to_wire(host)
        if self._copy_stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}, \
                None, step
        with torch.cuda.stream(self._copy_stream):
            dev = {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        if stream is not None and hasattr(stream, "copy_done"):
            stream.copy_done(event)
        return dev, event, step

    def _consume(self, staged) -> Dict[str, torch.Tensor]:
        """A staged batch as f32 on the compute stream, rotated at the root
        where the config asks (keyed by the step it was staged for)."""
        dev, event, step = staged
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in dev.values():
                t.record_stream(compute)
        batch = {k: v.float() for k, v in dev.items()}
        if self._augment is not None:
            batch = self._augment(batch, step)
        return batch

    def _call_noise(self, step: int, K: int, B: int):
        """The noise of steps step .. step+K-1 (K, B_rank, edges, d) per
        level on the device, drawn on the host from each step's generator
        for the global batch ``B`` (this rank's rows of it) and copied in one
        pinned, non-blocking transfer; or None where the loss draws none."""
        if isinstance(self.state.model, TrajectoryModel) or self.cfg.loss.kl_w == 0:
            return None
        r0, r1 = rank_rows(B, self.data_group)
        shapes = eps_shapes(self.cfg, B)
        draws = [draw_noise(shapes, step_generator(self.cfg.run.seed, step + k))
                 for k in range(K)]
        flat = torch.cat([torch.stack([d[lv][r0:r1] for d in draws]).reshape(-1)
                          for lv in range(len(shapes))])
        if self.device.type == "cuda":
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        shapes = [(r1 - r0,) + tuple(s[1:]) for s in shapes]
        sizes = [K * int(np.prod(s)) for s in shapes]
        return [e.view((K,) + tuple(s)) for e, s in zip(flat.split(sizes), shapes)]

    # ------------------------------------------------------------------
    def _save_visualizations(self, test_ds, step: int) -> None:
        """The train loop's periodic animations (``train_motion_vae.py:113-150``
        + ``model.test``, ``seq_two_hier_sa_vae.py:560-639``), under
        ``images/<step>/``: a test window beside its posterior-mean
        reconstruction (``mean_seq_rot_6d.mp4``) and a prior sample
        (``sampled_seq_rot_6d.mp4``); gifs without ffmpeg.  Needs
        matplotlib.  Every rank calls it (a sharded model is gathered into an
        unsharded copy first); the primary draws."""
        from ..apps.inference import VAEInference
        from ..ops import fk as fk_mod
        from ..utils.viz import save_animation

        model = self.state.model
        if self.shards:
            full = gather_state(model.state_dict(), self.shards, self.groups.model)
            model = cast_params(build_model(self.cfg, torch.Generator()),
                                self.cfg.optim.param_dtype).to(self.device)
            model.load_state_dict(full)
        if not self.primary:
            return
        was_training = model.training
        try:
            infer = VAEInference(model, self.cfg, device=self.device)
            b = test_ds.sample_batch(1)
            _, _, mean_pose = infer.mean_reconstruction(b["rot_6d"])
            _, _, samp_pose = infer.prior_samples(
                1, torch.Generator().manual_seed(self.cfg.run.seed * 1000003 + step))
        finally:
            model.train(was_training)
        gt_pose = fk_mod.fk_numpy(np.asarray(b["rot_mat"][0], np.float32))
        dest = os.path.join(self.image_dir, str(step))
        save_animation(np.stack([gt_pose, mean_pose[0].float().cpu().numpy()]),
                       os.path.join(dest, "mean_seq_rot_6d.mp4"))
        save_animation(samp_pose[0].float().cpu().numpy()[None],
                       os.path.join(dest, "sampled_seq_rot_6d.mp4"))

    def _val_pass(self, val_ds: MotionDataset, step: int) -> None:
        cfg = self.cfg
        vals = []
        v0, v1 = rank_rows(cfg.optim.batch_size, self.data_group)
        for vi, vb in enumerate(val_ds.ordered_batches(cfg.optim.batch_size, max_batches=50,
                                                       seed=cfg.run.seed)):
            vb = {k: v[v0:v1] for k, v in vb.items()}  # this rank's rows
            vm = eval_step(self.state, to_device(vb, self.device, self._fields), cfg,
                           generator=step_generator(cfg.run.seed, 10_000_000 + vi),
                           mean_std=self.mean_std, group=self.data_group)
            vm = allreduce_mean(vm, self.data_group)
            vals.append({k: float(v) for k, v in vm.items()})
        if vals:  # a val split smaller than one batch yields none
            self.writer.write(step, {f"val_{k}": float(np.mean([v[k] for v in vals]))
                                     for k in vals[0]})

    def _single(self, host, i: int, stream=None) -> Dict[str, torch.Tensor]:
        return train_step(self.state, self._consume(self._stage(host, i, stream)), self.cfg,
                          generator=step_generator(self.cfg.run.seed, i),
                          mean_std=self.mean_std, group=self.data_group)

    def fit(self, train_ds, val_ds: Optional[MotionDataset] = None,
            max_iter: Optional[int] = None, log_cb=None,
            test_ds: Optional[MotionDataset] = None) -> Dict[str, float]:
        cfg = self.cfg
        max_iter = cfg.optim.max_iter if max_iter is None else max_iter
        bs = cfg.optim.batch_size
        bs_local = mh.local_batch_size(bs, count=self.groups.data_count)  # the row's rows
        K = max(1, cfg.run.steps_per_call)
        need_root_v = isinstance(self.state.model, TrajectoryModel)
        pin = self.device.type == "cuda"
        compact = cfg.data.compact_transfer and hasattr(train_ds, "iter_compact_superbatches")
        native_super = K > 1 and (compact or hasattr(train_ds, "iter_superbatches"))
        wire, threads = cfg.data.wire_format, cfg.data.native_threads
        if native_super and compact:
            it = train_ds.iter_compact_superbatches(K, bs_local, need_root_v, threads, wire,
                                                    dtype=self._wire_dtype, pin_memory=pin)
        elif native_super:
            it = train_ds.iter_superbatches(K, bs_local, threads, pin_memory=pin)
        elif compact:
            it = _compact_single_iter(train_ds, bs_local, need_root_v, threads, wire)
        else:
            it = PrefetchIterator(train_ds.iter_batches(bs_local), depth=cfg.data.num_prefetch)
        if K > 1 and self._multi is None:
            # gloo's collectives cannot be captured: its steps run eagerly
            graph = self.world == 1 or dist.get_backend() == "nccl"
            self._multi = MultiStep(self.state, cfg, self.mean_std, graph=graph,
                                    group=self.data_group)
            if self.world > 1:
                log.info("MultiStep under %s: graphed=%s", dist.get_backend(),
                         self._multi.graph)

        def next_super():
            if native_super:
                return next(it)
            rows = [next(it) for _ in range(K)]
            return {k: np.stack([r[k] for r in rows]) for k in rows[0]}

        metrics: Dict[str, torch.Tensor] = {}
        pending = None
        nan_restored_from = -1
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
                    self.wait_for_saves()
                    self.writer.write(i, {"preempt_checkpoint_step": i})
                    log.warning("SIGTERM received: checkpointed at step %d, exiting fit "
                                "cleanly (resume with --resume)", i)
                    break
                if K > 1 and i + K <= max_iter:
                    if pending is None:
                        pending = self._stage(next_super(), i, it)
                    cur, pending = pending, None
                    metrics = self._multi(self._consume(cur), self._call_noise(i, K, bs))
                    if i + 2 * K <= max_iter:
                        # the next superbatch's copy overlaps this call; it is
                        # consumed (and rotated) at step i + K
                        pending = self._stage(next_super(), i + K, it)
                    i = self.state.step
                elif native_super:
                    # the tail: fewer than K steps remain, one row at a time
                    sb = next(it)
                    for j in range(max_iter - i):
                        metrics = self._single({k: v[j] for k, v in sb.items()}, i + j, it)
                    i = self.state.step
                else:
                    metrics = self._single(next(it), i)
                    i = self.state.step

                def crossed(interval):
                    return (i // interval) > (prev_i // interval)

                if crossed(cfg.run.log_iter):
                    host = {k: float(v)
                            for k, v in allreduce_mean(metrics, self.data_group).items()}
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
                if (test_ds is not None and not isinstance(self.state.model, TrajectoryModel)
                        and crossed(cfg.run.image_save_iter)):
                    self._save_visualizations(test_ds, i)
        finally:
            if handler_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
            # an exception already propagating is not masked by a failed
            # background batch fill or checkpoint write: that is logged
            failed = None
            propagating = sys.exc_info()[0] is not None
            for what, teardown in (("background batch fill", getattr(it, "close", None)),
                                   ("asynchronous checkpoint write", self.wait_for_saves)):
                try:
                    if teardown is not None:
                        teardown()
                except Exception as e:
                    if propagating or failed is not None:
                        log.exception("%s failed during teardown", what)
                    else:
                        failed = e
            if failed is not None:
                raise failed
        return {k: float(v) for k, v in allreduce_mean(metrics, self.data_group).items()}


def build_trainer(cfg: Config, output_dir: str, device="cuda") -> tuple:
    """(trainer, train_ds, val_ds, test_ds), the trainer on the training
    split's mean/std."""
    train_ds, val_ds, test_ds = make_loaders(cfg)
    ms = np.stack([train_ds.mean, train_ds.std])
    return Trainer(cfg, output_dir, device=device, mean_std=ms), train_ds, val_ds, test_ds
