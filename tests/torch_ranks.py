"""Running the port under several ``torch.distributed`` ranks on the CPU, for
the multi-rank tests (``test_torch_parallel_*.py``,
``test_torch_sequence_parallel.py``, ``test_torch_multihost.py``).

:func:`run_ranks` spawns one process a rank (``spawn``, one torch thread
each), joins them in a gloo group through a ``file://`` rendezvous under the
test's tmp_path (no TCP port: the suite runs under several xdist workers),
runs one of the rank bodies below and returns each rank's result.  The
group has a finite timeout and every wait here a deadline, so a rank that
hangs or dies fails its test instead of the suite's time limit.

This module imports torch and the port only, never JAX: the children start
fast, and the tests compute their JAX references in the parent process.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 90  # a collective some rank never joins fails after this
RUN_TIMEOUT_S = 420  # the whole run of the ranks


def _entry(fn, rank, world, init_file, args, results):
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = RUN_TIMEOUT_S):
    """``fn(rank, world, *args)`` in ``world`` gloo ranks; the list of their
    results by rank.  Raises AssertionError with the tracebacks if a rank
    fails, or if the ranks do not finish within ``timeout``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(str(tmp_path), f"pg_init_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, init_file, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, failed = {}, {}
    deadline = time.monotonic() + timeout
    try:
        # drain the queue before joining (a child blocks on a full pipe)
        while len(got) + len(failed) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 2.0))
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            (got if ok else failed)[rank] = out
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()) if not failed else 5.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
    if failed:
        raise AssertionError("\n".join(f"rank {r} failed:\n{tb}"
                                       for r, tb in sorted(failed.items())))
    missing = sorted(set(range(world)) - set(got))
    assert not missing, f"ranks {missing} did not finish within {timeout} s"
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# rank bodies: numpy in, numpy out


def _params(model):
    return {n: p.detach().float().numpy().copy() for n, p in model.named_parameters()}


def train_steps(rank, world, cfg, init, batches, eps, mean_std, multi):
    """``len(batches[f])`` steps of the port's step from ``init`` on this
    rank's rows of the global batches (K, B, ...) and noise (K, B, ...)
    (None: the trajectory model), one :func:`train_step` at a time or one
    :class:`MultiStep` call (graph=False).  Returns the parameters, the
    gradients of the first step (averaged over the ranks; of the last step
    under MultiStep) and the last step's metrics averaged over the ranks."""
    from hm_vae_torch.parallel.sharding import allreduce_mean, rank_rows
    from hm_vae_torch.train.train_step import MultiStep, create_state, train_step

    group = dist.group.WORLD if world > 1 else None
    state = create_state(cfg, "cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()},
                                strict=False)
    K, B = next(iter(batches.values())).shape[:2]
    r0, r1 = rank_rows(B, group)
    rows = {f: torch.from_numpy(v[:, r0:r1].copy()) for f, v in batches.items()}
    noise = None if eps is None else [torch.from_numpy(e[:, r0:r1].copy()) for e in eps]
    if multi:
        metrics = MultiStep(state, cfg, mean_std, graph=False, group=group)(rows, noise)
    else:
        for k in range(K):
            metrics = train_step(state, {f: v[k] for f, v in rows.items()}, cfg,
                                 None if noise is None else [e[k] for e in noise],
                                 mean_std=mean_std, group=group)
            if k == 0:
                first = {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()
                         if p.grad is not None}
    grads = first if not multi else {n: p.grad.numpy().copy()
                                     for n, p in state.model.named_parameters()
                                     if p.grad is not None}
    return (_params(state.model), grads,
            {k: float(v) for k, v in allreduce_mean(metrics, group).items()})


def fit_resume(rank, world, cfg, out_dir, max_iter):
    """``Trainer.fit`` for ``max_iter`` steps and a save, under the ranks,
    then a new Trainer resumed from the newest checkpoint.  Returns the
    checkpoint and metric-log writes this rank made, the metrics it logged,
    the resumed step, and the trained and resumed parameters."""
    from hm_vae_torch.train import trainer as tr
    from hm_vae_torch.utils import logging as tlog

    writes = []
    write_checkpoint, write_metrics = tr.Trainer._write_checkpoint, tlog.MetricWriter.write

    def record_checkpoint(self, path, blob):
        writes.append(os.path.basename(path))
        write_checkpoint(self, path, blob)

    def record_metrics(self, step, metrics, prefix=""):
        writes.append(f"metrics@{step}")
        write_metrics(self, step, metrics, prefix)

    tr.Trainer._write_checkpoint, tlog.MetricWriter.write = record_checkpoint, record_metrics
    try:
        trainer, train_ds, val_ds, _ = tr.build_trainer(cfg, out_dir, device="cpu")
        logged = []
        final = trainer.fit(train_ds, val_ds, max_iter=max_iter,
                            log_cb=lambda s, m: logged.append((s, m)))
        trainer.save()
        trainer.wait_for_saves()
        again = tr.build_trainer(cfg, out_dir, device="cpu")[0]
        step = again.resume()
    finally:
        tr.Trainer._write_checkpoint, tlog.MetricWriter.write = write_checkpoint, write_metrics
    return (writes, logged, final, step, _params(trainer.state.model),
            _params(again.state.model))


def _full_params(model, groups):
    """A model's parameters with its sharded heads gathered (numpy, f32)."""
    from hm_vae_torch.parallel.sharding import gather_state, model_shards

    full = gather_state(dict(model.named_parameters()), model_shards(model), groups.model)
    return {n: p.detach().float().numpy().copy() for n, p in full.items()}


def tp_train_steps(rank, world, cfg, init, batches, eps, model_parallel):
    """``len(batches[f])`` ``train_step`` calls on the (data, model) grid of
    ``model_parallel`` (the latent heads sharded over the model group, the
    gradients averaged over the data group), from the full weights
    ``init``, on this rank's data row's rows of the global batches and
    noise.  Returns the parameters after the first step and after the last,
    the first step's gradients (the heads' gathered) and every step's loss
    averaged over the data group, and (data index, model index, sharded
    leaves)."""
    from hm_vae_torch.parallel.sharding import (allreduce_mean, gather_state, make_groups,
                                                model_shards, rank_rows, shard_state)
    from hm_vae_torch.train.train_step import create_state, train_step

    g = make_groups(model_parallel)
    state = create_state(cfg, "cpu", model_group=g.model)
    shards = model_shards(state.model)
    own = state.model.state_dict()
    local = shard_state({k: torch.from_numpy(v) for k, v in init.items()}, shards,
                        {n: own[n].shape[0] for n in shards})
    state.model.load_state_dict({k: v.to(own[k].dtype) for k, v in local.items()})
    K, B = next(iter(batches.values())).shape[:2]
    r0, r1 = rank_rows(B, g.data)
    losses = []
    for k in range(K):
        m = train_step(state, {f: torch.from_numpy(v[k, r0:r1].copy()) for f, v in
                               batches.items()}, cfg,
                       [torch.from_numpy(e[k, r0:r1].copy()) for e in eps], group=g.data)
        losses.append(float(allreduce_mean(m, g.data)["loss_total"]))
        if k == 0:
            first = _full_params(state.model, g)
            grads = gather_state({n: p.grad for n, p in state.model.named_parameters()
                                  if p.grad is not None}, shards, g.model)
            grads = {n: v.float().numpy().copy() for n, v in grads.items()}
    return (first, _full_params(state.model, g), grads, losses,
            (g.data_index, g.model_index, len(shards)))


def tp_fit_resume(rank, world, cfg, out_dir, max_iter):
    """``Trainer.fit`` to ``max_iter`` and a save under the ranks (resumed
    first from the newest checkpoint, if any), then a new Trainer resumed
    from it.  Returns the files this rank wrote, the step each trainer ended
    at, and both trainers' gathered parameters."""
    from hm_vae_torch.train import trainer as tr

    writes = []
    write_checkpoint = tr.Trainer._write_checkpoint

    def record(self, path, blob):
        writes.append(os.path.basename(path))
        write_checkpoint(self, path, blob)

    tr.Trainer._write_checkpoint = record
    try:
        trainer, train_ds, val_ds, _ = tr.build_trainer(cfg, out_dir, device="cpu")
        start = trainer.resume()
        trainer.fit(train_ds, val_ds, max_iter=max_iter)
        trainer.save()
        again = tr.build_trainer(cfg, out_dir, device="cpu")[0]
        step = again.resume()
    finally:
        tr.Trainer._write_checkpoint = write_checkpoint
    return (writes, start, step, _full_params(trainer.state.model, trainer.groups),
            _full_params(again.state.model, again.groups))


def solve(rank, world, cfg, state_dict, targets, mask, z, zr):
    """One batched solve through ``LatentOptApps._dispatch`` over the ranks:
    every field of the gathered result."""
    from hm_vae_torch.apps.tasks import LatentOptApps
    from hm_vae_torch.models.hm_vae import HMVAE

    model = HMVAE(cfg.model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()},
                          strict=False)
    apps = LatentOptApps(model, cfg, group=dist.group.WORLD)
    res = apps._dispatch(apps.solve, targets, mask, z, zr)
    return {k: v.numpy().copy() for k, v in vars(res).items()}


def halo(rank, world, x, h, mode):
    """``halo_exchange`` of this rank's time shard of x (B, C, T)."""
    from hm_vae_torch.parallel.sequence_parallel import halo_exchange

    Tl = x.shape[-1] // world
    shard = torch.from_numpy(x[..., rank * Tl:(rank + 1) * Tl].copy())
    try:
        return halo_exchange(shard, h, dist.group.WORLD, mode).numpy()
    except ValueError as e:
        return f"ValueError: {e}"


def accumulate(rank, world, root_v):
    """``sp_accumulate_root_trajectory`` of this rank's time shard."""
    from hm_vae_torch.parallel.sequence_parallel import sp_accumulate_root_trajectory

    Tl = root_v.shape[1] // world
    shard = torch.from_numpy(root_v[:, rank * Tl:(rank + 1) * Tl].copy())
    return sp_accumulate_root_trajectory(shard, dist.group.WORLD).numpy()


def sp_trajectory(rank, world, model_cfg, state_dict, mean_std, cases):
    """``make_sp_trajectory_fn`` over the ranks on each (pose, pad_incomplete)
    case: (world_pose, root_v) gathered, or the ValueError's text."""
    from hm_vae_torch.models.trajectory import TrajectoryModel
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.parallel.sequence_parallel import make_sp_trajectory_fn

    model = TrajectoryModel(model_cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()},
                          strict=False)
    out = []
    for pose, pad_incomplete in cases:
        fn = make_sp_trajectory_fn(model, mean_std, dist.group.WORLD, pad_incomplete)
        try:
            out.append(tuple(a.numpy() for a in fn(torch.from_numpy(pose))))
        except ValueError as e:
            out.append(f"ValueError: {e}")
    return out, fcp.fused_conv_pool.launches


def cli(rank, world, module, argv):
    """A CLI's ``main(argv)`` under the ranks; the .npy and .json files this
    rank wrote (``np.save`` and ``json.dump`` recorded)."""
    import importlib
    import json

    written = []
    save, dump = np.save, json.dump

    def record_save(path, *a, **k):
        written.append(os.path.basename(str(path)))
        return save(path, *a, **k)

    def record_dump(obj, f, *a, **k):
        written.append(os.path.basename(getattr(f, "name", "?")))
        return dump(obj, f, *a, **k)

    np.save, json.dump = record_save, record_dump
    try:
        importlib.import_module(module).main(argv)
    finally:
        np.save, json.dump = save, dump
    return sorted(written)


def gather_and_mean(rank, world):
    """The zero-slot gather (rows, and along dim 1) and the metric mean."""
    from hm_vae_torch.parallel import sharding

    g = dist.group.WORLD
    r0, r1 = sharding.rank_rows(7, g)
    local = torch.arange(r0, r1, dtype=torch.float32)[:, None] * torch.tensor([1.0, -0.5])
    full = sharding.gather_rows(local, 7, r0, g)
    cols = sharding.gather_rows(local.T.contiguous(), 7, r0, g, dim=1)
    mean = sharding.allreduce_mean({"a": torch.tensor(float(rank)), "b": torch.tensor(2.0)}, g)
    return full.numpy(), cols.numpy(), {k: float(v) for k, v in mean.items()}, (r0, r1)


def env_child(port, results):
    """``maybe_initialize_distributed`` from torchrun's environment variables
    (one rank, on localhost): the backend, twice, the world, primary, group."""
    from hm_vae_torch.parallel import multihost as tmh

    os.environ.update({"HMVAE_DIST": "1", "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    try:
        backend = tmh.maybe_initialize_distributed("cpu")
        again = tmh.maybe_initialize_distributed("cpu")
        results.put((backend, again, tmh.process_count(), tmh.is_primary(),
                     tmh.process_group() is dist.group.WORLD))
    except BaseException as e:
        results.put(repr(e))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
