"""Data parallelism over ranks: the data-parallel half of
``hm_vae_tpu.parallel.sharding``.

GSPMD shards the batch over the mesh's ``data`` axis and inserts the
gradient all-reduce itself.  Here each rank holds its rows of the global
batch and the step all-reduces explicitly, between ``backward`` and the
optimizer step (:func:`allreduce_grads`): no ``DistributedDataParallel``
hooks, so the reduction can sit inside a captured CUDA graph (NCCL's
collectives can be captured; DDP's reducer cannot).

Every collective of the port is an ``all_reduce`` on tensors on the rank's
device (here, in the solver and in sequence parallelism) or a ``barrier``
(the Trainer's resume, synthetic data), so one code path runs under NCCL
and under gloo (which takes CUDA tensors for these, not for send/recv).  A
gather is each rank writing its rows into a zeroed buffer and an
``all_reduce`` SUM, which is exact (x + 0 = x): :func:`gather_rows`.

Tensor parallelism over a ``model`` axis (``run.model_parallel > 1``) is
not ported (ROADMAP item 11b).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
import torch.distributed as dist

from .multihost import process_shard


def world_size(group) -> int:
    """The group's size; 1 for no group (one process)."""
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def rank_rows(n: int, group) -> Tuple[int, int]:
    """This rank's contiguous [start, stop) rows of a global batch of
    ``n`` (:func:`~.multihost.process_shard` over the group)."""
    return process_shard(n, rank_of(group), world_size(group))


def allreduce_grads(params: Iterable[torch.Tensor], group) -> None:
    """Average the parameters' gradients over the group in place: per
    dtype, the gradients flattened into one bucket, one ``all_reduce`` SUM,
    divided by the world size, written back.  Parameters whose gradient is
    None are skipped (on every rank alike: the step is the same program on
    every rank)."""
    n = world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        bucket = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(bucket, group=group)
        if n > 1:
            bucket.div_(n)
        for g, v in zip(grads, bucket.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


def allreduce_mean(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The group's mean of each scalar metric (one ``all_reduce`` of the
    stacked values): the global batch's mean where every rank holds an equal
    share of it."""
    if group is None or not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    flat.div_(world_size(group))
    return dict(zip(keys, flat.unbind()))


def gather_rows(local: torch.Tensor, n_total: int, start: int, group,
                dim: int = 0) -> torch.Tensor:
    """The global tensor (``n_total`` along ``dim``) on every rank from each
    rank's part ``local`` at [start, start + its length) along ``dim``:
    written into zeros, then one ``all_reduce`` SUM.  Exact, since every
    entry is one rank's value plus zeros."""
    if group is None:
        return local
    shape = list(local.shape)
    shape[dim] = n_total
    out = local.new_zeros(shape)
    out.narrow(dim, start, local.shape[dim]).copy_(local)
    dist.all_reduce(out, group=group)
    return out
