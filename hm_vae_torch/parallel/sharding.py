"""Data and tensor parallelism over ranks: the port of
``hm_vae_tpu.parallel.sharding``.

GSPMD shards the batch over the mesh's ``data`` axis and inserts the
gradient all-reduce itself.  Here each rank holds its rows of the global
batch and the step all-reduces explicitly, between ``backward`` and the
optimizer step (:func:`allreduce_grads`): no ``DistributedDataParallel``
hooks, so the reduction can sit inside a captured CUDA graph (NCCL's
collectives can be captured; DDP's reducer cannot).

The ``model`` axis (``run.model_parallel`` = mp > 1): the ranks form the JAX
mesh's (data, model) grid, rank r at data index ``r // mp`` and model index
``r % mp`` (:func:`make_groups`, one ``dist.new_group`` per row and column,
made on every rank in the same order).  The JAX rule (``_param_spec``,
:func:`shard_dim`) shards the latent heads' output features
(``latent_head_*`` / ``latent_dec_*`` weight and bias, where they divide)
over the model group and replicates every other parameter.  A sharded head
is a :class:`ColumnParallelLinear` (swapped in by :func:`shard_model` after
the model is built whole): each model rank computes its columns of the
output, gathered exactly (:func:`gather_rows`); the backward takes the
rank's columns of the output gradient for the weight's and bias's, and
computes the input gradient through the weight gathered exactly, so the
step is the one-process step bit for bit.  The model ranks of one data row
hold the same rows of the batch and the same noise, so everything but a
head's columns is the same computation on each of them.

This is a port for parity with the JAX package, not a way to fit or speed
up a model: every model rank gathers each sharded head's whole weight in
every backward and computes the whole input gradient, so the model axis
saves neither memory nor arithmetic; it adds a gather to each sharded
head's forward and backward and the optimizer's one ``all_reduce`` of
flags a step.  The input gradient as partial sums and an ``all_reduce``
(what GSPMD does) would split that product over the ranks, but its sums
round differently: at len-8 size on the CPU the deepest encoder head
(``latent_head_3``, whose gradient comes through ``latent_dec_0``'s input
gradient) then leaves the one-process bits at the first step.

Every collective of the port is an ``all_reduce`` on tensors on the rank's
device (here, in the solver and in sequence parallelism) or a ``barrier``
(the Trainer's resume, synthetic data), so one code path runs under NCCL
and under gloo (which takes CUDA tensors for these, not for send/recv).  A
gather is each rank writing its rows into a zeroed buffer and an
``all_reduce`` SUM, which is exact (x + 0 = x): :func:`gather_rows`.

A checkpoint holds full tensors: :func:`gather_state` joins the sharded
leaves (and their moments) on every rank, :func:`shard_state` cuts a rank's
part back out, so a checkpoint of any ``model_parallel`` resumes at any
other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .multihost import data_count, data_index, process_index, process_shard


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


# ---------------------------------------------------------------------------
# the model axis


@dataclasses.dataclass(frozen=True)
class Groups:
    """This rank's groups of the (data, model) grid: ``data`` joins the ranks
    of its model index (the gradients' and metrics' mean), ``model`` those of
    its data index (the sharded heads); None where a group would be this
    rank alone."""

    data: Optional[object]
    model: Optional[object]
    data_index: int
    data_count: int
    model_index: int
    model_count: int


def make_groups(model_parallel: int = 1) -> Groups:
    """The groups of the JAX mesh's layout (``make_mesh`` reshapes the
    devices to (world // mp, mp)): rank r at data index ``r // mp``, model
    index ``r % mp``.  Every rank makes every group, in the same order (one
    ``dist.new_group`` per model index, then per data index); a group of
    every rank is the default group.  Raises ValueError where mp does not
    divide the world."""
    dc, d = data_count(model_parallel), data_index(model_parallel)
    rank, mp = process_index(), max(1, int(model_parallel))
    world, m = dc * mp, rank % mp

    def made(rows):
        mine = None
        for ranks in rows:
            g = (None if len(ranks) == 1 else dist.group.WORLD if len(ranks) == world
                 else dist.new_group(ranks))
            if rank in ranks:
                mine = g
        return mine

    return Groups(made([[i + j * mp for j in range(dc)] for i in range(mp)]),
                  made([[i * mp + j for j in range(mp)] for i in range(dc)]), d, dc, m, mp)


def shard_dim(name: str, shape, model_size: int) -> Optional[int]:
    """The JAX rule (``hm_vae_tpu/parallel/sharding.py:_param_spec``) on the
    port's names: a latent head's weight (out, in) or bias (out,) shards its
    output features, dim 0, over the model axis where they divide; None
    (replicated) for every other tensor."""
    *mods, leaf = name.split(".")
    if (model_size > 1 and any(p.startswith(("latent_head", "latent_dec")) for p in mods)
            and leaf in ("weight", "bias") and len(shape) >= 1
            and shape[0] % model_size == 0):
        return 0
    return None


class _ColumnParallelFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, group, start: int, n_out: int):
        ctx.save_for_backward(x, weight)
        ctx.group, ctx.start, ctx.n_out = group, start, n_out
        return gather_rows(nn.functional.linear(x, weight, bias), n_out, start, group, dim=-1)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        n = weight.shape[0]
        g = gy.narrow(-1, ctx.start, n)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            # the full output gradient (the same on every model rank) through
            # the full weight, gathered exactly: the one-process product, bit
            # for bit (partial sums + all_reduce would differ in the last
            # place, which Adam's first step shows on near-zero gradients)
            full = gather_rows(weight.detach(), ctx.n_out, ctx.start, ctx.group, dim=0)
            gx = gy.matmul(full)
        g2 = g.reshape(-1, n)
        if ctx.needs_input_grad[1]:
            gw = g2.t().mm(x.reshape(-1, x.shape[-1]))
        if ctx.needs_input_grad[2]:
            # summed as the one-process bias gradient is, then this rank's part
            gb = gy.sum(tuple(range(gy.dim() - 1))).narrow(0, ctx.start, n)
        return gx, gw, gb, None, None, None


class ColumnParallelLinear(nn.Module):
    """A latent head with its output features sharded over ``group``: this
    rank holds rows [start, start + out / mp) of the (out, in) weight and the
    bias; the output, its columns gathered, is the full one on every model
    rank, computed in the input's dtype (as :class:`~hm_vae_torch.models.
    hm_vae.Linear`).  Made from the full layer, so that the same seed draws
    the same weights at any ``model_parallel``."""

    def __init__(self, full: nn.Linear, group):
        super().__init__()
        n, mp = full.out_features, world_size(group)
        self.group, self.out_features = group, n
        self.start = rank_of(group) * (n // mp)
        rows = slice(self.start, self.start + n // mp)
        self.weight = nn.Parameter(full.weight.detach()[rows].clone())
        self.bias = nn.Parameter(full.bias.detach()[rows].clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ColumnParallelFn.apply(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                       self.group, self.start, self.out_features)


def shard_model(model: nn.Module, group) -> nn.Module:
    """The model with every ``nn.Linear`` the JAX rule shards (:func:`shard_dim`
    on its weight's name) swapped in place for a :class:`ColumnParallelLinear`
    of this rank's rows over ``group``: the model is built whole and unaware
    of the grid, as the JAX package applies its partition specs from
    outside.  The model as it is for no group or a group of one."""
    mp = world_size(group)
    for name, m in list(model.named_modules()):
        if (isinstance(m, nn.Linear)
                and shard_dim(f"{name}.weight", tuple(m.weight.shape), mp) is not None):
            parent, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(parent), leaf, ColumnParallelLinear(m, group))
    return model


def model_shards(model: nn.Module) -> Dict[str, Tuple[int, int, int]]:
    """The sharded parameters of a model by name: (dim, start, full size)."""
    return {f"{prefix}.{leaf}": (0, m.start, m.out_features)
            for prefix, m in model.named_modules() if isinstance(m, ColumnParallelLinear)
            for leaf in ("weight", "bias")}


def model_group_of(model: nn.Module):
    """The model group of a model's sharded heads, or None."""
    for m in model.modules():
        if isinstance(m, ColumnParallelLinear):
            return m.group
    return None


def gather_state(tensors: Mapping[str, torch.Tensor], shards: Mapping[str, Tuple[int, int, int]],
                 group) -> Dict[str, torch.Tensor]:
    """Full tensors on every rank of the model group: each sharded entry
    (by name in ``shards``) joined by :func:`gather_rows` (in f32, exact for
    bf16, whose values it holds), the others as they are.  A collective:
    every rank of the group calls it with the same names."""
    out = dict(tensors)
    for name in sorted(shards):
        if name in out:
            dim, start, full = shards[name]
            t = out[name]
            out[name] = gather_rows(t.detach().float(), full, start, group, dim).to(t.dtype)
    return out


def shard_state(full: Mapping[str, torch.Tensor], shards: Mapping[str, Tuple[int, int, int]],
                local_sizes: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """This rank's part of each sharded entry of full tensors (the others
    as they are): rows [start, start + local size) along the sharded dim."""
    out = dict(full)
    for name, (dim, start, _) in shards.items():
        if name in out:
            out[name] = out[name].narrow(dim, start, local_sizes[name]).contiguous()
    return out
