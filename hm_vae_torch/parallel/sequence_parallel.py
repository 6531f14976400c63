"""Temporal sequence parallelism for the trajectory model over ranks.

Port of ``hm_vae_tpu.parallel.sequence_parallel``.  The trajectory model is
fully convolutional over time; here the time axis is split over a
``torch.distributed`` group's ranks and each stride-1 level exchanges a
``(kernel_size - 1) // 2``-frame halo with its temporal neighbours, then
runs VALID on the halo-extended shard, which equals the unsharded level's
padding:

- interior shard boundaries see the true neighbouring activations;
- the first and last shards reflect- or zero-pad their outer edge locally,
  which equals the global padding because the halo never exceeds the shard
  (``h <= T_local - 1``).

One exchange per level, as in JAX: level i + 1's boundary context is level
i's output.  The exchange is a zero-slot all-reduce (each rank writes its
head and tail into its slot of a zeroed buffer, one ``all_reduce`` SUM,
exact), so that one collective path runs under NCCL and gloo.  Each level
runs the hand-written forward kernel on a VALID packing of its conv
(padding 0, packed once: ``SkeletonConv.packed_operands(padding=0)``).

The root-trajectory integration is a distributed prefix sum: a local cumsum
plus the exclusive prefix of the ranks' totals.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data import layout
from ..models.trajectory import TrajectoryModel, _stat
from ..ops.fused_conv_pool import fused_conv_pool_packed
from .sharding import gather_rows, rank_of, world_size


def halo_exchange(x: torch.Tensor, h: int, group, mode: str = "reflect") -> torch.Tensor:
    """Extend a time-split (B, C, T_local) activation by ``h`` frames a
    side: interior boundaries take the neighbour's frames, the global first
    and last shards pad their outer edge locally ('reflect' without edge
    repeat, or 'constant' zeros, as ``pad_temporal``).  Every rank of
    ``group`` calls it together.  Requires ``h <= T_local - 1``."""
    if h == 0:
        return x
    t_local = x.shape[-1]
    if h > t_local - 1:
        raise ValueError(f"halo {h} needs T_local >= {h + 1}, got {t_local}: use fewer "
                         "shards or longer sequences")
    mode = {"reflection": "reflect", "zeros": "constant"}.get(mode, mode)
    n, r = world_size(group), rank_of(group)
    # slot r: this rank's head (0) and tail (1)
    slots = x.new_zeros((n, 2) + tuple(x.shape[:-1]) + (h,))
    slots[r, 0] = x[..., :h]
    slots[r, 1] = x[..., t_local - h:]
    if group is not None:
        dist.all_reduce(slots, group=group)
    if r > 0:
        left = slots[r - 1, 1]
    elif mode == "reflect":
        left = x[..., 1:h + 1].flip(-1)
    else:
        left = torch.zeros_like(x[..., :h])
    if r < n - 1:
        right = slots[r + 1, 0]
    elif mode == "reflect":
        right = x[..., t_local - h - 1:t_local - 1].flip(-1)
    else:
        right = torch.zeros_like(x[..., :h])
    return torch.cat([left, x, right], dim=-1)


def sp_accumulate_root_trajectory(root_v: torch.Tensor, group) -> torch.Tensor:
    """Distributed ``accumulate_root_trajectory``: (B, T_local, 3) shards of
    per-step velocity -> absolute root translation, the global step 0
    contributing nothing.  A local cumsum plus the exclusive prefix of the
    ranks' totals (gathered by a zero-slot all-reduce)."""
    n, r = world_size(group), rank_of(group)
    v = root_v if r > 0 else torch.cat((torch.zeros_like(root_v[:, :1]), root_v[:, 1:]), 1)
    local = torch.cumsum(v, dim=1)
    totals = gather_rows(local[None, :, -1], n, r, group)  # (n, B, 3)
    prefix = torch.cumsum(totals, dim=0) - totals  # exclusive
    return local + prefix[r][:, None, :]


def make_sp_trajectory_fn(model: TrajectoryModel, mean_std: np.ndarray, group,
                          pad_incomplete: bool = False):
    """Sequence-parallel trajectory core: ``pose (B, T, 24, 3) -> (world_pose
    (B, T, 24, 3), root_v (B, T, 3))``, called by every rank of ``group``
    with the same global pose; each rank runs its contiguous time shard and
    the outputs are gathered to every rank (JAX's global array).

    Requires ``T % n == 0`` and ``T / n > (kernel_size - 1) // 2``.
    ``pad_incomplete`` lifts the divisibility: the tail repeats the last
    frame up to the next multiple and the outputs are trimmed back to T;
    the final ``num_levels * (kernel_size - 1) // 2`` velocities then see
    repeated frames instead of the global edge padding (the integration is
    exact: the cumsum is causal)."""
    enc = model.encoder
    convs = [getattr(enc, f"conv_{i}") for i in range(len(enc.structure.levels))]
    for i, conv in enumerate(convs):
        if conv.spec.stride != 1:
            # halo + VALID equals the global conv only with frame-aligned
            # shard boundaries; the trajectory encoder is stride 1
            raise ValueError(f"sequence parallelism requires stride 1, level {i} has stride "
                             f"{conv.spec.stride}")
    dev = next(model.parameters()).device
    with torch.no_grad():
        valid = [conv.packed_operands(padding=0) for conv in convs]
    c_mean = _stat(mean_std, 0, layout.COORD, dev).reshape(24, 3)
    c_std = _stat(mean_std, 1, layout.COORD, dev, zero_to_one=True).reshape(24, 3)
    rv_mean = _stat(mean_std, 0, layout.ROOT_V, dev)
    rv_std = _stat(mean_std, 1, layout.ROOT_V, dev)
    n, r = world_size(group), rank_of(group)
    halo = (model.cfg.kernel_size - 1) // 2

    def local_fn(pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, Tl = pose.shape[:2]
        x = ((pose - c_mean) / c_std).reshape(B, Tl, -1).transpose(1, 2)
        for conv, packed in zip(convs, valid):
            x = halo_exchange(x.float(), conv.spec.padding, group, conv.spec.padding_mode)
            x = fused_conv_pool_packed(x.to(packed.dtype).contiguous(), packed)
        root_v = rv_mean + rv_std * model.fc_mapping(x.float().transpose(1, 2))
        return pose + sp_accumulate_root_trajectory(root_v, group)[:, :, None, :], root_v

    @torch.no_grad()
    def fn(pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        T = pose.shape[1]
        pad = -T % n
        if pad and not pad_incomplete:
            raise ValueError(f"T={T} not divisible by {n} shards")
        if pad:
            pose = torch.cat([pose, pose[:, -1:].expand(-1, pad, -1, -1)], dim=1)
        Tl = (T + pad) // n
        if Tl <= halo:
            raise ValueError(f"shard length {Tl} <= halo {halo}: use fewer shards")
        world, root_v = local_fn(pose[:, r * Tl:(r + 1) * Tl].contiguous())
        world = gather_rows(world, T + pad, r * Tl, group, dim=1)
        root_v = gather_rows(root_v, T + pad, r * Tl, group, dim=1)
        return world[:, :T], root_v[:, :T]

    return fn
