"""Multi-process plumbing: one process a rank, started by ``torchrun``.

Port of ``hm_vae_tpu.parallel.multihost``.  PyTorch's model is one process
per rank, each holding its own tensors on its own device (or on a device it
shares), joined by ``torch.distributed``:

- :func:`maybe_initialize_distributed` -- ``init_process_group`` from
  torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``), gated on ``HMVAE_DIST`` as the JAX
  package's is, with a finite timeout and the backend rule of
  :func:`choose_backend`, which it logs and returns;
- :func:`process_index`, :func:`process_count`, :func:`is_primary` (the
  rank that writes files), :func:`process_group` (the default group once
  initialized, else None: one process);
- :func:`process_seed`, :func:`process_shard`, :func:`local_batch_size`:
  the same numbers and errors as the JAX package's for every (index, count),
  which a caller under ``run.model_parallel`` gives as the rank's
  :func:`data_index` and :func:`data_count` (the model ranks of one data row
  draw the same rows);
- :func:`rank_device`: the rank's device, ``cuda:{LOCAL_RANK % device
  count}`` unless the caller asks for the CPU.

The JAX module's ``host_local_copy`` and ``make_global_batch`` have nothing
to do here: a rank's tensors are its own and local already, there is no
pod-spanning array to copy to the host or to stitch from per-process parts.
The collectives that stand in for GSPMD's are in :mod:`.sharding`.

Everything degrades to the identity in one process.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_TRUTHY = ("1", "true", "yes", "on")
TIMEOUT_S = 600  # a rank that never joins a collective fails the run after this


def dist_requested() -> bool:
    """True where ``HMVAE_DIST`` asks for a multi-process run."""
    return os.environ.get("HMVAE_DIST", "").lower() in _TRUTHY


def choose_backend(device_type: str, local_world_size: int, device_count: int) -> str:
    """``nccl`` where the node's ranks run on CUDA and each has a device of
    its own; ``gloo`` where they share a device (NCCL refuses two ranks on
    one device) or run on the CPU."""
    if device_type == "cuda" and device_count >= local_world_size:
        return "nccl"
    return "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU where asked, else
    ``cuda:{LOCAL_RANK % device_count}`` (ranks beyond the node's cards
    share them); raises without CUDA."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def maybe_initialize_distributed(device="cuda") -> Optional[str]:
    """Join torchrun's process group where ``HMVAE_DIST`` is set.

    Returns the backend (``"nccl"`` or ``"gloo"``, by
    :func:`choose_backend` for ``device``'s type, logged), or None where
    the gate is off.  Already initialized: returns the group's backend.
    The CUDA device of the rank is made current before NCCL starts; a rank
    that never joins a collective fails the others after TIMEOUT_S.
    """
    if not dist_requested():
        return None
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, local_world, count)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    log.info("torch.distributed initialized: rank %d / %d, backend %s, device %s "
             "(%d local ranks, %d CUDA devices)", dist.get_rank(), dist.get_world_size(),
             backend, dev, local_world, count)
    return backend


def process_group():
    """The default process group once initialized, else None (one
    process)."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that owns filesystem writes (checkpoints, metric
    logs, images, evaluation outputs).  Always True in one process."""
    return process_index() == 0


def data_count(model_parallel: int = 1) -> int:
    """The data axis's size of the (data, model) grid: ``world //
    model_parallel``; raises ValueError where it does not divide."""
    mp, world = max(1, int(model_parallel)), process_count()
    if world % mp:
        raise ValueError(f"run.model_parallel={mp} does not divide the {world} ranks")
    return world // mp


def data_index(model_parallel: int = 1) -> int:
    """The rank's index on the data axis: ``rank // model_parallel``
    (:func:`~.sharding.make_groups`)."""
    data_count(model_parallel)  # raises where it does not divide
    return process_index() // max(1, int(model_parallel))


def process_seed(base_seed: int, index: Optional[int] = None,
                 count: Optional[int] = None) -> int:
    """Per-rank sampling seed: disjoint streams for iid window sampling
    (distinct streams are the data partition).  Identity for rank 0.
    ``count`` only validates ``index``; the stream does not depend on the
    world size."""
    i = process_index() if index is None else index
    c = process_count() if count is None else count
    if not 0 <= i < c:
        raise ValueError(f"process index {i} outside [0, {c})")
    return base_seed + 7_919_003 * i


def process_shard(n_items: int, index: Optional[int] = None,
                  count: Optional[int] = None) -> Tuple[int, int]:
    """Balanced contiguous [start, stop) shard of an ordered index space:
    the first ``n_items % count`` ranks take one extra item."""
    i = process_index() if index is None else index
    c = process_count() if count is None else count
    if not 0 <= i < c:
        raise ValueError(f"process index {i} outside [0, {c})")
    base, extra = divmod(n_items, c)
    start = i * base + min(i, extra)
    stop = start + base + (1 if i < extra else 0)
    return start, stop


def local_batch_size(global_batch: int, index: Optional[int] = None,
                     count: Optional[int] = None) -> int:
    """Per-rank batch: ``optim.batch_size`` stays GLOBAL; each rank loads
    its share.  Requires divisibility."""
    c = process_count() if count is None else count
    if global_batch % c != 0:
        raise ValueError(
            f"optim.batch_size={global_batch} must divide by the "
            f"{c} processes (each host loads batch/processes samples)")
    return global_batch // c
