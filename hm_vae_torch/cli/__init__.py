"""The port's command-line entry points.  Each starts with :func:`start`, as
the JAX package's CLIs start with ``apply_platform_env``."""

from __future__ import annotations


def start(device: str = "cuda"):
    """Join torchrun's process group where ``HMVAE_DIST`` asks for it
    (:func:`~hm_vae_torch.parallel.multihost.maybe_initialize_distributed`),
    then return this rank's device: ``cuda:{LOCAL_RANK % device count}``,
    or the CPU where asked; raises without CUDA otherwise."""
    from ..parallel.multihost import maybe_initialize_distributed, rank_device

    maybe_initialize_distributed(device)
    return rank_device(device)
