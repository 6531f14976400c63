"""The training and validation steps and the train state.

Port of ``hm_vae_tpu.train.train_step``: ``cast_params``, state creation,
``train_step`` (zero the gradients to None, loss, backward, optimizer step)
and ``eval_step``.  The JAX package's K-steps-per-dispatch ``lax.scan``
(``make_multi_step``), a TPU dispatch workaround, is not ported: its GPU
counterpart would be a CUDA graph, not measured yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.hm_vae import HMVAE
from ..utils.config import Config
from .losses import hmvae_forward
from .optim import _DTYPES, TorchAdamL2, make_optimizer

# the batch fields the VAE's loss reads (any one wire form)
LOSS_FIELDS = ("rot_6d", "rot_mat", "aa")


@dataclasses.dataclass
class TrainState:
    model: HMVAE
    optimizer: TorchAdamL2
    step: int = 0


def cast_params(model: torch.nn.Module, param_dtype: str) -> torch.nn.Module:
    """Store the floating parameters in ``param_dtype`` (buffers, such as
    the pool matrices, stay f32).  Init always draws in f32, so the bf16
    mode starts from the rounding of the same init."""
    dt = _DTYPES[param_dtype]
    for p in model.parameters():
        if p.is_floating_point() and p.dtype != dt:
            p.data = p.data.to(dt)
    return model


def create_state(cfg: Config, device, generator: Optional[torch.Generator] = None
                 ) -> TrainState:
    """A model drawn from ``generator`` (default: seeded by ``cfg.run.seed``)
    on the CPU, cast to the storage dtype, moved to ``device``, and its
    optimizer."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.run.seed)
    model = HMVAE(cfg.model, cfg.optim.init, generator=generator)
    cast_params(model, cfg.optim.param_dtype).to(device)
    return TrainState(model, make_optimizer(model.named_parameters(), cfg.optim))


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The loss's fields of a host batch as f32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
            for k, v in batch.items() if k in LOSS_FIELDS}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
               eps: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One step in place: returns the step's metrics (detached tensors)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = hmvae_forward(state.model, batch, state.step, cfg, sample=True, eps=eps,
                                  generator=generator)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
              eps: Optional[Sequence[torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The loss's metrics on a batch, sampled as in training, no update."""
    _, metrics = hmvae_forward(state.model, batch, state.step, cfg, sample=True, eps=eps,
                               generator=generator)
    return metrics
