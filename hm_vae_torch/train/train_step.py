"""The training and validation steps and the train state.

Port of ``hm_vae_tpu.train.train_step``: ``cast_params``, state creation,
``train_step`` (zero the gradients to None, loss, backward, optimizer step)
and ``eval_step``, for the VAE (``hmvae_forward``) and the trajectory model
(``trajectory_losses``, which reads the dataset's ``mean_std``, as the JAX
Trainer's loss does).  The JAX package's K-steps-per-dispatch ``lax.scan``
(``make_multi_step``), a TPU dispatch workaround, is not ported: its GPU
counterpart would be a CUDA graph, not measured yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..models.hm_vae import HMVAE
from ..models.trajectory import TrajectoryModel, trajectory_losses
from ..utils.config import Config
from .losses import hmvae_forward
from .optim import _DTYPES, TorchAdamL2, make_optimizer

# the batch fields the VAE's loss reads (any one wire form)
LOSS_FIELDS = ("rot_6d", "rot_mat", "aa")
# the trajectory model's: normalised and raw positions, root velocity, and
# the 6D input of a model without joint-position input
TRAJECTORY_FIELDS = ("joint_pos", "rot_pos", "root_v", "rot_6d")


@dataclasses.dataclass
class TrainState:
    model: Union[HMVAE, TrajectoryModel]
    optimizer: TorchAdamL2
    step: int = 0


def build_model(cfg: Config, generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """The model ``cfg.model.model_name`` names, drawn from ``generator``."""
    name = cfg.model.model_name
    if name == "TrajectoryModel":
        return TrajectoryModel(cfg.model, cfg.optim.init, generator=generator)
    if name == "TwoHierSAVAEModel":
        return HMVAE(cfg.model, cfg.optim.init, generator=generator)
    raise ValueError(f"unknown model_name: {name}")


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
    model = build_model(cfg, generator)
    cast_params(model, cfg.optim.param_dtype).to(device)
    return TrainState(model, make_optimizer(model.named_parameters(), cfg.optim))


def to_device(batch: Dict[str, np.ndarray], device,
              fields: Sequence[str] = LOSS_FIELDS) -> Dict[str, torch.Tensor]:
    """The loss's ``fields`` of a host batch as f32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
            for k, v in batch.items() if k in fields}


def loss_fields(model: torch.nn.Module) -> Sequence[str]:
    """The batch fields ``model``'s loss reads."""
    return TRAJECTORY_FIELDS if isinstance(model, TrajectoryModel) else LOSS_FIELDS


def loss_fn(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
            eps: Optional[Sequence[torch.Tensor]] = None,
            generator: Optional[torch.Generator] = None,
            mean_std: Optional[np.ndarray] = None):
    """(loss, metrics) of the state's model on a batch: the VAE's sampled
    loss, or the trajectory model's, which needs the dataset's mean/std."""
    if isinstance(state.model, TrajectoryModel):
        if mean_std is None:
            raise ValueError("TrajectoryModel training requires the dataset mean/std: pass "
                             "mean_std=(2, 579) to Trainer (build_trainer wires it)")
        return trajectory_losses(state.model, batch, cfg, mean_std)
    return hmvae_forward(state.model, batch, state.step, cfg, sample=True, eps=eps,
                         generator=generator)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
               eps: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               mean_std: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """One step in place: returns the step's metrics (detached tensors)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state, batch, cfg, eps, generator, mean_std)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
              eps: Optional[Sequence[torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None,
              mean_std: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """The loss's metrics on a batch, sampled as in training, no update."""
    return loss_fn(state, batch, cfg, eps, generator, mean_std)[1]
