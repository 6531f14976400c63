"""The training and validation steps and the train state.

Port of ``hm_vae_tpu.train.train_step``: ``cast_params``, state creation,
``train_step`` (zero the gradients to None, loss, backward, optimizer step)
and ``eval_step``, for the VAE (``hmvae_forward``) and the trajectory model
(``trajectory_losses``, which reads the dataset's ``mean_std``, as the JAX
Trainer's loss does); and :class:`MultiStep`, K steps a call, the
counterpart of the JAX Trainer's ``lax.scan`` over K steps
(``hm_vae_tpu/train/trainer.py``, ``multi_step``): on CUDA one step captured
in a CUDA graph and replayed K times, eagerly on the CPU.

The step is device work only: its count is a tensor on the model's device
(``TrainState.step_t``) that the step advances in place, the KL curriculum's
gate and the optimizer's counts, learning rate and skip are decided on the
device (``losses.py``, ``optim.py``), and the noise and the batch are read
from device buffers.
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
# the rotations (6D input, or FK of the compact wire's rotations)
TRAJECTORY_FIELDS = ("joint_pos", "rot_pos", "root_v", "rot_6d", "rot_mat", "aa")


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the step, on the host (``step``) and on
    the model's device (``step_t``, which the step advances in place)."""

    model: Union[HMVAE, TrajectoryModel]
    optimizer: TorchAdamL2
    step: int = 0
    step_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.step_t is None:
            dev = next(self.model.parameters()).device
            self.step_t = torch.full((), self.step, dtype=torch.int64, device=dev)

    def set_step(self, step: int) -> None:
        self.step = step
        self.step_t.fill_(step)


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
    return hmvae_forward(state.model, batch, state.step_t, cfg, sample=True, eps=eps,
                         generator=generator)


def _step_body(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
               eps: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               mean_std=None) -> Dict[str, torch.Tensor]:
    """One step's device work: loss, backward, optimizer step, ``step_t``
    advanced; the host's ``step`` is left to the caller."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state, batch, cfg, eps, generator, mean_std)
    loss.backward()
    state.optimizer.step()
    state.step_t.add_(1)
    return {k: v.detach() for k, v in metrics.items()}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
               eps: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               mean_std: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """One step in place: returns the step's metrics (detached tensors)."""
    metrics = _step_body(state, batch, cfg, eps, generator, mean_std)
    state.step += 1
    return metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: Config,
              eps: Optional[Sequence[torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None,
              mean_std: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """The loss's metrics on a batch, sampled as in training, no update."""
    return loss_fn(state, batch, cfg, eps, generator, mean_std)[1]


class MultiStep:
    """K training steps a call, the last step's metrics returned: the JAX
    Trainer's ``multi_step``.  ``batches`` are the K steps' batches stacked
    (K, B, ...) on the model's device; ``eps``, each level's noise of the K
    steps (K, B, edges, d), or None where the loss draws none (``kl_w``
    0, or the trajectory model).

    On CUDA (unless ``graph`` is false) one step is captured in a CUDA graph
    and replayed K times; the step reads its batch and noise at a device
    index the graph advances.  The graph is captured at the first call of a
    batch shape, after two warm-up steps on a side stream (the kernels'
    first-call attributes, each conv's structure, cuBLAS's workspace), from
    which the state is then restored bit for bit.  A failed capture raises.
    The kernel entries count their launches in the warm-up and the capture
    only: a replay runs the recorded kernels without calling the entries
    (a device trace counts them).  Elsewhere the K steps run eagerly,
    one :func:`train_step` each.  The state must stay the same objects
    (a resume writes into them)."""

    def __init__(self, state: TrainState, cfg: Config, mean_std=None, graph: bool = True):
        self.state, self.cfg = state, cfg
        self.device = state.step_t.device
        self.graph = graph and self.device.type == "cuda"
        self.mean_std = (None if mean_std is None else
                         torch.as_tensor(np.asarray(mean_std, np.float32), device=self.device))
        self._graph = None
        self._key = None

    def __call__(self, batches: Dict[str, torch.Tensor],
                 eps: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        K = next(iter(batches.values())).shape[0]
        if not self.graph:
            metrics = {}
            for k in range(K):
                metrics = train_step(self.state, {f: v[k] for f, v in batches.items()},
                                     self.cfg, None if eps is None else [e[k] for e in eps],
                                     mean_std=self.mean_std)
            return metrics
        key = (tuple((f, tuple(v.shape), v.dtype) for f, v in sorted(batches.items())),
               None if eps is None else tuple(tuple(e.shape) for e in eps))
        if key != self._key:
            self._capture(batches, eps)
            self._key = key
        for f, v in batches.items():
            self._batches[f].copy_(v)
        for e, s in zip(eps or (), self._eps or ()):
            s.copy_(e)
        self._index.zero_()
        for _ in range(K):
            self._graph.replay()
        self.state.step += K
        return {k: v.clone() for k, v in self._metrics.items()}

    def _body(self) -> Dict[str, torch.Tensor]:
        """The captured step: batch and noise at the device index, one step,
        the index advanced."""
        i = self._index
        batch = {f: v.index_select(0, i)[0] for f, v in self._batches.items()}
        eps = None if self._eps is None else [e.index_select(0, i)[0] for e in self._eps]
        metrics = _step_body(self.state, batch, self.cfg, eps, mean_std=self.mean_std)
        i.add_(1)
        return metrics

    def _snapshot(self):
        """The state's tensors and copies of them (optimizer state made by
        the warm-up is zeroed on restore: as fresh)."""
        opt = self.state.optimizer
        tensors = [p.data for p in self.state.model.parameters()]
        tensors += [t for st in opt.state.values() for t in st.values()]
        tensors += [g["step"] for g in opt.param_groups] + [self.state.step_t]
        return tensors, [t.clone() for t in tensors], {id(t) for t in tensors}

    def _restore(self, snap) -> None:
        tensors, saved, known = snap
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
            for st in self.state.optimizer.state.values():
                for t in st.values():
                    if id(t) not in known:
                        t.zero_()

    def _capture(self, batches, eps) -> None:
        self._graph = None
        self._batches = {f: v.clone() for f, v in batches.items()}
        self._eps = None if eps is None else [e.clone() for e in eps]
        self._index = torch.zeros((), dtype=torch.int64, device=self.device)
        snap = self._snapshot()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._index.zero_()
                self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._restore(snap)
        self._index.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._metrics = self._body()
        self._graph = graph
