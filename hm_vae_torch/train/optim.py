"""Adam with L2 weight decay, torch's ``grad is None`` skip, StepLR, and the
bf16 storage modes of the JAX package's optimizer.

Port of ``hm_vae_tpu.train.optim``: ``torch_adam_l2`` and the plain chain
``add_decayed_weights -> scale_by_adam_stored -> scale_by_learning_rate`` as
one :class:`torch.optim.Optimizer` (:class:`TorchAdamL2`, made by
:func:`make_optimizer`), ``make_schedule`` / ``make_schedule_raw``,
``stochastic_round_bf16_hash`` and its counter hash.  The same chain as a
functional update on lists of tensors (:func:`chain_init`,
:func:`chain_update`) serves the test-time solver, whose per-window state is
stacked (G, ...) tensors under the same elementwise update, with the
solver's two further elements: a per-tensor learning-rate multiplier and
the bf16 clone's stochastically rounded write-back
(``stochastic_round_updates``).

The update is the JAX package's expression, ``(m/c1) / (sqrt(v/c2) + eps)``
with ``c1 = 1 - b1**count`` in f32 (not torch's fused Adam: equal
algebraically, not bit for bit).  L2 is added into the gradient.  With
``none_grad_skip`` a parameter whose ``grad`` is None is skipped: no decay, no
moments, its own count does not advance (the JAX package's proxy is an
all-zero gradient leaf); without it every parameter steps on one global
count, a missing gradient counting as zeros.  The learning rate is read at
the global count before the step.

``param_dtype: bfloat16`` writes the new value back by stochastic rounding
with bits from :func:`_hash_bits16`, salted by the parameter's index + 1 in
the flax tree-flatten order of the JAX package's parameters and hashed over
the flax leaf's layout (a Linear weight is the transpose of a flax kernel),
so that both packages round the same way.  A leaf sharded over a model
group (``run.model_parallel``: a latent head's rows of output features) is
hashed at its elements' global positions in that flax layout, and it steps
where any rank of the group holds a nonzero gradient (one ``all_reduce`` of
the sharded leaves' flags a step), so that a sharded run rounds and counts
as the one-process run does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

import torch.distributed as dist

from ..utils.config import OptimConfig

B1, B2, EPS = 0.9, 0.999, 1e-8
_M32 = 0xFFFFFFFF
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def make_schedule_raw(lr: float, policy: str, step_size, gamma: float
                      ) -> Callable[[int], torch.Tensor]:
    """count -> learning rate (an f32 scalar): constant, StepLR
    (``lr * gamma ** (count // step_size)``) or MultiStepLR (``gamma`` once
    per milestone ``<= count``).  A count given as a tensor gives the rate
    on its device, computed there (no host sync; the constants enter as CPU
    0-dim tensors, which act as scalars on any device)."""
    if policy == "constant" or not policy:
        return lambda count: _f32(lr)
    if policy == "step":
        def step(count):
            if torch.is_tensor(count):
                q = torch.div(count, int(step_size), rounding_mode="floor").float()
                return _f32(lr) * _f32(gamma) ** q
            return _f32(lr) * _f32(gamma) ** float(count // int(step_size))

        return step
    if policy == "mstep":
        milestones = sorted(int(m) for m in step_size)

        def mstep(count):
            if torch.is_tensor(count):
                v = _f32(lr) * torch.ones((), device=count.device)
                for m in milestones:
                    v = torch.where(count >= m, v * _f32(gamma), v)
                return v
            v = _f32(lr)
            for m in milestones:
                if count >= m:
                    v = v * _f32(gamma)
            return v

        return mstep
    raise ValueError(f"unknown lr_policy: {policy}")


def make_schedule(cfg: OptimConfig) -> Callable[[int], torch.Tensor]:
    return make_schedule_raw(cfg.lr, cfg.lr_policy, cfg.step_size, cfg.gamma)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32), without overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _hash_bits16(shape, salt: int, count, device=None,
                 index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """16 uniform bits per element (int64) from a murmur3-finalised counter
    hash of (element index, salt, count): the JAX package's ``_hash_bits16``
    bit for bit.  ``count`` is an int or an int64 tensor on ``device``;
    ``index`` (int64, of ``shape``), the elements' indices where they are not
    ``0 .. n-1`` (a shard's global positions)."""
    n = 1
    for d in shape:
        n *= int(d)
    base = ((salt * 0x9E3779B1) + (count * 0x85EBCA6B)) & _M32
    idx = torch.arange(n, dtype=torch.int64, device=device) if index is None else \
        index.reshape(-1)
    h = (idx + base) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & 0xFFFF).reshape(tuple(shape))


def _shard_positions(shape, transposed: bool, start: int, full: int, device) -> torch.Tensor:
    """The flat positions, in the flax leaf's layout, of a port tensor of
    ``shape`` that is rows [start, start + shape[0]) of ``full`` rows: for a
    Linear weight (out, in) whose flax kernel is (in, out), ``i * full + o``;
    else row-major over (full, *shape[1:])."""
    rows = torch.arange(start, start + shape[0], dtype=torch.int64, device=device)
    inner = 1
    for d in shape[1:]:
        inner *= int(d)
    cols = torch.arange(inner, dtype=torch.int64, device=device)
    if transposed:
        return cols[None, :] * full + rows[:, None]
    return (rows[:, None] * inner + cols[None, :]).reshape(tuple(shape))


def stochastic_round_bf16_hash(x32: torch.Tensor, salt: int, count,
                               transposed: bool = False, lead: int = 0,
                               shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Stochastically round f32 values to the bf16 grid, returned as f32:
    add 16 hashed random bits to the IEEE bits and truncate the low 16, so
    ``E[round(x)] == x``.  ``transposed``: hash over the transposed layout
    (a flax kernel of this Linear weight).  ``lead``: leading (window) axes
    the hash does not see, every window drawing the same bits, as the JAX
    hash under ``jax.vmap`` over windows.  ``shard``: (start, full), the
    tensor is rows [start, start + its rows) of a leaf of ``full`` rows,
    hashed at their global positions.  Not inf/NaN-safe."""
    x32 = x32.float()
    shape = tuple(x32.shape[lead:])
    if shard is not None:
        index = _shard_positions(shape, transposed, shard[0], shard[1], x32.device)
        r = _hash_bits16(shape, salt, count, x32.device, index)
    else:
        r = _hash_bits16(shape[::-1] if transposed else shape, salt, count, x32.device)
        if transposed:
            r = r.T
    bits = x32.contiguous().view(torch.int32).to(torch.int64) & _M32
    bits = (bits + r) & 0xFFFF0000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _adam_math(g32, m, v, c1, c2):
    """The bias-corrected Adam update (f32 moments in, f32 out)."""
    m32 = B1 * m.float() + (1 - B1) * g32
    v32 = B2 * v.float() + (1 - B2) * g32 * g32
    u = (m32 / c1) / (torch.sqrt(v32 / c2) + EPS)
    return u, m32, v32


@dataclasses.dataclass
class ChainState:
    """The chain's state: its step count (the schedule's and Adam's) and the
    two moments of each tensor, stored in the moment dtype."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def chain_init(params: Sequence[torch.Tensor], moment_dtype: str = "float32") -> ChainState:
    dt = _DTYPES[moment_dtype]
    return ChainState(0, [torch.zeros_like(p, dtype=dt) for p in params],
                      [torch.zeros_like(p, dtype=dt) for p in params])


@torch.no_grad()
def chain_update(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                 state: ChainState, schedule: Callable[[int], torch.Tensor],
                 weight_decay: float, scales: Optional[Sequence[Optional[float]]] = None,
                 sr_salts: Optional[Sequence[Tuple[int, bool]]] = None,
                 lead: int = 0) -> List[torch.Tensor]:
    """One step of ``add_decayed_weights(weight_decay) ->
    scale_by_adam_stored -> scale_by_learning_rate(schedule)`` (the JAX
    package's optax chain): new parameter tensors, ``state`` updated in
    place.  A None gradient counts as zeros; the learning rate is read at
    the count before the step.  The weight decay is added in the
    parameter's dtype, as optax adds it (bf16: each operation rounded).

    Two more elements of the solver's chain, after the learning rate:
    ``scales``, a multiplier per tensor (None: none), as
    ``optax.masked(optax.scale(m))``; ``sr_salts``, a (salt, transposed)
    per bf16-stored tensor, its new value written back by stochastic
    rounding (``stochastic_round_updates``; the count is the chain's),
    hashed without the ``lead`` window axes."""
    lr = schedule(state.count)
    state.count += 1
    cf = _f32(float(state.count))
    c1, c2 = 1 - _f32(B1) ** cf, 1 - _f32(B2) ** cf
    out = []
    for i, (p, g) in enumerate(zip(params, grads)):
        g = torch.zeros_like(p) if g is None else g.to(p.dtype)
        g32 = (g + p * torch.tensor(weight_decay, dtype=p.dtype)).float()
        u, m32, v32 = _adam_math(g32, state.mu[i], state.nu[i], c1, c2)
        state.mu[i] = m32.to(state.mu[i].dtype)
        state.nu[i] = v32.to(state.nu[i].dtype)
        u = -lr * u
        if scales is not None and scales[i] is not None:
            u = u * scales[i]
        if sr_salts is None:
            out.append(p + u.to(p.dtype))
            continue
        p32 = p.float()
        salt, transposed = sr_salts[i]
        sr = stochastic_round_bf16_hash(p32 + u, salt, state.count, transposed, lead)
        out.append((p32 + (sr - p32)).to(p.dtype))
    return out


def flax_salts(names: Iterable[str]) -> Dict[str, Tuple[int, bool]]:
    """Port parameter name -> (salt, transposed): the salt is the index + 1
    of the parameter in the tree-flatten order (sorted keys) of the JAX
    package's flax parameters, where a latent Linear's ``weight`` is the
    transposed ``kernel``."""
    paths = {}
    for name in names:
        *mods, leaf = name.split(".")
        kernel = leaf == "weight" and mods[-1].startswith("latent_")
        paths[name] = (tuple(mods), "kernel" if kernel else leaf)
    order = sorted(paths, key=lambda n: (*paths[n][0], paths[n][1]))
    return {n: (i + 1, paths[n][1] == "kernel") for i, n in enumerate(order)}


class TorchAdamL2(torch.optim.Optimizer):
    """Adam + L2-in-gradient + the LR schedule over named parameters (see
    the module docstring).  State per parameter, made with the optimizer on
    the parameter's device: ``step`` (its count, an int64 0-dim tensor),
    ``exp_avg``, ``exp_avg_sq`` (``moment_dtype``); the group's ``step`` is
    the global count (an int64 0-dim tensor on the first parameter's
    device).

    A step is device work only, so that a CUDA graph can capture it: the
    counts, the learning rate, the bias corrections and the SR hash's count
    are tensors the step updates in place, and whether a parameter steps is
    decided on the device.  A parameter whose ``grad`` is None is skipped
    (with ``none_grad_skip``), as torch's Adam skips it; one whose gradient
    is all zeros is untouched, as the JAX package's traceable proxy reads it
    (``touched = any(g != 0)``): its value, moments and count are carried
    through by ``where``.  (A parameter in the graph never has an all-zero
    f32 gradient in practice; the curriculum's gated head always has one.)
    ``load_state_dict`` writes into the existing state tensors, so a
    captured step stays valid across a resume.

    ``shards``: the parameters sharded over ``model_group`` by name, (dim,
    start, full) (:func:`~hm_vae_torch.parallel.sharding.model_shards`):
    hashed at their global positions, and touched where the group's any is
    (see the module docstring)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 cfg: OptimConfig, shards: Optional[Dict[str, Tuple[int, int, int]]] = None,
                 model_group=None):
        named = list(named_params)
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.moment_dtype = _DTYPES[cfg.moment_dtype]
        if cfg.param_dtype not in _DTYPES:
            raise ValueError(f"unsupported param_dtype: {cfg.param_dtype!r} "
                             "(expected float32 | bfloat16)")
        self.param_sr = cfg.param_dtype == "bfloat16"
        if self.param_sr and not cfg.none_grad_skip:
            raise ValueError("param_dtype=bfloat16 requires none_grad_skip=True")
        names = [n for n, _ in named]
        salts = flax_salts(names)
        device = named[0][1].device if named else torch.device("cpu")
        shards = shards or {}
        self.model_group = model_group if shards else None
        # the hash's (start, full rows) of each sharded parameter
        self._shards = {p: shards[n][1:] for n, p in named if n in shards}
        super().__init__([{"params": [p for _, p in named],
                           "salts": [salts[n] for n in names],
                           "step": torch.zeros((), dtype=torch.int64, device=device)}],
                         {"lr": cfg.lr})

    def _fresh_state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        st["step"] = torch.zeros((), dtype=torch.int64, device=p.device)
        st["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
        st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.moment_dtype)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("TorchAdamL2 takes no closure")
        wd = float(self.cfg.weight_decay or 0.0)
        skip = self.cfg.none_grad_skip
        for group in self.param_groups:
            gstep = group["step"]
            lr = self.schedule(gstep)  # at the count before the step
            gstep.add_(1)
            touched_shard = self._touched_shards(group["params"]) if skip else {}
            for p, (salt, transposed) in zip(group["params"], group["salts"]):
                g = p.grad
                if g is None and skip:
                    continue
                state = self.state[p] or self._fresh_state(p)
                p32 = p.float()
                g32 = torch.zeros_like(p32) if g is None else g.float()
                if skip:
                    touched = touched_shard.get(p)
                    if touched is None:
                        touched = torch.any(g32 != 0)
                    state["step"].add_(touched.to(torch.int64))
                    # an untouched count may be 0: clamp the discarded branch
                    cf = state["step"].clamp_min(1).float()
                else:
                    touched = None
                    state["step"].copy_(gstep)
                    cf = gstep.float()
                if wd:
                    g32 = g32 + wd * p32
                m, v = state["exp_avg"], state["exp_avg_sq"]
                u, m32, v32 = _adam_math(g32, m, v, 1 - _f32(B1) ** cf, 1 - _f32(B2) ** cf)
                u = -lr * u  # CPU 0-dim tensors act as scalars on any device
                if self.param_sr:
                    new = stochastic_round_bf16_hash(p32 + u, salt, gstep, transposed,
                                                     shard=self._shards.get(p))
                else:
                    new = p + u.to(p.dtype)
                if touched is not None:
                    new = torch.where(touched, new, p32 if self.param_sr else p)
                    m32 = torch.where(touched, m32, m.float())
                    v32 = torch.where(touched, v32, v.float())
                p.copy_(new)
                m.copy_(m32)
                v.copy_(v32)
        return None

    def _touched_shards(self, params) -> Dict[torch.Tensor, torch.Tensor]:
        """Whether each sharded parameter with a gradient has a nonzero entry
        on any rank of the model group: one ``all_reduce`` MAX of the flags
        (the same parameters have gradients on every rank of the group)."""
        mine = [p for p in params if p in self._shards and p.grad is not None]
        if not mine or self.model_group is None:
            return {}
        flags = torch.stack([torch.any(p.grad != 0) for p in mine]).to(torch.float32)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self.model_group)
        return dict(zip(mine, (flags > 0).unbind()))

    def load_state_dict(self, state_dict) -> None:
        """Restore the counts and moments into the existing state tensors
        (bit for bit: torch would cast floating state to the parameter's
        dtype); a parameter without saved state but with state here is
        zeroed, as fresh."""
        group = self.param_groups[0]
        keep = {p: self.state[p] for p in group["params"] if self.state.get(p)}
        gstep = group["step"]
        saved = state_dict["state"]
        super().load_state_dict(state_dict)
        gstep.copy_(torch.as_tensor(self.param_groups[0]["step"]))
        self.param_groups[0]["step"] = gstep
        self.state.clear()
        for i, p in enumerate(group["params"]):
            s = saved.get(i)
            if s is None and p not in keep:
                continue
            st = self.state[p] = keep[p] if p in keep else self._fresh_state(p)
            for k, t in st.items():
                if s is None:
                    t.zero_()
                else:
                    t.copy_(torch.as_tensor(s[k]))


def make_optimizer(named_params, cfg: OptimConfig, shards=None, model_group=None
                   ) -> TorchAdamL2:
    """The training optimizer: torch-exact Adam with L2 and the grad-None
    skip (``none_grad_skip``, the default), else the plain chain; its
    sharded parameters (``shards`` over ``model_group``) as TorchAdamL2
    says."""
    return TorchAdamL2(named_params, cfg, shards, model_group)
