"""Compact (mask-live-only) storage for the skeleton convs' weights.

Port of ``hm_vae_tpu.models.param_layout``, its numpy parts copied.  Under
``param_layout: compact`` a masked conv stores only its mask-live entries as
``weight_c`` (L, K), L the live (out_channel, in_channel) pairs in row-major
order, and expands them to the dense (C_out, C_in, K) weight at each call by
a gather whose dead entries are exact zeros, so no mask multiply is needed.
The layout is function-exact against ``dense``: outputs, the live entries'
gradients and their Adam trajectories are the same (Adam is elementwise);
only the dead entries, which nothing reads, cease to exist.  A fully dense
conv (``mask.all()``, the deepest levels) keeps its plain ``weight``.

The expander (:class:`ExpandCompact`) is a gather both ways: forward from
the (L + 1)-row weight padded with a zero row, backward the dense gradient
gathered at the live positions (autograd's transpose of the forward gather
would scatter every dead entry's gradient into the zero row).  The JAX
module gathers runs of a row's columns at once (``run_w``), a TPU lane-width
measure; here rows are gathered, in the same row-major order.

Checkpoints of the port are dense (``utils/weights.py``); the conversions
below turn a state dict (:func:`convert_state_dict`) or the optimizer's
state (:func:`convert_optimizer_state`) from one layout into the other.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..utils.config import ModelConfig
from .structure import ConvSpec, get_structure, get_trajectory_structure

PARAM_LAYOUTS = ("dense", "compact")


def validate_layout(layout: str) -> None:
    if layout not in PARAM_LAYOUTS:
        raise ValueError(f"unsupported param_layout: {layout!r} (expected one of "
                         f"{PARAM_LAYOUTS})")


def is_compact_spec(spec: ConvSpec, layout: str) -> bool:
    """Whether this conv stores ``weight_c`` under the given layout."""
    validate_layout(layout)
    return layout == "compact" and not spec.mask.all()


@dataclasses.dataclass(eq=False)
class CompactMeta:
    n_live: int                 # L
    gather_idx: np.ndarray      # (C_out*C_in,) int64 in [0..L]; L = the zero row
    live_flat: np.ndarray       # (L,) int64 positions into C_out*C_in
    row_bounds: np.ndarray      # (L,) each live row's kaiming-uniform bound


@functools.lru_cache(maxsize=None)
def compact_meta(spec: ConvSpec) -> CompactMeta:
    """The constant index maps of one conv spec (cached by identity: specs
    live in the cached structure objects)."""
    mask = spec.mask.astype(bool)                      # (C_out, C_in)
    live_flat = np.flatnonzero(mask.ravel()).astype(np.int64)
    n_live = live_flat.size
    gather_idx = np.full(mask.size, n_live, dtype=np.int64)
    gather_idx[live_flat] = np.arange(n_live, dtype=np.int64)
    per_out = np.repeat(spec.block_bounds, spec.out_channels // spec.n_edges)  # (C_out,)
    rows_o = live_flat // spec.in_channels
    return CompactMeta(n_live=n_live, gather_idx=gather_idx, live_flat=live_flat,
                       row_bounds=per_out[rows_o].astype(np.float32))


def compact_from_dense(weight: np.ndarray, spec: ConvSpec) -> np.ndarray:
    """Dense (C_out, C_in, K) -> compact (L, K): the live rows, row-major."""
    return np.asarray(weight)[spec.mask.astype(bool)]


def dense_from_compact(w_c: np.ndarray, spec: ConvSpec) -> np.ndarray:
    """Compact (L, K) -> dense (C_out, C_in, K) with exact-zero dead rows."""
    w_c = np.asarray(w_c)
    k = w_c.shape[-1]
    dense = np.zeros((spec.out_channels * spec.in_channels, k), w_c.dtype)
    dense[compact_meta(spec).live_flat] = w_c
    return dense.reshape(spec.out_channels, spec.in_channels, k)


_INDEX: Dict[tuple, tuple] = {}


def _indices(spec: ConvSpec, device: torch.device):
    """(gather_idx, live_flat) as int64 tensors on ``device``, made once."""
    key = (id(spec), device)
    if key not in _INDEX:
        meta = compact_meta(spec)
        _INDEX[key] = (spec, torch.from_numpy(meta.gather_idx).to(device),
                       torch.from_numpy(meta.live_flat).to(device))
    return _INDEX[key][1:]


class ExpandCompact(torch.autograd.Function):
    """``ExpandCompact.apply(w_c, spec)``: (..., L, K) -> (..., C_out, C_in,
    K), leading (window) axes kept; the dead entries exact zeros.  Its
    backward gathers the dense gradient at the live positions (JAX's
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, w_c, spec: ConvSpec):
        gather, _ = _indices(spec, w_c.device)
        ctx.spec = spec
        lead, k = w_c.shape[:-2], w_c.shape[-1]
        pad = torch.cat((w_c, w_c.new_zeros(lead + (1, k))), dim=-2)
        dense = pad.index_select(pad.dim() - 2, gather)
        return dense.reshape(lead + (spec.out_channels, spec.in_channels, k))

    @staticmethod
    def backward(ctx, g):
        s = ctx.spec
        _, live = _indices(s, g.device)
        lead, k = g.shape[:-3], g.shape[-1]
        flat = g.reshape(lead + (s.out_channels * s.in_channels, k))
        return flat.index_select(flat.dim() - 2, live), None


def expand(w_c: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    return ExpandCompact.apply(w_c, spec)


def conv_specs_for(cfg: ModelConfig) -> Dict[str, ConvSpec]:
    """The port's module name of every conv (``encoder.conv_0``,
    ``decoder.conv_1_extra_0``, ...) -> its spec."""
    if cfg.model_name == "TrajectoryModel":
        st = get_trajectory_structure(cfg)
        return {f"encoder.conv_{i}": lvl.conv for i, lvl in enumerate(st.levels)}
    st = get_structure(cfg)
    out: Dict[str, ConvSpec] = {}
    for part, levels in (("encoder", st.encoder_levels), ("decoder", st.decoder_levels)):
        for i, lvl in enumerate(levels):
            out[f"{part}.conv_{i}"] = lvl.conv
            for e, espec in enumerate(lvl.extra_convs):
                out[f"{part}.conv_{i}_extra_{e}"] = espec
    return out


def params_layout(names: Sequence[str]) -> str:
    """The layout of a state dict's (or a flat name list's) conv weights:
    compact where any conv stores ``weight_c`` (fully dense convs keep
    ``weight`` under both)."""
    return "compact" if any(n.endswith(".weight_c") for n in names) else "dense"


def _convert(value, spec: ConvSpec, to_layout: str):
    """One conv weight (or moment) in ``to_layout``: numpy or a tensor
    (returned on its device and in its dtype)."""
    if torch.is_tensor(value):
        host = value.detach().cpu()
        out = _convert(host.float().numpy() if host.dtype == torch.bfloat16 else host.numpy(),
                       spec, to_layout)
        return torch.from_numpy(np.ascontiguousarray(out)).to(value.device, value.dtype)
    if to_layout == "compact":
        return compact_from_dense(value, spec)
    return dense_from_compact(value, spec)


def convert_state_dict(sd: Mapping, cfg: ModelConfig, to_layout: str) -> dict:
    """A state dict (the port's names) with every masked conv weight in
    ``to_layout``: ``weight`` (C_out, C_in, K) <-> ``weight_c`` (L, K).
    Exact both ways for what the function reads: dense -> compact drops the
    dead entries only, compact -> dense rebuilds them as zeros.  Other
    entries pass through."""
    validate_layout(to_layout)
    specs = conv_specs_for(cfg)
    out = {}
    for name, value in sd.items():
        module, _, leaf = name.rpartition(".")
        spec = specs.get(module)
        if spec is not None and leaf in ("weight", "weight_c") and not spec.mask.all():
            want = "weight_c" if to_layout == "compact" else "weight"
            if leaf != want:
                out[f"{module}.{want}"] = _convert(value, spec, to_layout)
                continue
        out[name] = value
    return out


def convert_optimizer_state(opt_sd: Mapping, names: Sequence[str], cfg: ModelConfig,
                            to_layout: str) -> dict:
    """:class:`~hm_vae_torch.train.optim.TorchAdamL2`'s ``state_dict`` with
    each masked conv weight's moments (``exp_avg``, ``exp_avg_sq``) in
    ``to_layout``, as the weights convert; ``names`` are the parameters' names
    in the optimizer's order (either layout: ``weight`` and ``weight_c``
    hold the same place).  The counts pass through: a dead entry's moments
    influence nothing and rebuild as zeros."""
    validate_layout(to_layout)
    specs = conv_specs_for(cfg)
    state = {}
    for i, st in opt_sd["state"].items():
        module, _, leaf = names[int(i)].rpartition(".")
        spec = specs.get(module)
        st = dict(st)
        if spec is not None and leaf in ("weight", "weight_c") and not spec.mask.all():
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st and st[k].dim() == (3 if to_layout == "compact" else 2):
                    st[k] = _convert(st[k], spec, to_layout)
        state[i] = st
    return {**opt_sd, "state": state}
