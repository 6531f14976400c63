"""Two-level hierarchical skeleton-aware sequence VAE (PyTorch).

Port of ``hm_vae_tpu.models.hm_vae``.  Module and parameter names follow the
flax tree (``encoder.conv_0.weight``, ``encoder.latent_head_0.weight``, ...),
with the latent Linear weights stored (out, in) as torch does.

Every skeleton conv is one launch of the ``fused_conv_pool`` kernel per
level on a CUDA device, on the JAX module's single folded weight
``P @ (W*mask) @ U`` and bias ``P @ b``, then LeakyReLU(0.2), or no
activation at the last decoder level.  Two paths:

- serving passes operands packed once (:meth:`HMVAE.conv_operands`) to
  :func:`~hm_vae_torch.ops.fused_conv_pool.fused_conv_pool_packed`;
- without them (training) a conv folds its weight with plain differentiable
  torch and runs :class:`~hm_vae_torch.ops.fused_conv_pool.FusedConvPoolFn`
  on its structure (the live tiles, decided once per device and dtype), so
  autograd carries the kernels' gradients back to the raw parameters.

:meth:`HMVAE.decode` also decodes through given decoder parameters (the
test-time solver's clones, ``model.apply(dec_sub, z, method=HMVAE.decode)``
in the JAX package).  A parameter with a leading window axis G is one clone
per window of a batch of G*n: the latent heads become batched matrix
products and the convs run
:class:`~hm_vae_torch.ops.fused_conv_pool.WindowedFusedConvPoolFn` on the
G folded weights.

With ``lora_rank`` r > 0 every decoder conv (its extra convs included; the
encoder has none) carries a rank-r adapter in folded weight space, as the
JAX module's ``SkeletonConv.lora_rank``: ``lora_a`` (out_f, r), zero at
init, and ``lora_b`` (r, in_f, K), uniform within +-1/sqrt(in_f*K), with
in_f the folded (pre-unpool) input channels.  Such a conv runs its base
conv through the kernel at slope 1.0 with no bias, adds the bias and
``A @ conv(x, B)`` (plain PyTorch: the rank-r conv as an im2col product,
batched over windows under per-window adapters), then the LeakyReLU: with
``lora_a == 0`` it is the base conv exactly.  The test-time solver's lora
scope passes the adapters in its parameter dict, beside the shared base
weights.

Under ``param_layout: compact`` a masked conv stores its mask-live entries
only (``weight_c`` (L, K), :mod:`.param_layout`) and its fold expands them
first, so the fold, the packing, the kernels, the export and the solver see
the dense layout's folded weight.

Hierarchical latents (shallow -> deep), for len-64/SMPL-24:
``[(B,14,2*shallow_d), (B,9,2*latent_d), (B,7,2*latent_d), (B,7,2*latent_d)]``.
The decoder reads only the deepest z (seeds level 0) and the shallowest z
(channel-concat at the last level); the middle latents are ignored.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import skeleton_nn as snn
from ..ops.fused_conv_pool import (FusedConvPoolFn, LevelStructure, PackedLevel,
                                   WindowedFusedConvPoolFn, fold_operands,
                                   fused_conv_pool_packed, pack_structure, repack)
from ..utils.config import ModelConfig
from . import param_layout as pl
from .structure import ConvSpec, get_structure

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

def _block_uniform(spec: ConvSpec, shape, generator) -> torch.Tensor:
    """Per-edge-block kaiming-uniform init: output block i draws
    U(-b_i, b_i) with ``b_i = 1/sqrt(fan_in_block_i)``."""
    bounds = np.repeat(spec.block_bounds, spec.out_channels // spec.n_edges)
    u = torch.rand(shape, generator=generator) * 2.0 - 1.0
    return u * torch.from_numpy(bounds).reshape((-1,) + (1,) * (len(shape) - 1))


def dense_kernel_init(init_type: str, out_f: int, in_f: int, generator) -> torch.Tensor:
    """The reference trainer's ``weights_init`` for the latent Linear heads,
    as a (out, in) weight; the bias is zero in every scheme.

      gaussian   normal(0, 0.02)
      xavier     normal, std 2/sqrt(fan_in + fan_out)   (gain sqrt(2))
      kaiming    normal, std sqrt(2/fan_in)
      orthogonal semi-orthogonal, gain sqrt(2)
      default    uniform(+-1/sqrt(fan_in))
    """
    shape = (out_f, in_f)
    if init_type == "gaussian":
        return torch.randn(shape, generator=generator) * 0.02
    if init_type == "xavier":
        return torch.randn(shape, generator=generator) * (2.0 / math.sqrt(in_f + out_f))
    if init_type == "kaiming":
        return torch.randn(shape, generator=generator) * math.sqrt(2.0 / in_f)
    if init_type == "orthogonal":
        a = torch.randn((max(shape), min(shape)), generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        return (q if out_f >= in_f else q.T) * math.sqrt(2.0)
    if init_type == "default":
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) / math.sqrt(in_f)
    raise ValueError(f"unsupported init: {init_type!r} "
                     "(expected gaussian|xavier|kaiming|orthogonal|default)")


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype, as a flax Dense
    promotes bf16-stored parameters (``param_dtype: bfloat16``) to f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def windowed_linear(z: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``z @ weight.T + bias`` in z's dtype: for a (out, in) weight as a
    :class:`Linear` computes it; for G windows' (G, out, in) weights and (G,
    out) biases, window g's rows of z (G*n, ..., in) through weight g."""
    w, b = weight.to(z.dtype), bias.to(z.dtype)
    if w.dim() == 2:
        return nn.functional.linear(z, w, b)
    G = w.shape[0]
    out = torch.baddbmm(b[:, None, :], z.reshape(G, -1, z.shape[-1]), w.transpose(1, 2))
    return out.reshape(z.shape[:-1] + (w.shape[1],))


def _linear(in_f: int, out_f: int, init_type: str, generator) -> Linear:
    lin = Linear(in_f, out_f)
    with torch.no_grad():
        lin.weight.copy_(dense_kernel_init(init_type, out_f, in_f, generator))
        lin.bias.zero_()
    return lin


def lora_b_init(rank: int, in_f: int, kernel_size: int, generator) -> torch.Tensor:
    """A fresh ``lora_b`` (r, in_f, K): uniform within +-1/sqrt(in_f*K), the
    folded fan-in."""
    u = torch.rand((rank, in_f, kernel_size), generator=generator) * 2.0 - 1.0
    return u / math.sqrt(in_f * kernel_size)


def lora_delta(x: torch.Tensor, lora_a: torch.Tensor, lora_b: torch.Tensor, stride: int,
               padding: int, padding_mode: str) -> torch.Tensor:
    """``A @ conv(x, B)`` of an adapter on x (B, in_f, T): the rank-r conv
    as an im2col product (``unfold``, then one matrix product), and A; for
    G windows' adapters (G, out_f, r) and (G, r, in_f, K), window g's rows
    of x (G*n, ...) through adapter g, one batched product over windows."""
    a, b = lora_a.to(x.dtype), lora_b.to(x.dtype)
    cols = snn.pad_temporal(x, padding, padding_mode).unfold(2, b.shape[-1], stride)
    if a.dim() == 2:  # cols (B, in_f, T_out, K)
        return torch.einsum("or,brt->bot", a, torch.einsum("bctk,rck->brt", cols, b))
    G = a.shape[0]
    lo = torch.einsum("gnctk,grck->gnrt", cols.reshape((G, -1) + cols.shape[1:]), b)
    return torch.einsum("gor,gnrt->gnot", a, lo).reshape(x.shape[0], a.shape[1], -1)


def _const(a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a, np.float32))


class SkeletonConv(nn.Module):
    """Masked temporal conv over (B, C, T), fused with an optional skeleton
    pool after it (``pool_matrix`` (Q, C_out)), an optional skeleton unpool
    folded in before it (``unpool_matrix`` (C_in, P)) and a LeakyReLU
    (``negative_slope`` 1.0 is none); with ``lora_rank`` > 0, a rank-r
    adapter on the folded weight (see the module docstring).  Under the
    compact ``param_layout`` a masked conv holds ``weight_c`` (L, K), drawn
    within its rows' bounds as the JAX module's
    ``_skeleton_conv_compact_weight_init``; otherwise ``weight``."""

    def __init__(self, spec: ConvSpec, compute_dtype: str = "float32",
                 pool_matrix: Optional[np.ndarray] = None,
                 unpool_matrix: Optional[np.ndarray] = None,
                 negative_slope: float = 1.0,
                 generator: Optional[torch.Generator] = None, lora_rank: int = 0,
                 param_layout: str = "dense"):
        super().__init__()
        self.spec = spec
        self.dtype = _DTYPES[compute_dtype]
        self.negative_slope = negative_slope
        self.compact = pl.is_compact_spec(spec, param_layout)
        if self.compact:
            meta = pl.compact_meta(spec)
            u = torch.rand((meta.n_live, spec.kernel_size), generator=generator) * 2.0 - 1.0
            self.weight_c = nn.Parameter(u * torch.from_numpy(meta.row_bounds)[:, None])
        else:
            self.weight = nn.Parameter(_block_uniform(
                spec, (spec.out_channels, spec.in_channels, spec.kernel_size), generator))
        self.bias = (nn.Parameter(_block_uniform(spec, (spec.out_channels,), generator))
                     if spec.bias else None)
        # a fully dense level (enc3, dec0 at len-64) skips the mask multiply,
        # and a compact one expands to exact zeros
        skip = bool(spec.mask.all()) or self.compact
        self.register_buffer("mask", None if skip else _const(spec.mask), persistent=False)
        self.register_buffer("pool", _const(pool_matrix), persistent=False)
        self.register_buffer("unpool", _const(unpool_matrix), persistent=False)
        self._structures: Dict[tuple, LevelStructure] = {}
        if lora_rank > 0:
            out_f, in_f = self.folded_shape()
            self.lora_a = nn.Parameter(torch.zeros(out_f, lora_rank))
            self.lora_b = nn.Parameter(lora_b_init(lora_rank, in_f, spec.kernel_size,
                                                   generator))
        else:
            self.lora_a = self.lora_b = None

    @property
    def raw_weight(self) -> nn.Parameter:
        """The stored weight: ``weight_c`` (compact) or ``weight``."""
        return self.weight_c if self.compact else self.weight

    def folded_shape(self) -> Tuple[int, int]:
        """(out_f, in_f) of the folded weight: the pool's rows, the unpool's
        (pre-unpool) columns."""
        out_f = self.spec.out_channels if self.pool is None else self.pool.shape[0]
        in_f = self.spec.in_channels if self.unpool is None else self.unpool.shape[1]
        return out_f, in_f

    def fold(self, weight: torch.Tensor, bias: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The JAX module's single conv weight and bias from this conv's
        ``weight`` and ``bias``: ``W*mask`` with the unpool folded in
        (``@ U``) and the pool folded on (``P @``, ``P @ b``).  G windows'
        weights (G, C_out, C_in, K) and biases (G, C_out) fold each.  A
        compact weight ((L, K), or (G, L, K)) is expanded first."""
        w = weight.to(self.dtype)
        b = None if bias is None else bias.to(self.dtype)
        if self.compact:
            w = pl.expand(w, self.spec)
        elif self.mask is not None:
            w = w * self.mask.to(self.dtype)[:, :, None]
        if w.dim() == 3:
            if self.unpool is not None:
                w = torch.einsum("ock,cp->opk", w, self.unpool.to(self.dtype))
            pool = None if self.pool is None else self.pool.to(self.dtype)
            return fold_operands(w, b, None, pool)
        if self.unpool is not None:
            w = torch.einsum("gock,cp->gopk", w, self.unpool.to(self.dtype))
        if self.pool is not None:
            pool = self.pool.to(self.dtype)
            w = torch.einsum("qo,gock->gqck", pool, w)
            b = None if b is None else b @ pool.T
        return w.contiguous(), b

    def folded_weight(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """:meth:`fold` of this conv's own parameters."""
        return self.fold(self.raw_weight, self.bias)

    def structure(self, negative_slope: Optional[float] = None,
                  padding: Optional[int] = None) -> LevelStructure:
        """The tiles of the folded weight that may be nonzero, from the
        structure alone (mask, unpool and pool folded over a weight of
        ones), so that a trained value of zero keeps its tile; made once per
        device, compute dtype, spec, slope (default: the conv's own; an
        adapter's base conv runs at 1.0) and padding (default: the spec's;
        0 for the VALID conv of sequence parallelism, which pads by halo
        exchange)."""
        slope = self.negative_slope if negative_slope is None else float(negative_slope)
        padding = self.spec.padding if padding is None else int(padding)
        device = self.raw_weight.device
        key = (device, self.dtype, self.spec, slope, padding)
        if key not in self._structures:
            live = self.spec.mask != 0
            if self.unpool is not None:
                live = (live.astype(np.float64) @ (self.unpool.cpu().numpy() != 0)) > 0
            if self.pool is not None:
                live = ((self.pool.cpu().numpy() != 0).astype(np.float64) @ live) > 0
            s = self.spec
            self._structures[key] = pack_structure(
                torch.from_numpy(live), s.kernel_size, self.dtype, s.stride, padding,
                s.padding_mode, slope, device=device)
        return self._structures[key]

    @torch.no_grad()
    def packed_operands(self, padding: Optional[int] = None) -> PackedLevel:
        """The folded weight and bias packed for the kernel (block-sparse
        tiles in the compute dtype), at the spec's padding or ``padding``."""
        if self.lora_a is not None:
            raise ValueError("a conv with adapters runs through forward_with (the base conv "
                             "at slope 1.0, then bias, adapter and activation)")
        return repack(self.structure(padding=padding), *self.folded_weight())

    def forward(self, x: torch.Tensor, packed: Optional[PackedLevel] = None) -> torch.Tensor:
        if packed is not None:
            return fused_conv_pool_packed(x.to(packed.dtype).contiguous(), packed)
        return self.forward_with(x, self.raw_weight, self.bias, self.lora_a, self.lora_b)

    def forward_with(self, x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], lora_a: Optional[torch.Tensor] = None,
                     lora_b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv on given parameters (``weight`` in this conv's layout),
        differentiable: G windows' weights (G, C_out, C_in, K), or (G, L, K),
        take x (G*n, ...) window by window.  With an
        adapter (``lora_a``, ``lora_b``; G windows' stacked, with their
        biases (G, C_out)) the one shared base weight runs through the
        kernel at slope 1.0 without its bias, then the bias and the
        adapter's delta are added and the activation applied."""
        x = x.to(self.dtype).contiguous()
        if lora_a is None:
            w, b = self.fold(weight, bias)
            fn = WindowedFusedConvPoolFn if w.dim() == 4 else FusedConvPoolFn
            return fn.apply(x, w, b, self.structure())
        if weight.dim() != (2 if self.compact else 3):
            raise ValueError("an adapter's base weight is shared by every window")
        w, _ = self.fold(weight, None)
        out = FusedConvPoolFn.apply(x, w, None, self.structure(1.0))
        if bias is not None:
            b = bias.to(out.dtype)
            if b.dim() == 1:
                out = out + b[:, None]
            else:
                out = (out.reshape((b.shape[0], -1) + out.shape[1:]) + b[:, None, :, None]
                       ).reshape(out.shape)
        s = self.spec
        out = out + lora_delta(x, lora_a, lora_b, s.stride, s.padding, s.padding_mode)
        return snn.leaky_relu(out, self.negative_slope)


OperandMap = Dict[SkeletonConv, PackedLevel]
ParamMap = Mapping[str, torch.Tensor]


def _run(conv: SkeletonConv, x: torch.Tensor, ops: Optional[OperandMap],
         params: Optional[ParamMap] = None, name: str = "") -> torch.Tensor:
    if params is not None:
        weight = params[f"{name}.weight_c" if conv.compact else f"{name}.weight"]
        return conv.forward_with(x, weight, params.get(f"{name}.bias"),
                                 params.get(f"{name}.lora_a"), params.get(f"{name}.lora_b"))
    return conv(x, None if ops is None else ops[conv])


class Encoder(nn.Module):
    """4-level skeleton conv/pool encoder with per-level latent heads.

    Input (B, n_joints*input_dim, T); returns the deepest feature map and the
    per-level latent stats (B, k_edges, 2*latent_d), shallow -> deep.
    """

    def __init__(self, cfg: ModelConfig, init_type: str = "kaiming",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.structure = st = get_structure(cfg)
        layout = cfg.param_layout
        for i, lvl in enumerate(st.encoder_levels):
            for e, espec in enumerate(lvl.extra_convs):
                self.add_module(f"conv_{i}_extra_{e}", SkeletonConv(
                    espec, cfg.compute_dtype, generator=generator, param_layout=layout))
            self.add_module(f"conv_{i}", SkeletonConv(
                lvl.conv, cfg.compute_dtype, pool_matrix=lvl.pool_matrix,
                negative_slope=0.2, generator=generator, param_layout=layout))
            self.add_module(f"latent_head_{i}", _linear(
                lvl.latent_in, lvl.latent_out, init_type, generator))

    def forward(self, x: torch.Tensor, ops: Optional[OperandMap] = None):
        z_stats: List[torch.Tensor] = []
        for i, lvl in enumerate(self.structure.encoder_levels):
            for e in range(len(lvl.extra_convs)):
                x = _run(getattr(self, f"conv_{i}_extra_{e}"), x, ops)
            x = _run(getattr(self, f"conv_{i}"), x, ops)
            x = x.float()  # latent heads and stats stay f32
            # (B, k_edges*cpe, T') -> (B, k_edges, cpe*T'): needs (B, C, T) layout
            per_edge = x.reshape(x.shape[0], lvl.pooled_edges, -1)
            z_stats.append(getattr(self, f"latent_head_{i}")(per_edge))
        return x, z_stats


class Decoder(nn.Module):
    """Mirror decoder: latent re-inflation, then upsample and unpool-folded
    conv per level.  Takes the z list (shallow -> deep) and returns
    (B, n_joints*output_dim, T).  With ``params`` (every decoder parameter
    by its name here, ``latent_dec_0.weight``, ..., and a conv's adapter
    ``conv_0.lora_a`` / ``conv_0.lora_b`` where it has one) it decodes
    through those tensors instead of its own (a compact conv's weight as
    ``conv_0.weight_c``)."""

    def __init__(self, cfg: ModelConfig, init_type: str = "kaiming",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.structure = st = get_structure(cfg)
        nl = cfg.num_layers
        layout = cfg.param_layout
        for i, lvl in enumerate(st.decoder_levels):
            self.add_module(f"latent_dec_{i}", _linear(
                lvl.latent_in, lvl.latent_out, init_type, generator))
        for i, lvl in enumerate(st.decoder_levels):
            slope = 0.2 if lvl.leaky else 1.0
            for e, espec in enumerate(lvl.extra_convs):
                self.add_module(f"conv_{i}_extra_{e}", SkeletonConv(
                    espec, cfg.compute_dtype, generator=generator, lora_rank=cfg.lora_rank,
                    param_layout=layout))
            if lvl.extra_convs:
                # extra convs sit between the unpool and the main conv: the
                # unpool is applied as a matrix, not folded
                self.register_buffer(f"unpool_{i}", _const(lvl.unpool_matrix),
                                     persistent=False)
            self.add_module(f"conv_{i}", SkeletonConv(
                lvl.conv, cfg.compute_dtype,
                unpool_matrix=None if lvl.extra_convs else lvl.unpool_matrix,
                negative_slope=slope, generator=generator, lora_rank=cfg.lora_rank,
                param_layout=layout))
        self.num_layers = nl

    def forward(self, z_list: Sequence[torch.Tensor], ops: Optional[OperandMap] = None,
                params: Optional[ParamMap] = None) -> torch.Tensor:
        st = self.structure
        nl = self.num_layers
        B = z_list[0].shape[0]

        def feats(i):
            z = z_list[nl - i - 1]
            name = f"latent_dec_{i}"
            if params is None:
                out = getattr(self, name)(z)
            else:
                out = windowed_linear(z, params[f"{name}.weight"], params[f"{name}.bias"])
            return out.reshape(B, -1, st.decoder_levels[i].timestep)

        x = None
        for i, lvl in enumerate(st.decoder_levels):
            if i == 0:
                x = feats(0)
            elif i == nl - 1:
                # channel-concat the shallow latent features per edge, on the
                # pre-unpool edge count
                pre_edges = st.cascade.pooled_edge_num[0]
                T_i = x.shape[-1]
                f = feats(i)
                dt = torch.promote_types(x.dtype, f.dtype)
                x = torch.cat((x.to(dt).reshape(B, pre_edges, -1, T_i),
                               f.to(dt).reshape(B, pre_edges, -1, T_i)),
                              dim=2).reshape(B, -1, T_i)
            if lvl.upsample:
                x = snn.upsample_linear(x, 2)
            if lvl.extra_convs:
                x = snn.apply_channel_matrix(x, getattr(self, f"unpool_{i}").to(x.dtype))
                for e in range(len(lvl.extra_convs)):
                    name = f"conv_{i}_extra_{e}"
                    x = _run(getattr(self, name), x, ops, params, name)
            x = _run(getattr(self, f"conv_{i}"), x, ops, params, f"conv_{i}")
        return x


class HMVAE(nn.Module):
    """Hierarchical skeleton-aware VAE: encode to z stats, decode z lists."""

    def __init__(self, cfg: ModelConfig, init_type: str = "kaiming",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        pl.validate_layout(cfg.param_layout)
        self.cfg = cfg
        self.encoder = Encoder(cfg, init_type, generator)
        self.decoder = Decoder(cfg, init_type, generator)

    def conv_operands(self) -> OperandMap:
        """Every conv's packed operands, computed once (see
        :meth:`SkeletonConv.packed_operands`)."""
        return {m: m.packed_operands() for m in self.modules()
                if isinstance(m, SkeletonConv)}

    def forward(self, x6d: torch.Tensor):
        """x6d (B, T, n_joints, 6) -> (z stats list, decoding of the means)."""
        _, z_stats = self.encode(x6d)
        z_means = [split_stats(s, self.cfg, i)[0] for i, s in enumerate(z_stats)]
        return z_stats, self.decode(z_means)

    def encode(self, x6d: torch.Tensor, ops: Optional[OperandMap] = None):
        """x6d (B, T, n_joints, 6) -> (deep feature, z stats list)."""
        B, T, J, D = x6d.shape
        x = x6d.reshape(B, T, J * D).transpose(1, 2).contiguous()
        return self.encoder(x, ops)

    def decode(self, z_list: Sequence[torch.Tensor], ops: Optional[OperandMap] = None,
               params: Optional[ParamMap] = None) -> torch.Tensor:
        """z list (shallow -> deep) -> 6D output (B, T, n_joints, output_dim),
        through the decoder's own parameters, its packed ``ops``, or the
        decoder parameters ``params`` (see :class:`Decoder`)."""
        out = self.decoder(z_list, ops, params).float()
        B, _, T = out.shape
        return out.transpose(1, 2).reshape(B, T, self.cfg.n_joints, self.cfg.output_dim)


def split_stats(stats: torch.Tensor, cfg: ModelConfig, level: int):
    """(B, k, 2*d) -> (mu, logvar), d = shallow_latent_d at level 0."""
    d = cfg.shallow_latent_d if level == 0 else cfg.latent_d
    return stats[..., :d], stats[..., d:]


def reparametrize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(logvar/2), with the noise ``eps`` given."""
    return mu + eps * torch.exp(0.5 * logvar)


def prior_z_list(cfg: ModelConfig, batch: int,
                 generator: Optional[torch.Generator] = None,
                 device="cpu") -> List[torch.Tensor]:
    """z ~ N(0, I) for the deepest and shallowest levels, zeros for the
    unused middles.  Drawn on the CPU from ``generator``, then moved."""
    st = get_structure(cfg)
    zs = []
    for i in range(cfg.num_layers):
        shape = (batch, st.z_edges[i], st.z_dims[i])
        if i == 0 or i == cfg.num_layers - 1:
            z = torch.randn(shape, generator=generator)
        else:
            z = torch.zeros(shape)
        zs.append(z.to(device))
    return zs
