"""Static per-level architecture metadata for the hierarchical VAE.

A numpy copy of ``hm_vae_tpu.models.structure`` (HMVAE part): every shape,
stride, mask and pool/unpool matrix the encoder and decoder need, including
the len-8 and len-16 stride and timestep schedules of the reference.  Built
once per frozen :class:`ModelConfig` through an ``lru_cache``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np

from ..ops import topology as tp
from ..utils.config import ModelConfig


@dataclasses.dataclass(eq=False)
class ConvSpec:
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int
    padding: int
    padding_mode: str          # 'reflect' | 'constant'
    bias: bool
    mask: np.ndarray           # (C_out, C_in) 0/1, broadcast over K
    block_bounds: np.ndarray   # (n_edges,) per-out-block init bound
    n_edges: int


@dataclasses.dataclass(eq=False)
class EncoderLevel:
    conv: ConvSpec
    pool_matrix: np.ndarray        # (k_edges*cpe, n_edges*cpe)
    pooled_edges: int
    latent_in: int                 # channel_base[i+1] * timestep_out
    latent_out: int                # 2 * (shallow_)latent_d
    timestep_out: int
    # stride-1 in->in convs ahead of the strided conv, no activation between
    extra_convs: List[ConvSpec] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(eq=False)
class DecoderLevel:
    upsample: bool
    unpool_matrix: np.ndarray      # (n_edges*cpe, k_edges*cpe)
    conv: ConvSpec
    leaky: bool
    latent_in: int                 # z dim for this level's latent features
    latent_out: int                # channel_base * timestep
    timestep: int
    z_edges: int
    # stride-1 in->in convs between the unpool and the main conv
    extra_convs: List[ConvSpec] = dataclasses.field(default_factory=list)


class HMVAEStructure:
    """Encoder/decoder cascade metadata for one :class:`ModelConfig`."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        nl = cfg.num_layers
        casc = tp.get_cascade(tp.SMPL24_PARENTS, nl, cfg.skeleton_dist)
        self.cascade = casc
        pad_mode = {"reflection": "reflect", "zeros": "constant"}.get(
            cfg.padding_mode, cfg.padding_mode)
        k = cfg.kernel_size
        padding = (k - 1) // 2

        self.channel_base = [cfg.input_dim]
        for _ in range(nl):
            self.channel_base.append(self.channel_base[-1] * 2)

        # encoder timestep schedule, with the len-8/16 special cases
        T = cfg.train_seq_len
        self.enc_timesteps = [T]
        self.enc_strides: List[int] = []
        for i in range(nl):
            if T == 8:
                stride = 1 if (i == 0 or i == nl - 1) else 2
            elif T == 16:
                stride = 1 if i == 0 else 2
            else:
                stride = 2
            self.enc_strides.append(stride)
            self.enc_timesteps.append(self.enc_timesteps[-1] // stride)

        self.channel_list = [self.channel_base[0] * casc.edge_num[0]]
        self.encoder_levels: List[EncoderLevel] = []
        for i in range(nl):
            n_edges = casc.edge_num[i]
            in_ch = self.channel_base[i] * n_edges
            out_ch = self.channel_base[i + 1] * n_edges
            self.channel_list.append(out_ch)
            conv = ConvSpec(
                in_channels=in_ch, out_channels=out_ch, kernel_size=k,
                stride=self.enc_strides[i], padding=padding,
                padding_mode=pad_mode, bias=True,
                mask=tp.conv_channel_mask(casc.neighbours[i], self.channel_base[i],
                                          self.channel_base[i + 1]),
                block_bounds=_block_bounds(casc.neighbours[i],
                                           self.channel_base[i], k),
                n_edges=n_edges,
            )
            extras = [
                _extra_conv_spec(casc.neighbours[i], self.channel_base[i],
                                 k, padding, pad_mode, True, n_edges)
                for _ in range(cfg.extra_conv)
            ]
            self.encoder_levels.append(EncoderLevel(
                conv=conv,
                pool_matrix=tp.pooling_matrix(casc.pooling_lists[i], n_edges,
                                              out_ch // n_edges),
                pooled_edges=casc.pooled_edge_num[i],
                latent_in=self.channel_base[i + 1] * self.enc_timesteps[i + 1],
                latent_out=2 * (cfg.shallow_latent_d if i == 0 else cfg.latent_d),
                timestep_out=self.enc_timesteps[i + 1],
                extra_convs=extras,
            ))

        # z edge counts and dims, shallow -> deep
        self.z_edges = [lvl.pooled_edges for lvl in self.encoder_levels]
        self.z_dims = [cfg.shallow_latent_d if i == 0 else cfg.latent_d
                       for i in range(nl)]

        self.dec_timesteps = list(reversed(self.enc_timesteps))
        self.decoder_levels: List[DecoderLevel] = []
        for i in range(nl):
            enc_idx = nl - i - 1
            n_edges = casc.edge_num[enc_idx]
            if i == nl - 1:
                in_ch = self.channel_list[nl - i] * 2
                out_ch = in_ch // 4
            else:
                in_ch = self.channel_list[nl - i]
                out_ch = in_ch // 2
            if T == 8:
                upsample = i != nl - 1 and i != 0
            elif T == 16:
                upsample = i != nl - 1
            else:
                upsample = True
            bias = not (i != 0 and i != nl - 1)
            in_cpe = in_ch // n_edges
            out_cpe = out_ch // n_edges
            conv = ConvSpec(
                in_channels=in_ch, out_channels=out_ch, kernel_size=k,
                stride=1, padding=padding, padding_mode=pad_mode, bias=bias,
                mask=tp.conv_channel_mask(casc.neighbours[enc_idx], in_cpe, out_cpe),
                block_bounds=_block_bounds(casc.neighbours[enc_idx], in_cpe, k),
                n_edges=n_edges,
            )
            extras = [
                _extra_conv_spec(casc.neighbours[enc_idx], in_cpe,
                                 k, padding, pad_mode, bias, n_edges)
                for _ in range(cfg.extra_conv)
            ]
            z_idx = nl - i - 1
            self.decoder_levels.append(DecoderLevel(
                upsample=upsample,
                unpool_matrix=tp.unpooling_matrix(casc.pooling_lists[enc_idx],
                                                  in_cpe),
                conv=conv,
                leaky=i != nl - 1,
                latent_in=self.z_dims[z_idx],
                latent_out=self.channel_base[nl - i] * self.dec_timesteps[i],
                timestep=self.dec_timesteps[i],
                z_edges=self.z_edges[z_idx],
                extra_convs=extras,
            ))

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def _extra_conv_spec(neighbours, cpe: int, kernel: int, padding: int,
                     pad_mode: str, bias: bool, n_edges: int) -> ConvSpec:
    """Stride-1, channel-preserving conv spec for ``extra_conv``."""
    return ConvSpec(
        in_channels=cpe * n_edges, out_channels=cpe * n_edges,
        kernel_size=kernel, stride=1, padding=padding, padding_mode=pad_mode,
        bias=bias, mask=tp.conv_channel_mask(neighbours, cpe, cpe),
        block_bounds=_block_bounds(neighbours, cpe, kernel),
        n_edges=n_edges,
    )


def _block_bounds(neighbours, in_cpe: int, kernel: int) -> np.ndarray:
    """Per-edge kaiming-uniform(a=sqrt(5)) bound ``1/sqrt(fan_in_block)`` with
    ``fan_in_block = len(nbrs)*in_cpe*K``; the bias bound is the same."""
    return np.asarray(
        [1.0 / np.sqrt(len(n) * in_cpe * kernel) for n in neighbours],
        dtype=np.float32,
    )


@functools.lru_cache(maxsize=None)
def get_structure(cfg: ModelConfig) -> HMVAEStructure:
    return HMVAEStructure(cfg)


# --------------------------------------------------------------------------
# The root-trajectory model: the same conv/pool cascade, stride 1 at every
# level, no latent heads (``hm_vae_tpu.models.structure``, trajectory part).
# --------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class TrajectoryLevel:
    conv: ConvSpec
    pool_matrix: np.ndarray        # (k_edges*cpe, n_edges*cpe)
    pooled_edges: int


class TrajectoryStructure:
    """Encoder cascade metadata of the trajectory model for one
    :class:`ModelConfig`: channel base 3 for joint-position input (else the
    input dim), doubled per level."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        nl = cfg.num_layers
        casc = tp.get_cascade(tp.SMPL24_PARENTS, nl, cfg.skeleton_dist)
        self.cascade = casc
        pad_mode = {"reflection": "reflect", "zeros": "constant"}.get(
            cfg.padding_mode, cfg.padding_mode)
        k = cfg.kernel_size
        padding = (k - 1) // 2
        base0 = 3 if cfg.trajectory_input_joint_pos else cfg.input_dim
        self.channel_base = [base0]
        for _ in range(nl):
            self.channel_base.append(self.channel_base[-1] * 2)
        self.d_model = self.channel_base[-1]

        self.levels: List[TrajectoryLevel] = []
        for i in range(nl):
            n_edges = casc.edge_num[i]
            in_ch = self.channel_base[i] * n_edges
            out_ch = self.channel_base[i + 1] * n_edges
            conv = ConvSpec(
                in_channels=in_ch, out_channels=out_ch, kernel_size=k,
                stride=1, padding=padding, padding_mode=pad_mode, bias=True,
                mask=tp.conv_channel_mask(casc.neighbours[i], self.channel_base[i],
                                          self.channel_base[i + 1]),
                block_bounds=_block_bounds(casc.neighbours[i], self.channel_base[i], k),
                n_edges=n_edges,
            )
            self.levels.append(TrajectoryLevel(
                conv=conv,
                pool_matrix=tp.pooling_matrix(casc.pooling_lists[i], n_edges,
                                              out_ch // n_edges),
                pooled_edges=casc.pooled_edge_num[i],
            ))
        self.out_edges = self.levels[-1].pooled_edges  # 7

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@functools.lru_cache(maxsize=None)
def get_trajectory_structure(cfg: ModelConfig) -> TrajectoryStructure:
    return TrajectoryStructure(cfg)
