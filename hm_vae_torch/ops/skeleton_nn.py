"""Skeleton-aware NN primitives: padded temporal conv, channel maps, upsampling.

Port of ``hm_vae_tpu.ops.skeleton_nn``.  These are the plain PyTorch forms;
the model's convolutions run through the hand-written kernel in
:mod:`hm_vae_torch.ops.fused_conv_pool`, whose plain version is built from
the functions here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

PAD_ALIASES = {"reflection": "reflect", "zeros": "constant"}


def pad_temporal(x: torch.Tensor, padding: int, mode: str) -> torch.Tensor:
    """Pad the trailing (time) axis of (B, C, T) by ``padding`` on each side.

    ``mode``: 'reflect' (no edge repeat) or 'constant' (zeros); the
    'reflection'/'zeros' aliases are accepted.
    """
    if padding == 0:
        return x
    return F.pad(x, (padding, padding), mode=PAD_ALIASES.get(mode, mode))


def skeleton_conv_w(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    stride: int,
    padding: int,
    padding_mode: str = "reflect",
) -> torch.Tensor:
    """Temporal conv of (B, C_in, T) with an already masked (C_out, C_in, K)
    weight: pad, then a valid strided ``conv1d``, then the bias added to its
    sums (as the JAX package adds it, not inside the conv's accumulation)."""
    out = F.conv1d(pad_temporal(x, padding, padding_mode), weight, stride=stride)
    return out if bias is None else out + bias[:, None]


def apply_channel_matrix(x: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in) matrix over the channel axis of (B, C_in, T)."""
    return torch.matmul(matrix, x)


@functools.lru_cache(maxsize=None)
def linear_upsample_matrix(t_in: int, scale: int = 2) -> np.ndarray:
    """(T_out, T_in) matrix of linear upsampling with half-pixel centres
    (``align_corners=False``) and edge clamping."""
    t_out = t_in * scale
    m = np.zeros((t_out, t_in), dtype=np.float32)
    for i in range(t_out):
        src = (i + 0.5) / scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        m[i, min(max(lo, 0), t_in - 1)] += 1.0 - frac
        m[i, min(max(lo + 1, 0), t_in - 1)] += frac
    return m


@functools.lru_cache(maxsize=None)
def _upsample_matrix_t(t_in: int, scale: int, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    """(T_in, T_out) transposed upsample matrix on ``device``, made once (as
    a normal tensor, so that it serves inside and outside inference mode)."""
    with torch.inference_mode(False):
        m = torch.from_numpy(linear_upsample_matrix(t_in, scale))
        return m.T.contiguous().to(device=device, dtype=dtype)


def upsample_linear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Temporal linear upsampling of (B, C, T) by an integer factor.  As in
    the JAX package the (f32) matrix promotes a bf16 input to f32."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    return torch.matmul(x.to(dtype), _upsample_matrix_t(x.shape[-1], scale, x.device, dtype))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)
