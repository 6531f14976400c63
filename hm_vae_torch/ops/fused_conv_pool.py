"""One skeleton-conv level in one kernel: masked temporal conv (+ bias), an
optional channel-pool matrix, then LeakyReLU.

Replaces the Pallas TPU kernel ``hm_vae_tpu/ops/pallas_kernels.py``
(``fused_conv_pool``, body ``_fused_kernel``) with the hand-written CUDA
kernel ``hm_vae_torch/csrc/fused_conv_pool.cu`` for Hopper (``sm_90a``).  The
source's header note says what bounds it on an H100 and what its design does
about that.

:func:`fused_conv_pool` takes the Pallas wrapper's arguments.  On a CPU tensor
it runs :func:`fused_conv_pool_reference`, the plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.  ``fused_conv_pool.launches``
counts kernel launches.

Differences from the TPU kernel, none of them semantic: operands keep the
input's dtype (f32 or bf16) with f32 accumulation, where the TPU kernel cast
to bf16 to fit VMEM; stride and padding are index arithmetic, not a
decimation matmul and a padded copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .skeleton_nn import PAD_ALIASES, apply_channel_matrix, leaky_relu, skeleton_conv_w

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_conv_pool_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
    pool_matrix: Optional[torch.Tensor],
    stride: int,
    padding: int,
    padding_mode: str = "reflect",
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Plain PyTorch version: pad, ``conv1d`` on ``weight*mask``, pool, act."""
    w = weight if mask is None else weight * mask[:, :, None]
    y = skeleton_conv_w(x, w, bias, stride, padding, padding_mode)
    if pool_matrix is not None:
        y = apply_channel_matrix(y, pool_matrix)
    return leaky_relu(y, negative_slope)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built at first use, and its C entry point."""
    lib = _build.load("fused_conv_pool")
    fn = lib.hmvae_fused_conv_pool
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check(name: str, t: Optional[torch.Tensor], x: torch.Tensor, shape) -> None:
    if t is None:
        return
    if t.device != x.device:
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if t.dtype != x.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, x has {x.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_conv_pool(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
    pool_matrix: Optional[torch.Tensor],
    stride: int,
    padding: int,
    padding_mode: str = "reflect",
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """x (B, C_in, T), weight (C_out, C_in, K), bias (C_out,) or None,
    mask (C_out, C_in) or None, pool_matrix (P, C_out) or None.

    Returns (B, P, T_out) in x's dtype, T_out = (T + 2*padding - K)//stride + 1;
    ``negative_slope=1.0`` is no activation.
    """
    if x.device.type == "cpu":
        return fused_conv_pool_reference(x, weight, bias, mask, pool_matrix, stride,
                                         padding, padding_mode, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pool runs on cpu or cuda tensors, not {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, mask, pool_matrix)):
        raise RuntimeError("fused_conv_pool has no backward yet: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv_pool takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError("x must be (B, C_in, T) and weight (C_out, C_in, K)")
    mode = PAD_ALIASES.get(padding_mode, padding_mode)
    if mode not in ("reflect", "constant"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    B, C_in, T = x.shape
    C_out, _, K = weight.shape
    P = C_out if pool_matrix is None else pool_matrix.shape[0]
    _check("x", x, x, (B, C_in, T))
    _check("weight", weight, x, (C_out, C_in, K))
    _check("bias", bias, x, (C_out,))
    _check("mask", mask, x, (C_out, C_in))
    _check("pool_matrix", pool_matrix, x, (P, C_out))
    if stride < 1 or padding < 0 or T + 2 * padding < K:
        raise ValueError(f"bad stride/padding: stride={stride} padding={padding} "
                         f"T={T} K={K}")
    if mode == "reflect" and padding >= T:
        raise ValueError(f"reflect padding {padding} needs T > padding, got T={T}")
    T_out = (T + 2 * padding - K) // stride + 1
    if not 0 < B * T_out <= 65535 * 32:
        raise ValueError(f"batch x output steps {B * T_out} outside the kernel's grid "
                         f"range (1..{65535 * 32})")

    lib, fn = _library()
    out = torch.empty((B, P, T_out), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ptr(x), ptr(weight), ptr(bias), ptr(mask), ptr(pool_matrix),
                 ptr(out), B, C_in, T, C_out, K, P, T_out, stride, padding,
                 int(mode == "reflect"), float(negative_slope), _DTYPES[x.dtype],
                 stream)
    _build.check(lib, err, "fused_conv_pool")
    fused_conv_pool.launches += 1
    return out


fused_conv_pool.launches = 0
