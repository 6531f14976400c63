"""One skeleton-conv level in one kernel: masked temporal conv (+ bias), an
optional channel-pool matrix, then LeakyReLU.

Replaces the Pallas TPU kernel ``hm_vae_tpu/ops/pallas_kernels.py``
(``fused_conv_pool``, body ``_fused_kernel``) with the hand-written CUDA
kernel ``hm_vae_torch/csrc/fused_conv_pool.cu`` for Hopper (``sm_90a``): a
block-sparse implicit GEMM on the level's folded weight, bf16 (or 3xTF32 for
f32) on ``wgmma``, weight tiles by bulk asynchronous copy.  The source's
header note says what bounds it on an H100 and what its design does about
that.

The operands are prepared once by :func:`pack_level`: the mask, the pool and
the unpool folded into one conv weight, as the JAX module folds them, laid
out as the kernel reads it, with its all-zero tiles dropped.  Two entries:

- :func:`fused_conv_pool` takes the Pallas wrapper's arguments and packs on
  the fly; the tests and one phase of ``chip_smoke.py`` use it;
- :func:`fused_conv_pool_packed` takes a :class:`PackedLevel`; the model
  calls it with operands prepared once per model.

On CPU tensors both run their plain PyTorch version
(:func:`fused_conv_pool_reference`, after :func:`unpack_level` for the packed
entry); on CUDA tensors they launch the kernel or raise.
``fused_conv_pool.launches`` counts kernel launches from either entry.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .skeleton_nn import PAD_ALIASES, apply_channel_matrix, leaky_relu, skeleton_conv_w

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 64  # rows of a weight tile (the kernel's wgmma M)
# input channels per reduction chunk: one tap's channels are one wgmma
# k-step (16 bf16 or 8 TF32 values)
CHUNK_CHANNELS = {torch.bfloat16: 16, torch.float32: 8}


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


def fold_operands(
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
    pool_matrix: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(P @ (W*mask), P @ b)``: one conv weight (P, C_in, K) and bias, in
    the weight's dtype, as ``hm_vae_tpu/models/hm_vae.py`` folds them."""
    w = weight if mask is None else weight * mask[:, :, None]
    if pool_matrix is not None:
        w = torch.einsum("qo,ock->qck", pool_matrix, w)
        bias = None if bias is None else pool_matrix @ bias
    return w.contiguous(), bias


@dataclasses.dataclass(frozen=True, eq=False)
class PackedLevel:
    """One level's folded operands as the kernel reads them.

    ``tiles`` holds the live (row tile, channel chunk) tiles of the folded
    weight, row tile by row tile, each ``planes`` x 64 rows x ``chunk*K``
    values (tap-major: j = k*chunk + c) in wgmma's core-matrix order; in
    f32 the planes are the TF32 rounding and the remainder.  ``tile_start`` (row tiles + 1) and
    ``tile_chunk`` (live tiles) index them; ``bias`` is f32, zero-padded to
    the row tiles.
    """

    tiles: torch.Tensor
    bias: torch.Tensor
    tile_start: torch.Tensor
    tile_chunk: torch.Tensor
    rows: int
    in_channels: int
    kernel_size: int
    has_bias: bool
    max_live: int
    stride: int
    padding: int
    reflect: bool
    negative_slope: float

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles.dtype

    @property
    def device(self) -> torch.device:
        return self.tiles.device


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits, ties away from zero)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tile_shape(dtype: torch.dtype, K: int):
    """(planes, chunk channels, values per 16-byte core-matrix row)."""
    planes = 2 if dtype == torch.float32 else 1
    return planes, CHUNK_CHANNELS[dtype], 16 // torch.empty((), dtype=dtype).element_size()


@torch.no_grad()
def pack_level(
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: int,
    padding: int,
    padding_mode: str = "reflect",
    negative_slope: float = 0.2,
) -> PackedLevel:
    """Pack a folded weight (P, C_in, K) and bias (P,) for the kernel, on
    the weight's device (one host sync, to list the live tiles)."""
    if weight.dtype not in _DTYPES:
        raise TypeError(f"fused_conv_pool takes float32 or bfloat16, not {weight.dtype}")
    mode = PAD_ALIASES.get(padding_mode, padding_mode)
    if mode not in ("reflect", "constant"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    P, C_in, K = weight.shape
    planes, cc, vec = _tile_shape(weight.dtype, K)
    rt, nc, J = -(-P // ROWS), -(-C_in // cc), cc * K
    w = weight.new_zeros((rt * ROWS, nc * cc, K))
    w[:P, :C_in] = weight
    # (rt, nc, 64, J), the reduction tap-major within a chunk: j = k*cc + c
    tiles = w.reshape(rt, ROWS, nc, cc, K).permute(0, 2, 1, 4, 3).reshape(rt, nc, ROWS, J)
    live = (tiles != 0).flatten(2).any(-1)  # (rt, nc)
    if planes == 2:
        big = _tf32(tiles.contiguous())
        tiles = torch.stack((big, tiles - big), dim=2)
    else:
        tiles = tiles[:, :, None]
    # (64, J) -> (k-step, row group, k half, row in group, value)
    tiles = tiles.reshape(rt, nc, planes, 8, 8, J // (2 * vec), 2, vec)
    tiles = tiles.permute(0, 1, 2, 5, 3, 6, 4, 7).reshape(rt * nc, -1)
    per_row = live.sum(1)
    b = torch.zeros(rt * ROWS, dtype=torch.float32, device=weight.device)
    if bias is not None:
        b[:P] = bias.float()
    start = torch.zeros(rt + 1, dtype=torch.int32, device=weight.device)
    start[1:] = per_row.cumsum(0)
    return PackedLevel(
        tiles=tiles[live.flatten()].contiguous(), bias=b, tile_start=start,
        tile_chunk=live.nonzero()[:, 1].to(torch.int32).contiguous(),
        rows=P, in_channels=C_in, kernel_size=K, has_bias=bias is not None,
        max_live=int(per_row.max()), stride=stride, padding=padding,
        reflect=mode == "reflect", negative_slope=float(negative_slope))


def unpack_level(packed: PackedLevel) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The folded weight (P, C_in, K) and bias (P,) back from the packing,
    exactly (f32: TF32 rounding + remainder is the weight)."""
    P, C_in, K = packed.rows, packed.in_channels, packed.kernel_size
    planes, cc, vec = _tile_shape(packed.dtype, K)
    rt = packed.tile_start.numel() - 1
    nc, J = -(-C_in // cc), cc * K
    flat = packed.tiles.new_zeros((rt, nc, packed.tiles.shape[-1]))
    row = torch.repeat_interleave(torch.arange(rt, device=packed.device),
                                  (packed.tile_start[1:] - packed.tile_start[:-1]).long())
    flat[row, packed.tile_chunk.long()] = packed.tiles
    t = flat.reshape(rt, nc, planes, J // (2 * vec), 8, 2, 8, vec)
    t = t.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(rt, nc, planes, ROWS, K, cc).sum(2)
    w = t.permute(0, 2, 1, 4, 3).reshape(rt * ROWS, nc * cc, K)[:P, :C_in].contiguous()
    b = packed.bias[:P].to(packed.dtype) if packed.has_bias else None
    return w, b


# hmvae_fused_conv_pool(x, tiles, bias, tile_start, tile_chunk, out, B, C_in,
# T_in, K, P, T_out, stride, padding, reflect, slope, max_live, dtype, device,
# sms, stream)
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's library, built at first use, and its C entry point."""
    lib = _build.load("fused_conv_pool")
    fn = lib.hmvae_fused_conv_pool
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _no_grad_guard(*tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("fused_conv_pool has no backward yet: call it under "
                           "torch.no_grad() or torch.inference_mode()")


def _launch(x: torch.Tensor, packed: PackedLevel) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, then one launch."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv_pool takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 3 or x.shape[1] != packed.in_channels:
        raise ValueError(f"x must be (B, {packed.in_channels}, T), got {tuple(x.shape)}")
    if x.device != packed.device or x.dtype != packed.dtype:
        raise ValueError(f"x is {x.dtype} on {x.device}, the packed level "
                         f"{packed.dtype} on {packed.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, C_in, T = x.shape
    K, stride, pad = packed.kernel_size, packed.stride, packed.padding
    if stride < 1 or pad < 0 or T + 2 * pad < K:
        raise ValueError(f"bad stride/padding: stride={stride} padding={pad} T={T} K={K}")
    if packed.reflect and pad >= T:
        raise ValueError(f"reflect padding {pad} needs T > padding, got T={T}")
    T_out = (T + 2 * pad - K) // stride + 1
    if B * T_out >= 2 ** 31:
        raise ValueError(f"batch x output steps {B * T_out} outside the kernel's range")

    if C_in % 8 or x.data_ptr() % 16:
        # the kernel copies whole 16-byte aligned rows of 8 channels: pad
        xp = x.new_zeros((B, C_in + -C_in % 8, T))
        xp[:, :C_in] = x
        x, C_in = xp, xp.shape[1]

    lib, fn = _library()
    out = torch.empty((B, packed.rows, T_out), dtype=x.dtype, device=x.device)
    dev = x.device.index

    def call():
        return fn(x.data_ptr(), packed.tiles.data_ptr(), packed.bias.data_ptr(),
                  packed.tile_start.data_ptr(), packed.tile_chunk.data_ptr(),
                  out.data_ptr(), B, C_in, T, K, packed.rows, T_out, stride, pad,
                  int(packed.reflect), packed.negative_slope, packed.max_live,
                  _DTYPES[x.dtype], dev, _sm_count(dev),
                  torch.cuda.current_stream(x.device).cuda_stream)

    if dev == torch.cuda.current_device():
        err = call()
    else:
        with torch.cuda.device(x.device):
            err = call()
    _build.check(lib, err, "fused_conv_pool")
    fused_conv_pool.launches += 1
    return out


def fused_conv_pool_packed(x: torch.Tensor, packed: PackedLevel) -> torch.Tensor:
    """x (B, C_in, T) through a packed level -> (B, P, T_out)."""
    if x.device.type == "cpu":
        w, b = unpack_level(packed)
        return fused_conv_pool_reference(
            x, w, b, None, None, packed.stride, packed.padding,
            "reflect" if packed.reflect else "constant", packed.negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pool runs on cpu or cuda tensors, not {x.device}")
    _no_grad_guard(x)
    return _launch(x, packed)


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
    ``negative_slope=1.0`` is no activation.  On CUDA tensors it folds and
    packs the operands, then launches (:func:`fused_conv_pool_packed`).
    """
    if x.device.type == "cpu":
        return fused_conv_pool_reference(x, weight, bias, mask, pool_matrix, stride,
                                         padding, padding_mode, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pool runs on cpu or cuda tensors, not {x.device}")
    _no_grad_guard(x, weight, bias, mask, pool_matrix)
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError("x must be (B, C_in, T) and weight (C_out, C_in, K)")
    C_out, C_in, K = weight.shape
    P = C_out if pool_matrix is None else pool_matrix.shape[0]
    _check("weight", weight, x, (C_out, C_in, K))
    _check("bias", bias, x, (C_out,))
    _check("mask", mask, x, (C_out, C_in))
    _check("pool_matrix", pool_matrix, x, (P, C_out))
    wf, bf = fold_operands(weight, bias, mask, pool_matrix)
    return _launch(x, pack_level(wf, bf, stride, padding, padding_mode, negative_slope))


fused_conv_pool.launches = 0
