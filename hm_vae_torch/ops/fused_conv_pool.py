"""One skeleton-conv level in one kernel: masked temporal conv (+ bias), an
optional channel-pool matrix, then LeakyReLU; and its backward.

Replaces the Pallas TPU kernel ``hm_vae_tpu/ops/pallas_kernels.py``
(``fused_conv_pool``, body ``_fused_kernel``) with the hand-written CUDA
kernel ``hm_vae_torch/csrc/fused_conv_pool.cu`` for Hopper (``sm_90a``): a
block-sparse implicit GEMM on the level's folded weight, bf16 (or 3xTF32 for
f32) on ``wgmma``, weight tiles by bulk asynchronous copy.  Its gradient is
two more hand-written kernels, ``hm_vae_torch/csrc/fused_conv_pool_bwd.cu``
(dgrad and wgrad + bias grad, f32 as 3xTF32 on ``mma.sync``, planned by
:func:`dgrad_plan` and :func:`wgrad_plan`), the counterparts of the JAX package's
autodiff of its XLA level (``hm_vae_tpu/models/hm_vae.py``; the JAX package
has no backward kernel).  Each source's header note says what bounds it on
an H100 and what its design does about that.

The operands are the mask, the pool and the unpool folded into one conv
weight (P, C_in, K) and bias (P,), as the JAX module folds them, laid out as
the kernel reads it: 64-row x channel-chunk tiles, all-zero tiles dropped.
Which tiles are live is decided once (:func:`pack_structure`, a
:class:`LevelStructure`); the values are written into those tiles by
:func:`repack`, with no host sync, whenever the weight changes.  Entries:

- :func:`fused_conv_pool` takes the Pallas wrapper's arguments and packs on
  the fly (:func:`pack_level`, live tiles from the values);
- :func:`fused_conv_pool_packed` takes a :class:`PackedLevel`; serving calls
  it with operands prepared once per model.  It calls the registered
  operator ``torch.ops.hm_vae_torch.fused_conv_pool`` (:data:`OP_NAME`) on
  the packing's tensors, so that ``torch.export`` records a level as one
  node (``hm_vae_torch/apps/export.py``);
- :class:`FusedConvPoolFn` is the differentiable level on a folded weight
  and a structure: forward by repack + kernel, backward by
  :func:`fused_conv_pool_dgrad` and :func:`fused_conv_pool_wgrad`.

Windowed forms: the test-time solver gives each window of its batch its own
decoder clone (``hm_vae_tpu/apps/latent_opt.py``, ``jax.vmap`` over windows
with the decoder parameters on axis 0).  For a batch of B = G*n (G windows
of n batches), :func:`repack` takes G folded weights (G, P, C_in, K) and
biases (G, P) and :class:`WindowedFusedConvPoolFn` runs the same three
kernels with each window reading its own weight:
:func:`fused_conv_pool_windowed`, :func:`fused_conv_pool_dgrad_windowed` and
:func:`fused_conv_pool_wgrad_windowed` (one gradient per window, no sum
across windows).  A ``torch.func.vmap`` cannot see inside a ``ctypes``
launch, so the window axis is written out.

On CPU tensors every entry runs its plain PyTorch version
(:func:`fused_conv_pool_reference`, :func:`fused_conv_pool_dgrad_reference`,
:func:`fused_conv_pool_wgrad_reference` and their ``_windowed`` forms); on
CUDA tensors they launch the kernel or raise.  The ``launches`` attribute of
each of the six entries counts its kernel launches; :func:`device_runs`
counts, on the device, the kernels' runs (those of CUDA-graph replays too).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .skeleton_nn import PAD_ALIASES, apply_channel_matrix, leaky_relu, pad_temporal, \
    skeleton_conv_w

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 64  # rows of a weight tile (the kernel's wgmma M)
# input channels per reduction chunk: one tap's channels are one wgmma
# k-step (16 bf16 or 8 TF32 values)
CHUNK_CHANNELS = {torch.bfloat16: 16, torch.float32: 8}
# the backward kernels' tiles: K up to 31 taps (wgrad: K + 1 tap tiles, 4 a warp)
MAX_BWD_K = 31
MAX_SPLIT = 8  # blocks of a cluster (the portable maximum)
BWD_WARPS = 8  # dgrad: one 16-column tile of a batch group per warp,
DGRAD_TILES = 2  # or up to two for a group of one batch (a padded row <= 256 / stride)
DGRAD_CHUNKS = 2  # dgrad: channel chunks of a block
MAX_SMEM = 232448  # shared memory a block may use
MAX_SMEM_PER_SM = 233472
WGRAD_STAGE_COLS = 32  # wgrad: (b, t) columns staged at a time, at least one batch


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


def _act_grad(gy: torch.Tensor, y: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU's gradient from its output: with slope > 0, ``y >= 0``
    exactly where the pre-activation is (``jnp.where(x >= 0, ...)``)."""
    return torch.where(y >= 0, gy, gy * slope)


def fused_conv_pool_dgrad_reference(gy, y, weight, T_in: int, stride: int, padding: int,
                                    padding_mode: str = "reflect",
                                    negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch input gradient of one folded level: the transposed conv
    of ``g = gy * act'(y)`` onto the padded input, then the padding's
    adjoint (reflected columns add onto their sources).  (B, C_in, T_in)."""
    g = _act_grad(gy, y, negative_slope)
    K, T_out = weight.shape[2], g.shape[2]
    Tp = T_in + 2 * padding
    gxp = torch.nn.functional.conv_transpose1d(
        g, weight, stride=stride, output_padding=Tp - ((T_out - 1) * stride + K))
    gx = gxp[..., padding:padding + T_in].clone()
    if padding and PAD_ALIASES.get(padding_mode, padding_mode) == "reflect":
        dev = gx.device
        # padded column j < padding reads x[padding - j]; column
        # padding + T_in + i reads x[T_in - 2 - i]
        gx.index_add_(2, torch.arange(padding, 0, -1, device=dev), gxp[..., :padding])
        gx.index_add_(2, T_in - 2 - torch.arange(padding, device=dev),
                      gxp[..., padding + T_in:])
    return gx


def fused_conv_pool_wgrad_reference(gy, y, x, K: int, stride: int, padding: int,
                                    padding_mode: str = "reflect",
                                    negative_slope: float = 0.2,
                                    live: Optional[torch.Tensor] = None):
    """Plain PyTorch weight and bias gradient of one folded level:
    ``sum_{b,t} g[b,p,t] * xpad[b,c,t*stride+k]`` (P, C_in, K) and
    ``sum_{b,t} g`` (P,).  ``live`` (P, C_in) zeroes the dead tiles, as the
    kernel leaves them (their entries are structural zeros of the fold, so
    the raw weight's gradient does not read them)."""
    g = _act_grad(gy, y, negative_slope)
    cols = pad_temporal(x, padding, padding_mode).unfold(2, K, stride)  # (B, C, T_out, K)
    gw = torch.einsum("bpt,bctk->pck", g, cols)
    if live is not None:
        gw = gw * live[:, :, None].to(gw.dtype)
    return gw, g.sum((0, 2))


def fused_conv_pool_windowed_reference(x, weight, bias, stride: int, padding: int,
                                       padding_mode: str = "reflect",
                                       negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch windowed level: x (G*n, C_in, T), folded weights
    (G, P, C_in, K) and biases (G, P) or None; window g's n batches go
    through its own weight, with :func:`fused_conv_pool_reference`."""
    G = weight.shape[0]
    return torch.cat([fused_conv_pool_reference(
        xg, weight[g], None if bias is None else bias[g], None, None, stride, padding,
        padding_mode, negative_slope) for g, xg in enumerate(x.chunk(G))])


def fused_conv_pool_dgrad_windowed_reference(gy, y, weight, T_in: int, stride: int,
                                             padding: int, padding_mode: str = "reflect",
                                             negative_slope: float = 0.2) -> torch.Tensor:
    """Plain windowed input gradient: :func:`fused_conv_pool_dgrad_reference`
    of each window's batches on its own weight (G, P, C_in, K)."""
    G = weight.shape[0]
    return torch.cat([fused_conv_pool_dgrad_reference(
        gg, yg, weight[g], T_in, stride, padding, padding_mode, negative_slope)
        for g, (gg, yg) in enumerate(zip(gy.chunk(G), y.chunk(G)))])


def fused_conv_pool_wgrad_windowed_reference(gy, y, x, K: int, stride: int, padding: int,
                                             windows: int, padding_mode: str = "reflect",
                                             negative_slope: float = 0.2,
                                             live: Optional[torch.Tensor] = None):
    """Plain windowed weight and bias gradients, (G, P, C_in, K) and (G, P):
    :func:`fused_conv_pool_wgrad_reference` over each window's batches."""
    parts = [fused_conv_pool_wgrad_reference(gg, yg, xg, K, stride, padding, padding_mode,
                                             negative_slope, live)
             for gg, yg, xg in zip(gy.chunk(windows), y.chunk(windows), x.chunk(windows))]
    return torch.stack([w for w, _ in parts]), torch.stack([b for _, b in parts])


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
class LevelStructure:
    """Which tiles of one level's folded weight the kernels read, decided once.

    ``live`` (row tiles, channel chunks) marks the 64-row x chunk tiles that
    may hold a nonzero.  The forward kernel walks them row tile by row tile
    (``tile_start`` (row tiles + 1) indexes ``tile_chunk``); the wgrad kernel
    takes one entry a block (``wgrad_row``, ``wgrad_chunk``: the live tiles
    by row tile, and ``(row tile, -1)`` for a row tile with none, whose bias
    gradient is still summed); the dgrad kernel walks, for each pair of
    chunks, the row tiles live in either (``dgrad_start`` (pairs + 1)
    indexes ``dgrad_row``).  ``live_index`` (row tile * chunks + chunk,
    int64) is the gather that :func:`repack` writes the values through.
    ``max_live`` and ``dgrad_max_live``: the most live tiles of a row tile,
    and row tiles of a pair.
    """

    live: torch.Tensor
    tile_start: torch.Tensor
    tile_chunk: torch.Tensor
    wgrad_row: torch.Tensor
    wgrad_chunk: torch.Tensor
    dgrad_start: torch.Tensor
    dgrad_row: torch.Tensor
    live_index: torch.Tensor
    dtype: torch.dtype
    rows: int
    in_channels: int
    kernel_size: int
    max_live: int
    dgrad_max_live: int
    stride: int
    padding: int
    reflect: bool
    negative_slope: float

    @property
    def device(self) -> torch.device:
        return self.tile_start.device

    def live_elements(self) -> torch.Tensor:
        """(P, C_in) bool: the entries of the live tiles."""
        cc = CHUNK_CHANNELS[self.dtype]
        t = self.live.repeat_interleave(ROWS, 0).repeat_interleave(cc, 1)
        return t[:self.rows, :self.in_channels]


@dataclasses.dataclass(frozen=True, eq=False)
class PackedLevel:
    """One level's folded operands as the forward kernel reads them.

    ``tiles`` holds the live tiles of the folded weight, in the structure's
    order, each ``planes`` x 64 rows x ``chunk*K`` values (tap-major:
    j = k*chunk + c) in wgmma's core-matrix order; in f32 the planes are the
    TF32 rounding and the remainder.  ``bias`` is f32, zero-padded to the
    row tiles.  Windowed (G weights, :func:`repack` of a (G, P, C_in, K)
    weight), both have a leading window axis.  The structure's fields
    (``tile_start``, ``rows``, ``stride``, ...) read through.
    """

    tiles: torch.Tensor
    bias: torch.Tensor
    has_bias: bool
    structure: LevelStructure

    def __getattr__(self, name):
        if name == "structure":  # not set yet (copy, unpickle)
            raise AttributeError(name)
        return getattr(self.structure, name)

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles.dtype

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @property
    def windows(self) -> Optional[int]:
        """G for a windowed packing, else None."""
        return self.tiles.shape[0] if self.tiles.dim() == 3 else None


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits, ties away from zero)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tile_shape(dtype: torch.dtype):
    """(planes, chunk channels, values per 16-byte core-matrix row)."""
    planes = 2 if dtype == torch.float32 else 1
    return planes, CHUNK_CHANNELS[dtype], 16 // torch.empty((), dtype=dtype).element_size()


def _mode_of(s: "LevelStructure") -> str:
    return "reflect" if s.reflect else "constant"


def _mode(padding_mode: str) -> str:
    mode = PAD_ALIASES.get(padding_mode, padding_mode)
    if mode not in ("reflect", "constant"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    return mode


def pack_structure(
    live: torch.Tensor,
    kernel_size: int,
    dtype: torch.dtype,
    stride: int,
    padding: int,
    padding_mode: str = "reflect",
    negative_slope: float = 0.2,
    device=None,
) -> LevelStructure:
    """The tile lists of a level whose folded weight may be nonzero where
    ``live`` (P, C_in) is true, on ``device`` (default: ``live``'s).  The
    lists are made on the host: one sync if ``live`` is on a GPU."""
    if dtype not in _DTYPES:
        raise TypeError(f"fused_conv_pool takes float32 or bfloat16, not {dtype}")
    mode = _mode(padding_mode)
    device = live.device if device is None else torch.device(device)
    P, C_in = live.shape
    cc = CHUNK_CHANNELS[dtype]
    rt, nc = -(-P // ROWS), -(-C_in // cc)
    pad = torch.zeros(rt * ROWS, nc * cc, dtype=torch.bool)
    pad[:P, :C_in] = live.cpu()
    tiles = pad.reshape(rt, ROWS, nc, cc).any(3).any(1)  # (rt, nc)
    by_row = tiles.nonzero()  # row-major: row tile, then chunk
    pairs = torch.zeros(rt, -(-nc // DGRAD_CHUNKS) * DGRAD_CHUNKS, dtype=torch.bool)
    pairs[:, :nc] = tiles
    pairs = pairs.reshape(rt, -1, DGRAD_CHUNKS).any(2)  # (rt, pairs)
    start = torch.zeros(rt + 1, dtype=torch.int32)
    start[1:] = tiles.sum(1).cumsum(0)
    dstart = torch.zeros(pairs.shape[1] + 1, dtype=torch.int32)
    dstart[1:] = pairs.sum(0).cumsum(0)
    # wgrad's entries: the live tiles by row, (row, -1) where a row has none
    empty = (~tiles.any(1)).nonzero()[:, 0]
    wg = torch.cat([by_row, torch.stack([empty, torch.full_like(empty, -1)], 1)])
    wg = wg[torch.argsort(wg[:, 0] * (nc + 1) + wg[:, 1], stable=True)]

    def put(t, dt=torch.int32):
        return t.to(dt).contiguous().to(device)

    return LevelStructure(
        live=tiles.to(device), tile_start=put(start), tile_chunk=put(by_row[:, 1]),
        wgrad_row=put(wg[:, 0]), wgrad_chunk=put(wg[:, 1]), dgrad_start=put(dstart),
        dgrad_row=put(pairs.T.nonzero()[:, 1]),
        live_index=put(by_row[:, 0] * nc + by_row[:, 1], torch.int64), dtype=dtype,
        rows=P, in_channels=C_in, kernel_size=kernel_size,
        max_live=int(tiles.sum(1).max()) if rt else 0,
        dgrad_max_live=int(pairs.sum(0).max()) if nc else 0, stride=stride, padding=padding,
        reflect=mode == "reflect", negative_slope=float(negative_slope))


def repack(structure: LevelStructure, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> PackedLevel:
    """The current values of a folded weight (P, C_in, K) and bias (P,)
    written into ``structure``'s live tiles, with no host sync (f32: the
    TF32 rounding and the remainder).  Entries outside the live tiles are
    dropped: they must be zero.  G windows' weights (G, P, C_in, K) and
    biases (G, P) give a windowed packing, each window's tiles packed as one
    weight's."""
    s = structure
    if weight.dtype != s.dtype:
        raise TypeError(f"the structure is for {s.dtype}, the weight is {weight.dtype}")
    lead, (P, C_in, K) = tuple(weight.shape[:-3]), weight.shape[-3:]
    if len(lead) > 1 or (P, C_in, K) != (s.rows, s.in_channels, s.kernel_size):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit the structure "
                         f"([G,] {s.rows}, {s.in_channels}, {s.kernel_size})")
    G = lead[0] if lead else 1
    planes, cc, vec = _tile_shape(weight.dtype)
    rt, nc, J = s.tile_start.numel() - 1, -(-C_in // cc), cc * K
    n = s.live_index.numel()
    with torch.no_grad():
        w = weight.new_zeros((G, rt * ROWS, nc * cc, K))
        w[:, :P, :C_in] = weight
        # (G, rt*nc, 64, J), the reduction tap-major within a chunk: j = k*cc + c
        tiles = w.reshape(G, rt, ROWS, nc, cc, K).permute(0, 1, 3, 2, 5, 4)
        tiles = tiles.reshape(G, rt * nc, ROWS, J).index_select(1, s.live_index)
        if planes == 2:
            big = _tf32(tiles)
            tiles = torch.stack((big, tiles - big), dim=2)
        else:
            tiles = tiles[:, :, None]
        # (64, J) -> (k-step, row group, k half, row in group, value)
        tiles = tiles.reshape(G, n, planes, 8, 8, J // (2 * vec), 2, vec)
        tiles = tiles.permute(0, 1, 2, 5, 3, 6, 4, 7).reshape(G, n, planes * ROWS * J)
        b = torch.zeros((G, rt * ROWS), dtype=torch.float32, device=weight.device)
        if bias is not None:
            b[:, :P] = bias.float().reshape(G, P)
        if not lead:
            tiles, b = tiles[0], b[0]
    return PackedLevel(tiles=tiles.contiguous(), bias=b, has_bias=bias is not None,
                       structure=s)


def pack_level(
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: int,
    padding: int,
    padding_mode: str = "reflect",
    negative_slope: float = 0.2,
) -> PackedLevel:
    """Pack a folded weight (P, C_in, K) and bias (P,) for the kernel, on
    the weight's device, its live tiles those where the values are nonzero
    (one host sync)."""
    if weight.dtype not in _DTYPES:
        raise TypeError(f"fused_conv_pool takes float32 or bfloat16, not {weight.dtype}")
    s = pack_structure((weight != 0).any(-1), weight.shape[2], weight.dtype, stride,
                       padding, padding_mode, negative_slope)
    return repack(s, weight, bias)


def unpack_level(packed: PackedLevel) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The folded weight (P, C_in, K) and bias (P,) back from the packing,
    exactly (f32: TF32 rounding + remainder is the weight); windowed,
    (G, P, C_in, K) and (G, P)."""
    return _unpack(packed.tiles, packed.bias if packed.has_bias else None, packed.tile_start,
                   packed.live_index, packed.in_channels, packed.kernel_size, packed.rows)


def _unpack(tiles, bias, tile_start, live_index, C_in: int, K: int, P: int):
    """:func:`unpack_level` on the packing's tensors (``bias`` None: no bias)."""
    planes, cc, vec = _tile_shape(tiles.dtype)
    rt = tile_start.numel() - 1
    nc, J = -(-C_in // cc), cc * K
    windowed = tiles.dim() == 3
    G = tiles.shape[0] if windowed else 1
    flat = tiles.new_zeros((G, rt * nc, tiles.shape[-1]))
    flat[:, live_index] = tiles.reshape(G, -1, tiles.shape[-1])
    t = flat.reshape(G, rt, nc, planes, J // (2 * vec), 8, 2, 8, vec)
    t = t.permute(0, 1, 2, 3, 5, 7, 4, 6, 8).reshape(G, rt, nc, planes, ROWS, K, cc).sum(3)
    w = t.permute(0, 1, 3, 2, 5, 4).reshape(G, rt * ROWS, nc * cc, K)[:, :P, :C_in]
    b = None if bias is None else bias[..., :P].to(tiles.dtype)
    if not windowed:
        w = w[0]
    return w.contiguous(), b


# hmvae_fused_conv_pool(x, tiles, bias, tile_start, tile_chunk, out, B, C_in,
# T_in, K, P, T_out, stride, padding, reflect, slope, max_live, windows,
# n_tiles, dtype, device, sms, stream)
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
# hmvae_conv_dgrad(gy, y, w, dgrad_start, dgrad_row, gx, B, C, T_in, K, P,
# T_out, t_ld, stride, padding, reflect, slope, nbb, split, windows, device,
# stream)
DGRAD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_float]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# hmvae_conv_wgrad(gy, y, x, wgrad_row, wgrad_chunk, gw, gb, n_tiles, B, C,
# T_in, K, P, T_out, t_ld, stride, padding, reflect, slope, sb, split,
# windows, device, stream)
WGRAD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_float]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _bind(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _library():
    """The forward kernel's library, built at first use, and its entry."""
    lib = _build.load("fused_conv_pool")
    return lib, _bind(lib, "hmvae_fused_conv_pool", ARGTYPES)


@functools.lru_cache(maxsize=None)
def _bwd_library():
    """The backward kernels' library, built at first use, and its entries."""
    lib = _build.load("fused_conv_pool_bwd")
    return (lib, _bind(lib, "hmvae_conv_dgrad", DGRAD_ARGTYPES),
            _bind(lib, "hmvae_conv_wgrad", WGRAD_ARGTYPES))


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


def _on_device(x: torch.Tensor, call) -> int:
    """Run a C entry point with ``x``'s device current."""
    if x.device.index == torch.cuda.current_device():
        return call()
    with torch.cuda.device(x.device):
        return call()


def _t_out(T: int, K: int, stride: int, pad: int, reflect: bool) -> int:
    if stride < 1 or pad < 0 or T + 2 * pad < K:
        raise ValueError(f"bad stride/padding: stride={stride} padding={pad} T={T} K={K}")
    if reflect and pad >= T:
        raise ValueError(f"reflect padding {pad} needs T > padding, got T={T}")
    return (T + 2 * pad - K) // stride + 1


def _launch(x: torch.Tensor, tiles: torch.Tensor, bias: torch.Tensor, tile_start: torch.Tensor,
            tile_chunk: torch.Tensor, n_tiles: int, C_packed: int, K: int, P: int, stride: int,
            pad: int, reflect: bool, slope: float, max_live: int) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, then one launch (uncounted) of a
    packing of ``C_packed`` input channels, its bias f32 (zero where the
    level has none); tiles with a leading window axis are a windowed
    packing."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv_pool takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 3 or x.shape[1] != C_packed:
        raise ValueError(f"x must be (B, {C_packed}, T), got {tuple(x.shape)}")
    if x.device != tiles.device or x.dtype != tiles.dtype:
        raise ValueError(f"x is {x.dtype} on {x.device}, the packed level "
                         f"{tiles.dtype} on {tiles.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, C_in, T = x.shape
    G = tiles.shape[0] if tiles.dim() == 3 else 1
    if B % G:
        raise ValueError(f"a batch of {B} is not {G} windows of equal size")
    planes, J = 2 if x.dtype == torch.float32 else 1, CHUNK_CHANNELS[x.dtype] * K
    if tiles.shape[-2:] != (n_tiles, planes * ROWS * J) or not tiles.is_contiguous():
        raise ValueError(f"tiles {tuple(tiles.shape)} are not {n_tiles} contiguous tiles of "
                         f"{planes} x {ROWS} x {J}")
    if (bias.dtype != torch.float32 or bias.device != x.device or not bias.is_contiguous()
            or bias.numel() != G * ROWS * (tile_start.numel() - 1)):
        raise ValueError(f"bias must be a contiguous float32 tensor of {G} x "
                         f"{ROWS * (tile_start.numel() - 1)} on {x.device}")
    if any(t.dtype != torch.int32 or t.device != x.device or not t.is_contiguous()
           for t in (tile_start, tile_chunk)):
        raise ValueError(f"tile_start and tile_chunk must be contiguous int32 tensors on "
                         f"{x.device}")
    T_out = _t_out(T, K, stride, pad, reflect)
    if B * T_out >= 2 ** 31:
        raise ValueError(f"batch x output steps {B * T_out} outside the kernel's range")

    if C_in % 8 or x.data_ptr() % 16:
        # the kernel copies whole 16-byte aligned rows of 8 channels: pad
        xp = x.new_zeros((B, C_in + -C_in % 8, T))
        xp[:, :C_in] = x
        x, C_in = xp, xp.shape[1]

    lib, fn = _library()
    out = torch.empty((B, P, T_out), dtype=x.dtype, device=x.device)
    dev = x.device.index
    err = _on_device(x, lambda: fn(
        x.data_ptr(), tiles.data_ptr(), bias.data_ptr(), tile_start.data_ptr(),
        tile_chunk.data_ptr(), out.data_ptr(), B, C_in, T, K, P, T_out, stride, pad,
        int(reflect), slope, max_live, G, n_tiles, _DTYPES[x.dtype], dev, _sm_count(dev),
        torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "fused_conv_pool" if tiles.dim() == 2 else "fused_conv_pool_windowed")
    return out


def _launch_packed(x: torch.Tensor, p: PackedLevel) -> torch.Tensor:
    """:func:`_launch` of a non-windowed packing, counted by
    :func:`fused_conv_pool` (training's and the Pallas-signature entry's
    launch, which do not go through the registered operator)."""
    out = _launch(x, p.tiles, p.bias, p.tile_start, p.tile_chunk, p.live_index.numel(),
                  p.in_channels, p.kernel_size, p.rows, p.stride, p.padding, p.reflect,
                  p.negative_slope, p.max_live)
    fused_conv_pool.launches += 1
    return out


# ---------------------------------------------------------------------------
# The forward as a registered operator: ``torch.ops.hm_vae_torch.fused_conv_pool``
# takes a packing's tensors and its ints, so that ``torch.export`` records one
# node per level (a ``ctypes`` call on ``data_ptr()`` cannot be traced) and
# any process that imports this module can run an exported graph.  It is
# registered with ``torch.library.define`` + ``impl`` + ``register_fake``:
# the dispatcher then calls the implementation with no Python layer between
# (``torch.library.custom_op`` adds one per call, on paths that are
# host-bound).  Nothing is built here: the kernel is built at its first launch.

OP_NAME = "hm_vae_torch::fused_conv_pool"
torch.library.define(
    OP_NAME,
    "(Tensor x, Tensor tiles, Tensor? bias, Tensor tile_start, Tensor tile_chunk, "
    "Tensor live_index, int in_channels, int K, int rows, int stride, int padding, "
    "bool reflect, float slope, int max_live) -> Tensor")


def _op_cpu(x, tiles, bias, tile_start, tile_chunk, live_index, in_channels, K, rows, stride,
            padding, reflect, slope, max_live):
    """The plain version: the folded weight unpacked, then
    :func:`fused_conv_pool_reference` (window by window for a windowed
    packing)."""
    w, b = _unpack(tiles, bias, tile_start, live_index, in_channels, K, rows)
    mode = "reflect" if reflect else "constant"
    if tiles.dim() == 3:
        return fused_conv_pool_windowed_reference(x, w, b, stride, padding, mode, slope)
    return fused_conv_pool_reference(x, w, b, None, None, stride, padding, mode, slope)


def _op_cuda(x, tiles, bias, tile_start, tile_chunk, live_index, in_channels, K, rows, stride,
             padding, reflect, slope, max_live):
    """One launch of the kernel, counted by :func:`fused_conv_pool` or, for
    a windowed packing, :func:`fused_conv_pool_windowed`."""
    if bias is None:  # one zero bias per window of a windowed packing
        bias = torch.zeros(tiles.shape[:-2] + (ROWS * (tile_start.numel() - 1),),
                           dtype=torch.float32, device=tiles.device)
    out = _launch(x, tiles, bias, tile_start, tile_chunk, live_index.numel(), in_channels, K,
                  rows, stride, padding, reflect, slope, max_live)
    entry = fused_conv_pool if tiles.dim() == 2 else fused_conv_pool_windowed
    entry.launches += 1
    return out


def _op_fake(x, tiles, bias, tile_start, tile_chunk, live_index, in_channels, K, rows, stride,
             padding, reflect, slope, max_live):
    """(B, rows, T_out) in x's dtype, for symbolic B and T too."""
    return x.new_empty((x.shape[0], rows, _t_out(x.shape[2], K, stride, padding, reflect)))


torch.library.impl(OP_NAME, "CPU", _op_cpu)
torch.library.impl(OP_NAME, "CUDA", _op_cuda)
torch.library.register_fake(OP_NAME, _op_fake)


def _op(x: torch.Tensor, p: PackedLevel) -> torch.Tensor:
    # the packing's bias is zero where the level has none: passed as it is,
    # the kernel reads it with no zero tensor made per call
    return torch.ops.hm_vae_torch.fused_conv_pool(
        x, p.tiles, p.bias, p.tile_start, p.tile_chunk, p.live_index,
        p.in_channels, p.kernel_size, p.rows, p.stride, p.padding, p.reflect,
        p.negative_slope, p.max_live)


def fused_conv_pool_packed(x: torch.Tensor, packed: PackedLevel) -> torch.Tensor:
    """x (B, C_in, T) through a packed level -> (B, P, T_out), by the
    registered operator (:data:`OP_NAME`).  Not differentiable on CUDA (use
    :class:`FusedConvPoolFn`)."""
    if packed.windows is not None:
        raise ValueError("a windowed packing goes through fused_conv_pool_windowed")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_conv_pool runs on cpu or cuda tensors, not {x.device}")
    if x.device.type == "cuda" and torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_conv_pool_packed has no gradient: train through "
                           "FusedConvPoolFn")
    return _op(x, packed)


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
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias, mask, pool_matrix)):
        raise RuntimeError("fused_conv_pool has no gradient: train through FusedConvPoolFn")
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError("x must be (B, C_in, T) and weight (C_out, C_in, K)")
    C_out, C_in, K = weight.shape
    P = C_out if pool_matrix is None else pool_matrix.shape[0]
    _check("weight", weight, x, (C_out, C_in, K))
    _check("bias", bias, x, (C_out,))
    _check("mask", mask, x, (C_out, C_in))
    _check("pool_matrix", pool_matrix, x, (P, C_out))
    wf, bf = fold_operands(weight, bias, mask, pool_matrix)
    return _launch_packed(x, pack_level(wf, bf, stride, padding, padding_mode, negative_slope))


fused_conv_pool.launches = 0


def fused_conv_pool_windowed(x: torch.Tensor, packed: PackedLevel) -> torch.Tensor:
    """x (G*n, C_in, T) through a windowed packing of G weights (window g's
    n batches through weight g) -> (G*n, P, T_out), by the registered
    operator.  Not differentiable on CUDA (use
    :class:`WindowedFusedConvPoolFn`)."""
    if packed.windows is None:
        raise ValueError("fused_conv_pool_windowed takes a windowed packing (repack of "
                         "(G, P, C_in, K) weights)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_conv_pool runs on cpu or cuda tensors, not {x.device}")
    if x.device.type == "cuda" and torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_conv_pool_windowed has no gradient: go through "
                           "WindowedFusedConvPoolFn")
    return _op(x, packed)


fused_conv_pool_windowed.launches = 0


# ---------------------------------------------------------------------------
# backward


def _bwd_checks(s: LevelStructure, gy: torch.Tensor, y: torch.Tensor, **tensors) -> None:
    if gy.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError("the fused_conv_pool backward kernels run in float32 only "
                        f"(got {gy.dtype}, structure {s.dtype})")
    if s.kernel_size > MAX_BWD_K:
        raise ValueError(f"the backward kernels take K <= {MAX_BWD_K}, not {s.kernel_size}")
    if not s.negative_slope > 0:
        raise ValueError("the backward reads LeakyReLU's gradient from its output: "
                         f"slope must be > 0, not {s.negative_slope}")
    _check("y", y, gy, gy.shape)
    for name, t in tensors.items():
        if t.device != gy.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {gy.device}")
    if gy.device != s.device:
        raise ValueError(f"gy is on {gy.device}, the structure on {s.device}")
    if not gy.is_contiguous():
        raise ValueError("gy must be contiguous")


# hmvae_fused_conv_pool_plan(dtype, B, T_in, K, P, T_out, stride, padding,
# windows, max_live, sms, out): csrc/fused_conv_pool_plan.h, its Plan's fields
PLAN_FIELDS = ("window", "win", "nb", "xp", "seg", "segments", "smem", "split", "fits")


@functools.lru_cache(maxsize=None)
def _plan_library():
    """The forward's planner (``csrc/fused_conv_pool_plan.h``, which the
    kernel's launcher includes) built alone for the host."""
    fn = _build.load_host("fused_conv_pool_plan").hmvae_fused_conv_pool_plan
    fn.argtypes = [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def _plan_dict(ints) -> dict:
    p = dict(zip(PLAN_FIELDS, ints))
    p["rows"] = "window" if p.pop("window") else "whole"
    p["window"], p["fits"] = p.pop("win"), bool(p["fits"])
    return p


def forward_plan(dtype: torch.dtype, B: int, T_in: int, K: int, P: int, T_out: int,
                 stride: int, padding: int, windows: int = 1, max_live: int = 1,
                 sms: int = 132) -> dict:
    """The forward launch's plan, from the planner its launcher runs
    (``csrc/fused_conv_pool_plan.h``, compiled for the host): ``rows``
    ``"whole"`` (a batch's rows of a chunk in one bulk copy) where they fit
    shared memory with no more tap segments than windows take, else
    ``"window"`` (of each row only the ``window`` columns a block's 64
    outputs read, a copy a row: bytes that depend on K and stride only, so
    any T fits); ``seg`` taps a stage (``segments`` stages a chunk),
    ``smem`` a block's bytes, ``nb`` batches a block spans, ``xp`` a row's
    slot, ``split`` blocks of a cluster, ``fits``."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    if _plan_library()(_DTYPES[dtype], B, T_in, K, P, T_out, stride, padding, windows,
                       max_live, sms, out):
        raise ValueError(f"no forward launch takes B={B} T_in={T_in} K={K} P={P} "
                         f"T_out={T_out} stride={stride} padding={padding} windows={windows}")
    return _plan_dict(out)


def last_forward_plan() -> dict:
    """The plan (as :func:`forward_plan`) that the last forward launch in this
    process ran, as its launcher recorded it."""
    lib, _ = _library()
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    lib.hmvae_fused_conv_pool_last_plan(out)
    return _plan_dict(out)


def dgrad_plan(B: int, T_in: int, K: int, stride: int, padding: int, t_ld: int,
               pairs: int, max_live: int, sms: int, windows: int = 1) -> Tuple[int, int, int]:
    """(nbb, groups, split) of the dgrad kernel: a block owns a pair of
    channel chunks and the padded rows of ``nbb`` batches (``groups`` batch
    groups of each of ``windows`` windows of ``B`` batches: a group never
    crosses a window), as many as its eight warps' 16-column tiles hold, one
    a warp (the columns of each stride phase tiled apart; one batch alone
    may take two a warp, so a padded row of up to 256 / stride columns),
    and ``split`` blocks of a cluster share the pair's live row tiles (at
    most ``max_live``).  Chosen for the least time on an SM, counted in row
    tiles: waves of blocks (two to an SM where their shared memory allows)
    times the row tiles a block walks, plus one for its prologue and
    epilogue; ties go to fewer blocks."""
    Tp = T_in + 2 * padding
    widths = [-(-(Tp - phi) // stride) for phi in range(stride)]
    if sum(-(-v // 16) for v in widths) > BWD_WARPS * DGRAD_TILES:
        raise ValueError(f"the dgrad kernel takes T_in + 2*padding <= "
                         f"{16 * BWD_WARPS * DGRAD_TILES // stride} at stride {stride}, not {Tp}")
    if _dgrad_smem(T_in, K, t_ld, stride, padding, 1) > MAX_SMEM:
        raise ValueError(f"the dgrad kernel's shared memory at K={K}, T_in={T_in} exceeds "
                         f"{MAX_SMEM} bytes")
    best = None
    for nb in range(1, B + 1):
        smem = _dgrad_smem(T_in, K, t_ld, stride, padding, nb)
        if nb > 1 and (sum(-(-nb * v // 16) for v in widths) > BWD_WARPS or smem > MAX_SMEM):
            continue
        groups = -(-B // nb)
        nbb = -(-B // groups)  # the same groups, batches spread evenly
        per_sm = 2 if smem <= MAX_SMEM_PER_SM // 2 - 1024 else 1
        for split in range(1, min(MAX_SPLIT, max(1, max_live)) + 1):
            blocks = pairs * windows * groups * split
            # a block's prologue and epilogue cost about one row tile
            cost = (-(-blocks // (sms * per_sm)) * (-(-max_live // split) + 1), blocks)
            if best is None or cost < best[0]:
                best = (cost, (nbb, groups, split))
    return best[1]


def _dgrad_smem(T_in: int, K: int, t_ld: int, stride: int, padding: int, nbb: int) -> int:
    """Bytes of shared memory a dgrad block takes (``dgrad_layout`` in the
    kernel's source): two weight stages (32 rows of 16 channels), one of gy
    and y, g split and padded, and gxpad (over the weight stages when it
    fits)."""
    Tp, kmax = T_in + 2 * padding, -(-K // stride)
    T_out = (Tp - K) // stride + 1
    rs = (kmax - 1 + max(-(-Tp // stride), T_out) + 11) // 16 * 16 + 4
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    half = ROWS // 2  # a stage: half a row tile
    w_ring = a16(2 * half * (8 * DGRAD_CHUNKS * K + 8) * 4)
    g2_end = 64 + w_ring + a16(2 * nbb * half * t_ld * 4) + nbb * half * rs * 8
    out = 8 * DGRAD_CHUNKS * nbb * Tp * 4
    return g2_end if out <= w_ring else a16(g2_end) + out


def _wgrad_smem(B: int, T_in: int, K: int, T_out: int, t_ld: int, stride: int, sb: int,
                split: int) -> int:
    """Bytes of shared memory a wgrad block takes (``wgrad_layout`` in the
    kernel's source): x's rows of the block's batches padded and split, one
    or two stages of gy and y, and g in fragment order (x's raw rows first,
    the partial gradient tile over the stages last)."""
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    nb_max = -(-B // split)
    n_st = -(-nb_max // sb)
    Lh = -(-((T_out - 1) * stride + K) // stride)
    rsx = (stride * Lh + 11) // 16 * 16 + 4
    g = 64 + a16(nb_max * 8 * rsx * 8)
    stage = a16(2 * sb * ROWS * t_ld * 4)
    frags = -(-sb * T_out // 8) * 4 * 32 * 8 * 4
    tail = max(frags, nb_max * 8 * T_in * 4)
    red = ROWS * (8 * K + 4) * 4
    slots = min(n_st, 2)
    while True:
        total = max(g + slots * stage + tail, g + red)
        if slots == 1 or total <= MAX_SMEM_PER_SM // 2 - 1024:
            return total
        slots -= 1


def wgrad_plan(B: int, T_out: int, entries: int, sms: int, windows: int = 1,
               smem=None) -> Tuple[int, int]:
    """(sb, split) of the wgrad kernel: one block per entry (a live tile) of
    each of ``windows`` windows of ``B`` batches, a window's batches split
    over ``split`` blocks of a cluster until the grid fills the card once,
    and staged ``sb`` batches (at most 32 columns, at least one batch) at a
    time.  ``smem(sb, split)``, where given, is a block's shared memory: a
    block holds x's rows of all its batches, so a large batch splits
    further until a block fits (``_wgrad_smem``)."""
    split = max(1, min(MAX_SPLIT, B, -(-sms // max(1, entries * windows))))

    def stage(split):
        return max(1, min(-(-B // split), WGRAD_STAGE_COLS // T_out))

    while smem is not None and split < min(MAX_SPLIT, B) and smem(stage(split), split) > MAX_SMEM:
        split += 1
    return stage(split), split


def _aligned(t: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to a multiple of ``multiple``, on a
    16-byte aligned address: the kernels bulk-copy whole rows (``t`` itself
    when it already is)."""
    n = t.shape[dim]
    pad = -n % multiple
    if not pad and t.data_ptr() % 16 == 0:
        return t
    shape = list(t.shape)
    shape[dim] += pad
    out = t.new_zeros(shape)
    out.narrow(dim, 0, n).copy_(t)
    return out


def _dgrad(gy, y, weight, s: LevelStructure, T_in: int, windows: Optional[int]):
    """Checks, then one dgrad launch; ``weight`` is (P, C_in, K), or
    (G, P, C_in, K) when ``windows`` is G."""
    entry = fused_conv_pool_dgrad if windows is None else fused_conv_pool_dgrad_windowed
    _bwd_checks(s, gy, y, weight=weight)
    B, P, T_out = gy.shape
    K, C_in = s.kernel_size, s.in_channels
    G = windows or 1
    shape = (s.rows, C_in, K) if windows is None else (G, s.rows, C_in, K)
    if tuple(weight.shape) != shape or P != s.rows or B % G:
        raise ValueError(f"weight {tuple(weight.shape)} / gy {tuple(gy.shape)} do not fit "
                         f"the structure and {G} windows")
    if _t_out(T_in, K, s.stride, s.padding, s.reflect) != T_out:
        raise ValueError(f"T_in {T_in} does not give T_out {T_out}")
    gy, y = _aligned(gy, 2, 4), _aligned(y, 2, 4)
    w = _aligned(weight, weight.dim() - 2, CHUNK_CHANNELS[torch.float32])
    C, t_ld = w.shape[-2], gy.shape[2]
    dev = gy.device.index
    nbb, _, split = dgrad_plan(B // G, T_in, K, s.stride, s.padding, t_ld,
                               s.dgrad_start.numel() - 1, s.dgrad_max_live, _sm_count(dev), G)
    lib, dgrad, _ = _bwd_library()
    gx = torch.empty((B, C, T_in), dtype=gy.dtype, device=gy.device)
    err = _on_device(gy, lambda: dgrad(
        gy.data_ptr(), y.data_ptr(), w.data_ptr(), s.dgrad_start.data_ptr(),
        s.dgrad_row.data_ptr(), gx.data_ptr(), B, C, T_in, K, P, T_out, t_ld, s.stride,
        s.padding, int(s.reflect), s.negative_slope, nbb, split, G, dev,
        torch.cuda.current_stream(gy.device).cuda_stream))
    _build.check(lib, err, entry.__name__)
    entry.launches += 1
    return gx if C == C_in else gx[:, :C_in].contiguous()


def _wgrad(gy, y, x, s: LevelStructure, windows: Optional[int]):
    """Checks, then one wgrad launch: (P, C_in, K) and (P,), or per window
    (G, P, C_in, K) and (G, P) when ``windows`` is G."""
    entry = fused_conv_pool_wgrad if windows is None else fused_conv_pool_wgrad_windowed
    _bwd_checks(s, gy, y, x=x)
    B, P, T_out = gy.shape
    K, C_in, T_in = s.kernel_size, s.in_channels, x.shape[2]
    G = windows or 1
    if tuple(x.shape[:2]) != (B, C_in) or P != s.rows or B % G:
        raise ValueError(f"x {tuple(x.shape)} / gy {tuple(gy.shape)} do not fit the structure "
                         f"and {G} windows")
    if _t_out(T_in, K, s.stride, s.padding, s.reflect) != T_out:
        raise ValueError(f"T_in {T_in} does not give T_out {T_out}")
    gy, y = _aligned(gy, 2, 4), _aligned(y, 2, 4)
    x = _aligned(x, 1, CHUNK_CHANNELS[torch.float32])
    C, t_ld = x.shape[1], gy.shape[2]
    dev = gy.device.index
    entries = s.wgrad_row.numel()
    sb, split = wgrad_plan(B // G, T_out, entries, _sm_count(dev), G,
                           lambda sb, split: _wgrad_smem(B // G, T_in, K, T_out, t_ld, s.stride,
                                                         sb, split))
    if _wgrad_smem(B // G, T_in, K, T_out, t_ld, s.stride, sb, split) > MAX_SMEM:
        raise ValueError(f"the wgrad kernel's shared memory at K={K}, T_in={T_in} and "
                         f"{B // G} batches a window exceeds {MAX_SMEM} bytes")
    lib, _, wgrad = _bwd_library()
    gw = torch.zeros((G, P, C, K), dtype=gy.dtype, device=gy.device)
    gb = torch.empty((G, P), dtype=gy.dtype, device=gy.device)
    err = _on_device(gy, lambda: wgrad(
        gy.data_ptr(), y.data_ptr(), x.data_ptr(), s.wgrad_row.data_ptr(),
        s.wgrad_chunk.data_ptr(), gw.data_ptr(), gb.data_ptr(), entries, B, C, T_in, K, P,
        T_out, t_ld, s.stride, s.padding, int(s.reflect), s.negative_slope, sb, split, G, dev,
        torch.cuda.current_stream(gy.device).cuda_stream))
    _build.check(lib, err, entry.__name__)
    entry.launches += 1
    if C != C_in:
        gw = gw[:, :, :C_in].contiguous()
    return (gw[0], gb[0]) if windows is None else (gw, gb)


def fused_conv_pool_dgrad(gy: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                          structure: LevelStructure, T_in: int) -> torch.Tensor:
    """The input gradient (B, C_in, T_in) of a folded level, from the output
    gradient ``gy`` and output ``y`` (B, P, T_out) and the folded weight
    (P, C_in, K).  One kernel launch on CUDA (f32), fixed-order sums (the
    same bits every run); the plain version on the CPU."""
    s = structure
    if gy.device.type == "cpu":
        return fused_conv_pool_dgrad_reference(gy, y, weight, T_in, s.stride, s.padding,
                                               _mode_of(s), s.negative_slope)
    return _dgrad(gy, y, weight, s, T_in, None)


def fused_conv_pool_wgrad(gy: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                          structure: LevelStructure):
    """The folded weight's gradient (P, C_in, K), zero outside the live
    tiles, and the bias gradient (P,), from ``gy`` and ``y`` (B, P, T_out)
    and the input x (B, C_in, T_in).  One kernel launch on CUDA (f32),
    fixed-order sums (the same bits every run); the plain version on the
    CPU."""
    s = structure
    if gy.device.type == "cpu":
        return fused_conv_pool_wgrad_reference(gy, y, x, s.kernel_size, s.stride, s.padding,
                                               _mode_of(s), s.negative_slope, s.live_elements())
    return _wgrad(gy, y, x, s, None)


def fused_conv_pool_dgrad_windowed(gy: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                                   structure: LevelStructure, T_in: int) -> torch.Tensor:
    """:func:`fused_conv_pool_dgrad` of G windows: gy, y (G*n, P, T_out),
    folded weights (G, P, C_in, K), window g's batches through weight g.
    One kernel launch on CUDA."""
    s = structure
    if gy.device.type == "cpu":
        return fused_conv_pool_dgrad_windowed_reference(gy, y, weight, T_in, s.stride,
                                                        s.padding, _mode_of(s),
                                                        s.negative_slope)
    return _dgrad(gy, y, weight, s, T_in, weight.shape[0])


def fused_conv_pool_wgrad_windowed(gy: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                                   structure: LevelStructure, windows: int):
    """:func:`fused_conv_pool_wgrad` of ``windows`` windows of gy, y
    (G*n, P, T_out) and x (G*n, C_in, T_in): each window's gradients
    (G, P, C_in, K) and (G, P), summed over its own n batches only.  One
    kernel launch on CUDA."""
    s = structure
    if gy.device.type == "cpu":
        return fused_conv_pool_wgrad_windowed_reference(
            gy, y, x, s.kernel_size, s.stride, s.padding, windows, _mode_of(s),
            s.negative_slope, s.live_elements())
    return _wgrad(gy, y, x, s, windows)


fused_conv_pool_dgrad.launches = 0
fused_conv_pool_wgrad.launches = 0
fused_conv_pool_dgrad_windowed.launches = 0
fused_conv_pool_wgrad_windowed.launches = 0


class FusedConvPoolFn(torch.autograd.Function):
    """One folded level, differentiable: ``FusedConvPoolFn.apply(x, weight,
    bias, structure)`` with x (B, C_in, T), the folded weight (P, C_in, K)
    and bias (P,) or None in the structure's dtype.

    On CUDA the forward writes the weight's current values into the
    structure's tiles (:func:`repack`) and launches the forward kernel; the
    backward launches the dgrad kernel (only when x needs a gradient) and
    the wgrad kernel.  The weight's entries outside the live tiles must be
    zero, as a fold of the structure leaves them.  It saves x and the output:
    LeakyReLU's gradient is read from the output's sign.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, structure: LevelStructure):
        s = structure
        if x.device.type == "cpu":
            y = fused_conv_pool_reference(x, weight, bias, None, None, s.stride, s.padding,
                                          "reflect" if s.reflect else "constant",
                                          s.negative_slope)
        elif x.device.type == "cuda":
            y = _launch_packed(x, repack(s, weight, bias))
        else:
            raise ValueError(f"fused_conv_pool runs on cpu or cuda tensors, not {x.device}")
        ctx.structure = s
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, y = ctx.saved_tensors
        s = ctx.structure
        gy = gy.contiguous()
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = fused_conv_pool_dgrad(gy, y, weight, s, x.shape[2])
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gw, gb = fused_conv_pool_wgrad(gy, y, x, s)
        return gx, gw, gb if ctx.has_bias else None, None


class WindowedFusedConvPoolFn(torch.autograd.Function):
    """G folded levels over the G windows of a batch, differentiable:
    ``WindowedFusedConvPoolFn.apply(x, weight, bias, structure)`` with x
    (G*n, C_in, T), folded weights (G, P, C_in, K) and biases (G, P) or None
    (f32), window g's n batches through weight g.

    On CUDA the forward repacks the G weights (:func:`repack`) and launches
    :func:`fused_conv_pool_windowed`; the backward launches
    :func:`fused_conv_pool_dgrad_windowed` (only when x needs a gradient)
    and :func:`fused_conv_pool_wgrad_windowed` (one gradient per window).
    As :class:`FusedConvPoolFn` otherwise.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, structure: LevelStructure):
        s = structure
        if x.device.type == "cpu":
            y = fused_conv_pool_windowed_reference(x, weight, bias, s.stride, s.padding,
                                                   _mode_of(s), s.negative_slope)
        elif x.device.type == "cuda":
            y = fused_conv_pool_windowed(x, repack(s, weight, bias))
        else:
            raise ValueError(f"fused_conv_pool runs on cpu or cuda tensors, not {x.device}")
        ctx.structure = s
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, y = ctx.saved_tensors
        s = ctx.structure
        gy = gy.contiguous()
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = fused_conv_pool_dgrad_windowed(gy, y, weight, s, x.shape[2])
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gw, gb = fused_conv_pool_wgrad_windowed(gy, y, x, s, weight.shape[0])
        return gx, gw, gb if ctx.has_bias else None, None


def launch_entries():
    """The six entries whose ``launches`` count their kernel's launches."""
    return (fused_conv_pool, fused_conv_pool_dgrad, fused_conv_pool_wgrad,
            fused_conv_pool_windowed, fused_conv_pool_dgrad_windowed,
            fused_conv_pool_wgrad_windowed)


def launch_counts() -> dict:
    """Every entry's launch count by its name."""
    return {f.__name__: f.launches for f in launch_entries()}


def device_runs(device: int, reset: bool = False) -> dict:
    """The runs of each kernel on CUDA device ``device`` since its last reset,
    by kernel name: counted on the device by block 0 of every launch
    (``csrc/run_counter.h``), so a CUDA-graph replay, which calls no entry,
    counts too.  Waits for the device first; sets the counts to 0 after
    reading them where ``reset``.  Builds both libraries if they are
    missing."""
    fwd, _ = _library()
    bwd = _bwd_library()[0]
    out = (ctypes.c_ulonglong * 3)()
    for lib, fn, at in ((fwd, "hmvae_fused_conv_pool_device_runs", 0),
                        (bwd, "hmvae_conv_bwd_device_runs", 1)):
        _build.check(lib, getattr(lib, fn)(device, int(reset), ctypes.byref(out, 8 * at)), fn)
    return {"conv_gemm_kernel": out[0], "dgrad_kernel": out[1], "wgrad_kernel": out[2]}
