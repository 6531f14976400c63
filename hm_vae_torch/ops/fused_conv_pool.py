"""One skeleton-conv level in one kernel: masked temporal conv (+ bias), an
optional channel-pool matrix, then LeakyReLU; and its backward.

Replaces the Pallas TPU kernel ``hm_vae_tpu/ops/pallas_kernels.py``
(``fused_conv_pool``, body ``_fused_kernel``) with the hand-written CUDA
kernel ``hm_vae_torch/csrc/fused_conv_pool.cu`` for Hopper (``sm_90a``): a
block-sparse implicit GEMM on the level's folded weight, bf16 (or 3xTF32 for
f32) on ``wgmma``, weight tiles by bulk asynchronous copy.  Its gradient is
two more hand-written kernels, ``hm_vae_torch/csrc/fused_conv_pool_bwd.cu``
(dgrad and wgrad + bias grad, f32 as 3xTF32 on ``mma.sync``, over long rows
and over the short rows of a large batch on ``wgmma``, planned by
:func:`dgrad_plan` and :func:`wgrad_plan`; dgrad's span kernel reads the
weight laid out once a call by :func:`dgrad_span_pack`, a kernel of its
own; wgrad's item kernel takes items of one batch's columns or of several
batches' whole rows; both tile kernels, :func:`wgrad_tiles` and
:func:`dgrad_tiles`, many windows' short rows; also bf16, the windowed forms too, one bf16
``mma.sync`` or ``wgmma`` a k-step: the models' ``compute_dtype:
bfloat16``), the counterparts of the JAX package's
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
across windows; at the solve's shapes, several windows of short rows,
the tile kernels, :func:`wgrad_tiles_routed` and
:func:`dgrad_tiles_routed`).  A ``torch.func.vmap``
cannot see inside a ``ctypes`` launch, so the window axis is written out.

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
from typing import Callable, NamedTuple, Optional, Tuple

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
BWD_CHUNK_CHANNELS = 8  # the backward kernels' channel chunk (the mma's N), in f32 and bf16
MAX_SPLIT = 8  # blocks of a cluster (the portable maximum)
BWD_WARPS = 8  # dgrad: one 16-column tile of a batch group per warp,
DGRAD_TILES = 2  # or up to two for a group of one batch (a padded row or span <= 256 / stride)
DGRAD_CHUNKS = 2  # dgrad: channel chunks of a block
MAX_SMEM = 232448  # shared memory a block may use
MAX_SMEM_PER_SM = 233472
DGRAD_SPAN_TILES = 4  # dgrad's span kernel: 64-column M tiles of a span, a warpgroup each
DGRAD_SPAN_CHANNELS = 32  # its channels of a block (the products' N)
DGRAD_SPAN_MAX_STAGES = 4  # its stages (k-steps of rows p) in flight
# rows p of its stage (a k-step) by element bytes: 8 in TF32, 16 in bf16
DGRAD_SPAN_KSTEP = {4: 8, 2: 16}
# bytes of a tap's weight plane: a k-step's rows p x 32 channels (f32: a TF32
# big and a small plane a tap; bf16: one)
DGRAD_TAP_PLANE = 1024
DGRAD_SPAN_SLOTS = 128 + 2 * DGRAD_TAP_PLANE  # barriers and zero planes, before the stages
# dgrad_plan routes whole rows to the span kernel (several batches' padded
# rows a span), in f32 and bf16, only at the shapes where the card timed it
# faster than dgrad_kernel: the len-64 levels (K 15, rows of at most 64
# frames) from the production batch of 64 on (PERF.md).  Batch 8 keeps its
# whole rows: its bf16 spans lost by 3%, though its f32 spans were faster
# (ROADMAP Queue 4)
DGRAD_ROWS_MIN_BATCH = 64
DGRAD_ROWS_K = 15
DGRAD_ROWS_MAX_T = 64
WGRAD_STAGE_COLS = 32  # wgrad: (b, t) columns staged at a time, at least one batch
WGRAD_SPAN_COLS = 128  # wgrad's items: the widest item's output columns (kSpanCols)
# an item's g built into a wgmma B tile this many columns at a time in f32
# (4 k-steps; a box row of 128 bytes): twice as many in bf16
WGRAD_SPAN_CHUNK = 32
WGRAD_SPAN_STAGES = 2  # items whose copies are in flight
# wgrad_plan routes whole rows to the item kernel (items of several batches'
# whole rows) only at the shapes where the card timed it faster than
# wgrad_kernel, in f32 and bf16: the len-64 levels (K 15, rows of at most 64
# frames) from the production batch of 64 on (PERF.md)
WGRAD_ROWS_MIN_BATCH = 64
WGRAD_ROWS_K = 15
WGRAD_ROWS_MAX_T = 64
# the trajectory model's short K-31 rows (traj_rows: K 31, stride 1,
# padding 15, fewer than DGRAD_ROWS_MIN_BATCH batches a window, frames a row
# within TRAJ_ROWS_T, so that a padded row fits a span and an output row one
# item): a level has few live row tiles against the card's SMs, so
# dgrad_span_plan counts their split in stages.  wgrad_plan routes them to
# items, dgrad_plan to spans from DGRAD_TRAJ_MIN_BATCH batches on: the card
# timed those faster than the whole-row kernels over batches 1-63 and T
# 64-128 in f32 and bf16, but bf16 dgrad at 1 and 2 batches (PERF.md)
TRAJ_ROWS_K = 31
TRAJ_ROWS_PADDING = 15
TRAJ_ROWS_T = (64, 128)
DGRAD_TRAJ_MIN_BATCH = 4
# wgrad's tile kernel (many windows' short rows, the test-time solve): a
# window's columns at most (kTilesCols), (K + 1) * 8 rows in its two m64
# tiles, the rows of its zero tile (kZeroRows)
WGRAD_TILES_COLS = 64
WGRAD_TILES_MAX_K = 15
WGRAD_TILES_ZERO_ROWS = 16
WGRAD_TILES_MAX_ENTRIES = 2048  # entries (live tiles and empty row tiles) it stages
# wgrad_tiles_routed gives the windowed wgrad of several windows to the tile
# kernel at the output lengths T_out (inclusive range) where the card timed
# it faster than wgrad_kernel's whole rows in the same call, by element
# bytes (4: f32, 2: bf16): the solve's four decoder levels, T_out 8-64, in
# both dtypes (PERF.md)
WGRAD_TILES_T = {4: (8, 64), 2: (8, 64)}
# dgrad's tile kernel (many windows' short rows, the test-time solve): K at
# most (8K rows in its two m64 tiles), a window's columns at most, the
# weight stages in flight at most (kDgradTilesMaxK, kDgradTilesMaxStages)
DGRAD_TILES_MAX_K = 15
DGRAD_TILES_COLS = 64
DGRAD_TILES_MAX_STAGES = 6
# dgrad_tiles_routed gives the windowed dgrad of several windows to the tile
# kernel at the output lengths T_out (inclusive range) where the card timed
# it faster than dgrad_kernel's whole rows in the same call, by element
# bytes (4: f32, 2: bf16): the solve's four decoder levels, T_out 8-64, in
# both dtypes (PERF.md)
DGRAD_TILES_T = {4: (8, 64), 2: (8, 64)}


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
    return _dgrad_of_g(_act_grad(gy, y, negative_slope), weight, T_in, stride, padding,
                       padding_mode)


def _dgrad_of_g(g, weight, T_in: int, stride: int, padding: int,
                padding_mode: str) -> torch.Tensor:
    """:func:`fused_conv_pool_dgrad_reference` from g = gy * act'(y)."""
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
    return _wgrad_of_g(_act_grad(gy, y, negative_slope), x, K, stride, padding, padding_mode,
                       live)


def _wgrad_of_g(g, x, K: int, stride: int, padding: int, padding_mode: str,
                live: Optional[torch.Tensor]):
    """:func:`fused_conv_pool_wgrad_reference` from g = gy * act'(y)."""
    cols = pad_temporal(x, padding, padding_mode).unfold(2, K, stride)  # (B, C, T_out, K)
    gw = torch.einsum("bpt,bctk->pck", g, cols)
    if live is not None:
        gw = gw * live[:, :, None].to(gw.dtype)
    return gw, g.sum((0, 2))


# The windowed plain versions compute as the kernels do in either dtype: in
# bf16, f32 sums of the bf16 operands, g = gy * act'(y) rounded to bf16 once
# and each output rounded once (JAX's bf16 level rounds its conv's output
# before the bias and the activation; the 0.02 * max|ref| rule covers both)


def fused_conv_pool_windowed_reference(x, weight, bias, stride: int, padding: int,
                                       padding_mode: str = "reflect",
                                       negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch windowed level: x (G*n, C_in, T), folded weights
    (G, P, C_in, K) and biases (G, P) or None; window g's n batches go
    through its own weight, with :func:`fused_conv_pool_reference` in f32
    (the bias added and the activation taken in f32), the output in x's
    dtype."""
    G = weight.shape[0]
    return torch.cat([fused_conv_pool_reference(
        xg.float(), weight[g].float(), None if bias is None else bias[g].float(), None, None,
        stride, padding, padding_mode, negative_slope) for g, xg in enumerate(x.chunk(G))]
    ).to(x.dtype)


def fused_conv_pool_dgrad_windowed_reference(gy, y, weight, T_in: int, stride: int,
                                             padding: int, padding_mode: str = "reflect",
                                             negative_slope: float = 0.2) -> torch.Tensor:
    """Plain windowed input gradient: :func:`fused_conv_pool_dgrad_reference`
    of each window's batches on its own weight (G, P, C_in, K), g in gy's
    dtype, the sums in f32, the result in gy's dtype."""
    G = weight.shape[0]
    g = _act_grad(gy, y, negative_slope)
    return torch.cat([_dgrad_of_g(gg.float(), weight[i].float(), T_in, stride, padding,
                                  padding_mode) for i, gg in enumerate(g.chunk(G))]
                     ).to(gy.dtype)


def fused_conv_pool_wgrad_windowed_reference(gy, y, x, K: int, stride: int, padding: int,
                                             windows: int, padding_mode: str = "reflect",
                                             negative_slope: float = 0.2,
                                             live: Optional[torch.Tensor] = None):
    """Plain windowed weight and bias gradients, (G, P, C_in, K) and (G, P):
    :func:`fused_conv_pool_wgrad_reference` over each window's batches, g in
    gy's dtype, the sums in f32, the results in gy's dtype."""
    g = _act_grad(gy, y, negative_slope)
    parts = [_wgrad_of_g(gg.float(), xg.float(), K, stride, padding, padding_mode, live)
             for gg, xg in zip(g.chunk(windows), x.chunk(windows))]
    return (torch.stack([w for w, _ in parts]).to(gy.dtype),
            torch.stack([b for _, b in parts]).to(gy.dtype))


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
    indexes ``dgrad_row``); over long rows, for each group of
    ``DGRAD_SPAN_CHANNELS`` channels, the row tiles live in any of its
    chunks (``dgrad_span_start`` indexes ``dgrad_span_row``, and
    ``dgrad_span_group`` is each entry's group, for
    :func:`dgrad_span_pack`); at the solve's windows (:func:`dgrad_tiles`),
    each chunk's own live row tiles (``dgrad_chunk_start`` (chunks + 1)
    indexes ``dgrad_chunk_row``), so that no chunk reads the zeros of a
    dead tile that its pair's live one brings into ``dgrad_row``.  The
    forward's chunks are the dtype's (``CHUNK_CHANNELS``); the backward's
    lists are over chunks of
    ``BWD_CHUNK_CHANNELS`` in either dtype (``bwd_live``: their live
    tiles).  ``live_index`` (row tile * chunks + chunk, int64) is the gather
    that :func:`repack` writes the values through.  ``max_live``,
    ``dgrad_max_live`` and ``dgrad_span_max_live``: the most live tiles of a
    row tile, and row tiles of a pair and of a group.
    """

    live: torch.Tensor
    bwd_live: torch.Tensor
    tile_start: torch.Tensor
    tile_chunk: torch.Tensor
    wgrad_row: torch.Tensor
    wgrad_chunk: torch.Tensor
    dgrad_start: torch.Tensor
    dgrad_row: torch.Tensor
    dgrad_span_start: torch.Tensor
    dgrad_span_row: torch.Tensor
    dgrad_span_group: torch.Tensor
    dgrad_chunk_start: torch.Tensor
    dgrad_chunk_row: torch.Tensor
    live_index: torch.Tensor
    dtype: torch.dtype
    rows: int
    in_channels: int
    kernel_size: int
    max_live: int
    dgrad_max_live: int
    dgrad_span_max_live: int
    stride: int
    padding: int
    reflect: bool
    negative_slope: float

    @property
    def device(self) -> torch.device:
        return self.tile_start.device

    def live_elements(self) -> torch.Tensor:
        """(P, C_in) bool: the entries of the backward's live tiles, those
        the wgrad kernel writes."""
        t = self.bwd_live.repeat_interleave(ROWS, 0).repeat_interleave(BWD_CHUNK_CHANNELS, 1)
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
    rt = -(-P // ROWS)

    def chunk_tiles(cc):  # (rt, chunks): the live ROWS x cc tiles
        nc = -(-C_in // cc)
        pad = torch.zeros(rt * ROWS, nc * cc, dtype=torch.bool)
        pad[:P, :C_in] = live.cpu()
        return pad.reshape(rt, ROWS, nc, cc).any(3).any(1)

    tiles = chunk_tiles(CHUNK_CHANNELS[dtype])  # the forward's
    by_row = tiles.nonzero()  # row-major: row tile, then chunk
    nc = tiles.shape[1]
    bt = chunk_tiles(BWD_CHUNK_CHANNELS)  # the backward's (the same in f32)
    nb = bt.shape[1]
    pairs = torch.zeros(rt, -(-nb // DGRAD_CHUNKS) * DGRAD_CHUNKS, dtype=torch.bool)
    pairs[:, :nb] = bt
    pairs = pairs.reshape(rt, -1, DGRAD_CHUNKS).any(2)  # (rt, pairs)
    per = DGRAD_SPAN_CHANNELS // BWD_CHUNK_CHANNELS
    groups = torch.zeros(rt, -(-nb // per) * per, dtype=torch.bool)
    groups[:, :nb] = bt
    groups = groups.reshape(rt, -1, per).any(2)  # (rt, groups)
    by_group = groups.T.nonzero()  # group-major: group, then row tile
    gstart = torch.zeros(groups.shape[1] + 1, dtype=torch.int32)
    gstart[1:] = groups.sum(0).cumsum(0)
    start = torch.zeros(rt + 1, dtype=torch.int32)
    start[1:] = tiles.sum(1).cumsum(0)
    dstart = torch.zeros(pairs.shape[1] + 1, dtype=torch.int32)
    dstart[1:] = pairs.sum(0).cumsum(0)
    cstart = torch.zeros(nb + 1, dtype=torch.int32)
    cstart[1:] = bt.sum(0).cumsum(0)
    # wgrad's entries: the live tiles by row, (row, -1) where a row has none
    empty = (~bt.any(1)).nonzero()[:, 0]
    wg = torch.cat([bt.nonzero(), torch.stack([empty, torch.full_like(empty, -1)], 1)])
    wg = wg[torch.argsort(wg[:, 0] * (nb + 1) + wg[:, 1], stable=True)]

    def put(t, dt=torch.int32):
        return t.to(dt).contiguous().to(device)

    return LevelStructure(
        live=tiles.to(device), bwd_live=bt.to(device), tile_start=put(start),
        tile_chunk=put(by_row[:, 1]),
        wgrad_row=put(wg[:, 0]), wgrad_chunk=put(wg[:, 1]), dgrad_start=put(dstart),
        dgrad_row=put(pairs.T.nonzero()[:, 1]), dgrad_span_start=put(gstart),
        dgrad_span_row=put(by_group[:, 1]),
        dgrad_span_group=put(by_group[:, 0]), dgrad_chunk_start=put(cstart),
        dgrad_chunk_row=put(bt.T.nonzero()[:, 1]),
        live_index=put(by_row[:, 0] * nc + by_row[:, 1], torch.int64), dtype=dtype,
        rows=P, in_channels=C_in, kernel_size=kernel_size,
        max_live=int(tiles.sum(1).max()) if rt else 0,
        dgrad_max_live=int(pairs.sum(0).max()) if nb else 0,
        dgrad_span_max_live=int(groups.sum(0).max()) if nb else 0, stride=stride,
        padding=padding,
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


def _span_pack_checks(s: LevelStructure, weight: torch.Tensor) -> int:
    """G of a weight (P, C_in, K) or G windows' (G, P, C_in, K) in the
    structure's dtype, else raises."""
    lead, (P, C_in, K) = tuple(weight.shape[:-3]), weight.shape[-3:]
    if weight.dtype != s.dtype or len(lead) > 1 or (P, C_in, K) != (
            s.rows, s.in_channels, s.kernel_size):
        raise ValueError(f"weight {tuple(weight.shape)} {weight.dtype} does not fit the "
                         f"structure ([G,] {s.rows}, {s.in_channels}, {s.kernel_size}) {s.dtype}")
    return lead[0] if lead else 1


def dgrad_span_pack_reference(structure: LevelStructure, weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dgrad_span_pack`: the folded weight
    (P, C_in, K), or G windows' (G, P, C_in, K), as ``dgrad_span_kernel``
    reads it, with no host sync: for each window and each entry
    (``dgrad_span_row``, ``dgrad_span_group``: a row tile live in any chunk
    of a group of ``DGRAD_SPAN_CHANNELS`` channels), each k-step of ks rows
    p (``DGRAD_SPAN_KSTEP``: 8 in f32, 16 in bf16) and each tap, 1 KB planes
    of the slice (ks rows p x 32 channels) in wgmma's K-major core-matrix
    order (channels in fours of 8, then half of the rows p, then the
    channel, then ks / 2 rows p): f32, the TF32 rounding and its remainder
    rounded to TF32, (G, entries, 8, K, 2, 256); bf16, the values, (G,
    entries, 4, K, 1, 512).  Rows past P and channels past C_in are zeros.
    A stage of the kernel (one k-step, its K taps) is one contiguous run."""
    s = structure
    G = _span_pack_checks(s, weight)
    P, C_in, K = weight.shape[-3:]
    rt, groups = s.tile_start.numel() - 1, s.dgrad_span_start.numel() - 1
    n = DGRAD_SPAN_CHANNELS
    ks = DGRAD_SPAN_KSTEP[weight.element_size()]
    with torch.no_grad():
        w = torch.nn.functional.pad(weight.reshape(G, P, C_in, K),
                                    (0, 0, 0, groups * n - C_in, 0, rt * ROWS - P))
        # p = (k-step, half, ks / 2 rows), c = (group, eight, 8 channels)
        t = w.reshape(G, rt, ROWS // ks, 2, ks // 2, groups, n // 8, 8, K)
        t = t.permute(0, 1, 5, 2, 8, 6, 3, 7, 4)
        t = t[:, s.dgrad_span_row, s.dgrad_span_group].reshape(G, -1, ROWS // ks, K, ks * n)
        if weight.dtype == torch.bfloat16:
            return t[:, :, :, :, None].contiguous()
        # the planes written in place (fewer passes than _tf32 and a stack)
        out = t.new_empty(t.shape[:4] + (2, ks * n))
        big, small = out[..., 0, :], out[..., 1, :]
        torch.bitwise_and(t.view(torch.int32) + 0x1000, -0x2000, out=big.view(torch.int32))
        torch.sub(t, big, out=small)
        small.view(torch.int32).add_(0x1000).bitwise_and_(-0x2000)
        return out


def dgrad_span_pack(structure: LevelStructure, weight: torch.Tensor) -> torch.Tensor:
    """The folded weight laid out for ``dgrad_span_kernel`` (the layout of
    :func:`dgrad_span_pack_reference`), once a backward call: on CUDA one
    launch of ``dgrad_span_pack_kernel`` (one pass over the weight, counted
    in ``launches``), on the CPU the plain version."""
    s = structure
    if weight.device.type == "cpu":
        return dgrad_span_pack_reference(s, weight)
    G = _span_pack_checks(s, weight)
    if weight.device != s.device or not weight.is_contiguous():
        raise ValueError(f"the weight must be a contiguous tensor on {s.device}")
    P, C_in, K = weight.shape[-3:]
    ks = DGRAD_SPAN_KSTEP[weight.element_size()]
    entries = s.dgrad_span_row.numel()
    out = weight.new_empty((G, entries, ROWS // ks, K, 16 // ks,
                            DGRAD_TAP_PLANE // weight.element_size()))
    if entries:
        lib, pack = _bwd_library()[0], _bwd_library()[3]
        err = _on_device(weight, lambda: pack(
            weight.data_ptr(), s.dgrad_span_row.data_ptr(), s.dgrad_span_group.data_ptr(),
            out.data_ptr(), entries, P, C_in, K, G, _DTYPES[weight.dtype],
            torch.cuda.current_stream(weight.device).cuda_stream))
        _build.check(lib, err, "dgrad_span_pack")
        dgrad_span_pack.launches += 1
    return out


dgrad_span_pack.launches = 0


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
# hmvae_conv_dgrad(gy, y, w, dgrad_start, dgrad_row, gx, wpk, B, C, T_in,
# K, P, T_out, t_ld, stride, padding, reflect, slope, nbb, split, span,
# windows, dtype, device, stream)
DGRAD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float]
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])
# hmvae_conv_wgrad(gy, y, x, wgrad_row, wgrad_chunk, gw, gb, n_tiles, B, C,
# T_in, K, P, T_out, t_ld, stride, padding, reflect, slope, sb, split, span,
# windows, dtype, device, stream)
WGRAD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_float]
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])
# hmvae_dgrad_span_pack(w, span_row, span_group, out, entries, P, C, K,
# windows, dtype, stream)
PACK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# hmvae_conv_wgrad_tiles(gy, y, x, wgrad_row, wgrad_chunk, gw, gb, n_tiles,
# B, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, slope, blocks,
# windows, dtype, device, stream)
TILES_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_float]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# hmvae_conv_dgrad_tiles(gy, y, w, dgrad_chunk_start, dgrad_chunk_row, gx,
# entries, B, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, slope,
# blocks, windows, dtype, device, stream)
DGRAD_TILES_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_float]
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
    """The backward kernels' library, built at first use, and its entries:
    dgrad, wgrad, dgrad's weight layout for spans, wgrad's tile kernel and
    dgrad's."""
    return _bwd_entries(_build.load("fused_conv_pool_bwd"))


def _bwd_entries(lib):
    """``lib`` (a build of ``csrc/fused_conv_pool_bwd.cu``) and its entries,
    as :func:`_bwd_library` returns them."""
    return (lib, _bind(lib, "hmvae_conv_dgrad", DGRAD_ARGTYPES),
            _bind(lib, "hmvae_conv_wgrad", WGRAD_ARGTYPES),
            _bind(lib, "hmvae_dgrad_span_pack", PACK_ARGTYPES),
            _bind(lib, "hmvae_conv_wgrad_tiles", TILES_ARGTYPES),
            _bind(lib, "hmvae_conv_dgrad_tiles", DGRAD_TILES_ARGTYPES))


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def span_clusters(device: int, K: int, stride: int, esz: int = 4) -> Tuple[int, ...]:
    """The most clusters of 1 to ``MAX_SPLIT`` blocks of ``dgrad_span_kernel``
    (its widest span at K and stride, elements of ``esz`` bytes) that CUDA
    device ``device`` runs at once (``cudaOccupancyMaxActiveClusters``), by
    split: :func:`dgrad_span_plan`'s waves where it splits a group's stages."""
    lib = _bwd_library()[0]
    fn = _bind(lib, "hmvae_dgrad_span_clusters", [ctypes.c_int] * 6 + [ctypes.c_void_p])
    span, dtype, out = dgrad_span_cols(K, stride, esz), int(esz == 2), []
    with torch.cuda.device(device):
        for split in range(1, MAX_SPLIT + 1):
            n = ctypes.c_int(0)
            _build.check(lib, fn(K, stride, span, split, dtype, device, ctypes.byref(n)),
                         "span_clusters")
            out.append(n.value)
    return tuple(out)


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
    """The backward kernels take float32, or bfloat16 where gy, y, the
    other operands and the structure all share it."""
    if gy.dtype not in _DTYPES or s.dtype != gy.dtype:
        raise TypeError("the fused_conv_pool backward kernels take float32 or bfloat16, gy in "
                        f"its structure's dtype (got {gy.dtype}, structure {s.dtype})")
    if s.kernel_size > MAX_BWD_K:
        raise ValueError(f"the backward kernels take K <= {MAX_BWD_K}, not {s.kernel_size}")
    if not s.negative_slope > 0:
        raise ValueError("the backward reads LeakyReLU's gradient from its output: "
                         f"slope must be > 0, not {s.negative_slope}")
    _check("y", y, gy, gy.shape)
    for name, t in tensors.items():
        if t.dtype != gy.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, gy has {gy.dtype}")
        if t.device != gy.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {gy.device}")
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


class DgradPlan(NamedTuple):
    """dgrad's launch: ``nbb`` batches a block, ``groups`` batch groups a
    window, ``split`` blocks of a cluster, and ``span``: 0 for whole padded
    rows (``dgrad_kernel``), else the padded columns of a span
    (``dgrad_span_kernel``: whole padded rows of ``nbb`` batches, or a span
    of one batch's row)."""
    nbb: int
    groups: int
    split: int
    span: int


class WgradPlan(NamedTuple):
    """wgrad's launch: ``sb`` batches staged at a time (the item kernel's: 1
    for items of one batch's columns, else the batches whose whole rows an
    item holds), ``split`` blocks of a cluster, and ``span``: 0 for x's
    whole rows, else the output columns of an item (at most
    ``WGRAD_SPAN_COLS``)."""
    sb: int
    split: int
    span: int


class DgradTilesPlan(NamedTuple):
    """dgrad's tile kernel's launch (``dgrad_tiles_kernel``): ``blocks``
    persistent blocks over the ``units`` (window, 8-channel chunk) units, a
    contiguous run of them a block, cut by the live row tiles they hold
    (:func:`dgrad_tiles_runs`)."""
    blocks: int
    units: int


class WgradTilesPlan(NamedTuple):
    """wgrad's tile kernel's launch (``wgrad_tiles_kernel``): ``blocks``
    persistent blocks over the ``units`` (window, entry) units, a
    contiguous run of them a block (:func:`wgrad_tiles_runs`)."""
    blocks: int
    units: int


def _dgrad_tiles(width: int, stride: int, nbb: int = 1) -> int:
    """16-column tiles of ``nbb`` batches' ``width`` padded columns, the
    columns of each stride phase tiled apart."""
    return sum(-(-nbb * -(-(width - phi) // stride) // 16) for phi in range(stride))


def dgrad_whole_rows(T_in: int, K: int, stride: int, padding: int, t_ld: int,
                     esz: int = 4) -> bool:
    """Whether one batch's padded row fits a whole-row dgrad block: at most
    ``DGRAD_TILES`` 16-column tiles a warp and within shared memory, in
    elements of ``esz`` bytes (4: f32, 2: bf16)."""
    return (_dgrad_tiles(T_in + 2 * padding, stride) <= BWD_WARPS * DGRAD_TILES
            and _dgrad_smem(T_in, K, t_ld, stride, padding, 1, esz) <= MAX_SMEM)


def dgrad_plan(B: int, T_in: int, K: int, stride: int, padding: int, t_ld: int,
               pairs: int, max_live: int, sms: int, windows: int = 1,
               span_groups: Optional[Tuple[int, int]] = None, esz: int = 4,
               clusters: Optional[Callable[[], Tuple[int, ...]]] = None) -> DgradPlan:
    """The dgrad kernel's :class:`DgradPlan`: whole padded rows that fit a
    block take :func:`dgrad_whole_plan`.  A padded row that one batch's
    block cannot hold (more than 256 / stride columns, or beyond shared
    memory) is cut into spans, and the short rows of one window that
    :func:`dgrad_rows_routed` takes (a large batch's; the trajectory's short
    K-31 rows) take spans of whole rows, one or more batches' a span:
    :func:`dgrad_span_plan` over ``span_groups``, the groups of
    ``DGRAD_SPAN_CHANNELS`` channels and their most live row tiles (by
    default half the pairs and their most).  ``esz``: the element's bytes
    (4: f32, 2: bf16); ``clusters``: :func:`dgrad_span_plan`'s."""
    if not dgrad_whole_rows(T_in, K, stride, padding, t_ld, esz) or (
            windows == 1 and dgrad_rows_routed(B, T_in, K, stride, padding, esz)):
        groups, group_live = span_groups or (-(-pairs // 2), max_live)
        return dgrad_span_plan(B, T_in, K, stride, padding, groups, group_live, sms, windows,
                               esz, clusters)
    return dgrad_whole_plan(B, T_in, K, stride, padding, t_ld, pairs, max_live, sms, windows,
                            esz)


def dgrad_whole_plan(B: int, T_in: int, K: int, stride: int, padding: int, t_ld: int,
                     pairs: int, max_live: int, sms: int, windows: int = 1,
                     esz: int = 4) -> DgradPlan:
    """``dgrad_kernel``'s :class:`DgradPlan` over whole padded rows that fit
    a block (:func:`dgrad_whole_rows`): a block owns a pair of channel
    chunks and the padded rows of ``nbb`` batches (``groups`` batch groups
    of each of ``windows`` windows of ``B`` batches: a group never crosses a
    window), as many as its eight warps' 16-column tiles hold, one a warp
    (the columns of each stride phase tiled apart; one batch alone may take
    two a warp), and ``split`` blocks of a cluster share the pair's live row
    tiles (at most ``max_live``).  Chosen for the least time on an SM,
    counted in row tiles: waves of blocks (two to an SM where their shared
    memory allows) times the row tiles a block walks, plus one for its
    prologue and epilogue; ties go to fewer blocks.  ``esz``: the element's
    bytes (bf16's smaller stages may let a block take more batches)."""
    Tp = T_in + 2 * padding
    best = None
    for nb in range(1, 1 + B):
        smem = _dgrad_smem(T_in, K, t_ld, stride, padding, nb, esz)
        if nb > 1 and (_dgrad_tiles(Tp, stride, nb) > BWD_WARPS or smem > MAX_SMEM):
            continue
        groups = -(-B // nb)
        nbb = -(-B // groups)  # the same groups, batches spread evenly
        per_sm = 2 if smem <= MAX_SMEM_PER_SM // 2 - 1024 else 1
        for split in range(1, min(MAX_SPLIT, max(1, max_live)) + 1):
            blocks = pairs * windows * groups * split
            # a block's prologue and epilogue cost about one row tile
            cost = (-(-blocks // (sms * per_sm)) * (-(-max_live // split) + 1), blocks)
            if best is None or cost < best[0]:
                best = (cost, DgradPlan(nbb, groups, split, 0))
    return best[1]


def dgrad_span_plan(B: int, T_in: int, K: int, stride: int, padding: int, groups: int,
                    max_live: int, sms: int, windows: int = 1, esz: int = 4,
                    clusters: Optional[Callable[[], Tuple[int, ...]]] = None) -> DgradPlan:
    """``dgrad_span_kernel``'s :class:`DgradPlan` at any length, in elements
    of ``esz`` bytes: a block owns one of ``groups`` groups of
    ``DGRAD_SPAN_CHANNELS`` channels and a span of :func:`dgrad_span_cols`
    padded columns.  Where a padded row fits a span, the span holds the
    whole rows of ``nbb`` batches of a window, as many as its M tiles hold
    (:func:`dgrad_span_rows`), spread evenly over ``groups`` batch groups a
    window; else a block owns one batch and its padded row is cut into
    spans (the first narrower by :func:`dgrad_span_shift`).  ``split``
    blocks of a cluster share a group's stages (its live row tiles, at most
    ``max_live``, a k-step each), a contiguous run a block, the split chosen
    as :func:`dgrad_plan` chooses it (a block takes an SM), counted in row
    tiles up to ``max_live`` blocks; or, at the trajectory's short rows of
    one window (:func:`traj_rows`, whose few row tiles leave most SMs idle),
    counted in stages up to ``MAX_SPLIT`` blocks, a row tile's stages for
    the prologue and epilogue, the waves counted in clusters:
    ``clusters()[split - 1]`` of them run at once (``clusters``: the
    device's :func:`span_clusters`, asked only there; by default sms //
    split)."""
    span = dgrad_span_cols(K, stride, esz)
    per = dgrad_span_rows(T_in, K, stride, padding, span)
    if per:
        bgroups = -(-B // min(per, B))
        nbb, units = -(-B // bgroups), bgroups
    else:
        if span <= 4 * padding + stride:
            raise ValueError(f"a dgrad span of {span} columns cannot hold both columns of the "
                             f"reflected pairs of padding {padding}")
        nbb, bgroups, units = 1, B, B * -(-(T_in + 2 * padding) // span)
    # the work of a group's block counted in row tiles, or in stages
    by_stages = windows == 1 and traj_rows(B, T_in, K, stride, padding)
    fits = clusters() if by_stages and clusters else None
    tile = ROWS // DGRAD_SPAN_KSTEP[esz] if by_stages else 1
    work, most = max(1, max_live) * tile, MAX_SPLIT if by_stages else max(1, max_live)
    best = None
    for split in range(1, min(MAX_SPLIT, most) + 1):
        blocks = groups * windows * units * split
        waves = -(-blocks // sms) if not by_stages else -(-(groups * windows * units) // max(
            1, fits[split - 1] if fits else sms // split))
        cost = (waves * (-(-work // split) + tile), blocks)
        if best is None or cost < best[0]:
            best = (cost, DgradPlan(nbb, bgroups, split, span))
    return best[1]


def dgrad_span_period(T_in: int, K: int, stride: int, padding: int) -> int:
    """The M rows (columns v) a batch's padded row takes in each stride
    phase of a span of whole rows (``dgrad_span_period`` in the kernel's
    source): its widest phase, and at least T_out + off, so that the off =
    ceil(K / stride) - 1 zeros ahead of the next batch's g stay between
    them."""
    Tp = T_in + 2 * padding
    return max(-(-Tp // stride), (Tp - K) // stride + 1 + -(-K // stride) - 1)


def dgrad_span_rows(T_in: int, K: int, stride: int, padding: int, span: int) -> int:
    """Whole padded rows a span of ``span`` columns holds: its M tiles of
    each stride phase (span / stride rows) over :func:`dgrad_span_period`;
    0 where one row is longer (spans of one batch's row)."""
    return span // stride // dgrad_span_period(T_in, K, stride, padding)


def traj_rows(B: int, T_in: int, K: int, stride: int, padding: int) -> bool:
    """Whether a window's rows are the trajectory model's short K-31 rows:
    K ``TRAJ_ROWS_K``, stride 1, padding ``TRAJ_ROWS_PADDING``, fewer than
    ``DGRAD_ROWS_MIN_BATCH`` batches, frames within ``TRAJ_ROWS_T`` (a
    padded row fits a span, an output row one item)."""
    return (K == TRAJ_ROWS_K and stride == 1 and padding == TRAJ_ROWS_PADDING
            and B < DGRAD_ROWS_MIN_BATCH and TRAJ_ROWS_T[0] <= T_in <= TRAJ_ROWS_T[1])


def dgrad_rows_routed(B: int, T_in: int, K: int, stride: int, padding: int,
                      esz: int = 4) -> bool:
    """Whether :func:`dgrad_plan` gives whole rows that fit a whole-row
    block to the span kernel (whole padded rows of one or more batches a
    span): only at the shapes where the card timed it faster than
    ``dgrad_kernel`` (K ``DGRAD_ROWS_K``, rows of at most
    ``DGRAD_ROWS_MAX_T`` frames, from ``DGRAD_ROWS_MIN_BATCH`` batches a
    window on; and the trajectory's short K-31 rows, :func:`traj_rows`,
    from ``DGRAD_TRAJ_MIN_BATCH`` batches on; PERF.md), and only where a
    span holds a row."""
    return ((B >= DGRAD_ROWS_MIN_BATCH and K == DGRAD_ROWS_K and T_in <= DGRAD_ROWS_MAX_T)
            or (traj_rows(B, T_in, K, stride, padding) and B >= DGRAD_TRAJ_MIN_BATCH)) and \
        dgrad_span_rows(T_in, K, stride, padding, dgrad_span_cols(K, stride, esz)) > 0


def _dgrad_smem(T_in: int, K: int, t_ld: int, stride: int, padding: int, nbb: int,
                esz: int = 4) -> int:
    """Bytes of shared memory a whole-row dgrad block takes (``dgrad_layout``
    in the kernel's source) in elements of ``esz`` bytes: two weight stages
    (32 rows of 16 channels), one of gy and y, g padded (f32: split, 8 bytes
    a value; bf16: two rows p a 4-byte word), and gxpad, f32 (over the
    weight stages when it fits)."""
    kmax = -(-K // stride)
    Tp = T_in + 2 * padding
    T_out = (Tp - K) // stride + 1
    n = kmax - 1 + max(-(-Tp // stride), T_out)
    rs = (n + 11) // 16 * 16 + 4 if esz == 4 else (n + 23) // 32 * 32 + 8
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    half = ROWS // 2  # a stage: half a row tile
    w_ring = a16(2 * half * (8 * DGRAD_CHUNKS * K + 8) * esz)
    g2_end = (64 + w_ring + a16(2 * nbb * half * t_ld * esz)
              + nbb * half * rs * (8 if esz == 4 else 2))
    out = 8 * DGRAD_CHUNKS * nbb * Tp * 4
    return g2_end if out <= w_ring else a16(g2_end) + out


def _dgrad_span_layout(K: int, stride: int, span: int, esz: int = 4) -> Tuple[int, int]:
    """(bytes, stages) of a ``dgrad_span_kernel`` block (``dgrad_span_layout``
    in the kernel's source) in elements of ``esz`` bytes: the barriers and
    zero planes, then as many stages as fit (at most
    ``DGRAD_SPAN_MAX_STAGES``), each the K taps' weight planes, the stage's
    rows of gy and of y (gw columns a row p, from a 16-byte granule on) and
    g in the A layout (f32: big and small planes of 8 rows p; bf16: 8 rows
    of pairs of rows p), gw columns a row, a row's pitch 8 mod 32 words.
    Independent of T and of the batch."""
    off = -(-K // stride) - 1
    gran, ks, planes = 16 // esz, DGRAD_SPAN_KSTEP[esz], esz // 2
    gw = (off + span // stride + 2 * gran - 2) // gran * gran
    gl = gw + (40 - gw % 32) % 32
    slot = -(-(K * planes * DGRAD_TAP_PLANE + 2 * ks * gw * esz + planes * 8 * gl * 4)
             // 128) * 128
    stages = min(DGRAD_SPAN_MAX_STAGES, (MAX_SMEM - DGRAD_SPAN_SLOTS) // slot)
    return DGRAD_SPAN_SLOTS + stages * slot, stages


def dgrad_span_cols(K: int, stride: int, esz: int = 4) -> int:
    """The widest dgrad span: whole 64-column M tiles of every stride phase,
    at most ``DGRAD_SPAN_TILES`` of them, with at least two stages in a
    block: 256 padded columns at strides 1, 2 and 4, 192 at 3."""
    for tiles in range(DGRAD_SPAN_TILES // stride, 0, -1):
        if _dgrad_span_layout(K, stride, 64 * stride * tiles, esz)[1] >= 2:
            return 64 * stride * tiles
    raise ValueError(f"no dgrad span fits shared memory at K={K}, stride={stride}")


def dgrad_span_shift(Tp: int, span: int, stride: int, padding: int, reflect: bool) -> int:
    """How many columns narrower than ``span`` the first span of a padded
    row of ``Tp`` columns is (``dgrad_span_shift`` in the kernel's source):
    under reflect, enough that the last span holds the row's last
    2*padding + 1 columns, so that each span folds its reflected columns."""
    n0 = -(-Tp // span)
    last = Tp - (n0 - 1) * span
    if not reflect or padding == 0 or n0 < 2 or last > 2 * padding:
        return 0
    return -(-(2 * padding + 1 - last) // stride) * stride


def _wgrad_smem(B: int, T_in: int, K: int, T_out: int, t_ld: int, stride: int, sb: int,
                split: int, esz: int = 4) -> int:
    """Bytes of shared memory a wgrad block takes (``wgrad_layout`` in the
    kernel's source) in elements of ``esz`` bytes: x's rows of the block's
    batches padded (f32: split, 8 bytes a value), one or two stages of gy
    and y, and g in fragment order (k-steps of 8 columns, big + small, in
    f32; of 16, one part, in bf16; x's raw rows first, the f32 partial
    gradient tile over the stages last)."""
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    nb_max = -(-B // split)
    n_st = -(-nb_max // sb)
    Lh = -(-((T_out - 1) * stride + K) // stride)
    f32 = esz == 4
    rsx = (stride * Lh + 11) // 16 * 16 + 4 if f32 else (stride * Lh + 55) // 64 * 64 + 8
    g = 64 + a16(nb_max * 8 * rsx * (8 if f32 else 2))
    stage = a16(2 * sb * ROWS * t_ld * esz)
    frags = -(-sb * T_out // (8 if f32 else 16)) * 4 * 32 * (32 if f32 else 16)
    tail = max(frags, nb_max * 8 * T_in * esz)
    red = ROWS * (8 * K + 4) * 4
    slots = min(n_st, 2)
    while True:
        total = max(g + slots * stage + tail, g + red)
        if slots == 1 or total <= MAX_SMEM_PER_SM // 2 - 1024:
            return total
        slots -= 1


def _wgrad_span_smem(K: int, stride: int, cols: int = WGRAD_SPAN_COLS, esz: int = 4,
                     nbb: int = 1, T_in: int = 0, T_out: int = 0, t_ld: int = 0) -> int:
    """Bytes of shared memory a block of the item kernel takes
    (``wgrad_span_layout`` in the kernel's source) at items of ``cols``
    output columns, in elements of ``esz`` bytes: two stages of an item's
    gy and y and x (one batch's columns, ``nbb`` 1: boxes of 64 rows x a
    chunk's 128 bytes, x's window in 16-byte granules, independent of T;
    several batches' rows, ``nbb`` > 1: each batch's 64 rows of ``t_ld``
    values and its x rows), from the first 1024-byte boundary past the
    barriers; x padded by stride phase (f32: split into TF32 big and small
    parts; rows of nbb periods of T_out + off columns where nbb > 1) and the
    chunk's B tile, two of each; the
    padding's table (nbb > 1); the partial gradient tile over the stages at
    the end."""
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    gran, chunk, planes = 16 // esz, 128 // esz, 2 if esz == 4 else 1
    if nbb > 1:
        R = T_out + -(-K // stride) - 1
        Lh, xr = nbb * R, 8 * T_in
        gbytes = nbb * ROWS * t_ld * esz
        raw = 2 * gbytes + nbb * xr * esz
    else:
        Lx = (cols - 1) * stride + K
        R, Lh, xr = 0, -(-Lx // stride), (Lx + 3 * gran - 3) // gran * gran
        raw = 2 * (cols // chunk) * ROWS * 128 + 8 * xr * esz
    n = stride * Lh
    # f32: a value's TF32 big and small parts, 8 bytes; bf16: the value
    rsx, xsz = ((n + 11) // 16 * 16 + 4, 8) if esz == 4 else ((n + 56) // 64 * 64 + 8, 2)
    stage = -(-raw // 1024) * 1024
    tiles = 2 * planes * 4 * 2048  # B tiles: 4 k-steps of 64 rows p a plane
    end = 64 + 1024 + WGRAD_SPAN_STAGES * stage + a16(2 * 8 * rsx * xsz) + tiles + 8 * stride * R
    return max(end, 64 + ROWS * (8 * K + 4) * 4)


def wgrad_span_cols(K: int, stride: int, esz: int = 4) -> int:
    """The widest item of one batch's columns (a multiple of a chunk, 32
    f32 or 64 bf16 columns, up to ``WGRAD_SPAN_COLS``) whose block fits
    shared memory: 128 at every model's levels (K 15 and 31, stride 1 and
    2), in f32 and bf16."""
    chunk = 128 // esz
    for cols in range(WGRAD_SPAN_COLS, 0, -chunk):
        if _wgrad_span_smem(K, stride, cols, esz) <= MAX_SMEM:
            return cols
    raise ValueError(f"no wgrad item fits shared memory at K={K}, stride={stride}")


def wgrad_span_rows(B: int, T_in: int, K: int, stride: int, padding: int, esz: int = 4,
                    cols: int = WGRAD_SPAN_COLS) -> int:
    """The batches an item of several batches' whole rows holds: as many
    rows of T_out output columns as fill ``cols`` columns (at most B),
    fewer where the block would not fit shared memory, or, in bf16 (``esz``
    2), where fewer let two blocks share an SM (:func:`wgrad_items_per_sm`),
    then spread evenly over the items.  0 (items of one batch's columns)
    where fewer than two fit; where x's rows are no whole 16-byte granules
    or longer than a box's 256 values (its 3D copies); at K > 15 (that
    form of the kernel has one m64 tile of (tap, channel) rows a
    warpgroup); or in bf16 where T_out is odd (a register pairs two
    columns, which must lie in one batch)."""
    T_out = (T_in + 2 * padding - K) // stride + 1
    t_ld = -(-T_out // (16 // esz)) * (16 // esz)
    if (esz == 2 and T_out % 2) or (T_in * esz) % 16 or T_in > 256 or (K + 1) * 8 > 128:
        return 0
    fits = [nbb for nbb in range(min(B, cols // T_out), 1, -1)
            if _wgrad_span_smem(K, stride, cols, esz, nbb, T_in, T_out, t_ld) <= MAX_SMEM]
    two = [nbb for nbb in fits
           if wgrad_items_per_sm(K, stride, cols, esz, nbb, T_in, T_out, t_ld) == 2]
    nbb = (two or fits or [0])[0]
    return -(-B // -(-B // nbb)) if nbb else 0  # the same items, batches spread evenly


def wgrad_items_per_sm(K: int, stride: int, cols: int = WGRAD_SPAN_COLS, esz: int = 4,
                       nbb: int = 1, T_in: int = 0, T_out: int = 0, t_ld: int = 0) -> int:
    """Blocks of the item kernel an SM holds (its arguments are
    :func:`_wgrad_span_smem`'s): two in bf16 (its sums stay in the
    accumulators, so its launch bounds leave registers for two at one or
    two m64 tiles a warpgroup) where the block's shared memory fits half an
    SM, else one."""
    smem = _wgrad_span_smem(K, stride, cols, esz, nbb, T_in, T_out, t_ld)
    return 2 if esz == 2 and smem <= MAX_SMEM_PER_SM // 2 - 1024 else 1


def wgrad_rows_routed(B: int, T_in: int, K: int, stride: int, padding: int,
                      esz: int = 4) -> bool:
    """Whether :func:`wgrad_plan` gives whole rows that fit a whole-row
    block to the item kernel (items of several batches' whole rows), in
    elements of ``esz`` bytes: only at the shapes where the card timed it
    faster than ``wgrad_kernel`` in f32 and bf16 (K ``WGRAD_ROWS_K``, rows
    of at most ``WGRAD_ROWS_MAX_T`` frames, from ``WGRAD_ROWS_MIN_BATCH``
    batches a window on; PERF.md), and only where an item holds two rows or
    more."""
    return (B >= WGRAD_ROWS_MIN_BATCH and K == WGRAD_ROWS_K and T_in <= WGRAD_ROWS_MAX_T
            and wgrad_span_rows(B, T_in, K, stride, padding, esz,
                                wgrad_span_cols(K, stride, esz)) > 1)


def wgrad_items_routed(B: int, T_in: int, K: int, stride: int, padding: int,
                       esz: int = 4) -> bool:
    """Whether :func:`wgrad_plan` gives rows that fit a whole-row block to
    the item kernel's items of one batch's columns: the trajectory's short
    K-31 rows (:func:`traj_rows`), and bf16 rows past f32's whole rows
    (:func:`wgrad_bf16_items`); where the card timed items faster (PERF.md)."""
    return traj_rows(B, T_in, K, stride, padding) or wgrad_bf16_items(B, T_in, K, stride,
                                                                      padding, esz)


def wgrad_bf16_items(B: int, T_in: int, K: int, stride: int, padding: int,
                     esz: int = 4) -> bool:
    """Whether bf16 (``esz`` 2) rows of ``B`` batches a window are too long
    for an f32 whole-row block, which f32 runs as items: bf16 takes items
    there too, one window (the stride-2 level enc1 at (8, 1,024)) or G
    windows (the solve's decoder levels at long windows, each window's
    rows as one window's), as f32 does."""
    T_out = (T_in + 2 * padding - K) // stride + 1
    return esz == 2 and not wgrad_whole_rows(B, T_in, K, T_out, -(-T_out // 4) * 4, stride)


def wgrad_routed_rows(B: int, T_in: int, K: int, stride: int, padding: int, esz: int = 4,
                      cols: int = WGRAD_SPAN_COLS) -> int:
    """The ``rows`` that :func:`wgrad_plan` takes for one window's call: the
    batches an item holds where it routes whole rows to items of several
    batches' rows (:func:`wgrad_rows_routed`), 1 where it routes them to
    items of one batch's columns (:func:`wgrad_items_routed`), else 0."""
    if wgrad_rows_routed(B, T_in, K, stride, padding, esz):
        return wgrad_span_rows(B, T_in, K, stride, padding, esz, cols)
    return int(wgrad_items_routed(B, T_in, K, stride, padding, esz))


def wgrad_span_plan(B: int, T_out: int, entries: int, sms: int, windows: int = 1,
                    cols: int = WGRAD_SPAN_COLS, nbb: int = 1, per_sm: int = 1) -> WgradPlan:
    """``wgrad_span_kernel``'s :class:`WgradPlan`: a window's items split
    over ``split`` blocks of a cluster in contiguous runs; an item is one
    batch's ``cols`` output columns (``nbb`` 1), or the whole rows of
    ``nbb`` batches (``nbb`` > 1: :func:`wgrad_span_rows`, the plan's
    ``sb``).  A block takes an SM, or half of one (``per_sm``:
    :func:`wgrad_items_per_sm`), so the split is chosen for the least time,
    counted in items: waves of blocks times the items a block takes, plus
    one for its prologue and epilogue; ties go to fewer blocks."""
    items = -(-B // nbb) if nbb > 1 else B * -(-T_out // cols)
    tiles = max(1, entries * windows)
    slots = sms * per_sm
    cost = lambda split: (-(-tiles * split // slots) * (-(-items // split) + 1), split)  # noqa
    return WgradPlan(nbb, min(range(1, min(MAX_SPLIT, items) + 1), key=cost), cols)


def wgrad_whole_rows(B: int, T_in: int, K: int, T_out: int, t_ld: int, stride: int,
                     esz: int = 4) -> bool:
    """Whether x's rows of a wgrad block fit shared memory at the widest
    split (``MAX_SPLIT`` blocks, at most B), in elements of ``esz`` bytes:
    else :func:`wgrad_plan` cuts the reduction into items."""
    split = min(MAX_SPLIT, B)
    sb = max(1, min(-(-B // split), WGRAD_STAGE_COLS // T_out))
    return _wgrad_smem(B, T_in, K, T_out, t_ld, stride, sb, split, esz) <= MAX_SMEM


def wgrad_plan(B: int, T_out: int, entries: int, sms: int, windows: int = 1,
               smem=None, span_cols: int = WGRAD_SPAN_COLS, rows: int = 0,
               per_sm: int = 1) -> WgradPlan:
    """The wgrad kernel's :class:`WgradPlan`: where the call is routed to
    the item kernel (``rows``: :func:`wgrad_routed_rows`, the batches an
    item holds, 1 for items of one batch's columns; over windows 1 at most),
    :func:`wgrad_span_plan` over them; else :func:`wgrad_whole_plan`.
    ``per_sm``: the item kernel's blocks an SM
    (:func:`wgrad_items_per_sm`)."""
    if rows:
        return wgrad_span_plan(B, T_out, entries, sms, windows, span_cols, rows, per_sm)
    return wgrad_whole_plan(B, T_out, entries, sms, windows, smem, span_cols, per_sm)


def wgrad_whole_plan(B: int, T_out: int, entries: int, sms: int, windows: int = 1,
                     smem=None, span_cols: int = WGRAD_SPAN_COLS,
                     per_sm: int = 1) -> WgradPlan:
    """``wgrad_kernel``'s :class:`WgradPlan`: one block per entry (a live
    tile) of each of ``windows`` windows of ``B`` batches, a window's
    batches split over ``split`` blocks of a cluster until the grid fills
    the card once, and staged ``sb`` batches (at most 32 columns, at least
    one batch) at a time.  ``smem(sb, split)``, where given, is a block's
    shared memory: a block holds x's rows of all its batches, so a large
    batch splits further until a block fits (``_wgrad_smem``); where no
    split fits (long rows), the reduction is cut over time too: items of
    one batch's ``span_cols`` output columns (:func:`wgrad_span_cols`),
    :func:`wgrad_span_plan` (``per_sm`` of its blocks an SM)."""
    split = max(1, min(MAX_SPLIT, B, -(-sms // max(1, entries * windows))))

    def stage(split):
        return max(1, min(-(-B // split), WGRAD_STAGE_COLS // T_out))

    while smem is not None and split < min(MAX_SPLIT, B) and smem(stage(split), split) > MAX_SMEM:
        split += 1
    if smem is None or smem(stage(split), split) <= MAX_SMEM:
        return WgradPlan(stage(split), split, 0)
    return wgrad_span_plan(B, T_out, entries, sms, windows, span_cols, 1, per_sm)


def _wgrad_tiles_layout(K: int, stride: int, nb: int, T_in: int, T_out: int, t_ld: int,
                        entries: int, esz: int = 4) -> dict:
    """A block of the tile kernel (``wgrad_tiles_layout`` in the kernel's
    source) for windows of ``nb`` batches, in elements of ``esz`` bytes:
    ``R``, ``Lh``, ``rsx`` (x: a batch's padded columns of a stride phase, a
    phase's, a row's pitch), ``ks`` (k-steps of the window's columns),
    ``gbytes``, ``xbytes``, ``bplane`` (gy's part of the g stage, x's stage,
    a B plane) and the byte offsets ``out`` (two output tiles of 64 rows p x
    8K values), ``zero`` (the zero tile), ``graw``, ``xraw`` (two stages),
    ``xs`` (two padded buffers), ``bt`` (two B tiles), ``lists`` (the
    ``entries`` entries' row tile and chunk, 8 bytes each), ``tab`` (the
    padding's table, 8 bytes a padded column of a batch) and ``total``."""
    a128 = lambda n: -(-n // 128) * 128  # noqa: E731
    R = T_out + -(-K // stride) - 1
    Lh = nb * R
    n = stride * Lh
    rsx = (n + 11) // 16 * 16 + 4 if esz == 4 else (n + 56) // 64 * 64 + 8
    ks = -(-nb * T_out // (8 if esz == 4 else 16))
    L = {"R": R, "Lh": Lh, "rsx": rsx, "ks": ks, "gbytes": nb * ROWS * t_ld * esz,
         "xbytes": nb * 8 * T_in * esz, "bplane": ks * 2048, "out": 128}
    L["zero"] = L["out"] + 2 * a128(ROWS * 8 * K * esz)
    L["graw"] = L["zero"] + a128(WGRAD_TILES_ZERO_ROWS * 8 * K * esz)
    L["xraw"] = L["graw"] + a128(2 * L["gbytes"])
    L["xs"] = L["xraw"] + 2 * a128(L["xbytes"])
    L["bt"] = L["xs"] + a128(2 * 8 * rsx * (8 if esz == 4 else 2))
    L["lists"] = L["bt"] + 2 * (2 if esz == 4 else 1) * L["bplane"]
    L["tab"] = L["lists"] + a128(entries * 8)
    L["total"] = L["tab"] + a128(stride * R * 8)
    return L


def wgrad_tiles_fits(nb: int, T_in: int, K: int, stride: int, padding: int, entries: int,
                     esz: int = 4) -> bool:
    """Whether the tile kernel takes windows of ``nb`` batches' rows of
    ``T_in`` frames over a structure's ``entries`` (``wgrad_row``), in
    elements of ``esz`` bytes: a window's columns (nb x T_out) at most
    ``WGRAD_TILES_COLS``, K at most ``WGRAD_TILES_MAX_K``, at most
    ``WGRAD_TILES_MAX_ENTRIES`` entries, in bf16 T_out even where a window
    has several batches (a register pairs two columns of one batch), its
    block within shared memory."""
    T_out = (T_in + 2 * padding - K) // stride + 1
    t_ld = -(-T_out // (16 // esz)) * (16 // esz)
    return (K <= WGRAD_TILES_MAX_K and nb * T_out <= WGRAD_TILES_COLS
            and entries <= WGRAD_TILES_MAX_ENTRIES and (esz == 4 or nb == 1 or T_out % 2 == 0)
            and _wgrad_tiles_layout(K, stride, nb, T_in, T_out, t_ld, entries,
                                    esz)["total"] <= MAX_SMEM)


def wgrad_tiles_routed(nb: int, T_in: int, K: int, stride: int, padding: int, entries: int,
                       esz: int = 4, windows: Optional[int] = None) -> bool:
    """Whether the wrapper gives a windowed wgrad of ``windows`` windows of
    ``nb`` batches to the tile kernel: several windows (the solve's; one
    window keeps its plan), T_out within ``WGRAD_TILES_T[esz]``, where the
    card timed the tile kernel faster than the whole rows (PERF.md), and a
    shape it takes (:func:`wgrad_tiles_fits`)."""
    T_out = (T_in + 2 * padding - K) // stride + 1
    lo, hi = WGRAD_TILES_T[esz]
    return (windows is not None and windows > 1 and lo <= T_out <= hi
            and wgrad_tiles_fits(nb, T_in, K, stride, padding, entries, esz))


def wgrad_tiles_per_sm(smem: int) -> int:
    """Blocks of the tile kernel an SM holds: two where a block's shared
    memory fits half an SM (its launch bounds keep registers for two), else
    one."""
    return 2 if smem <= MAX_SMEM_PER_SM // 2 - 1024 else 1


def wgrad_tiles_plan(entries: int, windows: int, sms: int, per_sm: int) -> WgradTilesPlan:
    """The tile kernel's :class:`WgradTilesPlan`: one block a unit (a
    window's entry) up to the blocks the card holds at once (``sms`` x
    ``per_sm``), each a contiguous run of units."""
    units = entries * windows
    return WgradTilesPlan(max(1, min(units, sms * per_sm)), units)


def wgrad_tiles_runs(plan: WgradTilesPlan):
    """Each block's units [lo, hi) (``wgrad_tiles_run`` in the kernel's
    source): contiguous runs, their lengths within one of each other."""
    return [(plan.units * b // plan.blocks, plan.units * (b + 1) // plan.blocks)
            for b in range(plan.blocks)]


def _dgrad_tiles_layout(K: int, P: int, cols: int, chunks: int, entries: int,
                        esz: int = 4) -> dict:
    """A block of dgrad's tile kernel (``dgrad_tiles_layout`` in the
    kernel's source) for windows of ``cols`` columns (batches x T_out) of a
    level of ``P`` rows p, ``chunks`` 8-channel chunks and ``entries`` live
    (chunk, row tile) entries, in elements of ``esz`` bytes: ``nt`` (the N
    tile: 8, 16, 32 or 64; 0 past 64), ``zp`` (Z's row pitch in floats),
    ``ks`` (g's k-steps over P), ``wstage``, ``bplane`` (a weight stage, a B
    plane) and the byte offsets ``z`` (8K rows of zp floats), ``lists`` (the
    chunks' starts and their row tiles, 4 bytes each), ``bt`` (the B tile:
    f32 a big and a small plane), ``st`` (the weight stages), ``stages`` (as
    many as fit the block's share: all of an SM's shared memory in f32, half
    in bf16; at most ``DGRAD_TILES_MAX_STAGES``) and ``total``."""
    a128 = lambda n: -(-n // 128) * 128  # noqa: E731
    row_k, kw = 8 * K, 8 if esz == 4 else 16
    nt = next((n for n in (8, 16, 32, 64) if cols <= n), 0)
    zp = (nt + 23) // 32 * 32 + 8
    ks = -(-P // kw)
    L = {"nt": nt, "zp": zp, "ks": ks, "bplane": ks * (nt // 8) * 256,
         "wstage": a128(ROWS * row_k * esz), "z": 128}
    L["lists"] = L["z"] + a128(row_k * zp * 4)
    L["bt"] = L["lists"] + a128((chunks + 1 + entries) * 4)
    L["st"] = L["bt"] + (2 if esz == 4 else 1) * L["bplane"]
    budget = MAX_SMEM if esz == 4 else MAX_SMEM_PER_SM // 2 - 1024
    L["stages"] = min(DGRAD_TILES_MAX_STAGES, max(0, budget - L["st"]) // L["wstage"])
    L["total"] = L["st"] + L["stages"] * L["wstage"]
    return L


def dgrad_tiles_fits(nb: int, T_in: int, K: int, stride: int, padding: int, P: int,
                     chunks: int, entries: int, esz: int = 4) -> bool:
    """Whether dgrad's tile kernel takes windows of ``nb`` batches' rows of
    ``T_in`` frames of a level of ``P`` rows, ``chunks`` 8-channel chunks
    and ``entries`` live (chunk, row tile) entries (``dgrad_chunk_row``), in
    elements of ``esz`` bytes: K at most ``DGRAD_TILES_MAX_K``, stride 1 or
    2, a window's columns (nb x T_out) at most ``DGRAD_TILES_COLS``, two
    weight stages at least beside the block's B and Z tiles."""
    T_out = (T_in + 2 * padding - K) // stride + 1
    if K > DGRAD_TILES_MAX_K or stride > 2 or nb * T_out > DGRAD_TILES_COLS:
        return False
    L = _dgrad_tiles_layout(K, P, nb * T_out, chunks, entries, esz)
    return L["stages"] >= 2 and L["total"] <= MAX_SMEM


def dgrad_tiles_routed(nb: int, T_in: int, K: int, stride: int, padding: int, P: int,
                       chunks: int, entries: int, esz: int = 4,
                       windows: Optional[int] = None) -> bool:
    """Whether the wrapper gives a windowed dgrad of ``windows`` windows of
    ``nb`` batches to the tile kernel: several windows (the solve's; one
    window, and the calls of several batches through one weight, keep their
    plans), T_out within ``DGRAD_TILES_T[esz]``, where the card timed the
    tile kernel faster than the whole rows (PERF.md), and a shape it takes
    (:func:`dgrad_tiles_fits`)."""
    T_out = (T_in + 2 * padding - K) // stride + 1
    lo, hi = DGRAD_TILES_T[esz]
    return (windows is not None and windows > 1 and lo <= T_out <= hi
            and dgrad_tiles_fits(nb, T_in, K, stride, padding, P, chunks, entries, esz))


def dgrad_tiles_per_sm(esz: int) -> int:
    """Blocks of dgrad's tile kernel an SM holds: one in f32 (a block takes
    all of its shared memory for stages), two in bf16 (half each; its
    launch bounds keep registers for two)."""
    return 2 if esz == 2 else 1


def dgrad_tiles_plan(chunks: int, windows: int, sms: int, per_sm: int) -> DgradTilesPlan:
    """dgrad's tile kernel's :class:`DgradTilesPlan`: one block a unit (a
    window's chunk) up to the blocks the card holds at once (``sms`` x
    ``per_sm``)."""
    units = chunks * windows
    return DgradTilesPlan(max(1, min(units, sms * per_sm)), units)


def dgrad_tiles_runs(plan: DgradTilesPlan, chunk_start):
    """Each block's units [lo, hi) (``dgrad_tiles_run`` in the kernel's
    source): unit u = w * chunks + c costs chunk c's live row tiles + 1
    (``chunk_start``: ``dgrad_chunk_start`` as a list), and block b's run
    begins at the first unit whose cost before it reaches b / blocks of the
    whole."""
    chunks = len(chunk_start) - 1
    windows = plan.units // chunks
    per = chunk_start[-1] + chunks
    total = per * windows

    def first(b):
        lo, hi = 0, plan.units
        while lo < hi:
            mid = (lo + hi) // 2
            w, c = divmod(mid, chunks)
            if (w * per + chunk_start[c] + c) * plan.blocks >= total * b:
                hi = mid
            else:
                lo = mid + 1
        return lo

    return [(first(b), first(b + 1)) for b in range(plan.blocks)]


def last_backward_plans() -> dict:
    """The plans that the last dgrad and wgrad launches in this process ran,
    as their launchers recorded them (``hmvae_conv_bwd_last_plan``):
    dgrad's :class:`DgradPlan` fields, its ``spans``, ``smem`` bytes,
    ``stages`` in flight, ``channels`` a block and ``blocks`` (the tile
    kernel's persistent blocks; 0 for the other dgrad kernels); wgrad's
    :class:`WgradPlan` fields, ``smem`` and ``blocks`` (the tile kernel's
    persistent blocks; 0 for the other wgrad kernels)."""
    lib = _bwd_library()[0]
    out = (ctypes.c_int * 14)()
    lib.hmvae_conv_bwd_last_plan(out)
    return {"dgrad": dict(zip(DgradPlan._fields + ("spans", "smem", "stages", "channels",
                                                   "blocks"), out[:9])),
            "wgrad": dict(zip(WgradPlan._fields + ("smem", "blocks"), out[9:]))}


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


def _dgrad(gy, y, weight, s: LevelStructure, T_in: int, windows: Optional[int],
           plan=None):
    """Checks, then one dgrad launch; ``weight`` is (P, C_in, K), or
    (G, P, C_in, K) when ``windows`` is G; ``plan`` (a :class:`DgradPlan` or
    :class:`DgradTilesPlan`) in place of the routed one (a span plan times
    the span kernel at shapes whose rows fit whole, a whole-row plan the
    whole-row kernel at shapes routed to tiles).  Several windows that
    :func:`dgrad_tiles_routed` takes run the tile kernel; the others
    :func:`dgrad_plan`'s kernel."""
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
    esz = gy.element_size()
    gran = 16 // esz  # the kernels bulk-copy rows of gy and y as whole 16-byte granules
    gy, y = _aligned(gy, 2, gran), _aligned(y, 2, gran)
    w = _aligned(weight, weight.dim() - 2, BWD_CHUNK_CHANNELS)
    C, t_ld = w.shape[-2], gy.shape[2]
    dev = gy.device.index
    entries = s.dgrad_chunk_row.numel()
    if plan is None and windows is not None and dgrad_tiles_routed(
            B // G, T_in, K, s.stride, s.padding, P, C // BWD_CHUNK_CHANNELS, entries, esz, G):
        plan = dgrad_tiles_plan(C // BWD_CHUNK_CHANNELS, G, _sm_count(dev),
                                dgrad_tiles_per_sm(esz))
    if isinstance(plan, DgradTilesPlan):
        gx = dgrad_tiles(gy, y, w, s, T_in, G, plan, entry)
        return gx if C == C_in else gx[:, :C_in].contiguous()
    plan = plan or dgrad_plan(
        B // G, T_in, K, s.stride, s.padding, t_ld, s.dgrad_start.numel() - 1,
        s.dgrad_max_live, _sm_count(dev), G,
        (s.dgrad_span_start.numel() - 1, s.dgrad_span_max_live), esz,
        functools.partial(span_clusters, dev, K, s.stride, esz))
    lib, dgrad = _bwd_library()[:2]
    gx = torch.empty((B, C, T_in), dtype=gy.dtype, device=gy.device)
    # spans read the weight laid out in planes (f32: split into TF32), once
    # a call, and walk the live row tiles of groups of channels
    wpk = dgrad_span_pack(s, weight) if plan.span else None
    start, rows = ((s.dgrad_span_start, s.dgrad_span_row) if plan.span else
                   (s.dgrad_start, s.dgrad_row))
    err = _on_device(gy, lambda: dgrad(
        gy.data_ptr(), y.data_ptr(), w.data_ptr(), start.data_ptr(),
        rows.data_ptr(), gx.data_ptr(), None if wpk is None else wpk.data_ptr(),
        B, C, T_in, K, P, T_out, t_ld, s.stride, s.padding, int(s.reflect), s.negative_slope,
        plan.nbb, plan.split, plan.span, G, _DTYPES[gy.dtype], dev,
        torch.cuda.current_stream(gy.device).cuda_stream))
    _build.check(lib, err, entry.__name__)
    entry.launches += 1
    return gx if C == C_in else gx[:, :C_in].contiguous()


def _wgrad(gy, y, x, s: LevelStructure, windows: Optional[int], plan=None):
    """Checks, then one wgrad launch: (P, C_in, K) and (P,), or per window
    (G, P, C_in, K) and (G, P) when ``windows`` is G; ``plan`` (a
    :class:`WgradPlan` or :class:`WgradTilesPlan`) in place of the routed
    one (a span plan times the span kernel at shapes whose rows fit whole, a
    whole-row plan the whole-row kernel at shapes routed to tiles).  Several
    windows that :func:`wgrad_tiles_routed` takes run the tile kernel, which
    writes every element of the gradient; the others :func:`wgrad_plan`'s
    kernel on a cleared gradient."""
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
    esz = gy.element_size()
    gran = 16 // esz
    gy, y = _aligned(gy, 2, gran), _aligned(y, 2, gran)
    x = _aligned(x, 1, BWD_CHUNK_CHANNELS)
    C, t_ld = x.shape[1], gy.shape[2]
    dev = gy.device.index
    entries = s.wgrad_row.numel()
    if plan is None and windows is not None and wgrad_tiles_routed(
            B // G, T_in, K, s.stride, s.padding, entries, esz, G):
        plan = wgrad_tiles_plan(entries, G, _sm_count(dev), wgrad_tiles_per_sm(
            _wgrad_tiles_layout(K, s.stride, B // G, T_in, T_out, t_ld, entries, esz)["total"]))
    if isinstance(plan, WgradTilesPlan):
        return wgrad_tiles(gy, y, x, s, G, plan, entry, windows is None)
    if plan is None:
        cols = wgrad_span_cols(K, s.stride, esz)
        # over windows no items of several batches' rows: the card has
        # timed none (ROADMAP)
        rows = (wgrad_routed_rows(B, T_in, K, s.stride, s.padding, esz, cols)
                if windows is None else int(wgrad_bf16_items(B // G, T_in, K, s.stride,
                                                             s.padding, esz)))
        plan = wgrad_plan(
            B // G, T_out, entries, _sm_count(dev), G,
            lambda sb, split: _wgrad_smem(B // G, T_in, K, T_out, t_ld, s.stride, sb, split,
                                          esz),
            cols, rows, wgrad_items_per_sm(K, s.stride, cols, esz, max(1, rows), T_in, T_out,
                                           t_ld))
    sb, split, span = plan
    lib, wgrad = _bwd_library()[0], _bwd_library()[2]
    gw = torch.zeros((G, P, C, K), dtype=gy.dtype, device=gy.device)
    gb = torch.empty((G, P), dtype=gy.dtype, device=gy.device)
    err = _on_device(gy, lambda: wgrad(
        gy.data_ptr(), y.data_ptr(), x.data_ptr(), s.wgrad_row.data_ptr(),
        s.wgrad_chunk.data_ptr(), gw.data_ptr(), gb.data_ptr(), entries, B, C, T_in, K, P,
        T_out, t_ld, s.stride, s.padding, int(s.reflect), s.negative_slope, sb, split, span, G,
        _DTYPES[gy.dtype], dev, torch.cuda.current_stream(gy.device).cuda_stream))
    _build.check(lib, err, entry.__name__)
    entry.launches += 1
    if C != C_in:
        gw = gw[:, :, :C_in].contiguous()
    return (gw[0], gb[0]) if windows is None else (gw, gb)


def wgrad_tiles(gy, y, x, s: LevelStructure, G: int, plan: WgradTilesPlan, entry,
                one: bool):
    """One launch of wgrad's tile kernel, for :func:`_wgrad` (after its
    checks; gy, y and x aligned) and counted in ``entry.launches`` and its
    own ``launches``: G windows' gradients (the first alone where ``one``)
    allocated uncleared, every element written by the kernel."""
    B, P, T_out = gy.shape
    K, C_in, T_in = s.kernel_size, s.in_channels, x.shape[2]
    C, t_ld, dev = x.shape[1], gy.shape[2], gy.device.index
    if plan.units != s.wgrad_row.numel() * G:
        raise ValueError(f"{plan} does not cover {s.wgrad_row.numel()} entries of {G} windows")
    lib, tiles = _bwd_library()[0], _bwd_library()[4]
    gw = torch.empty((G, P, C, K), dtype=gy.dtype, device=gy.device)
    gb = torch.empty((G, P), dtype=gy.dtype, device=gy.device)
    err = _on_device(gy, lambda: tiles(
        gy.data_ptr(), y.data_ptr(), x.data_ptr(), s.wgrad_row.data_ptr(),
        s.wgrad_chunk.data_ptr(), gw.data_ptr(), gb.data_ptr(), s.wgrad_row.numel(), B, C, T_in,
        K, P, T_out, t_ld, s.stride, s.padding, int(s.reflect), s.negative_slope, plan.blocks, G,
        _DTYPES[gy.dtype], dev, torch.cuda.current_stream(gy.device).cuda_stream))
    _build.check(lib, err, entry.__name__)
    entry.launches += 1
    wgrad_tiles.launches += 1
    if C != C_in:
        gw = gw[:, :, :C_in].contiguous()
    return (gw[0], gb[0]) if one else (gw, gb)


wgrad_tiles.launches = 0


def dgrad_tiles(gy, y, w, s: LevelStructure, T_in: int, G: int, plan: DgradTilesPlan, entry):
    """One launch of dgrad's tile kernel, for :func:`_dgrad` (after its
    checks; gy and y aligned, the weight ``w`` (G, P, C, K) with C a multiple
    of 8) and counted in ``entry.launches`` and its own ``launches``: the G
    windows' input gradients (B, C, T_in) allocated uncleared, every element
    written by the kernel."""
    B, P, T_out = gy.shape
    C, t_ld, dev = w.shape[-2], gy.shape[2], gy.device.index
    nch = C // BWD_CHUNK_CHANNELS
    if plan.units != G * nch:
        raise ValueError(f"{plan} does not cover {nch} chunks of {G} windows")
    if not dgrad_tiles_fits(B // G, T_in, s.kernel_size, s.stride, s.padding, P, nch,
                            s.dgrad_chunk_row.numel(), gy.element_size()):
        raise ValueError(f"dgrad's tile kernel does not take windows of {B // G} batches of "
                         f"{T_in} frames at K={s.kernel_size}, stride={s.stride}, P={P}")
    lib, tiles = _bwd_library()[0], _bwd_library()[5]
    gx = torch.empty((B, C, T_in), dtype=gy.dtype, device=gy.device)
    rows = s.dgrad_chunk_row
    err = _on_device(gy, lambda: tiles(
        gy.data_ptr(), y.data_ptr(), w.data_ptr(), s.dgrad_chunk_start.data_ptr(),
        rows.data_ptr() if rows.numel() else None, gx.data_ptr(), rows.numel(), B, C, T_in,
        s.kernel_size, P, T_out, t_ld, s.stride, s.padding, int(s.reflect), s.negative_slope,
        plan.blocks, G, _DTYPES[gy.dtype], dev, torch.cuda.current_stream(gy.device).cuda_stream))
    _build.check(lib, err, entry.__name__)
    entry.launches += 1
    dgrad_tiles.launches += 1
    return gx


dgrad_tiles.launches = 0


def fused_conv_pool_dgrad(gy: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                          structure: LevelStructure, T_in: int) -> torch.Tensor:
    """The input gradient (B, C_in, T_in) of a folded level, from the output
    gradient ``gy`` and output ``y`` (B, P, T_out) and the folded weight
    (P, C_in, K), in gy's dtype.  One kernel launch on CUDA, f32 or bf16
    (where the plan runs the span kernel, after the launch that lays its
    weight out: :func:`dgrad_span_pack`), fixed-order sums (the same bits
    every run); the plain version on the CPU."""
    s = structure
    if gy.device.type == "cpu":
        return fused_conv_pool_dgrad_reference(gy, y, weight, T_in, s.stride, s.padding,
                                               _mode_of(s), s.negative_slope)
    return _dgrad(gy, y, weight, s, T_in, None)


def fused_conv_pool_wgrad(gy: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                          structure: LevelStructure):
    """The folded weight's gradient (P, C_in, K), zero outside the live
    tiles, and the bias gradient (P,), from ``gy`` and ``y`` (B, P, T_out)
    and the input x (B, C_in, T_in), in gy's dtype.  One kernel launch on
    CUDA (f32 or bf16), fixed-order sums (the same bits every run); the
    plain version on the CPU."""
    s = structure
    if gy.device.type == "cpu":
        return fused_conv_pool_wgrad_reference(gy, y, x, s.kernel_size, s.stride, s.padding,
                                               _mode_of(s), s.negative_slope, s.live_elements())
    return _wgrad(gy, y, x, s, None)


def fused_conv_pool_dgrad_windowed(gy: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                                   structure: LevelStructure, T_in: int) -> torch.Tensor:
    """:func:`fused_conv_pool_dgrad` of G windows: gy, y (G*n, P, T_out),
    folded weights (G, P, C_in, K), window g's batches through weight g.
    One kernel launch on CUDA, f32 or bf16, as the one-window entry (at the
    solve's shapes, several windows of short rows, the tile kernel:
    :func:`dgrad_tiles_routed`)."""
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
    kernel launch on CUDA, f32 or bf16, as the one-window entry."""
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
    the wgrad kernel, in the structure's dtype (f32 or bf16), so that the
    gradients come back in the dtypes of x, the
    weight and the bias.  The weight's entries outside the live tiles must be
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
    in the structure's dtype (f32 or bf16), window g's n batches through
    weight g.

    On CUDA the forward repacks the G weights (:func:`repack`) and launches
    :func:`fused_conv_pool_windowed`; the backward launches
    :func:`fused_conv_pool_dgrad_windowed` (only when x needs a gradient)
    and :func:`fused_conv_pool_wgrad_windowed` (one gradient per window),
    in the structure's dtype: a solver's clone leaves (f32 or bf16) reach
    it through the fold's cast to the compute dtype, whose backward returns
    each leaf its gradient in its own dtype.  As :class:`FusedConvPoolFn`
    otherwise.
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
