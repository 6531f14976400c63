"""Where a launch of one of the port's kernels spends its time, from inside
the kernel (run from the repo root on a GPU):

    python3 kernel_trace.py [--kernel fwd|dgrad|wgrad|wgrad_span|dgrad_span|wgrad_tiles
                             |dgrad_tiles]
                            [--variant base|nobuild|nomma|noxb] [--levels enc0,dec0]
                            [--batch N | --rows BxT[,BxT] | --windows G]
                            [--dtype float32|bfloat16]
                            [--source FILE]

Builds a copy of the kernel's source (``hm_vae_torch/csrc/fused_conv_pool.cu``
for ``fwd``, ``fused_conv_pool_bwd.cu`` for ``dgrad`` and ``wgrad``) with
``%globaltimer`` stamps taken by thread 0 of every block (into
``build/kernel_trace/``), runs each chosen level of the len-64 model once and
prints one JSON line per level: the device time of a launch (20 launches in a
CUDA graph), the kernel's span, and each block's mean phases: prologue (start
to the first stage), per stage (a forward chunk, a backward column or row
tile) the wait for its copies, the staging (im2col build), the product, and
the epilogue (its reduction, then the stores).  The forward runs at batch 8
and 237 in bf16 and f32; the backward at batch 8 in f32, on the operands
``chip_smoke.py`` gives it (``--batch`` and ``--dtype`` choose another batch
and the element type of a backward kernel: the production batch of 64, bf16
as under ``compute_dtype: bfloat16``).  ``--kernel dgrad`` and ``wgrad``
trace the whole-row kernels (``dgrad_kernel``, ``wgrad_kernel``) under their
whole-row plans, also at shapes that the wrapper routes to the span kernels.

``--rows BxT[,BxT]`` runs any backward kernel at the trajectory model's four
K-31 levels (C_in 72 / 84 / 108 / 168, stride 1, padding 15) at batch B and
T frames a row instead: training's ``8x128``, the solve's trajectory term
``10x64``; each kernel under its own plan (``dgrad_span`` and
``wgrad_span``: ``dgrad_span_plan``, its split counted in stages as the
wrapper plans these rows, ``wgrad_span_plan``), whether or not the wrapper
routes the shape to it, each row with its error against the plain version.
A ``--source`` whose span kernel splits a group's row tiles over a
cluster's ranks (``ROW_TILE_SPLIT``), or whose bf16 item kernel takes one
block an SM at K 31 (``ITEMS_ONE_BF16_K31``), is planned as it was then:
the split counted in row tiles, one item block an SM.

``--variant nobuild`` skips the forward's im2col build and ``nomma`` its
wgmma; for ``--kernel wgrad``, ``nomma`` skips its products and ``noxb``
takes x's B fragments as constants in place of their shared-memory loads;
for ``--kernel wgrad_span``, ``nomma`` skips its products and ``nobuild``
the B tile's build of every chunk but the first; for ``--kernel
wgrad_tiles``, ``nodrain`` skips the storing thread's wait for the last
store to read its output tile, ``nostore`` the output tile's store,
``nowrite`` the output tile's writes, ``nb3`` keeps three output tiles
(each store a unit longer to read its tile) and ``lb3`` plans three blocks
an SM (registers capped for three).  Their outputs are wrong (but nb3's and
lb3's), their times say what the skipped phase costs.

``--kernel wgrad_span`` traces the wgrad kernel over long rows
(``wgrad_span_kernel``) at the trajectory model's four K-31 levels at batch
8, T 1,024 and batch 1, T 7,200: per block the prologue (to the first item
staged), then summed over its chunks of 32 columns (an item's chunks, or
the whole item where the source stages items of 64 columns alone) the wait
for an item's copies, the build (x's window padded and split, g's
fragments), the products, and the epilogue, with the means per item.
``--source FILE`` traces that copy of ``fused_conv_pool_bwd.cu`` instead
(``git show <commit>:hm_vae_torch/csrc/fused_conv_pool_bwd.cu``): a source
whose span kernel stages items of 64 output columns without bulk copies
runs under that design's plan.  With ``--batch N`` it traces the item
kernel at the len-64 model's levels at batch N instead, under its own plan
(``wgrad_span_plan``: items of several batches' whole rows,
``wgrad_span_rows``, where the source has them), in ``--dtype``.

``--windows G`` traces the windowed wgrad at the test-time solve's four
decoder levels (K 15, T 8-64), G windows of one batch each, in ``--dtype``:
``--kernel wgrad`` the whole-row kernel under its whole-row plan (one block
a live tile and window), with per block its one stage's wait, build and
products and the epilogue, and the launch's waves (the blocks that started
before the first block ended ran at once); ``--kernel wgrad_tiles`` the
tile kernel under its plan, per block the prologue, then summed over its
units the waits for their copies, the builds (B tiles and x), the products
and the store, and the epilogue (the stores' completion), with the means
per unit.  ``--kernel dgrad`` traces the windowed dgrad's whole-row kernel
there under its whole-row plan (one block a pair of chunks and window:
per block its first stages' waits, builds and products, its epilogue, and
the launch's waves), ``--kernel dgrad_tiles`` the tile kernel under its
plan (per block the prologue, then summed over its (window, chunk) units
the waits for their weight tiles, g's builds, the products, the Z tile's
writes and the shift-add with the stores of gx, with the means per unit).

``--kernel dgrad_span`` traces the dgrad kernel over long rows
(``dgrad_span_kernel``) at the trajectory model's four K-31 levels at batch
8, T 1,024 and batch 1, T 7,200 and at the len-64 model's stride-2 level
enc1 at batch 8, T 1,024: per block the prologue, then summed over its
stages (k-steps of 8 rows p) the consumers' wait for a built stage and
their products (warp 0), the splitters' wait for the stage's copies and
their g build (warp 17), the producer's wait for a released stage (warp 16),
and the epilogue (the cluster's sum, the fold and the stores), with the
means per stage.  ``--source FILE`` with a source from before that kernel
(whose spans ran ``dgrad_kernel<true>`` and ``dgrad_fold_kernel``) traces
its span mode under its own plan, with ``--kernel dgrad``'s stamps.
With ``--batch N`` it traces the span kernel at the len-64 model's levels at
batch N instead, under its own plan (``dgrad_span_plan``), in ``--dtype``.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import hashlib
import json
import os
import subprocess

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "kernel_trace")
SLOTS, BLOCKS = 32, 8192
STAMP = ("if (threadIdx.x == 0) g_trace[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x "
         "+ blockIdx.x) % {B} * {S} + ({{slot}})] = {{value}};").format(B=BLOCKS, S=SLOTS)
SOURCES = {"fwd": "fused_conv_pool", "dgrad": "fused_conv_pool_bwd",
           "wgrad": "fused_conv_pool_bwd", "wgrad_span": "fused_conv_pool_bwd",
           "dgrad_span": "fused_conv_pool_bwd", "wgrad_tiles": "fused_conv_pool_bwd",
           "dgrad_tiles": "fused_conv_pool_bwd"}
# the span mode before dgrad_span_kernel: dgrad_kernel<true>, then the fold
FOLD_KERNEL = "__global__ void dgrad_fold_kernel("
# the span kernel that stages items of 64 output columns alone, read from
# device memory without bulk copies (its layout's signature)
ITEMS64 = "  const WgradSpanLayout L = wgrad_span_layout(K, stride);\n"
# a span kernel whose cluster ranks take interleaved live row tiles (before
# the contiguous runs of stages), planned over row tiles
ROW_TILE_SPLIT = "  auto entry = [&](int j) { return first + rank + j * split; };\n"
# an item kernel whose bf16 form takes two blocks an SM only at one m64 tile
# a warpgroup (K <= 15)
ITEMS_ONE_BF16_K31 = "__launch_bounds__(kThreads, sizeof(T) == 2 && NT == 1 ? 2 : 1)"
# the item kernel's layout line: items of several batches' rows in f32 and
# bf16, or (an older source) items of one batch's columns in f32
SPAN_LAYOUTS = ("  const WgradSpanLayout L =\n      wgrad_span_layout(K, stride, span, sizeof(T), nbb, "
                "T_in, T_out, t_ld);\n",
                "  const WgradSpanLayout L = wgrad_span_layout(K, stride, span);\n")


def stamp(slot, value="gtime()", thread=0):
    return STAMP.replace("threadIdx.x == 0", f"threadIdx.x == {thread}").format(
        slot=slot, value=value)


def _fwd_patches(variant):
    """0 start, 1 before the chunk loop, 2+3i after chunk i's copies
    arrived, 3+3i after its im2col, 4+3i after its wgmma (i < 4), 20 after
    the loop, 21 and 22 after the epilogue's cluster syncs (or 21 = 22 = the
    end without a split), 31 the block's chunks."""
    wait = "    mbar_wait(smem_addr(bars + stage), (i / Tr::kStages) & 1);\n"
    built = "    __syncthreads();  // the im2col tile is complete\n"
    summed = "    for (int r = 0; r < 16; ++r) sum[r] += acc[r];\n  }\n"
    first = "  cluster.sync();  // every block's partial tile is in its shared memory\n"
    last = "  cluster.sync();  // no block leaves while another reads its partial tile\n"
    patches = [
        ("  const int tid = threadIdx.x;\n",
         "  const int tid = threadIdx.x;\n  " + stamp(0) + "\n"),
        ("  for (int i = 0; i < n_mine; ++i) {\n",
         f"  {stamp(1)}\n  {stamp(31, 'n_mine')}\n  for (int i = 0; i < n_mine; ++i) {{\n"),
        (wait, wait + "    if (i < 4) { " + stamp("2 + 3 * i") + " }\n"),
        (built, built + "    if (i < 4) { " + stamp("3 + 3 * i") + " }\n"),
        (summed, summed[:-4] + "\n    if (i < 4) { " + stamp("4 + 3 * i") + " }\n  }\n  "
         + stamp(20) + "\n"),
        ("    return;\n  }\n", "    " + stamp(21) + "\n    " + stamp(22) + "\n    return;\n  }\n"),
        (first, first + "  " + stamp(21) + "\n"),
        (last, last + "  " + stamp(22) + "\n"),
    ]
    if variant == "nobuild":
        patches.append(("    for (int k = kp; k < nk; k += 2) {",
                        "    for (int k = kp; k < 0; k += 2) {"))
    elif variant == "nomma":
        patches.append(("    for (int k = 0; k < nk; ++k) {\n      const uint32_t off",
                        "    for (int k = 0; k < 0; ++k) {\n      const uint32_t off"))
    return patches


def _dgrad_patches():
    """The same slots over the halves of a block's live row tiles (stage i):
    2+3i after the stage's gy and y arrived, 3+3i after g is split and
    padded and the weight rows arrived, 4+3i after the products; 21 after the partial gxpad is written
    (cluster sync), 22 after the cluster's sum, the reflect fold and the
    stores."""
    return [
        ("  const int c0 = blockIdx.x * kDC;\n",
         "  const int c0 = blockIdx.x * kDC;\n  " + stamp(0) + "\n"),
        ("  for (int i = 0; i < n_mine; ++i) {\n",
         f"  {stamp(1)}\n  {stamp(31, 'n_mine')}\n  for (int i = 0; i < n_mine; ++i) {{\n"),
        ("    mbar_wait(smem_addr(bars + kStages), i & 1);\n",
         "    mbar_wait(smem_addr(bars + kStages), i & 1);\n    if (i < 4) { "
         + stamp("2 + 3 * i") + " }\n"),
        ("    __syncthreads();  // g and the weight rows are staged\n",
         "    __syncthreads();  // g and the weight rows are staged\n    if (i < 4) { "
         + stamp("3 + 3 * i") + " }\n"),
        ("    __syncthreads();  // every warp is done with this stage's weight rows and g2\n",
         "    __syncthreads();  // every warp is done with this stage's weight rows and g2\n"
         "    if (i < 4) { " + stamp("4 + 3 * i") + " }\n"),
        ("  // gxpad of the block's columns -> out_s",
         "  " + stamp(20) + "\n  // gxpad of the block's columns -> out_s"),
        ("    __syncthreads();\n  {\n    const float* part[kMaxSplit];\n",
         "    __syncthreads();\n  " + stamp(21) + "\n  {\n    const float* part[kMaxSplit];\n"),
        ("  if (split > 1) cluster.sync();  // no block leaves while another reads its partial gxpad\n",
         "  if (split > 1) cluster.sync();  // no block leaves while another reads its partial "
         "gxpad\n  " + stamp(22) + "\n"),
    ]


def _wgrad_patches():
    """Over a block's stages of batches: 1 after x is staged (padded and
    split), 2+3i after stage i's bulk copies arrived, 3+3i after g is
    written in fragment order, 4+3i after the products; 21 after the
    partial tile is written (cluster sync), 22 after the cluster's sum and
    the stores."""
    summed = ("        wgrad_kstep<NQ>(sum, xp, gf, xb, koff, ks, K, warp, lane);\n      }\n"
              "    }\n  }\n")
    layout = ("  const WgradLayout L = wgrad_layout(B, T_in, K, T_out, t_ld, stride, sb, split, "
              "sizeof(T));\n")
    return [
        (layout, layout + "  " + stamp(0) + "\n"),
        ("  for (int i = 0; i < n_st; ++i) {\n",
         f"  {stamp(1)}\n  {stamp(31, 'n_st')}\n  for (int i = 0; i < n_st; ++i) {{\n"),
        ("    mbar_wait(smem_addr(bars + 1 + slot), (i / L.slots) & 1);\n",
         "    mbar_wait(smem_addr(bars + 1 + slot), (i / L.slots) & 1);\n    if (i < 4) { "
         + stamp("2 + 3 * i") + " }\n"),
        ("    __syncthreads();  // the fragments are staged; the stage's copies are read\n",
         "    __syncthreads();  // the fragments are staged; the stage's copies are read\n"
         "    if (i < 4) { " + stamp("3 + 3 * i") + " }\n"),
        (summed, summed[:-4] + "    if (i < 4) { " + stamp("4 + 3 * i") + " }\n  }\n  "
         + stamp(20) + "\n"),
        ("    __syncthreads();\n  const float* part[kMaxSplit];\n",
         "    __syncthreads();\n  " + stamp(21) + "\n  const float* part[kMaxSplit];\n"),
        ("  if (split > 1) cluster.sync();  // no block leaves while another reads its partial tile\n",
         "  if (split > 1) cluster.sync();  // no block leaves while another reads its partial tile\n  "
         + stamp(22) + "\n"),
    ]


_EPILOGUE = [  # wgrad_store, shared by both wgrad kernels: 21 and 22 as in _wgrad_patches
    ("    __syncthreads();\n  const float* part[kMaxSplit];\n",
     "    __syncthreads();\n  " + stamp(21) + "\n  const float* part[kMaxSplit];\n"),
    ("  if (split > 1) cluster.sync();  // no block leaves while another reads its partial tile\n",
     "  if (split > 1) cluster.sync();  // no block leaves while another reads its partial tile\n  "
     + stamp(22) + "\n"),
]
_SPAN_SUMS = ("  " + stamp(20) + "\n  " + stamp(2, "tr_w") + "\n  " + stamp(3, "tr_b") + "\n  "
              + stamp(4, "tr_m") + "\n  " + stamp(30, "tr_n") + "\n")


def _wgrad_span_patches(src):
    """wgrad_span_kernel: 0 start, 1 after the prologue (the first item
    staged), 31 the block's items; summed over its chunks by thread 0 (ns):
    2 the waits for an item's copies, 3 the builds (the next item's x, the
    next chunk's B tile), 4 the products: their issue (the A registers'
    loads and the waits between k-steps) and the wait for the last k-step
    with the f32 sums, to the chunk's barrier, 5 the copies it issues after
    the barrier (warp 0's refills); 30 the chunks; 20 after the loop; 21, 22
    the epilogue."""
    decl = "unsigned long long tr_w = 0, tr_b = 0, tr_m = 0, tr_r = 0, tr_n = 0, tr_t = 0;"
    lap = "{ const unsigned long long t = gtime(); tr_%s += t - tr_t; tr_t = t; }"
    synced = "    __syncthreads();  // chunk c and its x are read; chunk c + 1 is staged\n"
    refill = "    if (next) refill(ni, nj);\n"
    sums = ("  " + stamp(20) + "\n  " + stamp(2, "tr_w") + "\n  " + stamp(3, "tr_b") + "\n  "
            + stamp(4, "tr_m") + "\n  " + stamp(5, "tr_r") + "\n  " + stamp(30, "tr_n") + "\n")
    layout = next(a for a in SPAN_LAYOUTS if a in src)
    head = [(layout, layout + "  " + stamp(0) + "\n  " + decl + "\n"),
            ("  int nc = n_items > 0 ? chunks(0) : 0;\n",
             f"  {stamp(1)}\n  {stamp(31, 'n_items')}\n  int nc = n_items > 0 ? chunks(0) : 0;\n")]
    tail = [(synced, synced + "    " + lap % "m" + "\n"),
            (refill, refill + "    " + lap % "r" + "\n")] + _EPILOGUE
    wait = "      mbar_wait(smem_addr(bars + ni % kSpanStages), (ni / kSpanStages) & 1);\n"
    issued = "    issue_products(i, j, c & 1);\n"
    built = ("    fence_async();  // the B tile's writes before the products read it\n"
             "    finish_products();\n")
    # the loop's first and last lines (an older source carries the next
    # item's chunk count through the loop)
    first, last = (("    int ni = i, nj = j + 1;\n", "    i = ni, j = nj;\n  }\n")
                   if "    int ni = i, nj = j + 1;\n" in src else
                   ("    int ni = i, nj = j + 1, nnc = nc;\n", "    i = ni, j = nj, nc = nnc;\n  }\n"))
    return head + [
        (first, "    tr_t = gtime();\n    ++tr_n;\n" + first),
        (issued, issued + "    " + lap % "m" + "\n"),
        (wait, wait + "      " + lap % "w" + "\n"),
        (built, "    " + lap % "b" + "\n" + built),
        (last, last + sums),
    ] + tail


def _wgrad_items64_patches():
    """The span kernel that stages items of 64 columns alone (no copies in
    flight): the slots of :func:`_wgrad_span_patches`, an item a chunk; its
    build reads x and g from device memory, so its wait is 0."""
    decl = "unsigned long long tr_w = 0, tr_b = 0, tr_m = 0, tr_n = 0, tr_t = 0;"
    products = ("        xb[h] = gid * L.rsx + (n < nt ? n : 0);  // past the span: column 0, g is "
                "zero\n      }\n      wgrad_kstep<NQ>(sum, xp, gf, xb, koff, ks, K, warp, lane);\n"
                "    }\n  }\n")
    staged = "    __syncthreads();  // x and the fragments are staged\n"
    return [
        (ITEMS64, ITEMS64 + "  " + stamp(0) + "\n  " + decl + "\n"),
        ("  for (int item = it_lo; item < it_hi; ++item) {\n",
         f"  {stamp(1)}\n  {stamp(31, 'it_hi - it_lo')}\n"
         "  for (int item = it_lo; item < it_hi; ++item) {\n    tr_t = gtime();\n    ++tr_n;\n"),
        (staged, staged + "    { const unsigned long long t = gtime(); tr_b += t - tr_t; tr_t = t; }\n"),
        (products, products[:-4] + "    tr_m += gtime() - tr_t;\n  }\n" + _SPAN_SUMS),
    ] + _EPILOGUE


def _wgrad_tiles_patches(variant="base"):
    """wgrad_tiles_kernel: 0 start, 10 after the first copies' issue (by
    another thread in bf16), 9 after the prologue's first barrier (the
    lists, the table and the zero tile staged), 11 after the first B tile,
    12 after the first x, 1 after the prologue (its barrier and refills),
    31 the block's units; summed over them by thread 0 (ns): 2 the
    waits for the next unit's copies (its row tile's g, its x), 3 the
    builds (the next row tile's B tile, the next unit's x), 4 the products
    (their issue, and the wait for them with the f32 sums), 5 the stores'
    and refills' issue, 6 the output tile's writes, 7 thread 0's wait for
    the last store to read its tile (0 under nodrain), 8 the barrier after
    them; 30 the units; 20 after the loop; 21 = 20 (no reduction); 22 after
    the stores are done."""
    decl = ("unsigned long long tr_w = 0, tr_b = 0, tr_m = 0, tr_s = 0, tr_o = 0, tr_d = 0, "
            "tr_y = 0, tr_n = 0, tr_t = 0;")
    lap = "{ const unsigned long long t = gtime(); tr_%s += t - tr_t; tr_t = t; }"
    layout = ("  const WgradTilesLayout L =\n      wgrad_tiles_layout(K, stride, nb, T_in, T_out, "
              "t_ld, entries, sizeof(T));\n")
    g_wait = "        mbar_wait(smem_addr(bars), g_phase);\n"
    b_built = "        build_b(u_lo + i + 1, gbuf ^ 1);\n"
    x_wait = "      mbar_wait(smem_addr(bars + 1 + ((i + 1) & 1)), ((i + 1) >> 1) & 1);\n"
    x_built = "      build_x(i + 1);\n"
    finished = ("      fence_async();  // the B tile's writes before the products read it\n"
                "      finish();\n")
    last = "    if (new_group) gbuf ^= 1;\n    cur = nx;\n  }\n"
    done = "  if (tid == kStorer || warp == kZeroWarp) bulk_wait_all();\n"
    written = ("            if (m < row_k) ob[p * row_k + m] = sum[r];\n          }\n        }\n"
               "      }\n      fence_async();  // the output tile's writes before the store reads "
               "it\n")
    zeroed = ("    fence_async();  // the zero tile's writes before the stores read it\n  }\n"
              "  __syncthreads();\n")
    issued = "    if (n > 1) issue_x(1, unit_dev(u_lo + 1));\n  }\n"
    b0 = "  build_b(u_lo, 0);\n"
    x0 = "    mbar_wait(smem_addr(bars + 1), 0);\n    build_x(0);\n"
    drained = "    if (tid == kStorer) bulk_wait_read();\n"
    synced = ("    __syncthreads();  // unit i's tile is written; unit i - 1's store has read its "
              "buffer\n")
    sums = "".join(f"  {stamp(slot, value)}\n" for slot, value in (
        (20, "gtime()"), (21, "gtime()"), (2, "tr_w"), (3, "tr_b"), (4, "tr_m"), (5, "tr_s"),
        (6, "tr_o"), (7, "tr_d"), (8, "tr_y"), (30, "tr_n")))
    return [
        (layout, layout + "  " + stamp(0) + "\n  " + decl + "\n"),
        (zeroed, zeroed + "  " + stamp(9) + "\n"),
        (issued, issued + "  " + stamp(10) + "\n"),
        (b0, b0 + "  " + stamp(11) + "\n"),
        (x0, x0 + "  " + stamp(12) + "\n"),
        ("  Unit cur = unit(u_lo);\n",
         f"  {stamp(1)}\n  {stamp(31, 'n')}\n  Unit cur = unit(u_lo);\n"),
        ("    products(i, gbuf);\n",
         "    tr_t = gtime();\n    ++tr_n;\n    products(i, gbuf);\n    " + lap % "m" + "\n"),
        (g_wait, g_wait + "        " + lap % "w" + "\n"),
        (b_built, b_built + "        " + lap % "b" + "\n"),
        (x_wait, x_wait + "      " + lap % "w" + "\n"),
        (x_built, x_built + "      " + lap % "b" + "\n"),
        (finished, finished + "      " + lap % "m" + "\n"),
        (written, written + "      " + lap % "o" + "\n"),
        (synced, synced + "    " + lap % "y" + "\n"),
        (last, "    " + lap % "s" + "\n" + last + sums),
        (done, done + "  " + stamp(22) + "\n"),
    ] + ([] if variant == "nodrain" else [(drained, drained + "    " + lap % "d" + "\n")])


def _dgrad_tiles_patches():
    """dgrad_tiles_kernel: 0 start, 1 after the prologue (the lists staged,
    the block's run found), 31 the block's units; summed over them by
    thread 0 (ns): 2 the waits for a tile's weight stage, 3 g's builds (with
    their two barriers), 4 the products (their issue, the wait for them, the
    f32 sums, the stage's release), 5 the Z tile's writes (with its two
    barriers), 6 the shift-add, the padding's adjoint and the stores of gx;
    30 the units, 29 the tiles; 20 = 21 = 22 after the loop (no reduction,
    the stores are plain)."""
    decl = ("unsigned long long tr_w = 0, tr_g = 0, tr_m = 0, tr_z = 0, tr_e = 0, tr_n = 0, "
            "tr_k = 0, tr_t = 0;")
    lap = "{ const unsigned long long t = gtime(); tr_%s += t - tr_t; tr_t = t; }"
    layout = ("  const DgradTilesLayout L = dgrad_tiles_layout(K, P, ncols, nch, entries, "
              "sizeof(T));\n")
    run = "  if (u_lo >= u_hi) return;\n"
    enter = "    if (w != cur_w) {  // the run enters window w: its g, once\n"
    entered = "      cur_w = w;\n    }\n"
    waited = "      mbar_wait(smem_addr(full + slot), (it / nst) & 1);\n"
    released = "      finish();\n    }\n"
    z_written = "    consumers_sync();  // Z is written\n"
    stored = ("      gx[(size_t(w * nb + bb) * C + c * kCC + cc) * T_in + i] = from_f<T>(v);\n"
              "    }\n  }\n}\n")
    sums = "".join(f"  {stamp(slot, value)}\n" for slot, value in (
        (20, "gtime()"), (21, "gtime()"), (22, "gtime()"), (2, "tr_w"), (3, "tr_g"),
        (4, "tr_m"), (5, "tr_z"), (6, "tr_e"), (30, "tr_n"), (29, "tr_k")))
    return [
        (layout, layout + "  " + stamp(0) + "\n  " + decl + "\n"),
        (run, run + f"  {stamp(1)}\n  {stamp(31, 'u_hi - u_lo')}\n"),
        (enter, "    tr_t = gtime();\n    ++tr_n;\n" + enter),
        (entered, entered + "    " + lap % "g" + "\n"),
        (waited, waited + "      " + lap % "w" + "\n      ++tr_k;\n"),
        (released, released + "      " + lap % "m" + "\n"),
        (z_written, z_written + "    " + lap % "z" + "\n"),
        (stored, stored[:-6] + "    " + lap % "e" + "\n  }\n" + sums + "}\n"),
    ]


def _dgrad_span_patches():
    """dgrad_span_kernel: 0 start, 1 after the prologue, 31 the block's
    stages; summed over them (ns): 2 the consumers' waits for a built stage
    and 5 their products, to the stage's release (thread 0); 3 the
    splitters' waits for the stage's copies and 4 their build (thread 544);
    6 the producer's waits for a released stage (thread 512); 20 after the
    consumers' loop; 21 after the cluster's barrier; 22 after the fold and
    the stores."""
    lap = "{ const unsigned long long t = gtime(); tr_%s += t - tr_t; tr_t = t; }"
    ready = "      mbar_wait(smem_addr(ready + i % S), (i / S) & 1);\n"
    released = "      if (lane == 0) mbar_arrive(smem_addr(empty + i % S));\n"
    full = "      mbar_wait(smem_addr(full + i % S), (i / S) & 1);\n"
    built = "      mbar_arrive(smem_addr(ready + i % S));\n"
    empty = "      if (i >= S) mbar_wait(smem_addr(empty + i % S), (i / S - 1) & 1);\n"
    return [
        ("  const int S = L.stages;\n",
         "  const int S = L.stages;\n  " + stamp(0) + "\n"
         "  unsigned long long tr_a = 0, tr_b = 0, tr_t = 0;\n"),
        ("  if (warp == kSpanProducer) {\n",
         f"  {stamp(1)}\n  {stamp(31, 'n_stages')}\n  if (warp == kSpanProducer) {{\n"),
        (empty, "      tr_t = gtime();\n" + empty + "      " + lap % "a" + "\n"),
        ("  } else if (warp > kSpanProducer) {\n",
         "    " + stamp(6, "tr_a", 512) + "\n  } else if (warp > kSpanProducer) {\n"),
        (full, "      tr_t = gtime();\n" + full + "      " + lap % "a" + "\n"),
        (built, built + "      " + lap % "b" + "\n"),
        ("  // The consumers' M tiles:",
         "  " + stamp(3, "tr_a", 544) + "\n  " + stamp(4, "tr_b", 544) + "\n"
         "  // The consumers' M tiles:"),
        (ready, "      tr_t = gtime();\n" + ready + "      " + lap % "a" + "\n"),
        (released, released + "      " + lap % "b" + "\n"),
        ("  __syncthreads();  // every stage is consumed: the slots take gxpad\n",
         "  " + stamp(20) + "\n  " + stamp(2, "tr_a") + "\n  " + stamp(5, "tr_b") + "\n"
         "  __syncthreads();  // every stage is consumed: the slots take gxpad\n"),
        ("  {\n    const float* parts[kMaxSplit];\n",
         "  " + stamp(21) + "\n  {\n    const float* parts[kMaxSplit];\n"),
        ("  if (split > 1) cluster.sync();  // no block leaves while another reads its span's "
         "gxpad\n",
         "  if (split > 1) cluster.sync();  // no block leaves while another reads its span's "
         "gxpad\n  " + stamp(22) + "\n"),
    ]


# the whole-row wgrad's variants: its products skipped (nomma), or x's B
# fragments taken as constants in place of their shared-memory loads (noxb);
# every occurrence replaced, in wgrad_kstep and wgrad_kstep_bf16 only
WGRAD_VARIANTS = {
    "nomma": [("if (warp + kWarps * qq <= K) mma_", "if (warp + kWarps * qq < 0) mma_")],
    "noxb": [("const float2 v = q < K ? xp[xb[h] + koff[qq]]",
              "const float2 v = q < K ? make_float2(1.f, 0.f)"),
             ("b[qq][h] = q < K ? pack_bf16(xh[xb[2 * h] + koff[qq]], xh[xb[2 * h + 1] + koff[qq]])",
              "b[qq][h] = q < K ? 0x3F803F80u")],
}


# the item kernel's variants: its products skipped (nomma), or the B tile's
# build of every chunk but the first skipped (nobuild)
WGRAD_SPAN_VARIANTS = {
    "nomma": [("wgmma_rs_tf32(acc[mt],", "if (0) wgmma_rs_tf32(acc[mt],"),
              ("wgmma_rs_bf16(acc[mt],", "if (0) wgmma_rs_bf16(acc[mt],")],
    "nobuild": [("    if (next) {\n      build_g(ni, nj, (c + 1) & 1, 0);",
                 "    if (0) {\n      build_g(ni, nj, (c + 1) & 1, 0);")],
}


# the tile kernel's variants: the wait for the last store to read its
# output tile skipped (nodrain), the output tile's store skipped (nostore),
# three output tiles, each store left a unit longer to read its tile
# (nb3), or registers for three blocks an SM, planned so (lb3)
WGRAD_TILES_VARIANTS = {
    "nodrain": [("    if (tid == kStorer) bulk_wait_read();\n", "")],
    "nostore": [("tid == kStorer && cur.chunk >= 0) {\n      tensor_store3(&gw_map",
                 "tid == kStorer && cur.chunk > C) {\n      tensor_store3(&gw_map")],
    "nowrite": [("      if (cur.chunk >= 0) {\n        const int mw",
                 "      if (cur.chunk > C) {\n        const int mw")],
    "lb3": [("__launch_bounds__(sizeof(T) == 2 ? kThreads + 32 : kThreads, 2)\nwgrad_tiles_kernel",
             "__launch_bounds__(sizeof(T) == 2 ? kThreads + 32 : kThreads, 3)\nwgrad_tiles_kernel")],
    "nb3": [("  L.zero = L.out + 2 * align128(", "  L.zero = L.out + 3 * align128("),
            ("(smem + L.out + (i & 1) * out_tile)", "(smem + L.out + (i % 3) * out_tile)"),
            ("cp.async.bulk.wait_group.read 0;", "cp.async.bulk.wait_group.read 1;")],
}


# dgrad's tile kernel's variants: the gx stores skipped (nostore), the
# shift-add reduced to one Z read an output (noshift), or g's build with no
# load of gy and y (nogload, g all zeros)
DGRAD_TILES_VARIANTS = {
    "nostore": [("        v += column(padding + 2 * (T_in - 1) - i);\n",
                 "        v += column(padding + 2 * (T_in - 1) - i);\n      if (v != 1234.5f) "
                 "continue;\n")],
    "nogload": [("          const bool in = it < items && n < ncols && p0 + q < P;",
                 "          const bool in = false;")],
    "noshift": [("      float v = column(i + padding);",
                 "      float v = zc[i];\n      if (0) v = column(i + padding);")],
}


def patched_source(variant: str = "base", kernel: str = "fwd", source=None) -> str:
    """The kernel's source (or ``source``, a copy of it) with stamps
    (slots: see the patch lists)."""
    src = open(source or os.path.join(ROOT, "hm_vae_torch", "csrc", SOURCES[kernel] + ".cu")).read()
    variants = {"fwd": {"nobuild": [], "nomma": []}, "wgrad": WGRAD_VARIANTS,
                "wgrad_span": WGRAD_SPAN_VARIANTS,
                "wgrad_tiles": WGRAD_TILES_VARIANTS,
                "dgrad_tiles": DGRAD_TILES_VARIANTS}.get(kernel, {})
    if variant != "base" and variant not in variants:
        raise ValueError(f"--variant {variant} is not a variant of --kernel {kernel}")
    for old, new in variants.get(variant, []) if kernel != "fwd" else []:
        if old not in src:
            raise RuntimeError(f"kernel source changed; variant anchor not found: {old!r}")
        src = src.replace(old, new)
    patches = {"fwd": lambda: _fwd_patches(variant), "dgrad": _dgrad_patches,
               "wgrad": _wgrad_patches,
               "wgrad_span": lambda: (_wgrad_items64_patches() if ITEMS64 in src
                                      else _wgrad_span_patches(src)),
               "dgrad_span": lambda: (_dgrad_patches() if FOLD_KERNEL in src
                                      else _dgrad_span_patches()),
               "wgrad_tiles": lambda: _wgrad_tiles_patches(variant),
               "dgrad_tiles": _dgrad_tiles_patches}[kernel]()
    patches.insert(0, ("namespace {\n", "namespace {\n__device__ unsigned long long g_trace[%d];\n"
                       "__device__ __forceinline__ unsigned long long gtime() { unsigned long "
                       'long t; asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t)); '
                       "return t; }\n" % (BLOCKS * SLOTS)))
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"kernel source changed; anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src + (
        '\nextern "C" int hmvae_trace_copy(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n"
        'extern "C" int hmvae_trace_clear() {\n'
        "  static unsigned long long zeros[%d];\n"
        "  return (int)cudaMemcpyToSymbol(g_trace, zeros, sizeof(zeros));\n}\n"
        % (BLOCKS * SLOTS))


def build(variant: str, kernel: str, source=None) -> ctypes.CDLL:
    from hm_vae_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    tag = f"{kernel}_{variant}" + ("_source" if source else "")
    text = patched_source(variant, kernel, source)
    # the library's name carries a hash of the patched source, the headers it
    # includes and the flags; it is renamed into place only once nvcc succeeds
    headers = b"".join(p.read_bytes() for p in sorted(_build.CSRC_DIR.glob("*.h")))
    digest = hashlib.sha256(text.encode() + headers + " ".join(_build.NVCC_FLAGS).encode())
    lib = os.path.join(OUT, f"libtrace_{tag}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        src = os.path.join(OUT, f"{tag}.cu")
        with open(src, "w") as f:
            f.write(text)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                        tmp, src], check=True)
        os.replace(tmp, lib)
    lib = ctypes.CDLL(lib)
    lib.hmvae_trace_copy.argtypes = [ctypes.c_void_p]  # a 64-bit host pointer
    lib.hmvae_error_string.argtypes = [ctypes.c_int]
    lib.hmvae_error_string.restype = ctypes.c_char_p
    return lib


def phases(trace: np.ndarray) -> dict:
    t = trace[trace[:, 0] > 0].astype(np.int64)
    us = lambda a, b, rows=t: float(np.mean(rows[:, b] - rows[:, a]) / 1e3)  # noqa: E731
    out = {"blocks": len(t), "stages_max": int(t[:, 31].max()),
           "span_us": float((t[:, 22].max() - t[:, 0].min()) / 1e3),
           "prologue_us": us(0, 1), "loop_us": us(1, 20), "epilogue_us": us(20, 22),
           "reduce_us": us(20, 21)}
    for i in range(2):
        rows = t[t[:, 31] > i]
        if len(rows):
            out[f"stage{i}"] = {"wait_us": us(1 + 3 * i, 2 + 3 * i, rows),
                                "build_us": us(2 + 3 * i, 3 + 3 * i, rows),
                                "mma_us": us(3 + 3 * i, 4 + 3 * i, rows)}
    return out


def span_phases(trace: np.ndarray) -> dict:
    """Means over a span launch's blocks (slots: :func:`_wgrad_span_patches`),
    and the summed phases per item (refill 0 where the source's items have
    no copies)."""
    t = trace[trace[:, 0] > 0].astype(np.int64)
    us = lambda a, b: float(np.mean(t[:, b] - t[:, a]) / 1e3)  # noqa: E731
    items = max(1, int(t[:, 31].sum()))
    out = {"blocks": len(t), "items_max": int(t[:, 31].max()),
           "chunks_max": int(t[:, 30].max()),
           "span_us": float((t[:, 22].max() - t[:, 0].min()) / 1e3),
           "prologue_us": us(0, 1), "loop_us": us(1, 20), "epilogue_us": us(20, 22),
           "reduce_us": us(20, 21)}
    for slot, what in ((2, "wait"), (3, "build"), (4, "mma"), (5, "refill")):
        out[f"{what}_us"] = float(t[:, slot].mean() / 1e3)
        out[f"{what}_us_per_item"] = float(t[:, slot].sum() / 1e3 / items)
    return out


def dgrad_span_phases(trace: np.ndarray) -> dict:
    """Means over a dgrad span launch's blocks (slots:
    :func:`_dgrad_span_patches`), and the summed phases per stage."""
    t = trace[trace[:, 0] > 0].astype(np.int64)
    us = lambda a, b: float(np.mean(t[:, b] - t[:, a]) / 1e3)  # noqa: E731
    stages = max(1, int(t[:, 31].sum()))
    out = {"blocks": len(t), "stages_max": int(t[:, 31].max()),
           "span_us": float((t[:, 22].max() - t[:, 0].min()) / 1e3),
           "prologue_us": us(0, 1), "loop_us": us(1, 20), "epilogue_us": us(20, 22),
           "reduce_us": us(20, 21)}
    for slot, what in ((2, "ready_wait"), (5, "products"), (3, "copy_wait"), (4, "build"),
                       (6, "slot_wait")):
        out[f"{what}_us"] = float(t[:, slot].mean() / 1e3)
        out[f"{what}_us_per_stage"] = float(t[:, slot].sum() / 1e3 / stages)
    return out


def window_phases(trace: np.ndarray) -> dict:
    """:func:`phases` of a windowed whole-row wgrad launch (one stage a
    block at one batch a window), and its waves: the blocks that started
    before the first block ended ran at once, so the launch took about
    blocks / that many waves."""
    t = trace[trace[:, 0] > 0].astype(np.int64)
    resident = int((t[:, 0] < t[:, 22].min()).sum())
    return {**phases(trace), "resident": resident, "waves": len(t) / max(1, resident),
            "block_us": float(np.mean(t[:, 22] - t[:, 0]) / 1e3)}


def tiles_phases(trace: np.ndarray) -> dict:
    """Means over a tile-kernel launch's blocks (slots:
    :func:`_wgrad_tiles_patches`), the summed phases per unit, and its
    waves as :func:`window_phases` counts them."""
    t = trace[trace[:, 0] > 0].astype(np.int64)
    us = lambda a, b: float(np.mean(t[:, b] - t[:, a]) / 1e3)  # noqa: E731
    units = max(1, int(t[:, 30].sum()))
    resident = int((t[:, 0] < t[:, 22].min()).sum())
    out = {"blocks": len(t), "units_max": int(t[:, 31].max()),
           "span_us": float((t[:, 22].max() - t[:, 0].min()) / 1e3),
           "prologue_us": us(0, 1), "loop_us": us(1, 20), "epilogue_us": us(20, 22),
           "resident": resident, "waves": len(t) / max(1, resident),
           "block_us": us(0, 22), "prologue_parts_us": {
               "issue": us(0, 10), "init": us(10, 9), "g_and_b": us(9, 11),
               "x": us(11, 12), "barrier_refill": us(12, 1)}}
    for slot, what in ((2, "wait"), (3, "build"), (4, "products"), (6, "tile_write"),
                       (7, "store_drain"), (8, "barrier"), (5, "store_issue")):
        out[f"{what}_us"] = float(t[:, slot].mean() / 1e3)
        out[f"{what}_us_per_unit"] = float(t[:, slot].sum() / 1e3 / units)
    return out


def dgrad_tiles_phases(trace: np.ndarray) -> dict:
    """Means over a dgrad tile-kernel launch's blocks that ran units (slots:
    :func:`_dgrad_tiles_patches`), the summed phases per unit, and its waves
    as :func:`window_phases` counts them."""
    t = trace[trace[:, 22] > 0].astype(np.int64)
    us = lambda a, b: float(np.mean(t[:, b] - t[:, a]) / 1e3)  # noqa: E731
    units = max(1, int(t[:, 30].sum()))
    resident = int((t[:, 0] < t[:, 22].min()).sum())
    out = {"blocks": len(t), "units_max": int(t[:, 31].max()),
           "tiles_max": int(t[:, 29].max()), "tiles_per_unit": float(t[:, 29].sum()) / units,
           "span_us": float((t[:, 22].max() - t[:, 0].min()) / 1e3),
           "prologue_us": us(0, 1), "loop_us": us(1, 20), "resident": resident,
           "waves": len(t) / max(1, resident), "block_us": us(0, 22)}
    for slot, what in ((2, "wait"), (3, "g_build"), (4, "products"), (5, "z_write"),
                       (6, "shift_add_store")):
        out[f"{what}_us"] = float(t[:, slot].mean() / 1e3)
        out[f"{what}_us_per_unit"] = float(t[:, slot].sum() / 1e3 / units)
    return out


def _trace(lib, buf, launch, read=phases) -> dict:
    """Device ms of a launch (CUDA graph), then one stamped launch's phases."""
    import chip_smoke

    graph_ms = chip_smoke.device_ms(launch)
    lib.hmvae_trace_clear()
    launch()
    torch.cuda.synchronize()
    lib.hmvae_trace_copy(buf.ctypes.data)
    return {"graph_us": graph_ms * 1e3, **read(buf.reshape(BLOCKS, SLOTS))}


def _items64_plan(fcp, B, T_out, entries, sms):
    """The plan of the span kernel that stages items of 64 columns: the
    items split over the cluster until the grid fills the card twice."""
    items = B * -(-T_out // 64)
    return fcp.WgradPlan(1, max(1, min(fcp.MAX_SPLIT, items, -(-2 * sms // max(1, entries)))), 64)


def trajectory_cases(gen, shapes):
    """(name, conv, batch, T) of the trajectory model's four K-31 levels at
    each (batch, T) of ``shapes`` (seeded random weights, on the card)."""
    import chip_smoke
    from hm_vae_torch.models.trajectory import TrajectoryModel
    from hm_vae_torch.utils.config import load_config

    tcfg = load_config(chip_smoke.TRAJ_CONFIG)
    tmodel = TrajectoryModel(tcfg.model, tcfg.optim.init, generator=gen).to("cuda")
    return [(f"traj{i}", getattr(tmodel.encoder, f"conv_{i}"), b, T)
            for b, T in shapes for i in range(4)]


def trace_span(lib, buf, items64: bool, batch=None, dtype=torch.float32, rows=True,
               variant="base", shapes=None, one_bf16_k31=False) -> None:
    """The wgrad item kernel in ``dtype`` at the trajectory model's four
    levels, batch 8, T 1,024 and batch 1, T 7,200, under its plan; or,
    where ``batch`` is given, at the len-64 model's eight levels at that
    batch under the item kernel's plan (``wgrad_span_plan``: items of
    several batches' whole rows, ``wgrad_span_rows``, where ``rows`` and
    the source has them, else of one batch's columns), whether or not
    ``wgrad_plan`` routes the shape there; or, where ``shapes`` is given,
    at the trajectory model's levels at each (batch, T) of it, under the
    same plan (one block an SM at two m64 tiles a warpgroup where
    ``one_bf16_k31``, as a source whose bf16 form took one was planned): one
    JSON line a level, with its error against the plain version."""
    import chip_smoke
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.models.trajectory import TrajectoryModel
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.utils.config import load_config

    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    if shapes:
        cases = trajectory_cases(gen, shapes)
    elif batch is None:
        tcfg = load_config(chip_smoke.TRAJ_CONFIG)
        tmodel = TrajectoryModel(tcfg.model, tcfg.optim.init, generator=gen).to("cuda")
        cases = [(f"traj{i}", getattr(tmodel.encoder, f"conv_{i}"), b, T)
                 for b, T in ((8, 1024), (1, 7200)) for i in range(4)]
    else:
        cfg = load_config(chip_smoke.CONFIG)
        model = HMVAE(cfg.model, cfg.optim.init, generator=gen).to("cuda")
        cases = [(n, c, batch, T) for n, c, T in
                 chip_smoke.level_cases(model, get_structure(cfg.model))]
    sms = fcp._sm_count(torch.cuda.current_device())
    for name, conv, b, T in cases:
        s, wf, bf, x, y, gy = chip_smoke.bwd_inputs(conv, T, gen, b, dtype)
        T_out, entries, esz = y.shape[2], s.wgrad_row.numel(), gy.element_size()
        cols = fcp.wgrad_span_cols(s.kernel_size, s.stride, esz)
        nbb = (fcp.wgrad_span_rows(b, T, s.kernel_size, s.stride, s.padding, esz, cols)
               if (batch is not None or shapes) and rows else 0)
        t_ld = -(-T_out // (16 // esz)) * (16 // esz)
        per_sm = (1 if one_bf16_k31 and (s.kernel_size + 1) * 8 > 128 else
                  fcp.wgrad_items_per_sm(s.kernel_size, s.stride, cols, esz, max(1, nbb), T,
                                         T_out, t_ld))
        plan = (_items64_plan(fcp, b, T_out, entries, sms) if items64 else
                fcp.wgrad_span_plan(b, T_out, entries, sms, 1, cols, max(1, nbb), per_sm))
        launch = lambda: fcp._wgrad(gy, y, x, s, None, plan)  # noqa: E731
        ref = fcp.fused_conv_pool_wgrad_reference(gy, y, x, s.kernel_size, s.stride, s.padding,
                                                  "reflect" if s.reflect else "constant",
                                                  s.negative_slope, s.live_elements())[0]
        err = float((launch()[0].float() - ref.float()).abs().max())
        row = _trace(lib, buf, launch, span_phases)
        print(json.dumps({"kernel": "wgrad_span", "variant": variant,
                          "items": 64 if items64 else plan.span,
                          "level": name, "batch": b, "T": T,
                          "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
                          "max_abs_ref": float(ref.float().abs().max()),
                          "plan": plan._asdict(), **row}), flush=True)


def _parent_span_plan(fcp, B, T_in, K, stride, padding, pairs, max_live, sms):
    """(span, split) of the span mode before dgrad_span_kernel: two 16-column
    tiles a warp where that block fits shared memory, else one; the split
    chosen as ``dgrad_plan`` chooses it."""
    kmax = -(-K // stride)
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731

    def smem(span):
        rs = (kmax - 1 + span // stride + 11) // 16 * 16 + 4
        gl = -(-(kmax - 1 + span // stride + 6) // 4) * 4
        w_ring = a16(2 * 32 * (16 * K + 8) * 4)
        g2_end = 64 + w_ring + a16(2 * 32 * gl * 4) + 32 * rs * 8
        return g2_end if 16 * span * 4 <= w_ring else a16(g2_end) + 16 * span * 4

    span = next(sp for sp in (16 * stride * (8 * t // stride) for t in (2, 1))
                if sp and smem(sp) <= fcp.MAX_SMEM)
    per_sm = 2 if smem(span) <= fcp.MAX_SMEM_PER_SM // 2 - 1024 else 1
    spans = -(-(T_in + 2 * padding) // span)

    def cost(split):
        blocks = pairs * B * spans * split
        return (-(-blocks // (sms * per_sm)) * (-(-max_live // split) + 1), blocks)

    return span, min(range(1, min(fcp.MAX_SPLIT, max(1, max_live)) + 1), key=cost)


# the parent source's hmvae_conv_dgrad: DGRAD_ARGTYPES without the dtype
PARENT_DGRAD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float]
                         + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _parent_span_launch(lib, fcp, s, wf, gy, y, T_in):
    """One launch of the parent source's span mode (its scratch row and the
    fold), as its wrapper made it; returns gx."""
    fn = fcp._bind(lib, "hmvae_conv_dgrad", PARENT_DGRAD_ARGTYPES)
    B, P, T_out = gy.shape
    w = fcp._aligned(wf, 1, 8)
    C, dev = w.shape[1], gy.device.index
    span, split = _parent_span_plan(fcp, B, T_in, s.kernel_size, s.stride, s.padding,
                                    s.dgrad_start.numel() - 1, s.dgrad_max_live,
                                    fcp._sm_count(dev))
    gx = torch.empty((B, C, T_in), device=gy.device)
    gxpad = torch.empty((B, C, T_in + 2 * s.padding), device=gy.device)
    err = fn(gy.data_ptr(), y.data_ptr(), w.data_ptr(), s.dgrad_start.data_ptr(),
             s.dgrad_row.data_ptr(), gx.data_ptr(), gxpad.data_ptr(), B, C, T_in, s.kernel_size,
             P, T_out, gy.shape[2], s.stride, s.padding, int(s.reflect), s.negative_slope, 1,
             split, span, 1, dev, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's dgrad launch failed: {err}")
    return gx[:, :wf.shape[1]]


def _row_tiles_plan(fcp, plan, s, sms):
    """``plan`` (``dgrad_span_plan``'s at the trajectory's short rows) as a
    source whose cluster ranks took interleaved row tiles planned it: the
    split over a group's live row tiles, counted in row tiles (waves of one
    block an SM times the row tiles a block walks, plus one)."""
    groups, live = s.dgrad_span_start.numel() - 1, max(1, s.dgrad_span_max_live)
    split = min(range(1, min(fcp.MAX_SPLIT, live) + 1),
                key=lambda k: (-(-groups * plan.groups * k // sms) * (-(-live // k) + 1), k))
    return plan._replace(split=split)


def trace_dgrad_span(lib, buf, parent: bool, batch=None, dtype=torch.float32,
                     shapes=None, row_tiles=False) -> None:
    """The dgrad span kernel (or, ``parent``, the span mode of a source from
    before it) in ``dtype`` at the trajectory model's four levels, batch 8,
    T 1,024 and batch 1, T 7,200, and at enc1, batch 8, T 1,024; or, where
    ``batch`` is given, at the len-64 model's eight levels at that batch
    under the span kernel's plan (``dgrad_span_plan``, whether or not
    ``dgrad_plan`` routes the shape there), or, where ``shapes`` is given,
    at the trajectory model's levels at each (batch, T) of it under the
    span kernel's plan (its split counted in stages; counted in row tiles
    where ``row_tiles``, as a source whose ranks took row tiles planned
    it): one JSON line a level, with its error against the plain
    version and the packing's device time (in the wrapper's launch, outside
    the kernel)."""
    import chip_smoke
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.models.trajectory import TrajectoryModel
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.utils.config import load_config

    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    tcfg = load_config(chip_smoke.TRAJ_CONFIG)
    tmodel = TrajectoryModel(tcfg.model, tcfg.optim.init, generator=gen).to("cuda")
    cfg = load_config(chip_smoke.CONFIG)
    model = HMVAE(cfg.model, cfg.optim.init, generator=gen).to("cuda")
    if shapes:
        cases = trajectory_cases(gen, shapes)
    elif batch is None:
        cases = [(f"traj{i}", getattr(tmodel.encoder, f"conv_{i}"), b, T)
                 for b, T in ((8, 1024), (1, 7200)) for i in range(4)]
        cases.append(("enc1", model.encoder.conv_1, 8, 1024))
    else:
        cases = [(n, c, batch, T) for n, c, T in
                 chip_smoke.level_cases(model, get_structure(cfg.model))]
    esz = torch.empty((), dtype=dtype).element_size()
    for name, conv, b, T in cases:
        s, wf, bf, x, y, gy = chip_smoke.bwd_inputs(conv, T, gen, b, dtype)
        dev = torch.cuda.current_device()
        plan = None if (batch is None and not shapes) or parent else fcp.dgrad_span_plan(
            b, T, s.kernel_size, s.stride, s.padding, s.dgrad_span_start.numel() - 1,
            s.dgrad_span_max_live, fcp._sm_count(dev), 1, esz,
            None if row_tiles else lambda: fcp.span_clusters(dev, s.kernel_size, s.stride, esz))
        if plan and row_tiles and fcp.traj_rows(b, T, s.kernel_size, s.stride, s.padding):
            plan = _row_tiles_plan(fcp, plan, s, fcp._sm_count(dev))
        if parent:
            launch = lambda: _parent_span_launch(lib, fcp, s, wf, gy, y, T)  # noqa: E731
        else:
            launch = lambda: fcp._dgrad(gy, y, wf, s, T, None, plan)  # noqa: E731
        ref = fcp.fused_conv_pool_dgrad_reference(gy, y, wf, T, s.stride, s.padding,
                                                  "reflect" if s.reflect else "constant",
                                                  s.negative_slope)
        err = float((launch().float() - ref.float()).abs().max())
        row = _trace(lib, buf, launch, phases if parent else dgrad_span_phases)
        extra = {} if parent else {"plan": fcp.last_backward_plans()["dgrad"],
                                   "pack_us": 1e3 * chip_smoke.device_ms(
                                       lambda: fcp.dgrad_span_pack(s, wf))}
        print(json.dumps({"kernel": "dgrad_span", "source": "parent" if parent else "repo",
                          "level": name, "batch": b, "T": T,
                          "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
                          "max_abs_ref": float(ref.float().abs().max()),
                          **extra, **row}), flush=True)


def trace_windows(lib, buf, kernel: str, windows: int, dtype, variant="base") -> None:
    """The windowed wgrad or dgrad at the solve's four decoder levels,
    ``windows`` windows of one batch each (``chip_smoke.windowed_inputs``),
    in ``dtype``: ``wgrad`` / ``dgrad`` the whole-row kernel under its
    whole-row plan (``wgrad_whole_plan``, one block a live tile and window;
    ``dgrad_whole_plan``, one block a pair of chunks and window), routed or
    not, or ``wgrad_tiles`` / ``dgrad_tiles`` the tile kernel under its plan
    (``wgrad_tiles_plan``, ``dgrad_tiles_plan``); one JSON line a level with
    its error against the plain version, the plan and the phases
    (:func:`window_phases`, :func:`tiles_phases`,
    :func:`dgrad_tiles_phases`)."""
    import chip_smoke
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import fused_conv_pool as fcp

    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    lcfg = chip_smoke.latent_config()
    model = HMVAE(lcfg.model, lcfg.optim.init, generator=gen).to("cuda")
    sms = fcp._sm_count(torch.cuda.current_device())
    for name, conv, T in chip_smoke.level_cases(model, get_structure(lcfg.model)):
        if not name.startswith("dec"):
            continue
        s, w, b, packed, x, y, gy = chip_smoke.windowed_inputs(conv, T, gen, dtype, windows)
        K, stride, T_out, esz = s.kernel_size, s.stride, y.shape[2], gy.element_size()
        t_ld = -(-T_out // (16 // esz)) * (16 // esz)
        mode = "reflect" if s.reflect else "constant"
        if kernel.startswith("dgrad"):
            plan = (chip_smoke.dgrad_tiles_plan_of(s, gy, windows) if kernel == "dgrad_tiles"
                    else chip_smoke.whole_row_plan(s, gy, T, windows))
            if plan.__class__ is fcp.DgradPlan and plan.span:
                raise SystemExit(f"{name}: the whole-row dgrad cannot take rows of {T} frames")
            launch = lambda: fcp._dgrad(gy, y, w, s, T, windows, plan)  # noqa: E731
            ref = fcp.fused_conv_pool_dgrad_windowed_reference(gy, y, w, T, stride, s.padding,
                                                               mode, s.negative_slope)
            err = float((launch().float() - ref.float()).abs().max())
            row = _trace(lib, buf, launch,
                         dgrad_tiles_phases if kernel == "dgrad_tiles" else window_phases)
            print(json.dumps({"kernel": kernel, "level": name, "windows": windows, "T": T,
                              "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
                              "max_abs_ref": float(ref.float().abs().max()),
                              "live_tiles": s.dgrad_chunk_row.numel(), "plan": plan._asdict(),
                              **row}), flush=True)
            continue
        if kernel == "wgrad_tiles":
            plan = chip_smoke.wgrad_tiles_plan_of(s, gy, T, windows)
            if variant == "lb3":
                plan = fcp.wgrad_tiles_plan(s.wgrad_row.numel(), windows, sms, 3)
        else:
            plan = fcp.wgrad_whole_plan(
                1, T_out, s.wgrad_row.numel(), sms, windows,
                lambda sb, split: fcp._wgrad_smem(1, T, K, T_out, t_ld, stride, sb, split, esz),
                fcp.wgrad_span_cols(K, stride, esz))
            if plan.span:
                raise SystemExit(f"{name}: the whole-row wgrad cannot take rows of {T} frames")
        launch = lambda: fcp._wgrad(gy, y, x, s, windows, plan)[0]  # noqa: E731
        ref = fcp.fused_conv_pool_wgrad_windowed_reference(
            gy, y, x, K, stride, s.padding, windows, mode, s.negative_slope,
            s.live_elements())[0]
        err = float((launch().float() - ref.float()).abs().max())
        row = _trace(lib, buf, launch, tiles_phases if kernel == "wgrad_tiles" else window_phases)
        print(json.dumps({"kernel": kernel, "level": name, "windows": windows, "T": T,
                          "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
                          "max_abs_ref": float(ref.float().abs().max()),
                          "live_tiles": s.wgrad_row.numel(), "plan": plan._asdict(),
                          **row}), flush=True)


@torch.inference_mode()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="fwd", choices=tuple(SOURCES))
    ap.add_argument("--source", default=None,
                    help="a copy of the backward source to trace instead of the repo's")
    ap.add_argument("--variant", default="base",
                    choices=("base", "nobuild", "nomma", "noxb", "nodrain", "nostore", "nowrite",
                             "nb3", "lb3", "noshift", "nogload"))
    ap.add_argument("--levels", default=None,
                    help="comma-separated levels (default: enc0,enc3,dec0,dec3 for fwd, all "
                         "eight for the backward)")
    ap.add_argument("--batch", type=int, default=None,
                    help="dgrad / wgrad: the batch (default 8); dgrad_span / wgrad_span: the "
                         "len-64 levels at this batch in place of the long rows")
    ap.add_argument("--rows", default=None,
                    help="BxT[,BxT]: the backward kernels at the trajectory model's four K-31 "
                         "levels at batch B and T frames (training 8x128, the solve 10x64)")
    ap.add_argument("--windows", type=int, default=None,
                    help="wgrad, wgrad_tiles, dgrad, dgrad_tiles: the windowed kernel at the "
                         "solve's four decoder levels, this many windows of one batch each")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the element type of the backward kernels (default float32)")
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if dtype != torch.float32 and args.kernel == "fwd":
        raise SystemExit("--dtype is for the backward kernels (the forward runs both)")
    shapes = [tuple(int(v) for v in r.split("x")) for r in args.rows.split(",")] \
        if args.rows else None
    if shapes and (args.kernel == "fwd" or args.batch):
        raise SystemExit("--rows is for the backward kernels, in place of --batch")
    if args.windows and (args.kernel not in ("wgrad", "wgrad_tiles", "dgrad", "dgrad_tiles")
                         or shapes or args.batch):
        raise SystemExit("--windows is for --kernel wgrad, wgrad_tiles, dgrad and dgrad_tiles, "
                         "in place of --batch and --rows")
    if args.kernel in ("wgrad_tiles", "dgrad_tiles") and not args.windows:
        raise SystemExit(f"--kernel {args.kernel} runs at --windows G")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_trace.py needs a GPU")
    # the plain versions that max_abs_err reads, in full f32 (no TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke
    from hm_vae_torch.models.hm_vae import HMVAE
    from hm_vae_torch.models.structure import get_structure
    from hm_vae_torch.ops import _build
    from hm_vae_torch.ops import fused_conv_pool as fcp
    from hm_vae_torch.utils.config import load_config

    lib = build(args.variant, args.kernel, args.source)
    if args.kernel == "fwd":
        fcp._library = lambda: (lib, fcp._bind(lib, "hmvae_fused_conv_pool", fcp.ARGTYPES))
    else:
        _build.load("fused_conv_pool")  # the forward, for y
        entries = fcp._bwd_entries(lib)
        fcp._bwd_library = lambda: entries
    if args.windows:
        trace_windows(lib, np.zeros(BLOCKS * SLOTS, dtype=np.uint64), args.kernel,
                      args.windows, dtype, args.variant)
        print(chip_smoke.nvidia_smi(), flush=True)
        return
    if args.kernel == "dgrad_span":
        with open(args.source or os.path.join(_build.CSRC_DIR, "fused_conv_pool_bwd.cu")) as f:
            src = f.read()
        trace_dgrad_span(lib, np.zeros(BLOCKS * SLOTS, dtype=np.uint64), FOLD_KERNEL in src,
                         args.batch, dtype, shapes, ROW_TILE_SPLIT in src)
        print(chip_smoke.nvidia_smi(), flush=True)
        return
    if args.kernel == "wgrad_span":
        with open(args.source or os.path.join(_build.CSRC_DIR, "fused_conv_pool_bwd.cu")) as f:
            src = f.read()
        trace_span(lib, np.zeros(BLOCKS * SLOTS, dtype=np.uint64), ITEMS64 in src, args.batch,
                   dtype, SPAN_LAYOUTS[0] in src, args.variant, shapes, ITEMS_ONE_BF16_K31 in src)
        print(chip_smoke.nvidia_smi(), flush=True)
        return
    levels = args.levels or ("enc0,enc3,dec0,dec3" if args.kernel == "fwd" else
                             "enc0,enc1,enc2,enc3,dec0,dec1,dec2,dec3")

    cfg = load_config(chip_smoke.CONFIG)
    st = get_structure(cfg.model)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    model = HMVAE(cfg.model, cfg.optim.init, generator=gen).to("cuda")
    buf = np.zeros(BLOCKS * SLOTS, dtype=np.uint64)
    cases = [(n, c, args.batch or chip_smoke.BATCH, T)
             for n, c, T in chip_smoke.level_cases(model, st) if n in levels.split(",")]
    if shapes:
        cases = trajectory_cases(gen, shapes)
    if args.kernel == "fwd":
        for dtype in (torch.bfloat16, torch.float32):
            for batch in (chip_smoke.BATCH, chip_smoke.VIBE_BATCH):
                for name, conv, _, T_in in cases:
                    conv = copy.deepcopy(conv)
                    conv.dtype = dtype
                    packed = conv.packed_operands()
                    x = torch.randn((batch, packed.in_channels, T_in), generator=gen).to(
                        "cuda", dtype)
                    row = _trace(lib, buf, lambda: fcp.fused_conv_pool_packed(x, packed))
                    print(json.dumps({"kernel": "fwd", "variant": args.variant, "level": name,
                                      "batch": batch, "dtype": str(dtype).replace("torch.", ""),
                                      **row}), flush=True)
    else:
        # the whole-row kernels under their whole-row plans, routed or not
        for name, conv, batch, T_in in cases:
            s, wf, bf, x, y, gy = chip_smoke.bwd_inputs(conv, T_in, gen, batch, dtype)
            mode = "reflect" if s.reflect else "constant"
            if args.kernel == "dgrad":
                plan = chip_smoke.whole_row_plan(s, gy, T_in)
                launch = lambda: fcp._dgrad(gy, y, wf, s, T_in, None, plan)  # noqa: E731
                ref = fcp.fused_conv_pool_dgrad_reference(gy, y, wf, T_in, s.stride, s.padding,
                                                          mode, s.negative_slope)
            else:
                plan = chip_smoke.whole_row_wgrad_plan(s, gy, T_in)
                launch = lambda: fcp._wgrad(gy, y, x, s, None, plan)[0]  # noqa: E731
                ref = fcp.fused_conv_pool_wgrad_reference(
                    gy, y, x, s.kernel_size, s.stride, s.padding, mode, s.negative_slope,
                    s.live_elements())[0]
            if plan.span:
                raise SystemExit(f"{name}: the whole-row {args.kernel} cannot take rows of "
                                 f"{T_in} frames")
            err = float((launch().float() - ref.float()).abs().max())
            row = _trace(lib, buf, launch)
            print(json.dumps({"kernel": args.kernel, "variant": args.variant, "level": name,
                              "batch": batch, "T": T_in, "dtype": args.dtype,
                              "max_abs_err": err, "max_abs_ref": float(ref.float().abs().max()),
                              "plan": plan._asdict(), **row}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
