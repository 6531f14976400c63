// The backward of one skeleton-conv level (fused_conv_pool.cu's forward) on
// Hopper, in f32 and in bf16: the input gradient (dgrad) and the folded
// weight's and bias's gradients (wgrad), kernels on the tensor cores.
//
// The JAX package has no backward kernel: it differentiates its XLA level in
// hm_vae_tpu/models/hm_vae.py:200 (SkeletonConv: the conv on the folded
// weight P @ (W*mask) @ U, bias P @ b, then LeakyReLU).  These kernels are the
// counterparts of that autodiff for the port, whose forward is a kernel.
// For the forward
//
//   y[b, p, t] = act( bf[p] + sum_{c,k} Wf[p, c, k] * xpad[b, c, t*stride + k] )
//
// with x (B, C, T_in), xpad x padded in time by `padding` (reflect without
// edge repeat, or zeros) and act(v) = v >= 0 ? v : slope*v, and the output
// gradient gy, both kernels read g = gy * act'(y), act'(y) = y >= 0 ? 1 :
// slope (slope > 0, so y >= 0 exactly where the pre-activation is):
//
//   dgrad: gx[b, c, i] = sum over the padded columns u that read x[., ., i]
//          (u = i + padding, and under reflect the mirrored columns) of
//          gxpad[b, c, u] = sum_{p, k: u = t*stride + k} Wf[p, c, k] * g[b, p, t];
//   wgrad: gWf[p, c, k] = sum_{b, t} g[b, p, t] * xpad[b, c, t*stride + k],
//          gbf[p] = sum_{b, t} g[b, p, t].
//
// Both read only the live tiles of the folded weight (64 rows x 8 input
// channels; pack_structure in hm_vae_torch/ops/fused_conv_pool.py): dgrad
// the row tiles live in a pair of chunks (dgrad_start / dgrad_row), wgrad
// one live tile a block (wgrad_row / wgrad_chunk, where chunk -1 is a row
// tile with no live tile, whose bias gradient is still summed).  Entries of dead tiles
// are structural zeros of the fold: wgrad leaves them as the wrapper zeroed
// them.  The wrapper chooses the work split (dgrad_plan, wgrad_plan), a pure
// function of the shapes that the CPU tests check.
//
// What bounds them on an H100 (data sheet: 3.35 TB/s; 495 TFLOP/s TF32 on
// the tensor cores, 165 as 3xTF32, 989 in bf16).  At the len-64 model's
// batch of 8 each kernel does ~1/3 of the forward's multiply-adds per level (a few GFLOP
// over the eight levels) and moves the live weight (or its gradient), x, y
// and gy: tens of megabytes.  Both bounds are microseconds: a launch is
// bound by latency (copies in flight, the dependent steps of a block) and
// by how many blocks fill the 132 SMs, not by the units.  What the design
// does about it:
// - the products are mma.sync.m16n8k8 in 3xTF32 (big*big + big*small +
//   small*big, f32 accumulate), each operand split into its TF32 rounding
//   and the remainder (g and x where they are staged, dgrad's weight where
//   its fragments are loaded); the tensor cores' sums are added in f32
//   after every k-step (wgrad: 8 columns) or tap (dgrad), so that no
//   tensor-core sum runs long (as the forward adds each chunk's).  mma.sync,
//   not wgmma: TF32 wgmma takes both operands K-major from shared memory,
//   but dgrad's weight operand is the folded weight transposed (its
//   reduction runs over the rows p) and its g operand is g shifted by the
//   tap; both kernels' tiles are narrow (8 channels, 64 rows).  mma.sync's
//   fragments are loaded by each lane from shared memory in whatever layout
//   is staged.  Over long rows both kernels run wgmma with A from
//   registers: wgrad_span_kernel's transposed product takes x's taps as A
//   and g's tile, K-major along time, as B; dgrad_span_kernel (also over
//   the short rows of a large batch, several batches' rows a span) takes g
//   shifted by the tap as A and the tap's weight slice, laid out in the
//   K-major layout by dgrad_span_pack_kernel once a call (f32: TF32
//   planes), as B;
// - every copy from global memory is a cp.async.bulk onto an mbarrier, and
//   the next stage's copies are in flight while the current stage
//   multiplies: dgrad keeps two weight stages and refills its one stage of
//   gy and y as soon as it is rewritten for the products; wgrad does the
//   same with one or two stages of gy and y, as many as let two blocks
//   share an SM;
// - sums run in a fixed order, the cluster split's partial tiles are added
//   in rank order through distributed shared memory: no atomics, the same
//   bits every run;
// - dgrad: a block owns a pair of 8-channel chunks (two mma N tiles, so
//   that each g fragment read from shared memory feeds two products) and
//   whole padded input rows of a group of batches (the M side: 16-column
//   tiles over (b, v), one per warp; a single batch's row may take up to
//   two tiles a warp, tiles warp and warp + 8, run one after the other in
//   a stage, so that a padded row of up to 256 columns fits one block: the
//   trajectory model's 128 + 30 at K 31).  At stride 2 a padded column
//   u = 2v + phi reads only taps k = 2m + phi, so the columns are split by
//   phase and each phase is a stride-1 product over its ~K/2 taps with g
//   shifted by m: no zero tap is multiplied and no im2col is built.  The
//   block walks the row tiles live in either chunk (the reduction: 64 rows x
//   a phase's taps; a dead tile's weight is zeros), half a tile a stage:
//   the weight rows (32 bulk copies of 16*K floats, read by the lanes in
//   fragment order and split) and g's rows, written once per stage split
//   and zero-padded in time, so a fragment load needs no bounds test.
//   Where pairs x batch groups are too few to fill the card the row tiles
//   are split over a cluster.  The epilogue writes gxpad to shared memory,
//   sums the cluster's partials, adds each reflected edge column onto its
//   source (the padding's adjoint) and stores gx row by row.  A padded row
//   too long for one block is cut into spans of one batch's padded columns,
//   and at a large batch (dgrad_plan) the short rows of several batches
//   share a span, at the trajectory's short rows one or two batches' rows
//   a span (dgrad_span_kernel: wgmma, warp-specialised, its own section
//   below);
// - wgrad: a block owns one live tile (64 rows x the chunk's 8 channels x K
//   taps, plus a ones-column for the bias: the mma's N runs over 8-channel
//   tap tiles, K + 1 of them, 2, 3 or 4 a warp: a template parameter, so
//   K <= 15 keeps its registers and two blocks an SM, and K 31 takes all
//   32 tiles over the 8 warps) and a range of batches (the reduction over the
//   (b, t) columns); a cluster splits the batches where the live tiles are
//   too few to fill the card.  x's rows for the block's batches are staged
//   once, padded and split by stride phase (so that a tap's columns read
//   consecutive words); g is staged a few batches at a time and written in
//   the mma's fragment order, so each lane reads its A fragment as two
//   16-byte loads.  The item kernel (wgrad_span_kernel, its own section
//   below) cuts the (b, t) reduction into items of 128 output columns, a
//   contiguous run of them a cluster rank, two items' copies in flight:
//   where x's rows of a block do not fit shared memory (long rows, even at
//   batch 1), items of one batch's columns; at a large batch of short rows
//   (wgrad_plan routes the len-64 levels from batch 64 on), items of
//   several batches' whole rows.  Its products are wgmma with the gradient
//   transposed (rows (tap, channel): x's taps in registers; columns p: g
//   in a shared-memory tile a chunk at a time), f32 3xTF32 with the sums
//   added in f32 after every chunk, bf16 one m64n64k16 a k-step; the
//   partial tiles summed in rank order as above, so the bits are the same
//   on every run.  At batch 64 the whole-row kernel walks 8-32 stages of 32
//   columns a block, each a serial chain (the stage's wait, g's build, a
//   barrier, mma.sync products whose x fragments are scalar shared-memory
//   loads: 22% of its time in f32, 29% in bf16; the tensor cores 2-7%,
//   PERF.md): what bounds it there is that chain, not bytes or the units,
//   and items of 2-32 batches' rows, 2-4 chunks each, cut a block's serial
//   steps several times over;
// - windows: the test-time solver gives every window of its batch its own
//   decoder clone (hm_vae_tpu/apps/latent_opt.py, jax.vmap over windows
//   with the decoder on axis 0).  Both kernels then take `windows` weights
//   (dgrad) or gradients (wgrad), one after the other: a dgrad block's
//   batch group lies inside one window and stages that window's weight
//   rows; a wgrad block (grid z: the window) sums over its window's batches
//   only, its cluster split too.  One window is the kernels' plain form.
// - bf16 (the models' compute_dtype bfloat16, where JAX's autodiff
//   differentiates the level in bf16): dgrad_kernel and wgrad_kernel take
//   the element type as a template parameter.  The bf16 forms stage gy, y,
//   x and the weight rows as bf16 (half the bytes a copy, 16-byte granules
//   of 8 elements) and run one mma.sync.m16n8k16 bf16 product a k-step of
//   16 in place of the three m16n8k8 TF32 products and the splits: g =
//   gy * act'(y) is rounded to bf16 once, as the plain version rounds it,
//   and staged two rows p (dgrad) or two columns (wgrad) to a 32-bit word
//   in the operands' fragment order; the sums are f32, added after each
//   tap (dgrad) or k-step (wgrad) as in f32, the cluster's partials summed
//   in rank order; each output is rounded to bf16 once, at its store.
//   dgrad_span_kernel's bf16 form runs one wgmma.m64n32k16 a tap, the item
//   kernel's one wgmma.m64n64k16 a k-step.  Every bf16 form takes windows
//   as its f32 form does (the solve at compute_dtype bfloat16, JAX's bf16
//   level under jax.vmap): the window from grid y (dgrad_kernel, the span
//   kernel, its weight layout) or z (wgrad_kernel, the item kernel), its
//   offsets in elements of T, so a window's weight, gradient and batches
//   lie where the f32 form finds them, at half the bytes;
// - the test-time solve's windows of short rows (several windows, a window's
//   columns at most 64): wgrad_tiles_kernel, persistent blocks that walk
//   runs of (window, live tile) units and write the windows' whole
//   gradients, dead tiles included; dgrad_tiles_kernel, persistent blocks
//   that walk runs of (window, channel chunk) units, streaming each unit's
//   live weight tiles once, g built once a window (their own sections
//   below);
// Limits: C a multiple of 8 (the wrappers pad), K <= 31 (wgrad's 32
// tap tiles), and shared memory: dgrad's two weight stages are 32 rows of
// 16 channels x K taps (127 KB at K 31, so one block an SM there) beside
// g's rows; dgrad's columns of a block fill at most 16 column tiles
// (dgrad_plan gives a group of several batches at most one tile a warp, a
// batch alone up to two, and cuts a longer padded row into spans).  Rows of
// any length run.
// Times against the bounds, and traces of both kernels (kernel_trace.py),
// are in PERF.md.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "run_counter.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // rows of a weight tile
constexpr int kHalf = 32;      // dgrad: weight rows of a stage (half a tile)
constexpr int kDC = 16;        // dgrad: input channels of a block (two chunks)
constexpr int kCC = 8;         // input channels of a chunk (the mma's N)
constexpr int kStages = 2;     // stages in flight
constexpr int kMaxSplit = 8;   // blocks per cluster (the portable maximum)
constexpr int kMaxTiles = 2;  // dgrad: 16-column tiles of a warp
constexpr int kMaxK = 31;     // wgrad: K + 1 tap tiles (the bias's last) over 8 warps, 4 each
constexpr int kMaxSmem = 232448;   // a block
constexpr int kSmemPerSM = 233472;  // 228 KB
constexpr int kMaxDevices = 64;

__device__ unsigned long long g_runs[2];  // the dgrad kernels, the wgrad kernels (run_counter.h)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase after `parity`; traps (a launch error, not a hang) if a
// copy never completes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Arrive on `bar` and make its phase wait for `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One bulk copy of `bytes` contiguous bytes (16-byte aligned, a multiple of
// 16) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One box (columns x0.., rows y0..) of a 2D tensor map into shared memory,
// completing on `bar`; the map is a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int x0, int y0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(y0), "r"(smem_addr(bar))
      : "memory");
}

// One box (x0.., y0.., z0..) of a 3D tensor map into shared memory, dense
// in box order, completing on `bar`.
__device__ __forceinline__ void tensor_copy3(void* dst, const CUtensorMap* map, int x0, int y0,
                                             int z0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(y0), "r"(z0), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float tf32_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// v ~ big + small: big is v rounded to TF32, small the remainder rounded to
// TF32 too (the tensor cores would truncate it, a bias that long sums of
// like-signed terms add up).
__device__ __forceinline__ float2 split_tf32(float v) {
  const float big = tf32_round(v);
  return make_float2(big, tf32_round(v - big));
}

__device__ __forceinline__ float act_grad(float gy, float y, float slope) {
  return y >= 0.f ? gy : gy * slope;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// f32 as the element type T: itself, or rounded to bf16 (to nearest even)
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (sizeof(T) == 2)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// Two bf16 as one 32-bit mma operand register: `lo` in the low half (the
// lower k index of a fragment's pair).
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// d += A (16 x 8, row) * B (8 x 8, col), TF32 in, f32 accumulate.  Lane
// (g = lane/4, q = lane%4) holds a = A[g][q], A[g+8][q], A[g][q+4],
// A[g+8][q+4]; b = B[q][g], B[q+4][g]; d = D[g][2q], D[g][2q+1],
// D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A (16 x 16, row) * B (16 x 8, col), bf16 in, f32 accumulate.  Lane
// (g = lane/4, q = lane%4) holds, two bf16 a register (the lower column of
// A, row of B, in the low half): a = A[g][2q..2q+1], A[g+8][2q..2q+1],
// A[g][2q+8..2q+9], A[g+8][2q+8..2q+9]; b = B[2q..2q+1][g],
// B[2q+8..2q+9][g]; d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// wgmma shared-memory descriptor, no swizzle, K-major: core matrices of
// 8 rows x 16 bytes; the two along k 128 bytes apart (leading byte offset),
// row groups of 8 rows 256 bytes apart (stride byte offset), as the
// forward's (fused_conv_pool.cu).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// Pins a wgmma's accumulators: no access to them moves across this point.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HMVAE_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HMVAE_ACC32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d = A (64 x 8, tf32, in registers) * B (8 x 64, tf32, K-major in shared
// memory) + (acc ? d : 0).  Warp w of the warpgroup holds A's rows
// 16w..16w+15: a[0] row lane/4, column lane%4; a[1] row lane/4 + 8; a[2],
// a[3] the same rows at column lane%4 + 4.  d[i]: row 16w + lane/4 (+8 if
// i&2), column 8*(i/4) + 2*(lane%4) + (i&1).
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HMVAE_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HMVAE_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// The smallest row stride >= len (in 8-byte words) that is 4 mod 16: a
// half-warp's 16 lanes, four rows of four consecutive words, read 16
// different bank pairs.
__host__ __device__ __forceinline__ int frag_stride(int len) { return (len + 11) / 16 * 16 + 4; }

// bf16 dgrad's g: the smallest row stride >= len (in 4-byte words, a pair of
// rows p a word) that is 8 mod 32: a warp's 32 loads, eight consecutive
// columns of four pair rows, hit 32 banks.
__host__ __device__ __forceinline__ int pair_stride(int len) { return (len + 23) / 32 * 32 + 8; }

// bf16 wgrad's x: the smallest row stride >= len (in bf16 values) that is 8
// mod 64: the eight channel rows of a warp's 16-bit loads lie 4 words mod 32
// apart, each row's four lanes on consecutive words.
__host__ __device__ __forceinline__ int half_stride(int len) { return (len + 55) / 64 * 64 + 8; }

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// ---------------------------------------------------------------------------
// dgrad

struct DgradLayout {
  int Tp, off, rs, wr, gl;  // staged padded width, g's time offset (a phase's taps - 1),
                            // g2's row stride (f32: 8-byte words, bf16: 4-byte words), a
                            // weight row (values), a staged row of gy or y (values)
  size_t bars, w, g, g2, out, total;  // byte offsets in shared memory
};

// A stage is half a row tile: 32 weight rows of the block's 16 channels and
// the same rows of gy and y, so that two blocks fit an SM.  Two weight
// stages in flight (a stage's rows are read by the products); one stage of
// gy and y, refilled as soon as it is rewritten into g2.  gxpad (16
// channels x the group's padded columns) reuses the weight stages.  A
// block stages whole padded rows of nbb batches (gy's and y's rows of t_ld
// values).  `esz` is the element's bytes: 4 (f32: g2 holds each row p's
// TF32 big and small parts) or 2 (bf16: g2 holds a pair of rows p a word);
// gxpad is f32 either way.
__host__ __device__ inline DgradLayout dgrad_layout(int T_in, int K, int T_out, int t_ld,
                                                    int stride, int padding, int nbb, int esz) {
  DgradLayout L;
  L.off = (K + stride - 1) / stride - 1;
  L.Tp = T_in + 2 * padding;
  const int V0 = (L.Tp + stride - 1) / stride;
  const int len = L.off + (V0 > T_out ? V0 : T_out);
  L.rs = esz == 4 ? frag_stride(len) : pair_stride(len);
  L.gl = t_ld;
  L.wr = kDC * K + 8;  // 16-byte rows; 8 more values spread a fragment's rows over the banks
  L.bars = 0;
  L.w = 64;
  L.g = L.w + align16(size_t(kStages) * kHalf * L.wr * esz);
  L.g2 = L.g + align16(size_t(2) * nbb * kHalf * L.gl * esz);
  const size_t out_bytes = size_t(kDC) * nbb * L.Tp * 4;
  const size_t g2_end = L.g2 + size_t(nbb) * kHalf * L.rs * (esz == 4 ? 8 : 2);
  L.out = out_bytes <= L.g - L.w ? L.w : align16(g2_end);
  L.total = L.out == L.w ? g2_end : L.out + out_bytes;
  return L;
}

// Whole padded rows of a batch group a block, folded here; T is float or
// __nv_bfloat16 (gy, y, the weight and gx).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dgrad_kernel(const T* __restrict__ gy, const T* __restrict__ y,
             const T* __restrict__ w, const int* __restrict__ dgrad_start,
             const int* __restrict__ dgrad_row, T* __restrict__ gx, int B, int C, int T_in,
             int K, int P, int T_out, int t_ld, int stride, int padding, int reflect,
             float slope, int nbb, int gpw, size_t w_stride) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kPr = kBf16 ? kHalf / 2 : kHalf;  // g2's rows of a batch: rows p, or pairs (bf16)
  count_run(&g_runs[0]);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const DgradLayout L = dgrad_layout(T_in, K, T_out, t_ld, stride, padding, nbb, sizeof(T));

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // weight [kStages], then g
  T* w_s = reinterpret_cast<T*>(smem + L.w);                     // [kStages][32][wr]
  T* g_s = reinterpret_cast<T*>(smem + L.g);                     // [2][nbb][32][gl]
  float2* g2 = reinterpret_cast<float2*>(smem + L.g2);           // f32: [nbb][32][rs]
  uint32_t* g2h = reinterpret_cast<uint32_t*>(smem + L.g2);      // bf16: [nbb][16][rs]
  float* out_s = reinterpret_cast<float*>(smem + L.out);         // [16][nbb][Tp]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * kDC;
  const int cw = min(kDC, C - c0);  // 16, or 8 for a last odd chunk
  // blockIdx.y: (window, batch group); window `win` owns the batches
  // [win*B, (win+1)*B) in gpw groups, and its own folded weight
  const int yg = static_cast<int>(blockIdx.y);
  const int win = yg / gpw;
  const int b0 = win * B + (yg - win * gpw) * nbb;
  const int nbl = min(nbb, (win + 1) * B - b0);
  const T* wwin = w + win * w_stride;
  const int width = L.Tp;
  const int first = dgrad_start[blockIdx.x];
  const int live = dgrad_start[blockIdx.x + 1] - first;
  // stages: both halves of each of the block's live row tiles
  const int n_mine = live > rank ? 2 * ((live - rank + split - 1) / split) : 0;
  const int wt = kHalf * L.wr;        // values of a weight stage
  const int gt = nbb * kHalf * L.gl;  // values of gy (or y) in a stage
  auto stage_row = [&](int i) {
    return dgrad_row[first + rank + (i >> 1) * split] * kRows + (i & 1) * kHalf;
  };

  // Stage i: its weight rows (cw*K contiguous values each; thread r copies
  // row r) into weight stage `slot`, or the batches' rows of gy and y (one
  // contiguous run each; threads 32.. copy).  Thread 0 arms the barrier; a
  // copy may land before it does, the phase completes only after both.
  auto issue_w = [&](int i, int slot) {
    const int p0 = stage_row(i), nrows = max(0, min(kHalf, P - p0));
    const uint32_t w_row = cw * K * sizeof(T);
    if (tid == 0) mbar_expect(smem_addr(bars + slot), nrows * w_row);
    if (tid < nrows) {
      fence_async();
      bulk_copy(w_s + slot * wt + tid * L.wr, wwin + (size_t(p0 + tid) * C + c0) * K, w_row,
                bars + slot);
    }
  };
  auto issue_g = [&](int i) {
    const int p0 = stage_row(i), nrows = max(0, min(kHalf, P - p0));
    const int q = tid - kHalf;
    const uint32_t g_bytes = nrows * t_ld * sizeof(T);
    if (tid == 0) mbar_expect(smem_addr(bars + kStages), 2 * nbl * g_bytes);
    if (nrows > 0 && q >= 0 && q < 2 * nbl) {
      const int which = q / nbl, bb = q - which * nbl;
      fence_async();
      bulk_copy(g_s + which * gt + bb * kHalf * t_ld,
                (which ? y : gy) + (size_t(b0 + bb) * P + p0) * t_ld, g_bytes, bars + kStages);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages + 1; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // g's time padding stays zero (a stage writes only t in [0, T_out)), and
  // so do the weight rows' second chunk where the block has one chunk
  for (int q = tid; q < nbb * kPr * L.rs; q += kThreads) {
    if constexpr (kBf16)
      g2h[q] = 0u;
    else
      g2[q] = make_float2(0.f, 0.f);
  }
  if (cw < kDC)
    for (int q = tid; q < kStages * wt; q += kThreads) w_s[q] = from_f<T>(0.f);
  __syncthreads();
  for (int i = 0; i < kStages && i < n_mine; ++i) issue_w(i, i);
  if (n_mine > 0) issue_g(0);

  // This warp's 16-column tiles warp + 8w (w < kMaxTiles): phase phi[w],
  // rows (b, v) of that phase; taps[w] = 0 where the warp has no such tile.
  int phis[kMaxTiles], mts[kMaxTiles], Vs[kMaxTiles], taps[kMaxTiles], base[kMaxTiles][2];
#pragma unroll
  for (int w = 0; w < kMaxTiles; ++w) {
    int phi = 0, mt = warp + kWarps * w, V = 0;
    for (; phi < stride; ++phi) {
      V = (width - phi + stride - 1) / stride;
      const int n = (nbl * V + 15) / 16;
      if (mt < n) break;
      mt -= n;
    }
    const bool has_tile = phi < stride;
    phis[w] = phi, mts[w] = mt, Vs[w] = max(V, 1);
    taps[w] = has_tile ? (K - phi + stride - 1) / stride : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + gid + 8 * h;
      const int bb = r / Vs[w];
      base[w][h] = has_tile && bb < nbl ? bb * kPr * L.rs + L.off + r - bb * Vs[w] : L.off;
    }
  }

  float sum[kMaxTiles][2][4] = {};  // per tile, the two chunks' 16 x 8 tiles
  for (int i = 0; i < n_mine; ++i) {
    const int slot = i % kStages;
    const int nrows = max(0, min(kHalf, P - stage_row(i)));
    mbar_wait(smem_addr(bars + kStages), i & 1);
    // g = gy * act'(y) into its zero-padded rows: f32 split, bf16 rounded
    // and paired (rows 2r, 2r + 1 in one word)
    if constexpr (kBf16) {
      for (int q = tid; q < nbl * kPr * T_out; q += kThreads) {
        const int bb = q / (kPr * T_out), rem = q - bb * (kPr * T_out);
        const int r = rem / T_out, t = rem - r * T_out;
        const int o = (bb * kHalf + 2 * r) * t_ld + t;
        const float v0 = 2 * r < nrows ? act_grad(to_f(g_s[o]), to_f(g_s[gt + o]), slope) : 0.f;
        const float v1 = 2 * r + 1 < nrows
                             ? act_grad(to_f(g_s[o + t_ld]), to_f(g_s[gt + o + t_ld]), slope)
                             : 0.f;
        g2h[(bb * kPr + r) * L.rs + L.off + t] = pack_bf16(v0, v1);
      }
    } else {
      for (int q = tid; q < nbl * kHalf * T_out; q += kThreads) {
        const int bb = q / (kHalf * T_out), rem = q - bb * (kHalf * T_out);
        const int r = rem / T_out, t = rem - r * T_out;
        const int o = (bb * kHalf + r) * t_ld + t;
        const float v = r < nrows ? act_grad(g_s[o], g_s[gt + o], slope) : 0.f;
        g2[(bb * kHalf + r) * L.rs + L.off + t] = split_tf32(v);
      }
    }
    mbar_wait(smem_addr(bars + slot), (i / kStages) & 1);
    // weight rows past P (a ragged last tile) read as zeros
    for (int q = nrows * L.wr + tid; q < wt; q += kThreads) w_s[slot * wt + q] = from_f<T>(0.f);
    __syncthreads();  // g and the weight rows are staged
    if (i + 1 < n_mine) issue_g(i + 1);  // overlaps the products

#pragma unroll
    for (int w = 0; w < kMaxTiles; ++w) {
      // f32: per chunk four independent sums (small and big products, even
      // and odd rows of 8), so that consecutive mma.sync do not wait on each
      // other, added in f32 after each tap; each g fragment feeds both chunks
      const T* ws = w_s + slot * wt;
      for (int m = 0; m < taps[w]; ++m) {
        const int k = phis[w] + stride * m;
        if constexpr (kBf16) {
          // two k-steps of 16 rows p, a sum each; A: the pair rows 8j + tig
          // (+4) at the lane's columns, shifted by the tap; B: the weight at
          // rows 16j + 2tig (+1, +8, +9), the lane's channel, tap k
          float acc[2][2][4] = {};
#pragma unroll
          for (int j = 0; j < kHalf / 16; ++j) {
            const int pr = 8 * j + tig;
            const uint32_t a[4] = {g2h[base[w][0] + pr * L.rs - m], g2h[base[w][1] + pr * L.rs - m],
                                   g2h[base[w][0] + (pr + 4) * L.rs - m],
                                   g2h[base[w][1] + (pr + 4) * L.rs - m]};
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const T* wc = ws + 2 * pr * L.wr + (n * kCC + gid) * K + k;
              const uint32_t b[2] = {pack_bf16(wc[0], wc[L.wr]),
                                     pack_bf16(wc[8 * L.wr], wc[9 * L.wr])};
              mma_bf16(acc[n][j], a, b);
            }
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r) sum[w][n][r] += acc[n][0][r] + acc[n][1][r];
        } else {
          float acc[2][4][4] = {};
#pragma unroll
          for (int j = 0; j < kHalf / 8; ++j) {
            const int pr = 8 * j + tig;
            const float2 a0 = g2[base[w][0] + pr * L.rs - m];
            const float2 a1 = g2[base[w][1] + pr * L.rs - m];
            const float2 a2 = g2[base[w][0] + (pr + 4) * L.rs - m];
            const float2 a3 = g2[base[w][1] + (pr + 4) * L.rs - m];
            const uint32_t ab[4] = {__float_as_uint(a0.x), __float_as_uint(a1.x),
                                    __float_as_uint(a2.x), __float_as_uint(a3.x)};
            const uint32_t as[4] = {__float_as_uint(a0.y), __float_as_uint(a1.y),
                                    __float_as_uint(a2.y), __float_as_uint(a3.y)};
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const float2 b0v = split_tf32(ws[pr * L.wr + (n * kCC + gid) * K + k]);
              const float2 b1v = split_tf32(ws[(pr + 4) * L.wr + (n * kCC + gid) * K + k]);
              const uint32_t bb[2] = {__float_as_uint(b0v.x), __float_as_uint(b1v.x)};
              const uint32_t bs[2] = {__float_as_uint(b0v.y), __float_as_uint(b1v.y)};
              mma_tf32(acc[n][j & 1], as, bb);
              mma_tf32(acc[n][j & 1], ab, bs);
              mma_tf32(acc[n][2 + (j & 1)], ab, bb);
            }
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              sum[w][n][r] += ((acc[n][0][r] + acc[n][1][r]) + acc[n][2][r]) + acc[n][3][r];
        }
      }
    }
    __syncthreads();  // every warp is done with this stage's weight rows and g2
    if (i + kStages < n_mine) issue_w(i + kStages, slot);
  }

  // gxpad of the block's columns -> out_s (over the weight stages, now
  // unread); a block alone in its cluster skips the cluster barriers
#pragma unroll
  for (int w = 0; w < kMaxTiles; ++w) {
    if (taps[w] == 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mts[w] * 16 + gid + 8 * h;
      const int bb = r / Vs[w], u = (r - bb * Vs[w]) * stride + phis[w];
      if (bb >= nbl) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          out_s[((n * kCC + 2 * tig + cc) * nbb + bb) * L.Tp + u] = sum[w][n][2 * h + cc];
    }
  }
  if (split > 1)
    cluster.sync();  // every block's partial gxpad is in its shared memory
  else
    __syncthreads();
  {
    const float* part[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      part[q] = q == rank ? out_s : cluster.map_shared_rank(out_s, min(q, split - 1));
    auto column = [&](int row, int u) {  // summed over the cluster in rank order
      float s = part[0][row + u];
#pragma unroll
      for (int q = 1; q < kMaxSplit; ++q)
        if (q < split) s += part[q][row + u];
      return s;
    };
    const int n_el = cw * nbl * T_in;
    const int lo = n_el * rank / split, hi = n_el * (rank + 1) / split;
    for (int el = lo + tid; el < hi; el += kThreads) {
      const int c = el / (nbl * T_in), rem = el - c * (nbl * T_in);
      const int bb = rem / T_in, i = rem - bb * T_in;
      const int row = (c * nbb + bb) * L.Tp;
      // the padded columns that read x[b, c, i]: i + padding, and under
      // reflect the mirrored columns
      float v = column(row, i + padding);
      if (reflect && i >= 1 && i <= padding) v += column(row, padding - i);
      if (reflect && i <= T_in - 2 && i >= T_in - 1 - padding)
        v += column(row, padding + 2 * (T_in - 1) - i);
      gx[(size_t(b0 + bb) * C + c0 + c) * T_in + i] = from_f<T>(v);
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its partial gxpad
}

// ---------------------------------------------------------------------------
// dgrad over long rows, and over the short rows of a large batch
//
// dgrad_span_kernel<T> (T float or __nv_bfloat16).  A block owns a group of
// four 8-channel chunks (32 channels: the products' N) and a span of padded
// columns; it walks the group's live row tiles (dgrad_span_start /
// dgrad_span_row in pack_structure), one k-step of rows p a stage (8 in
// f32, 16 in bf16); a cluster splits the group's stages into contiguous
// runs, one a rank, its partial sums added in rank order.  At the short
// rows of a small batch (the trajectory's (8, 128) and (10, 64)) a level
// has 2-6 live row tiles and 15-48 span blocks, so a block walked up to 24
// stages of ~5.5 us (f32) while most SMs idled, and a rank whose last row
// tile was part-filled waited for the others (PERF.md): a run of stages
// splits the work at any count up to the cluster's 8 blocks, evenly.
// Per stride phase phi the columns u = stride*v + phi read only taps k =
// phi + stride*m, from g's column v - m, so each phase is a stride-1
// product over its taps with g shifted by the tap, in M tiles of 64
// columns v.  A span is one of two things:
// - spans of one batch's padded row (a row too long for one block): a span
//   [u0, u0 + width) stages g's columns t0 - off.. (t0 = u0 / stride) from
//   the 16-byte granule that holds them; the plan sizes the first and the
//   last span so that each holds both columns of every reflected pair
//   (dgrad_span_shift);
// - whole padded rows of nbb batches of a window (short rows at a large
//   batch, where one batch's row fills one or two of the span's M tiles and
//   the stage's cost, the same whether a tile is full or not, bought little
//   work): each phase's M rows are the batches' columns v in turn, a period
//   of R (dgrad_span_period) rows a batch, and g is staged with the same
//   period: a batch's T_out columns after off zeros, zeros up to the next
//   batch's.  A tap's shifted read of a batch's row then lands in its own
//   g or in zeros: no im2col, no shifted copy, no column of another batch.
//   The epilogue folds each batch's reflected columns in the block.
// The products are wgmma with A from registers and B from shared memory:
// - A is g shifted by the tap: each lane loads its fragment from the stage's
//   g at the tap's column offset; g's rows are 8 mod 32 words apart, so a
//   warp's 32 loads hit 32 banks.  f32: g split into TF32 big and small
//   planes of 8 rows p; bf16: g rounded once (as the plain version rounds
//   it), two rows p a 32-bit word (a register of the bf16 A fragment);
// - B is the tap's weight slice, K-major in core matrices: f32, 8 rows p x
//   32 channels as TF32 big and small planes; bf16, 16 rows p x 32 channels.
//   dgrad_span_pack_kernel lays the folded weight out so once a backward
//   call: a stage's K taps are one contiguous bulk copy, and nothing is
//   converted in the product loop;
// - f32 runs three m64n32k8 products a tap (small*big, big*small, big*big),
//   bf16 one m64n32k16; the tensor cores' sum of a tap is added in f32 once
//   a tap, in tap order then stage order: the same bits every run.  A
//   warpgroup issues kSpanTaps taps, each into its own accumulator, as one
//   wgmma group, waits for it and adds the taps' sums: a product of 64 x 32
//   is short, so a group of one tap left the tensor cores idle between its
//   products and the wait (PERF.md), and ptxas serializes wgmma whose
//   accumulators are read while another group is in flight.
// What bounds it is shared memory's bandwidth: a tile's A fragments (4 KB a
// tap) feed only N channels, so N 32 rather than a pair's 16 halves the bytes
// a multiply-add (PERF.md).
// Warp-specialised: warps 0-15 are four consumer warpgroups, one M tile of
// the span each; warp 16 is the producer, which keeps up to kSpanMaxStages
// stages of copies in flight (the stage's weight planes, and gy's and y's
// rows: a span's window of each row p, or each batch's rows of the stage as
// one contiguous run, onto the stage's `full` barrier) and refills a stage
// as soon as every consumer warp releases it (`empty`); warps 17-19, the
// splitters, build g = gy * act'(y) from those rows into the A layout
// (`ready`), zero outside [0, T_out), between batches and past P.  So no
// block-wide barrier runs between the stages.  The epilogue writes the
// span's gxpad to shared memory, sums the cluster's partials in rank order,
// folds the padding and stores gx (rounded to bf16 once, at the store).
constexpr int kSpanWG = 4;          // consumer warpgroups: a span's 64-column M tiles
constexpr int kSpanThreads = 640;   // the consumers, the producer and splitter warps
constexpr int kSpanC = 32;          // channels of a block: the products' N
constexpr int kSpanTaps = 2;        // taps of a wgmma group (each its own accumulator)
constexpr int kSpanMaxStages = 4;   // stages in flight
constexpr int kSpanProducer = 4 * kSpanWG;  // the producer's warp
constexpr int kSpanSplitters = 96;  // the splitters: the three warps after it
// bytes of a tap's weight plane: 8 rows p x 32 channels in TF32, or 16 rows
// p x 32 channels in bf16
constexpr int kTapPlane = 1024;
constexpr int kSpanSlots = 128 + 2 * kTapPlane;  // barriers, zero planes, then the stages

// A stage's rows p (a k-step of the products) and weight planes a tap.
template <typename T>
struct SpanStep {
  static constexpr int kRowsP = sizeof(T) == 2 ? 16 : 8;
  static constexpr int kPlanes = sizeof(T) == 2 ? 1 : 2;
};

struct DgradSpanLayout {
  int off, gw, gl, stages;  // g's halo (a phase's taps - 1), staged columns, g's row pitch
                            // (4-byte words, 8 mod 32), stages in flight
  size_t wbytes, raw, slot, total;  // a stage's weight planes, its rows of gy and y, a
                                    // stage, the block (bytes)
};

// A stage: the K taps' weight planes, then gy's and y's rows of the stage
// (a span's window, gw columns a row from a 16-byte granule on; or each
// batch's rows one after the other, t_ld values a row, which never takes
// more), then g in the A layout (f32: big and small planes of 8 rows, bf16:
// 8 rows of pairs of rows p), gw columns a row.  `esz` is the element's
// bytes (4: f32, 2: bf16).  The shared memory depends on K, stride, span and
// the element only, never on T_in or the batch.  As many stages as fit a
// block, at most kSpanMaxStages; the epilogue's gxpad (32 x span floats)
// reuses them.
__host__ __device__ inline DgradSpanLayout dgrad_span_layout(int K, int stride, int span,
                                                             int esz) {
  DgradSpanLayout L;
  const int gran = 16 / esz, rows_p = esz == 2 ? 16 : 8, planes = esz == 2 ? 1 : 2;
  L.off = (K + stride - 1) / stride - 1;
  L.gw = (L.off + span / stride + 2 * gran - 2) / gran * gran;
  L.gl = L.gw + (40 - L.gw % 32) % 32;
  L.wbytes = size_t(K) * planes * kTapPlane;
  L.raw = size_t(2) * rows_p * L.gw * esz;
  L.slot = (L.wbytes + L.raw + size_t(planes) * 8 * L.gl * 4 + 127) & ~size_t(127);
  const size_t fit = (size_t(kMaxSmem) - kSpanSlots) / L.slot;
  L.stages = static_cast<int>(fit < size_t(kSpanMaxStages) ? fit : kSpanMaxStages);
  L.total = kSpanSlots + size_t(L.stages) * L.slot;
  return L;
}

// The M rows (columns v) a batch's padded row takes in each stride phase of
// a span of whole rows: its widest phase, and at least T_out + off, so that
// the off zeros ahead of the next batch's g stay between them.
__host__ __device__ inline int dgrad_span_period(int T_in, int K, int T_out, int stride,
                                                 int padding) {
  const int V0 = (T_in + 2 * padding + stride - 1) / stride;
  const int tail = T_out + (K + stride - 1) / stride - 1;
  return V0 > tail ? V0 : tail;
}

// How much narrower than `span` the first span is: under reflect, enough
// that the last span holds the row's last 2*padding + 1 columns (the first
// span holds its first ones as long as span - shift > 2*padding).
__host__ __device__ inline int dgrad_span_shift(int Tp, int span, int stride, int padding,
                                                int reflect) {
  const int n0 = (Tp + span - 1) / span, last = Tp - (n0 - 1) * span;
  if (!reflect || padding == 0 || n0 < 2 || last > 2 * padding) return 0;
  return (2 * padding + 1 - last + stride - 1) / stride * stride;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// d = A (64 x 8, tf32, in registers, as wgmma_rs_tf32's) * B (8 x 32, tf32,
// K-major in shared memory) + (acc ? d : 0); d[i]: row 16w + lane/4 (+8 if
// i&2), column 8*(i/4) + 2*(lane%4) + (i&1).
__device__ __forceinline__ void wgmma_rs_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d = A (64 x 16, bf16, in registers) * B (16 x 32, bf16, K-major in shared
// memory) + (acc ? d : 0).  Warp w of the warpgroup holds A's rows
// 16w..16w+15, two bf16 a register (the lower k in the low half): a[0] row
// lane/4, k 2*(lane%4) and + 1; a[1] row lane/4 + 8; a[2], a[3] the same
// rows at k + 8.  d as wgmma_rs_tf32_n32's.
__device__ __forceinline__ void wgmma_rs_bf16_n32(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// N values of T from shared memory at p as floats: 4 f32 (16-byte
// aligned), 4 bf16 (8-byte aligned) or 8 bf16 (16-byte aligned), one load.
template <int N, typename T>
__device__ __forceinline__ void load_vals(float (&v)[N], const T* p) {
  if constexpr (sizeof(T) == 4) {
    static_assert(N == 4, "four f32 a load");
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    static_assert(N == 4 || N == 8, "four or eight bf16 a load");
    uint32_t w[N / 2];
    if constexpr (N == 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    } else {
      const uint2 a = *reinterpret_cast<const uint2*>(p);
      w[0] = a.x, w[1] = a.y;
    }
#pragma unroll
    for (int q = 0; q < N / 2; ++q)
      v[2 * q] = __uint_as_float(w[q] << 16), v[2 * q + 1] = __uint_as_float(w[q] & 0xFFFF0000u);
  }
}

// One stage's products of a consumer warpgroup's M tile: kSpanTaps taps m
// at a time, each tap's products (f32: small*big, big*small, big*big; bf16:
// one) into its own accumulator, one wgmma group; then the group's sums are
// added to sum in f32 in tap order.  Branch-free: mtaps is a multiple of
// kSpanTaps, a phase's taps past K read the zero planes (their A at the
// last tap, `last`).  g: the stage's g (f32: the big plane, the small plane
// 8 rows on; bf16: the pairs of rows p); acol: the tile's A column at tap 0
// for the lane's row; kph: its phase (tap k = kph + stride*m); w: the
// stage's weight planes (tap k's at w + k * planes * kTapPlane, f32's small
// plane kTapPlane after its big), zero: planes of zeros.
template <typename T>
__device__ __forceinline__ void span_stage_products(float (&sum)[16], const uint32_t* g, int gl,
                                                    int acol, int kph, uint32_t w, uint32_t zero,
                                                    int stride, int K, int mtaps, int last) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr uint32_t kTapBytes = SpanStep<T>::kPlanes * kTapPlane;
  const int tig = threadIdx.x & 3;
#pragma unroll 1
  for (int m0 = 0; m0 < mtaps; m0 += kSpanTaps) {
    float acc[kSpanTaps][16];
    uint32_t ab[kSpanTaps][4], as[kSpanTaps][4];
#pragma unroll
    for (int t = 0; t < kSpanTaps; ++t) {
      const int o = tig * gl + acol - min(m0 + t, last);
      ab[t][0] = g[o];
      ab[t][1] = g[o + 8];
      ab[t][2] = g[o + 4 * gl];
      ab[t][3] = g[o + 4 * gl + 8];
      if constexpr (!kBf16) {
        as[t][0] = g[8 * gl + o];
        as[t][1] = g[8 * gl + o + 8];
        as[t][2] = g[8 * gl + o + 4 * gl];
        as[t][3] = g[8 * gl + o + 4 * gl + 8];
      }
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < kSpanTaps; ++t) {
      const int k = kph + stride * (m0 + t);
      const uint32_t big = k < K ? w + k * kTapBytes : zero;
      if constexpr (kBf16) {
        wgmma_rs_bf16_n32(acc[t], ab[t], gmma_desc(big), 0);
      } else {
        wgmma_rs_tf32_n32(acc[t], as[t], gmma_desc(big), 0);
        wgmma_rs_tf32_n32(acc[t], ab[t], gmma_desc(big + kTapPlane), 1);
        wgmma_rs_tf32_n32(acc[t], ab[t], gmma_desc(big), 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < kSpanTaps; ++t) {
      fence_acc(acc[t]);
#pragma unroll
      for (int r = 0; r < 16; ++r) sum[r] += acc[t][r];
    }
  }
}

// gx (B x C x T_in) of the group of chunks blockIdx.x and, where nbb > 0,
// the whole padded rows of the nbb batches of batch group blockIdx.y (gpw
// groups a window), else (nbb 0) of batch blockIdx.y / nspans's span
// blockIdx.y % nspans; B is a window's batches (window b / B reads its own
// packing of wpk, an entry a live row tile of a group).
template <typename T>
__global__ void __launch_bounds__(kSpanThreads, 1)
dgrad_span_kernel(const T* __restrict__ gy, const T* __restrict__ y,
                  const T* __restrict__ wpk, const int* __restrict__ span_start,
                  const int* __restrict__ span_row, T* __restrict__ gx, int B, int C,
                  int T_in, int P, int T_out, int t_ld, int K, int stride, int padding,
                  int reflect, float slope, int span, int nspans, int nbb, int gpw) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kKS = SpanStep<T>::kRowsP;  // rows p of a stage
  constexpr int kTile = kRows / kKS;        // stages of a row tile
  constexpr int kGran = 16 / sizeof(T);     // values of a 16-byte granule
  count_run(&g_runs[0]);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const DgradSpanLayout L = dgrad_span_layout(K, stride, span, sizeof(T));
  const int S = L.stages;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [S]: a stage's copies landed
  uint64_t* ready = full + kSpanMaxStages;              // [S]: its g is built
  uint64_t* empty = ready + kSpanMaxStages;             // [S]: both warpgroups are done with it
  float* zero = reinterpret_cast<float*>(smem + 128);   // big and small planes of zeros
  unsigned char* slots = smem + kSpanSlots;              // [S][weight planes, gy, y, g]
  float* out_s = reinterpret_cast<float*>(slots);       // [32][span] gxpad, at the end

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int group = blockIdx.x, c0 = group * kSpanC;
  const int cw = min(kSpanC, C - c0);  // 32, or fewer for a last group
  const int Tp = T_in + 2 * padding;
  const bool rows = nbb > 0;
  const int R = dgrad_span_period(T_in, K, T_out, stride, padding);
  // the block's batches [b0, b0 + nbl) of window `win`, and its span
  // [u0, u0 + width) of their padded rows (g's staged column 0 is t = tb0)
  int win, b0, nbl, u0, width, t0, tb0;
  if (rows) {
    const int yg = static_cast<int>(blockIdx.y);
    win = yg / gpw;
    b0 = win * B + (yg - win * gpw) * nbb;
    nbl = min(nbb, (win + 1) * B - b0);
    u0 = 0, width = Tp, t0 = 0, tb0 = -L.off;
  } else {
    b0 = static_cast<int>(blockIdx.y) / nspans;
    const int sp = static_cast<int>(blockIdx.y) - b0 * nspans;
    const int shift = dgrad_span_shift(Tp, span, stride, padding, reflect);
    win = b0 / B, nbl = 1;
    u0 = sp == 0 ? 0 : sp * span - shift;
    width = min(Tp, (sp + 1) * span - shift) - u0;
    t0 = u0 / stride;
    tb0 = (t0 - L.off) & ~(kGran - 1);  // the granule holding g's column t0 - off
  }
  const int entries = span_start[gridDim.x];  // a window's packing
  const int first = span_start[group];
  const int live = span_start[group + 1] - first;
  auto entry = [&](int j) { return first + j; };
  auto ksteps = [&](int j) { return min(kTile, (P - span_row[entry(j)] * kRows + kKS - 1) / kKS); };
  // the group's stages in order (its live row tiles, each one k-step at a
  // time), a contiguous run of them a cluster rank: the ranks' runs differ
  // by one stage at most, so a split may exceed the live row tiles
  int total = 0;
  for (int j = 0; j < live; ++j) total += ksteps(j);
  const int s_lo = total * rank / split, n_stages = total * (rank + 1) / split - s_lo;
  struct Cursor {
    int j, ks;
  };
  auto start = [&]() {  // the rank's first stage
    Cursor c = {0, s_lo};
    while (c.j < live && c.ks >= ksteps(c.j)) c.ks -= ksteps(c.j++);
    return c;
  };
  auto next = [&](Cursor& c) {
    if (++c.ks == ksteps(c.j)) ++c.j, c.ks = 0;
  };
  auto slot_of = [&](int i) { return slots + size_t(i % S) * L.slot; };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(ready + s), kSpanSplitters);
      mbar_init(smem_addr(empty + s), 4 * kSpanWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int q = tid; q < 2 * kTapPlane / 4; q += kSpanThreads) zero[q] = 0.f;
  if (rows)  // g's columns that no batch's row lands on stay zeros through the stages
    for (int q = tid; q < S * SpanStep<T>::kPlanes * 8 * L.gl; q += kSpanThreads) {
      const int s = q / (SpanStep<T>::kPlanes * 8 * L.gl);
      reinterpret_cast<uint32_t*>(slots + size_t(s) * L.slot + L.wbytes +
                                  L.raw)[q - s * SpanStep<T>::kPlanes * 8 * L.gl] = 0u;
    }
  fence_async();  // the zero planes before the products read them
  __syncthreads();

  if (warp == kSpanProducer) {
    // the producer: stage i's copies into its slot, the first S at once,
    // then each as soon as the stage S before it is released: the weight
    // planes, and gy's and y's rows (a span's window of each row, or each
    // batch's rows of the stage as one run)
    const int lo = max(tb0, 0), hi = min(t_ld, tb0 + L.gw);
    const uint32_t row_bytes = hi > lo ? (hi - lo) * sizeof(T) : 0;
    const int per = rows ? nbl : kKS;  // copies of gy (and of y) a stage, at most
    Cursor c = start();
    for (int i = 0; i < n_stages; ++i, next(c)) {
      if (i >= S) mbar_wait(smem_addr(empty + i % S), (i / S - 1) & 1);
      const int p0 = span_row[entry(c.j)] * kRows + c.ks * kKS, nrows = min(kKS, P - p0);
      unsigned char* dst = slot_of(i);
      T* raw = reinterpret_cast<T*>(dst + L.wbytes);
      uint64_t* bar = full + i % S;
      const uint32_t bytes = rows ? nbl * nrows * t_ld * sizeof(T) : nrows * row_bytes;
      if (lane == 0) mbar_expect(smem_addr(bar), L.wbytes + 2 * bytes);
      fence_async();  // the stage's reads by the block come before these writes
      for (int q = lane; q <= 2 * per; q += 32) {
        if (q == 0) {
          bulk_copy(dst,
                    reinterpret_cast<const unsigned char*>(wpk) +
                        ((size_t(win) * entries + entry(c.j)) * kTile + c.ks) * L.wbytes,
                    L.wbytes, bar);
          continue;
        }
        const int which = (q - 1) / per, r = q - 1 - which * per;
        const T* src = which ? y : gy;
        T* to = raw + which * kKS * L.gw;
        if (rows)
          bulk_copy(to + r * kKS * t_ld, src + (size_t(b0 + r) * P + p0) * t_ld,
                    nrows * t_ld * sizeof(T), bar);
        else if (r < nrows && row_bytes > 0)
          bulk_copy(to + r * L.gw + lo - tb0, src + (size_t(b0) * P + p0 + r) * t_ld + lo,
                    row_bytes, bar);
      }
    }
  } else if (warp > kSpanProducer) {
    // the splitters: g = gy * act'(y) from the stage's rows into the A
    // layout, zero past P.  Spans of one batch's row: four columns of g a
    // thread at a time, zeros outside [0, T_out).  Whole rows: each batch's
    // T_out columns of g, a 16-byte granule of its row at a time (g's other
    // columns, zeros between the batches, were written before the stages).
    const int q0 = tid - (kSpanProducer + 1) * 32;
    Cursor c = start();
    for (int i = 0; i < n_stages; ++i, next(c)) {
      mbar_wait(smem_addr(full + i % S), (i / S) & 1);
      const int nrows = min(kKS, P - span_row[entry(c.j)] * kRows - c.ks * kKS);
      const T* gys = reinterpret_cast<const T*>(slot_of(i) + L.wbytes);
      const T* ys = gys + kKS * L.gw;
      uint32_t* gw = reinterpret_cast<uint32_t*>(slot_of(i) + L.wbytes + L.raw);
      if (rows) {
        const int ng = t_ld / kGran, per_row = nbl * ng;
        for (int e = q0; e < 8 * per_row; e += kSpanSplitters) {
          const int r = e / per_row, rem = e - r * per_row, bb = rem / ng;
          const int t = (rem - bb * ng) * kGran, dst = r * L.gl + L.off + bb * R + t;
          if constexpr (kBf16) {
            // g's pair row r: rows p 2r and 2r + 1 of batch bb
            const int o = (bb * kKS + 2 * r) * t_ld + t;
            float a0[kGran], a1[kGran], y0[kGran], y1[kGran];
            load_vals(a0, gys + o);
            load_vals(a1, gys + o + t_ld);
            load_vals(y0, ys + o);
            load_vals(y1, ys + o + t_ld);
#pragma unroll
            for (int q = 0; q < kGran; ++q)
              if (t + q < T_out)
                gw[dst + q] = pack_bf16(2 * r < nrows ? act_grad(a0[q], y0[q], slope) : 0.f,
                                        2 * r + 1 < nrows ? act_grad(a1[q], y1[q], slope) : 0.f);
          } else {
            const int o = (bb * kKS + r) * t_ld + t;
            float a[kGran], yv[kGran];
            load_vals(a, gys + o);
            load_vals(yv, ys + o);
#pragma unroll
            for (int q = 0; q < kGran; ++q)
              if (t + q < T_out) {
                const float2 sp = split_tf32(r < nrows ? act_grad(a[q], yv[q], slope) : 0.f);
                gw[dst + q] = __float_as_uint(sp.x);
                gw[8 * L.gl + dst + q] = __float_as_uint(sp.y);
              }
          }
        }
      } else {
        const int n4 = L.gw / 4;
        uint4* g4 = reinterpret_cast<uint4*>(gw);
#pragma unroll 2
        for (int e = q0; e < 8 * n4; e += kSpanSplitters) {
          const int r = e / n4, j0 = 4 * (e - r * n4), t = tb0 + j0;  // g's row r, column t..
          uint32_t v[4], sm[4];
          if constexpr (kBf16) {
            const int o = 2 * r * L.gw + j0;
            float a0[4], a1[4], y0[4], y1[4];
            load_vals(a0, gys + o);
            load_vals(a1, gys + o + L.gw);
            load_vals(y0, ys + o);
            load_vals(y1, ys + o + L.gw);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const bool in = t + q >= 0 && t + q < T_out;
              v[q] = pack_bf16(in && 2 * r < nrows ? act_grad(a0[q], y0[q], slope) : 0.f,
                               in && 2 * r + 1 < nrows ? act_grad(a1[q], y1[q], slope) : 0.f);
            }
          } else {
            const int o = r * L.gw + j0;
            float a[4], yv[4];
            load_vals(a, gys + o);
            load_vals(yv, ys + o);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const bool in = r < nrows && t + q >= 0 && t + q < T_out;
              const float2 sp = split_tf32(in ? act_grad(a[q], yv[q], slope) : 0.f);
              v[q] = __float_as_uint(sp.x), sm[q] = __float_as_uint(sp.y);
            }
          }
          g4[(r * L.gl + j0) / 4] = make_uint4(v[0], v[1], v[2], v[3]);
          if constexpr (!kBf16)
            g4[((8 + r) * L.gl + j0) / 4] = make_uint4(sm[0], sm[1], sm[2], sm[3]);
        }
      }
      mbar_arrive(smem_addr(ready + i % S));
    }
  }

  // The consumers' M tiles: warpgroup wg's is tile wg of the span's stride
  // * (span / (64 * stride)) tiles, phase wg / mt, 64 columns v from 64 *
  // (wg % mt); a tile past the phase's columns (the span's width, or the
  // batches' periods) is idle.
  const int wg = warp >> 2, w4 = warp & 3;
  const int mt = span / (64 * stride), phi = wg / mt;
  const int kph = phi < stride ? phi : 0, v0 = 64 * (wg - phi * mt);
  const int nv = rows ? nbl * R : (width - phi + stride - 1) / stride;
  const bool active = warp < 4 * kSpanWG && phi < stride && v0 < nv;
  float sum[16] = {};
  if (warp < 4 * kSpanWG) {
    const int mtaps = (L.off + kSpanTaps) / kSpanTaps * kSpanTaps;  // a phase's taps, padded
    const int acol = t0 - tb0 + v0 + 16 * w4 + gid;
    for (int i = 0; i < n_stages; ++i) {
      unsigned char* st = slot_of(i);
      mbar_wait(smem_addr(ready + i % S), (i / S) & 1);
      if (active)
        span_stage_products<T>(sum, reinterpret_cast<const uint32_t*>(st + L.wbytes + L.raw),
                               L.gl, acol, kph, smem_addr(st), smem_addr(zero), stride, K,
                               mtaps, L.off);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(empty + i % S));
    }
  }
  __syncthreads();  // every stage is consumed: the slots take gxpad

  // gxpad of the span's columns -> out_s (a batch's padded row at bb * Tp);
  // a block alone in its cluster skips the cluster barriers
  if (active) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int v = v0 + 16 * w4 + gid + 8 * ((r >> 1) & 1);
      const int ch = 8 * (r >> 2) + 2 * tig + (r & 1);
      const int bb = rows ? v / R : 0, u = stride * (v - bb * R) + kph;
      if (bb < nbl && u < width) out_s[ch * span + bb * Tp + u] = sum[r];
    }
  }
  if (split > 1)
    cluster.sync();  // every block's partial gxpad is in its shared memory
  else
    __syncthreads();
  {
    const float* parts[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      parts[q] = q == rank ? out_s : cluster.map_shared_rank(out_s, min(q, split - 1));
    auto column = [&](int row, int u) {  // summed over the cluster in rank order
      float s = parts[0][row + u - u0];
#pragma unroll
      for (int q = 1; q < kMaxSplit; ++q)
        if (q < split) s += parts[q][row + u - u0];
      return s;
    };
    // each batch's x columns whose padded column i + padding lies in the
    // span, with their reflected columns (in the same span, by the plan)
    const int i_lo = max(0, u0 - padding), i_hi = min(T_in, u0 + width - padding);
    const int ncols = max(0, i_hi - i_lo), n_el = cw * nbl * ncols;
    const int lo = n_el * rank / split, hi = n_el * (rank + 1) / split;
    for (int el = lo + tid; el < hi; el += kSpanThreads) {
      const int c = el / (nbl * ncols), rem = el - c * (nbl * ncols);
      const int bb = rem / ncols, i = i_lo + rem - bb * ncols, row = c * span + bb * Tp;
      float v = column(row, i + padding);
      if (reflect && i >= 1 && i <= padding) v += column(row, padding - i);
      if (reflect && i <= T_in - 2 && i >= T_in - 1 - padding)
        v += column(row, padding + 2 * (T_in - 1) - i);
      gx[(size_t(b0 + bb) * C + c0 + c) * T_in + i] = from_f<T>(v);
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its span's gxpad
}

// The folded weight (windows x (P, C, K)) as dgrad_span_kernel<T> reads it
// (dgrad_span_pack in hm_vae_torch/ops/fused_conv_pool.py, whose plain
// version this is): for each window, entry e (row tile span_row[e] of the
// group of 32 channels span_group[e]), k-step of a stage's rows p and tap,
// the planes of a stage's rows p x 32 channels in wgmma's K-major
// core-matrix order (channels in fours of 8, then half of the rows p, then
// the channel, then the rows p of the half); f32, the TF32 rounding and the
// remainder rounded to TF32 (ties away from zero, as the plain version's
// integer arithmetic rounds), bf16 the values.  Rows past P and channels
// past C are zeros.  A block lays out one k-step of one entry: it reads the
// rows p of the group's 32 channels, each one contiguous run of 32 * K
// values, into shared memory and writes the k-step's K taps' planes, one
// contiguous run: one pass, read and written once.  It replaces eight
// plain PyTorch passes a call.
template <typename T>
__global__ void __launch_bounds__(256)
dgrad_span_pack_kernel(const T* __restrict__ w, const int* __restrict__ span_row,
                       const int* __restrict__ span_group, T* __restrict__ out, int P, int C,
                       int K, int entries) {
  constexpr int kKS = SpanStep<T>::kRowsP, kPlanes = SpanStep<T>::kPlanes;
  constexpr int kPV = kTapPlane / sizeof(T);  // values of a plane
  constexpr int kHalf = kKS / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // [kKS][32 * K + pad]: rows p, then (channel, tap)
  const int n = kSpanC * K, pitch = n + 4 / static_cast<int>(sizeof(T));
  const int e = static_cast<int>(blockIdx.x) / (kRows / kKS);
  const int ks = static_cast<int>(blockIdx.x) - e * (kRows / kKS);
  const int win = static_cast<int>(blockIdx.y);
  const int p0 = span_row[e] * kRows + ks * kKS, c0 = span_group[e] * kSpanC;
  const int nc = min(kSpanC, C - c0) * K;  // the row's values past which channels are zeros
  // kLoads loads of a thread in flight at a time (a loop of one load and
  // its store waits out each load's latency)
  constexpr int kLoads = 8;
  for (int q0 = threadIdx.x; q0 < kKS * n; q0 += kLoads * blockDim.x) {
    T v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = q0 + u * blockDim.x, r = q / n, j = q - r * n;
      v[u] = q < kKS * n && p0 + r < P && j < nc
                 ? w[(size_t(win) * P + p0 + r) * C * K + size_t(c0) * K + j]
                 : from_f<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = q0 + u * blockDim.x, r = q / n;
      if (q < kKS * n) tile[r * pitch + q - r * n] = v[u];
    }
  }
  __syncthreads();
  T* o = out + ((size_t(win) * entries + e) * (kRows / kKS) + ks) * K * kPlanes * kPV;
  // a thread writes the kHalf rows p of one channel (16 bytes) at a time
  for (int gq = threadIdx.x; gq < K * kPlanes * kPV / kHalf; gq += blockDim.x) {
    const int q = gq * kHalf;
    const int k = q / (kPlanes * kPV), rem = q - k * (kPlanes * kPV);
    const int plane = rem / kPV, i = rem - plane * kPV;
    const int cc = (i / kHalf) % 8, half = (i / (8 * kHalf)) % 2, c8 = i / (16 * kHalf);
    const T* src = tile + half * kHalf * pitch + (c8 * 8 + cc) * K + k;
    alignas(16) T vals[kHalf];
#pragma unroll
    for (int pr = 0; pr < kHalf; ++pr) {
      const T v = src[pr * pitch];
      if constexpr (sizeof(T) == 2) {
        vals[pr] = v;
      } else {
        auto tf32 = [](float a) { return __int_as_float((__float_as_int(a) + 0x1000) & -0x2000); };
        const float big = tf32(v);
        vals[pr] = plane ? tf32(v - big) : big;
      }
    }
    *reinterpret_cast<uint4*>(o + q) = *reinterpret_cast<const uint4*>(vals);
  }
}

// ---------------------------------------------------------------------------
// wgrad

struct WgradLayout {
  int Lh, rsx;       // x: a stride phase's padded columns, the row stride (f32: 8-byte words,
                     // bf16: values)
  int ks, rj;        // k-steps of a stage; a row of the gradient tile: (c, k), the bias, pad
  int nb_max, slots;  // the most batches of a block; stages of gy and y in flight
  size_t bars, xp, g, gf, total;  // byte offsets in shared memory
};

// x's raw rows wait in the fragment buffer until x is padded; the partial
// gradient tile reuses the stages at the end.  Two stages of gy and y are
// in flight where the block still fits two to an SM, else one.  `esz` is
// the element's bytes: 4 (f32: x's padded columns as TF32 big + small, a
// k-step 8 columns, a lane's A fragments big + small) or 2 (bf16: x's
// values, a k-step 16 columns, one 16-byte A fragment a lane); the partial
// gradient tile is f32 either way.
__host__ __device__ inline WgradLayout wgrad_layout(int B, int T_in, int K, int T_out, int t_ld,
                                                    int stride, int sb, int split, int esz) {
  WgradLayout L;
  L.nb_max = (B + split - 1) / split;
  const int n_st = (L.nb_max + sb - 1) / sb;
  const int Lx = (T_out - 1) * stride + K;  // padded columns the taps read
  L.Lh = (Lx + stride - 1) / stride;
  L.rsx = esz == 4 ? frag_stride(stride * L.Lh) : half_stride(stride * L.Lh);
  const int kw = esz == 4 ? 8 : 16;  // columns of a k-step
  L.ks = (sb * T_out + kw - 1) / kw;
  L.rj = kCC * K + 4;  // 16-byte rows
  L.bars = 0;
  L.xp = 64;
  L.g = L.xp + align16(size_t(L.nb_max) * kCC * L.rsx * (esz == 4 ? 8 : 2));
  const size_t stage = align16(size_t(2) * sb * kRows * t_ld * esz);
  const size_t gf = size_t(L.ks) * 4 * 32 * (esz == 4 ? 32 : 16);
  const size_t x_raw = size_t(L.nb_max) * kCC * T_in * esz;
  const size_t red = size_t(kRows) * L.rj * 4;
  for (L.slots = n_st < kStages ? n_st : kStages;; --L.slots) {
    L.gf = L.g + L.slots * stage;
    L.total = L.gf + (gf > x_raw ? gf : x_raw);
    if (L.total < L.g + red) L.total = L.g + red;
    if (L.slots == 1 || L.total <= kSmemPerSM / 2 - 1024) break;
  }
  return L;
}

// One k-step (8 (b, t) columns) of a warp's NQ gradient tiles: B is x at the
// lane's two columns, xp[xb[h] + koff] (the tap's padded column), or ones
// for the bias tile; A the g fragments of the k-step.  3xTF32, each kind over
// all 4*NQ independent tiles before the next; the k-step's sum (24 products)
// is added in f32.
template <int NQ>
__device__ __forceinline__ void wgrad_kstep(float (&sum)[4][NQ][4], const float2* xp,
                                            const float4* gf, const int (&xb)[2],
                                            const int (&koff)[NQ], int ks, int K, int warp,
                                            int lane) {
  const int gid = lane >> 2;
  uint32_t bbig[NQ][2], bsml[NQ][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      const int q = warp + kWarps * qq;
      const float2 v = q < K ? xp[xb[h] + koff[qq]]
                             : make_float2(gid == 0 ? 1.f : 0.f, 0.f);  // the bias: ones
      bbig[qq][h] = __float_as_uint(v.x);
      bsml[qq][h] = __float_as_uint(v.y);
    }
  }
  uint32_t ab[4][4], as[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4 hi = gf[((ks * 4 + a) * 32 + lane) * 2];
    const float4 lo = gf[((ks * 4 + a) * 32 + lane) * 2 + 1];
    ab[a][0] = __float_as_uint(hi.x), ab[a][1] = __float_as_uint(hi.y);
    ab[a][2] = __float_as_uint(hi.z), ab[a][3] = __float_as_uint(hi.w);
    as[a][0] = __float_as_uint(lo.x), as[a][1] = __float_as_uint(lo.y);
    as[a][2] = __float_as_uint(lo.z), as[a][3] = __float_as_uint(lo.w);
  }
  float acc[4][NQ][4] = {};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      if (warp + kWarps * qq <= K) mma_tf32(acc[a][qq], as[a], bbig[qq]);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      if (warp + kWarps * qq <= K) mma_tf32(acc[a][qq], ab[a], bsml[qq]);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      if (warp + kWarps * qq <= K) mma_tf32(acc[a][qq], ab[a], bbig[qq]);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[a][qq][r] += acc[a][qq][r];
}

// wgrad_kstep in bf16: one k-step of 16 (b, t) columns.  B is x at the
// lane's columns 2*tig, 2*tig + 1, 8 + 2*tig, 9 + 2*tig of the k-step
// (xh[xb[i] + koff], two values a register), or ones for the bias tile; A
// the g fragments (one 16-byte load a row tile).  One bf16 product a tile,
// its sum added in f32.
template <int NQ>
__device__ __forceinline__ void wgrad_kstep_bf16(float (&sum)[4][NQ][4], const __nv_bfloat16* xh,
                                                 const uint4* gh, const int (&xb)[4],
                                                 const int (&koff)[NQ], int ks, int K, int warp,
                                                 int lane) {
  const int gid = lane >> 2;
  uint32_t b[NQ][2];
#pragma unroll
  for (int qq = 0; qq < NQ; ++qq) {
    const int q = warp + kWarps * qq;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b[qq][h] = q < K ? pack_bf16(xh[xb[2 * h] + koff[qq]], xh[xb[2 * h + 1] + koff[qq]])
                       : (gid == 0 ? 0x3F803F80u : 0u);  // the bias: ones (bf16 1.0 twice)
  }
  uint32_t a[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint4 f = gh[(ks * 4 + t) * 32 + lane];
    a[t][0] = f.x, a[t][1] = f.y, a[t][2] = f.z, a[t][3] = f.w;
  }
  float acc[4][NQ][4] = {};
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      if (warp + kWarps * qq <= K) mma_bf16(acc[t][qq], a[t], b[qq]);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[t][qq][r] += acc[t][qq][r];
}

// Block `rank` sums its rows of the cluster's partial gradient tiles
// red[p][c*K + k] (bias at 8*K) in rank order and stores them, four values
// at a time (row p's chunk is 8*K contiguous values of gw; T float or
// __nv_bfloat16, rounded once here).  A block alone in its cluster skips
// the cluster barriers.  The caller has written its tile.
template <typename T>
__device__ __forceinline__ void wgrad_reduce(float* red, int rj, cg::cluster_group& cluster,
                                             int rank, int split, bool has_x, bool writes_bias,
                                             int nrows, int p0, int c0, int C, int K,
                                             T* gw_w, T* gb_w) {
  const int tid = threadIdx.x;
  if (split > 1)
    cluster.sync();  // every block's partial tile is in its shared memory
  else
    __syncthreads();
  const float* part[kMaxSplit];
#pragma unroll
  for (int q = 0; q < kMaxSplit; ++q)
    part[q] = q == rank ? red : cluster.map_shared_rank(red, min(q, split - 1));
  const int r_lo = nrows * rank / split, r_hi = nrows * (rank + 1) / split;
  const int row4 = kCC * K / 4;  // 16-byte groups of a row's (c, k)
  for (int el = r_lo * row4 + tid; has_x && el < r_hi * row4; el += kThreads) {
    const int r = el / row4, j4 = el - r * row4;
    const int o = r * rj + 4 * j4;
    float4 v = *reinterpret_cast<const float4*>(part[0] + o);
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q) {
      if (q >= split) break;
      const float4 w = *reinterpret_cast<const float4*>(part[q] + o);
      v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
    }
    T* dst = gw_w + (size_t(p0 + r) * C + c0) * K + 4 * j4;
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                  *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
  if (writes_bias && tid < r_hi - r_lo) {
    const int o = (r_lo + tid) * rj + kCC * K;
    float v = part[0][o];
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q)
      if (q < split) v += part[q][o];
    gb_w[p0 + r_lo + tid] = from_f<T>(v);
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its partial tile
}

// The block's partial gradient tile (wgrad_kstep's sums) -> red, over
// shared memory no longer read, then wgrad_reduce.  The caller has
// synchronised the block.
template <int NQ, typename T>
__device__ __forceinline__ void wgrad_store(const float (&sum)[4][NQ][4], float* red, int rj,
                                            cg::cluster_group& cluster, int rank, int split,
                                            bool has_x, bool writes_bias, int nrows, int p0,
                                            int c0, int C, int K, T* gw_w, T* gb_w) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      const int q = warp + kWarps * qq;
      if (q > K) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = a * 16 + gid + ((r & 2) ? 8 : 0), c = 2 * tig + (r & 1);
        if (q < K)
          red[p * rj + c * K + q] = sum[a][qq][r];
        else if (c == 0)
          red[p * rj + kCC * K] = sum[a][qq][r];
      }
    }
  wgrad_reduce(red, rj, cluster, rank, split, has_x, writes_bias, nrows, p0, c0, C, K, gw_w,
               gb_w);
}

// The padded column u of x's row `row` (batch b, channel c0 + row): x under
// the padding (reflect without edge repeat, or zeros), 0 past the padded row.
template <typename T>
__device__ __forceinline__ float padded_x(const T* row, int u, int T_in, int padding,
                                          int reflect) {
  int s = u - padding;
  if ((s < 0 || s >= T_in) && u < T_in + 2 * padding)
    s = reflect ? (s < 0 ? -s : 2 * (T_in - 1) - s) : -1;
  return s >= 0 && s < T_in ? to_f(row[s]) : 0.f;
}

// NQ: 8-column tiles of the gradient (taps, then the bias) per warp; T float
// or __nv_bfloat16 (gy, y, x, gw, gb)
template <int NQ, typename T>
__global__ void __launch_bounds__(kThreads, NQ == 2 ? 2 : 1)
wgrad_kernel(const T* __restrict__ gy, const T* __restrict__ y,
             const T* __restrict__ x, const int* __restrict__ wrow,
             const int* __restrict__ wchunk, T* __restrict__ gw, T* __restrict__ gb,
             int B, int C, int T_in, int K, int P, int T_out, int t_ld, int stride, int padding,
             int reflect, float slope, int sb) {
  constexpr bool kBf16 = sizeof(T) == 2;
  count_run(&g_runs[1]);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const WgradLayout L = wgrad_layout(B, T_in, K, T_out, t_ld, stride, sb, split, sizeof(T));

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // x, then [slots]
  float2* xp = reinterpret_cast<float2*>(smem + L.xp);           // f32: [nb_max][8][rsx]
  T* xh = reinterpret_cast<T*>(smem + L.xp);                     // bf16: [nb_max][8][rsx]
  T* g_s = reinterpret_cast<T*>(smem + L.g);                     // [slots][2][sb][64][t_ld]
  float4* gf = reinterpret_cast<float4*>(smem + L.gf);           // f32: [ks][4][32][2]
  uint4* gh = reinterpret_cast<uint4*>(smem + L.gf);             // bf16: [ks][4][32]
  T* x_s = reinterpret_cast<T*>(smem + L.gf);                    // [nb_max][8][T_in], first
  float* red = reinterpret_cast<float*>(smem + L.g);             // [64][rj], last

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int e = blockIdx.y;
  const int rt = wrow[e], chunk = wchunk[e];
  const bool has_x = chunk >= 0;
  const bool writes_bias = e == 0 || wrow[e - 1] != rt;
  const int p0 = rt * kRows, nrows = min(kRows, P - p0);
  const int c0 = has_x ? chunk * kCC : 0;
  // window blockIdx.z: its batches [z*B, (z+1)*B), split over the cluster,
  // and its own gradient
  const int win = static_cast<int>(blockIdx.z);
  const int b_lo = win * B + B * rank / split;
  const int nb = B * (rank + 1) / split - B * rank / split;
  T* gw_w = gw + size_t(win) * P * C * K;
  T* gb_w = gb + size_t(win) * P;
  const int n_st = (nb + sb - 1) / sb;
  const int gt = sb * kRows * t_ld;  // values of gy (or y) in a stage
  const size_t stage_values = (L.gf - L.g) / sizeof(T) / L.slots;

  // Stage i into `slot`: batches b_lo + i*sb .. of gy and y, rows p0.. (one
  // contiguous run per batch and tensor).  Thread 0 issues.
  auto issue = [&](int i, int slot) {
    const int nbs = min(sb, nb - i * sb);
    const uint32_t bytes = nrows * t_ld * sizeof(T);
    T* dst = g_s + slot * stage_values;
    mbar_expect(smem_addr(bars + 1 + slot), 2 * nbs * bytes);
    for (int bb = 0; bb < nbs; ++bb) {
      const size_t src = (size_t(b_lo + i * sb + bb) * P + p0) * t_ld;
      bulk_copy(dst + bb * kRows * t_ld, gy + src, bytes, bars + 1 + slot);
      bulk_copy(dst + gt + bb * kRows * t_ld, y + src, bytes, bars + 1 + slot);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < 1 + kStages; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (has_x) {
      const uint32_t bytes = kCC * T_in * sizeof(T);
      mbar_expect(smem_addr(bars), nb * bytes);
      for (int bb = 0; bb < nb; ++bb)
        bulk_copy(x_s + bb * kCC * T_in, x + (size_t(b_lo + bb) * C + c0) * T_in, bytes, bars);
    }
    for (int i = 0; i < L.slots && i < n_st; ++i) issue(i, i);
  }
  __syncthreads();

  // x's rows, padded in time and split by stride phase: padded column
  // u = w*stride + ph at ph*Lh + w, so tap k of column t reads
  // (k % stride)*Lh + k/stride + t
  if (has_x) mbar_wait(smem_addr(bars), 0);
  for (int q = tid; q < nb * kCC * stride * L.Lh; q += kThreads) {
    const int row = q / (stride * L.Lh), idx = q - row * (stride * L.Lh);
    const int ph = idx / L.Lh, u = (idx - ph * L.Lh) * stride + ph;
    const float v = has_x ? padded_x(x_s + row * T_in, u, T_in, padding, reflect) : 0.f;
    if constexpr (kBf16)
      xh[row * L.rsx + idx] = from_f<T>(v);
    else
      xp[row * L.rsx + idx] = split_tf32(v);
  }

  // This warp's tiles: q = warp + 8*qq, tap q (q < K) or the bias (q == K).
  float sum[4][NQ][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[a][qq][r] = 0.f;
  int koff[NQ];
#pragma unroll
  for (int qq = 0; qq < NQ; ++qq) {
    const int q = warp + kWarps * qq;
    koff[qq] = (q % stride) * L.Lh + q / stride;
  }

  for (int i = 0; i < n_st; ++i) {
    const int slot = i % L.slots;
    __syncthreads();  // x is padded (x_s is read); the previous fragments are read
    mbar_wait(smem_addr(bars + 1 + slot), (i / L.slots) & 1);
    const int nbs = min(sb, nb - i * sb), ncols = nbs * T_out;
    // g = gy * act'(y) in the A fragments' order: a thread writes one
    // lane's values of one k-step and row tile; f32: rows r, r + 8 at
    // columns n, n + 4, split, as a 16-byte big and a 16-byte small part;
    // bf16: rows r, r + 8 at columns n, n + 1, n + 8, n + 9, rounded, as 16
    // bytes
    const T* gys = g_s + slot * stage_values;
    if constexpr (kBf16) {
      for (int it = tid; it < L.ks * 4 * 32; it += kThreads) {
        const int ln = it & 31, mt = (it >> 5) & 3, ks = it >> 7;
        const int r0 = mt * 16 + (ln >> 2), n0 = ks * 16 + 2 * (ln & 3);
        float v[8];  // register 2h + lo: row r0 + 8*lo, columns n0 + 8*h, + 1
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * h + e;
            const int bb = n / T_out, t = n - bb * T_out;
#pragma unroll
            for (int lo = 0; lo < 2; ++lo) {
              const int r = r0 + 8 * lo;
              const int o = (bb * kRows + r) * t_ld + t;
              v[2 * (2 * h + lo) + e] =
                  n < ncols && r < nrows ? act_grad(to_f(gys[o]), to_f(gys[gt + o]), slope) : 0.f;
            }
          }
        gh[it] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                            pack_bf16(v[6], v[7]));
      }
    } else {
      for (int it = tid; it < L.ks * 4 * 32; it += kThreads) {
        const int ln = it & 31, mt = (it >> 5) & 3, ks = it >> 7;
        const int r0 = mt * 16 + (ln >> 2), n0 = ks * 8 + (ln & 3);
        float v[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 4 * h;
          const int bb = n / T_out, t = n - bb * T_out;
#pragma unroll
          for (int lo = 0; lo < 2; ++lo) {
            const int r = r0 + 8 * lo;
            const int o = (bb * kRows + r) * t_ld + t;
            v[2 * h + lo] =
                n < ncols && r < nrows ? act_grad(to_f(gys[o]), to_f(gys[gt + o]), slope) : 0.f;
          }
        }
        float4 hi, lo;
        float* hv = reinterpret_cast<float*>(&hi);
        float* lv = reinterpret_cast<float*>(&lo);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 s = split_tf32(v[q]);
          hv[q] = s.x;
          lv[q] = s.y;
        }
        gf[2 * it] = hi;
        gf[2 * it + 1] = lo;
      }
    }
    __syncthreads();  // the fragments are staged; the stage's copies are read
    if (tid == 0 && i + L.slots < n_st) {  // the next copy overlaps the products
      fence_async();
      issue(i + L.slots, slot);
    }

    for (int ks = 0; ks < L.ks; ++ks) {
      if constexpr (kBf16) {
        // B: x at the lane's columns n = 16*ks + 2*tig (+1, +8, +9), as in f32
        int xc[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int n = ks * 16 + 2 * tig + (h & 1) + 8 * (h >> 1);
          const int bb = n < ncols ? n / T_out : 0, t = n < ncols ? n - bb * T_out : 0;
          xc[h] = ((i * sb + bb) * kCC + gid) * L.rsx + t;
        }
        wgrad_kstep_bf16<NQ>(sum, xh, gh, xc, koff, ks, K, warp, lane);
      } else {
        // B: x at the lane's two columns n = 8*ks + tig (+4); padded columns
        // past the stage read column 0 (their g is zero)
        int xb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = ks * 8 + tig + 4 * h;
          const int bb = n < ncols ? n / T_out : 0, t = n < ncols ? n - bb * T_out : 0;
          xb[h] = ((i * sb + bb) * kCC + gid) * L.rsx + t;
        }
        wgrad_kstep<NQ>(sum, xp, gf, xb, koff, ks, K, warp, lane);
      }
    }
  }

  __syncthreads();
  wgrad_store<NQ>(sum, red, L.rj, cluster, rank, split, has_x, writes_bias, nrows, p0, c0, C, K,
                  gw_w, gb_w);
}

// wgrad over items: a block's reduction over the (b, t) columns runs item by
// item (a window's items split over the cluster in contiguous runs), its
// shared memory independent of the batch.  An item is one of two things,
// each its own instantiation (kRowsMode), so that neither's loop carries the
// other's code:
// - one batch's `span` output columns: rows of any length, the shared
//   memory independent of T too.  Its operands arrive by bulk copies: gy's
//   and y's 64 rows of the row tile over the item's columns as 2D tensor
//   copies, one box of a chunk's columns each (128-byte swizzle, so that a
//   warp reading 8 rows at one column hits 32 banks; one copy a row had
//   cost a block ~4 us an item in copy issue, PERF.md), and x's 8 channel
//   rows over the unpadded window the item's taps read (the padding
//   resolved: reflect folds padded columns back into the row), widened to
//   16-byte granules, one bulk copy a row;
// - the whole rows of nbb batches of a window (the short rows of a large
//   batch, K <= 15), where one batch's T_out columns would fill a fraction
//   of an item and the item's fixed costs (its copies' wait, x's build, a
//   chunk's barrier) would buy little work.  Its columns are the batches'
//   T_out columns in turn, as many batches as fill `span` columns where the
//   block fits (in bf16: two blocks an SM).  gy's and y's rows p0.. of the
//   nbb batches, and their x's 8 channel rows, arrive as three 3D tensor
//   boxes, several short rows merged into a box row (box_merge: the copy
//   engine moves a box row at a time, and 16-byte rows had cost a block's
//   prologue ~4 us, PERF.md).  x is padded batch by batch with a period of
//   R = T_out + off columns a stride phase (off = ceil(K / stride) - 1, the
//   taps' reach) through a table of a batch's padded columns, so that a
//   tap's read of a batch's column stays in that batch's padded row: item
//   column n of batch bb = n / T_out reads x's column n + bb * (R - T_out)
//   at the tap's offset.  A k-step may hold columns of two batches: their
//   sum is the same.
// Two items' copies are in flight on their stages' barriers, issued by warp
// 0.  The block pads x by stride phase (two buffers; f32 split into TF32
// big + small, bf16 as it is), and builds g = gy * act'(y) a chunk at a
// time (4 k-steps: 32 columns in f32, 64 in bf16; rounded to bf16 once, as
// the plain version rounds it) into the products' B tile (two buffers: f32
// as TF32 big and small planes, bf16 one plane).  The products are wgmma
// with the gradient transposed: rows (tap, channel) = x's taps read into
// registers (bf16: two columns a register), columns p = the chunk's g
// tile; f32 three m64n64k8 a k-step (3xTF32), bf16 one m64n64k16.  The
// warps issue one chunk's products, build the next chunk (with the next
// item's x at an item's first chunk) while they run, then wait for them;
// one __syncthreads a chunk orders both.  f32 adds a chunk's sums in f32,
// so that no tensor-core sum runs longer than a chunk (sums kept in the
// tensor cores over whole items gave 17x the error of its 1e-4 gate,
// PERF.md); bf16 keeps the block's sums in the tensor cores' f32
// accumulators over all its items (held at its 0.02 * max|ref| gate, the
// same bits every run), which frees the registers for two blocks an SM, at
// one m64 tile a warpgroup (K <= 15) and at two (K <= 31: 64 accumulator
// registers a thread).  At the trajectory's short K-31 rows a block's items
// are a serial chain (copy wait, x's and g's builds, the refill's issue,
// products: a third of it, PERF.md), so a second block on the SM runs its
// chain beside the first's.
// An item's stage takes the copies of the item kSpanStages on as soon as
// its last chunk is built.  The partial tiles are summed in rank order
// (wgrad_reduce): the same bits every run.
constexpr int kSpanCols = 128;         // the widest item (WGRAD_SPAN_COLS)
constexpr int kSpanStages = 2;         // items whose copies are in flight
constexpr int kBox = kRows * 128;      // bytes of a box of gy or y: 64 rows of a chunk's 128 bytes
constexpr int kChunkPlane = 4 * 2048;  // bytes of a chunk's B plane: 4 k-steps of 64 rows p

// A chunk of an item: 4 k-steps of the products and a box row of 128
// bytes, so 32 columns in f32 (k-steps of 8; TF32 big and small B planes)
// and 64 in bf16 (k-steps of 16; one plane); X, a padded value of x as the
// products' A reads it: f32 its TF32 big and small parts, bf16 itself.
template <typename T>
struct ItemStep;
template <>
struct ItemStep<float> {
  static constexpr int kChunk = 32, kPlanes = 2;
  using X = float2;
  static __device__ __forceinline__ X x(float v) { return split_tf32(v); }
};
template <>
struct ItemStep<__nv_bfloat16> {
  static constexpr int kChunk = 64, kPlanes = 1;
  using X = __nv_bfloat16;
  static __device__ __forceinline__ X x(float v) { return __float2bfloat16_rn(v); }
};

struct WgradSpanLayout {
  int R;            // several batches' rows: a batch's columns of a stride phase in x (else 0)
  int Lh, rsx, rj;  // x: a stride phase's padded columns, a row (elements); a gradient row
  int xr;           // a staged row of x's window, or a batch's staged x rows (elements)
  size_t gbytes;    // gy's part of a stage (y's follows, then x's)
  size_t stage, st, xs, bt, tab, red, total;  // a stage's bytes; byte offsets in shared memory
};

// A stage: gy's part, then y's, then x's.  One batch's columns: span /
// chunk boxes each, then x's 8 rows of the window, which never holds more
// than the (span - 1)*stride + K padded columns its taps read (reflected
// columns lie inside the direct ones) and a granule less one a side.
// Several batches' rows (nbb > 1): a 3D box of each, nbb batches' (at most)
// 64 rows of t_ld values, then their 8 channel rows of x.  The stages
// start at the first 1024-byte boundary past the barriers (the swizzle's
// period); st is the furthest that can be.  Then x's padded rows, two
// buffers (f32: a value's TF32 big and small parts, 8 bytes; rows 4 mod 16
// of them apart; bf16: rows 8 mod 64 values apart, one more for the second
// value of a register's pair), so that a warp's A loads spread over the
// banks; the B tiles, two; and (nbb > 1) the padding's table,
// an int2 a padded column of a batch.  The partial gradient tile reuses the
// stages at the end.  `esz`: the element's bytes (4 f32, 2 bf16).
__host__ __device__ inline WgradSpanLayout wgrad_span_layout(int K, int stride, int span, int esz,
                                                             int nbb, int T_in, int T_out,
                                                             int t_ld) {
  WgradSpanLayout L;
  const int gran = 16 / esz, chunk = 128 / esz, planes = esz == 4 ? 2 : 1;
  size_t raw;
  if (nbb > 1) {
    L.R = T_out + (K + stride - 1) / stride - 1;
    L.Lh = nbb * L.R;
    L.xr = kCC * T_in;
    L.gbytes = size_t(nbb) * kRows * t_ld * esz;
    raw = 2 * L.gbytes + size_t(nbb) * L.xr * esz;
  } else {
    const int Lx = (span - 1) * stride + K;  // padded columns of an item's taps
    L.R = 0;
    L.Lh = (Lx + stride - 1) / stride;
    L.xr = (Lx + 3 * gran - 3) / gran * gran;
    L.gbytes = size_t(span / chunk) * kBox;
    raw = 2 * L.gbytes + size_t(kCC) * L.xr * esz;
  }
  const int len = stride * L.Lh;
  L.rsx = esz == 4 ? frag_stride(len) : half_stride(len + 1);
  L.rj = kCC * K + 4;
  L.stage = (raw + 1023) & ~size_t(1023);
  L.st = 64 + 1024;
  L.xs = L.st + kSpanStages * L.stage;
  L.bt = L.xs + align16(size_t(2) * kCC * L.rsx * (esz == 4 ? 8 : 2));
  L.tab = L.bt + size_t(2) * planes * kChunkPlane;
  const size_t tab_end = L.tab + (nbb > 1 ? size_t(stride) * L.R * 8 : 0);
  L.red = 64;
  const size_t red_end = L.red + size_t(kRows) * L.rj * 4;
  L.total = tab_end > red_end ? tab_end : red_end;
  return L;
}

// The columns [lo, hi] of x's unpadded row that the output columns
// [t_lo, t_lo + nt) read, the padding resolved (hi < lo: none).
__device__ __forceinline__ void span_window(int t_lo, int nt, int T_in, int K, int stride,
                                            int padding, int reflect, int& lo, int& hi) {
  const int s0 = t_lo * stride - padding, s1 = s0 + (nt - 1) * stride + K - 1;
  lo = max(s0, 0);
  hi = min(s1, T_in - 1);
  if (lo > hi) lo = T_in, hi = -1;
  if (reflect && s0 < 0) lo = min(lo, -min(s1, -1)), hi = max(hi, -s0);
  if (reflect && s1 >= T_in)
    lo = min(lo, 2 * T_in - 2 - s1), hi = max(hi, 2 * T_in - 2 - max(s0, T_in));
}

// Rows of a (batches, rows, cols) tensor that a 3D copy of several
// batches' rows merges into one row of its box: the most of 8, 4, 2 or 1
// that divide `rows` and `box_rows` and keep a box row within the copy
// engine's 256 values.  A row of gy, y or x here is 16-128 bytes, and the
// engine moves a box row at a time: merged, it moves 8x fewer, 8x longer.
__host__ __device__ inline int box_merge(int cols, int rows, int box_rows) {
  int m = 8;
  while (m > 1 && (m * cols > 256 || rows % m != 0 || box_rows % m != 0)) m >>= 1;
  return m;
}

// d = A (64 x 16, bf16, in registers, as wgmma_rs_bf16_n32's) * B (16 x 64,
// bf16, K-major in shared memory) + (acc ? d : 0); d as wgmma_rs_tf32's.
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HMVAE_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HMVAE_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// NT m64 tiles of (tap, channel) rows a warpgroup: 1 up to K = 15, 2 up to
// 31; T float or __nv_bfloat16 (gy, y, x, gw, gb); kRowsMode: items of
// several batches' whole rows (nbb of them, NT 1: at K <= 15), else of one
// batch's span output columns (x_map unread; nbb 1).  The two forms are
// instantiations apart: the loop's code of one stays as small as it was.
template <int NT, typename T, bool kRowsMode>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
wgrad_span_kernel(const __grid_constant__ CUtensorMap gy_map,
                  const __grid_constant__ CUtensorMap y_map,
                  const __grid_constant__ CUtensorMap x_map, const T* __restrict__ gy,
                  const T* __restrict__ y, const T* __restrict__ x,
                  const int* __restrict__ wrow, const int* __restrict__ wchunk,
                  T* __restrict__ gw, T* __restrict__ gb, int B, int C, int T_in, int K, int P,
                  int T_out, int t_ld, int stride, int padding, int reflect, float slope,
                  int span, int nbb) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kChunk = ItemStep<T>::kChunk, kPlanes = ItemStep<T>::kPlanes;
  using X = typename ItemStep<T>::X;
  constexpr int kGran = 16 / sizeof(T);  // values of a 16-byte granule
  count_run(&g_runs[1]);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  constexpr bool rows = kRowsMode;
  static_assert(!rows || NT == 1, "items of several batches' rows at K <= 15");
  const WgradSpanLayout L =
      wgrad_span_layout(K, stride, span, sizeof(T), nbb, T_in, T_out, t_ld);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kSpanStages]
  // [kSpanStages]: gy, y (one batch's columns: [span / kChunk][64 rows][128
  // bytes] swizzled; several batches' rows: [nbb][64 rows][t_ld]), then x
  unsigned char* st = smem + (((smem_addr(smem) + 64 + 1023) & ~1023u) - smem_addr(smem));
  X* xs = reinterpret_cast<X*>(smem + L.xs);            // [2][8][rsx]
  unsigned char* bt = smem + L.bt;                      // [2][kPlanes][kChunkPlane]
  int2* tab = reinterpret_cast<int2*>(smem + L.tab);    // [stride * R]
  float* red = reinterpret_cast<float*>(smem + L.red);  // [64][rj], last

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int e = blockIdx.y;
  const int rt = wrow[e], chunk = wchunk[e];
  const bool has_x = chunk >= 0;
  const bool writes_bias = e == 0 || wrow[e - 1] != rt;
  const int p0 = rt * kRows, nrows = min(kRows, P - p0);
  const int c0 = has_x ? chunk * kCC : 0;
  const int win = static_cast<int>(blockIdx.z);
  T* gw_w = gw + size_t(win) * P * C * K;
  T* gb_w = gb + size_t(win) * P;
  const int rows_b = min(kRows, P);  // several batches' rows: a batch's rows in a stage
  const int nch = rows ? 1 : (T_out + span - 1) / span;
  const int items = (rows ? (B + nbb - 1) / nbb : B) * nch;
  const int it_lo = items * rank / split, n_items = items * (rank + 1) / split - it_lo;
  // several batches' rows: item column n is batch (n * mag) >> 16's (exact
  // for n < span <= 128 and T_out <= 64), x's column n + gap * that batch
  const int mag = rows ? (65536 + T_out - 1) / T_out : 0;
  const int gap = rows ? L.R - T_out : 0;

  // The block's item i: its first batch b0 and batches nbl, first output
  // column t_lo; returns its columns.
  auto item_of = [&](int i, int& b0, int& nbl, int& t_lo) {
    const int item = it_lo + i;
    if (rows) {
      b0 = win * B + item * nbb;
      nbl = min(nbb, B - item * nbb);
      t_lo = 0;
      return nbl * T_out;
    }
    b0 = win * B + item / nch;
    nbl = 1;
    t_lo = (item % nch) * span;
    return min(span, T_out - t_lo);
  };
  auto chunks = [&](int i) {
    int b0, nbl, t_lo;
    return (item_of(i, b0, nbl, t_lo) + kChunk - 1) / kChunk;
  };

  // Item i's copies into stage `slot`, by warp 0's lanes.  One batch's
  // columns: the boxes of gy and y over the item's columns (rows past the
  // tile or the tensor are masked or zero-filled, columns past T_out
  // masked), x's rows from the granule holding the window's first column.
  // Several batches' rows: three 3D boxes, nbb batches' rows_b rows of gy
  // and of y and their x's 8 channel rows, rows merged by box_merge
  // (batches past the tensor zero-filled; those past the item's unread).
  auto issue = [&](int i, int slot) {
    int b0, nbl, t_lo;
    const int nt = item_of(i, b0, nbl, t_lo);
    unsigned char* dst = st + slot * L.stage;
    if (rows) {
      if (lane == 0) {
        const uint32_t gbox = nbb * rows_b * t_ld * sizeof(T);
        mbar_expect(smem_addr(bars + slot), 2 * gbox + (has_x ? nbb * kCC * T_in * sizeof(T) : 0));
        fence_async();  // the stage's reads by the block come before these writes
        const int mg = box_merge(t_ld, P, rows_b), mx = box_merge(T_in, C, kCC);
        tensor_copy3(dst, &gy_map, 0, p0 / mg, b0, bars + slot);
        tensor_copy3(dst + L.gbytes, &y_map, 0, p0 / mg, b0, bars + slot);
        if (has_x) tensor_copy3(dst + 2 * L.gbytes, &x_map, 0, c0 / mx, b0, bars + slot);
      }
      return;
    }
    const int nbox = (nt + kChunk - 1) / kChunk, boxes = span / kChunk;
    int lo, hi;
    span_window(t_lo, nt, T_in, K, stride, padding, reflect, lo, hi);
    uint32_t x_bytes = 0;
    size_t g0 = 0;
    if (has_x && lane < kCC && hi >= lo) {
      const size_t e0 = (size_t(b0) * C + c0 + lane) * T_in + lo;
      g0 = e0 / kGran;
      x_bytes = static_cast<uint32_t>((e0 + hi - lo) / kGran - g0 + 1) * 16;
    }
    const uint32_t bytes = 2 * nbox * kBox + __reduce_add_sync(0xffffffffu, x_bytes);
    if (lane == 0) mbar_expect(smem_addr(bars + slot), bytes);
    fence_async();  // the stage's reads by the block come before these writes
    if (lane < 2 * nbox) {
      const int which = lane >= nbox, jb = lane - which * nbox;
      tensor_copy(dst + (which * boxes + jb) * kBox, which ? &y_map : &gy_map,
                  t_lo + jb * kChunk, b0 * P + p0, bars + slot);
    }
    if (x_bytes > 0)
      bulk_copy(dst + 2 * L.gbytes + lane * L.xr * sizeof(T), x + g0 * kGran, x_bytes,
                bars + slot);
  };
  // Once item i's chunk j is built: after its last, its stage takes the
  // item kSpanStages on.  The block has synchronised.
  auto refill = [&](int i, int j) {
    if (warp == 0 && j == chunks(i) - 1 && i + kSpanStages < n_items)
      issue(i + kSpanStages, i % kSpanStages);
  };

  // Item i's x, padded and split by stride phase as wgrad_kernel splits
  // whole rows, into buffer i & 1.  One batch's columns: the item's padded
  // column u at [row][(u % stride)*Lh + u/stride]; zeros under a zero
  // padding and past the window (columns whose g is zero).  Several
  // batches' rows: batch bb's padded column u at [row][bb*R + tab[u].x],
  // x's column tab[u].y of its staged row (-1: a zero).
  auto build_x = [&](int i) {
    int b0, nbl, t_lo;
    const int nt = item_of(i, b0, nbl, t_lo);
    const T* xraw = reinterpret_cast<const T*>(st + (i % kSpanStages) * L.stage + 2 * L.gbytes);
    X* xo = xs + (i & 1) * kCC * L.rsx;
    if (rows) {
      // q / U as a multiply-high (exact for q < 2^32 / U)
      const uint32_t U = stride * L.R, magic = static_cast<uint32_t>((0x100000000ull + U - 1) / U);
#pragma unroll 4
      for (uint32_t q = tid; q < nbl * kCC * U; q += kThreads) {
        const uint32_t row = __umulhi(q, magic), u = q - row * U;  // row: batch row / 8, channel
        const int2 tu = tab[u];
        const float v = has_x && tu.y >= 0 ? to_f(xraw[row * T_in + tu.y]) : 0.f;
        xo[(row & 7) * L.rsx + (row >> 3) * L.R + tu.x] = ItemStep<T>::x(v);
      }
      return;
    }
    int lo, hi;
    span_window(t_lo, nt, T_in, K, stride, padding, reflect, lo, hi);
    const int w = stride * L.Lh;
    for (int q = tid; q < kCC * w; q += kThreads) {
      const int row = q / w, idx = q - row * w;
      const int ph = idx / L.Lh, u = t_lo * stride + (idx - ph * L.Lh) * stride + ph;
      int s = u - padding;
      if (reflect && (s < 0 || s >= T_in) && u < T_in + 2 * padding)
        s = s < 0 ? -s : 2 * (T_in - 1) - s;
      float v = 0.f;
      if (has_x && s >= lo && s <= hi) {
        const int a = static_cast<int>(((size_t(b0) * C + c0 + row) * T_in + lo) % kGran);
        v = to_f(xraw[row * L.xr + s - lo + a]);
      }
      xo[row * L.rsx + idx] = ItemStep<T>::x(v);
    }
  };
  // Chunk j of item i's g = gy * act'(y) as the products' B operand in
  // buffer `buf`: 64 rows p x kChunk columns, K-major in 8x16-byte core
  // matrices (the two of a k-step 128 bytes apart, row groups 256 bytes
  // apart, k-steps 2 KB apart; f32: TF32 big, then small plane; bf16:
  // rounded once); zeros past the item's columns and the tile's rows.  A
  // thread takes two 16-byte groups of a row's chunk (4 f32 or 8 bf16
  // columns each), consecutive lanes consecutive rows: one batch's columns,
  // group grp of the box's row at grp ^ (row % 8) under the swizzle;
  // several batches' rows, group grp ^ (row % 8) of the chunk, so that 8
  // lanes' loads of rows t_ld apart spread over the banks.  build_g builds
  // group h of the two.
  // this thread's row of the B tile and its two groups of it, and their
  // places in the tile
  static_assert(kRows * 8 == 2 * kThreads, "two 16-byte groups of the B tile a thread");
  const int br = tid % kRows;
  int bgrp[2], boff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gp = tid / kRows + 4 * h;
    bgrp[h] = rows ? gp ^ (br & 7) : gp;
    boff[h] = (bgrp[h] >> 1) * 2048 + (bgrp[h] & 1) * 128 + (br >> 3) * 256 + (br & 7) * 16;
  }
  auto build_g = [&](int i, int j, int buf, int h) {
    int b0, nbl, t_lo;
    const int nt = item_of(i, b0, nbl, t_lo);
    const unsigned char* sg = st + (i % kSpanStages) * L.stage;
    const int grp = bgrp[h], r = br;
    const int n = j * kChunk + kGran * grp;  // the group's first column of the item
    float gv[kGran], yv[kGran];
#pragma unroll
    for (int q2 = 0; q2 < kGran; ++q2) gv[q2] = yv[q2] = 0.f;
    if (r < nrows && n < nt) {
      if (!rows) {
        const int o = j * kBox + r * 128 + ((grp ^ (r & 7)) << 4);
        load_vals<kGran>(gv, reinterpret_cast<const T*>(sg + o));
        load_vals<kGran>(yv, reinterpret_cast<const T*>(sg + L.gbytes + o));
      } else if (T_out % kGran == 0) {  // the group lies in one batch's row
        const int bb = (n * mag) >> 16;
        const size_t o = (size_t(bb * rows_b + r) * t_ld + n - bb * T_out) * sizeof(T);
        load_vals<kGran>(gv, reinterpret_cast<const T*>(sg + o));
        load_vals<kGran>(yv, reinterpret_cast<const T*>(sg + L.gbytes + o));
      } else {
#pragma unroll
        for (int q2 = 0; q2 < kGran; ++q2) {
          const int m = min(n + q2, nt - 1), bb = (m * mag) >> 16;
          const size_t o = size_t(bb * rows_b + r) * t_ld + m - bb * T_out;
          gv[q2] = to_f(reinterpret_cast<const T*>(sg)[o]);
          yv[q2] = to_f(reinterpret_cast<const T*>(sg + L.gbytes)[o]);
        }
      }
    }
    float v[kGran];
#pragma unroll
    for (int q2 = 0; q2 < kGran; ++q2)
      v[q2] = n + q2 < nt ? act_grad(gv[q2], yv[q2], slope) : 0.f;
    unsigned char* out = bt + buf * kPlanes * kChunkPlane + boff[h];
    if constexpr (kBf16) {
      *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                  pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else {
      float4 big, small;
      float* bv = reinterpret_cast<float*>(&big);
      float* sv = reinterpret_cast<float*>(&small);
#pragma unroll
      for (int q2 = 0; q2 < 4; ++q2) {
        const float2 sp = split_tf32(v[q2]);
        bv[q2] = sp.x;
        sv[q2] = sp.y;
      }
      *reinterpret_cast<float4*>(out) = big;
      *reinterpret_cast<float4*>(out + kChunkPlane) = small;
    }
  };

  // The products: gW^T (rows (k, c) = 8k + c, columns p) = X (rows (k, c),
  // the reduction over the item's columns) * g^T.  Warpgroup wg takes the NT
  // m64 tiles of taps 8*(wg*NT + mt) ..; its warp w the taps kb[mt] and
  // kb[mt] + 1 (A rows 16w + lane/4 and + 8, channel lane/4).  A is x at
  // the lane's columns, read from the x buffer into registers (the bias
  // tap: ones at channel 0; taps past it: zeros); B the chunk's g tile.
  const int wg = warp >> 2, w4 = warp & 3;
  int kb[NT], koff[NT][2];
#pragma unroll
  for (int mt = 0; mt < NT; ++mt) {
    kb[mt] = (wg * NT + mt) * 8 + 2 * w4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kb[mt] + h;
      koff[mt][h] = (k % stride) * L.Lh + k / stride;
    }
  }
  float acc[NT][32], sum[NT][32];
#pragma unroll
  for (int mt = 0; mt < NT; ++mt)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[mt][r] = sum[mt][r] = 0.f;
  // A at k-step ks of a chunk j whose item has `left` columns from the
  // chunk on, from x's rows xi (the lane's channel): f32, the big and small
  // parts at the lane's columns 8*ks + tig (+4); bf16, two columns 16*ks +
  // 2*tig, + 1 (and + 8, + 9) a register, the lower in the low half.
  // Columns past the item read column 0 (their g is zero).
  auto load_a = [&](uint32_t (&ab)[NT][4], uint32_t (&as)[NT][4], int left, int j, int ks,
                    const X* xi) {
    int col[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = kBf16 ? ks * 16 + 2 * tig + 8 * h2 : ks * 8 + tig + 4 * h2;
      const int n = j * kChunk + c;
      col[h2] = c < left ? n + gap * ((n * mag) >> 16) : 0;
    }
#pragma unroll
    for (int mt = 0; mt < NT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, k = kb[mt] + h;
        const X* p = xi + koff[mt][h] + col[q >> 1];
        if constexpr (kBf16) {
          ab[mt][q] = k < K ? pack_bf16(p[0], p[1]) : (k == K && gid == 0 ? 0x3F803F80u : 0u);
        } else {
          const float2 v = k < K ? p[0] : make_float2(k == K && gid == 0 ? 1.f : 0.f, 0.f);
          ab[mt][q] = __float_as_uint(v.x);
          as[mt][q] = __float_as_uint(v.y);
        }
      }
  };
  // Chunk c = (item i, chunk j) from B buffer `buf`: every k-step's
  // products issued (f32: small*big, big*small, big*big), the A registers
  // of one k-step loaded while the one before multiplies; the last k-step's
  // products are left in flight.
  auto issue_products = [&](int i, int j, int buf) {
    int b0, nbl, t_lo;
    const int left = item_of(i, b0, nbl, t_lo) - j * kChunk;
    const X* xi = xs + ((i & 1) * kCC + gid) * L.rsx;
    const uint32_t bb0 = smem_addr(bt + buf * kPlanes * kChunkPlane);
    uint32_t ab[2][NT][4], as[2][NT][4];
    load_a(ab[0], as[0], left, j, 0, xi);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int mt = 0; mt < NT; ++mt) {
        const uint32_t big = bb0 + ks * 2048;
        if constexpr (kBf16) {
          wgmma_rs_bf16(acc[mt], ab[ks & 1][mt], gmma_desc(big), 1);
        } else {
          wgmma_rs_tf32(acc[mt], as[ks & 1][mt], gmma_desc(big), ks > 0);
          wgmma_rs_tf32(acc[mt], ab[ks & 1][mt], gmma_desc(big + kChunkPlane), 1);
          wgmma_rs_tf32(acc[mt], ab[ks & 1][mt], gmma_desc(big), 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (ks + 1 < 4) {
        // the k-step before has finished: its A registers take the next one's
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        load_a(ab[(ks + 1) & 1], as[(ks + 1) & 1], left, j, ks + 1, xi);
      }
    }
  };
  // The chunk's products done; f32: their sums added in f32, so that no
  // tensor-core sum runs longer than a chunk (bf16 sums the block's items
  // in the tensor cores' f32 accumulators).
  auto finish_products = [&]() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      fence_acc(acc[mt]);
      if constexpr (!kBf16) {
#pragma unroll
        for (int r = 0; r < 32; ++r) sum[mt][r] += acc[mt][r];
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kSpanStages; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zeros past each x row's padded columns (the second value of the last
  // register pairs there; never written by a build)
  const int pad_x = L.rsx - stride * L.Lh;
  for (int q = tid; q < 2 * kCC * pad_x; q += kThreads)
    xs[(q / pad_x) * L.rsx + stride * L.Lh + q % pad_x] = ItemStep<T>::x(0.f);
  // several batches' rows: a batch's padded column u = w*stride + ph (w <
  // R) at ph*Lh + w of its x row, and the column of x it holds
  if (rows)
    for (int u = tid; u < stride * L.R; u += kThreads) {
      int s = u - padding;
      if (reflect && (s < 0 || s >= T_in) && u < T_in + 2 * padding)
        s = s < 0 ? -s : 2 * (T_in - 1) - s;
      tab[u] = make_int2((u % stride) * L.Lh + u / stride, s >= 0 && s < T_in ? s : -1);
    }
  __syncthreads();
  if (warp == 0)
    for (int i = 0; i < kSpanStages && i < n_items; ++i) issue(i, i);
  if (n_items > 0) {
    mbar_wait(smem_addr(bars), 0);
    build_x(0);
    build_g(0, 0, 0, 0);
    build_g(0, 0, 0, 1);
  }
  fence_async();    // the B tile's writes before the products read it
  __syncthreads();  // the first item's x and first chunk are staged
  if (n_items > 0) refill(0, 0);

  // Chunk c (item i, chunk j): the warps issue its products, build chunk
  // c + 1 (and, at an item's first chunk, its x) while they run, then add
  // their sums.
  int nc = n_items > 0 ? chunks(0) : 0;
#pragma unroll 1
  for (int i = 0, j = 0, c = 0; i < n_items; ++c) {
    int ni = i, nj = j + 1;
    if (nj == nc) ni = i + 1, nj = 0;
    const bool next = ni < n_items;
    issue_products(i, j, c & 1);
    if (next && nj == 0) {
      mbar_wait(smem_addr(bars + ni % kSpanStages), (ni / kSpanStages) & 1);
      build_x(ni);
    }
    if (next) {
      build_g(ni, nj, (c + 1) & 1, 0);
      build_g(ni, nj, (c + 1) & 1, 1);
    }
    fence_async();  // the B tile's writes before the products read it
    finish_products();
    __syncthreads();  // chunk c and its x are read; chunk c + 1 is staged
    if (next) refill(ni, nj);
    if (next && nj == 0) nc = chunks(ni);
    i = ni, j = nj;
  }

  // the partial tile -> red (over the stages, no longer read): gW[p, c, k]
  // at p*rj + c*K + k, the bias (tap K, channel 0) at p*rj + 8K
#pragma unroll
  for (int mt = 0; mt < NT; ++mt)
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int k = kb[mt] + ((r >> 1) & 1), p = 8 * (r >> 2) + 2 * tig + (r & 1);
      const float v = kBf16 ? acc[mt][r] : sum[mt][r];
      if (k < K)
        red[p * L.rj + gid * K + k] = v;
      else if (k == K && gid == 0)
        red[p * L.rj + kCC * K] = v;
    }
  wgrad_reduce(red, L.rj, cluster, rank, split, has_x, writes_bias, nrows, p0, c0, C, K, gw_w,
               gb_w);
}

// ---------------------------------------------------------------------------
// wgrad over many windows' short rows (the test-time solve)
//
// wgrad_tiles_kernel<T> (T float or __nv_bfloat16) replaces the same JAX
// autodiff as wgrad_kernel (hm_vae_tpu/models/hm_vae.py:200) under jax.vmap
// over the solve's windows (hm_vae_tpu/apps/latent_opt.py:423), where each
// window holds one or a few batches' short rows: the decoder levels at 10
// windows of one batch, T_out 8-64.  There a window's reduction is 8-64
// columns deep and each (window, live tile) is one small product, so the
// whole-row kernel's grid of one block a live tile and window (5,040 blocks
// at dec0, ~20 waves) ran a serial chain a block (barrier init, the copies'
// wait, g's build, 1-4 k-steps, the store) that made 15 KB of gradient
// (bf16), and its wrapper cleared the whole gradient first: ~0.5 TB/s.  What
// bounds the work on an H100 is the gradient's bytes, written once (97.8 MB
// of nonzeros in bf16 over the 4 levels, PERF.md), not the operations.
//
// The design: a persistent grid of min(units, SMs x blocks an SM) blocks; a
// unit is one (window, entry) of wgrad_row / wgrad_chunk, units in window
// then entry order, and each block walks a contiguous run of them
// (wgrad_tiles_run), so that a row tile's chunks come one after another and
// nothing of a window's reduction lies in another block: no cluster, no
// partial sums, the same bits every run.  A block stages the entries' lists
// and the padding's table (a padded column's place and source) in shared
// memory once; then per unit:
// - g = gy * act'(y) is built once per (window, row tile) into the
//   products' B tile (64 rows p x the window's columns, K-major core
//   matrices as the item kernel's; f32 TF32 big and small planes; bf16
//   rounded once, as the plain version rounds it) and serves every chunk of
//   the row tile; the next row tile's gy and y rows are bulk-copied as soon
//   as the stage is read, two B tiles alternate;
// - x's 8 channel rows of the unit's chunk for the window's batches arrive
//   by bulk copy two units ahead (two stages), and are padded in time
//   (reflect resolved) and split by stride phase into one of two buffers, a
//   batch's padded columns a period R apart (the item kernel's rows form),
//   while the unit before multiplies;
// - the products are wgmma with the gradient transposed (rows m, x's taps
//   as A in registers; columns p: the B tile), the rows in the output's
//   order, m = c*K + k, the bias the ones-row m = 8K, two m64 tiles, one a
//   warpgroup; the window's columns zero-padded to a k-step: bf16 one
//   m64n64k16 a k-step, sums in f32; f32 3xTF32, the sums added in f32
//   after each chunk of at most 4 k-steps (32 columns);
// - the epilogue rounds each value once into one of two output tiles in
//   shared memory (64 rows p x the chunk's 8K values, dense as the gradient
//   lies): bf16 by stmatrix, 8 rows m of a fragment transposed into 16
//   consecutive bytes of a row p (a store of 16-bit values a lane had cost
//   ~0.9 us a unit, the most of any phase; kernel_trace.py --windows),
//   f32 a value a lane; one thread stores the tile by a TMA tensor store
//   while the next unit's products run; warp 2 stores the tile's dead
//   chunks (between the row tile's live entries, after its last, or all of
//   a row tile with none) from a constant zero tile, the bias goes out once
//   per row tile, and another thread issues the copies (in bf16 a ninth
//   warp does the stores and the copies, so that no warpgroup's products
//   wait for them), so the kernel writes every element of every window's
//   (P, C, K) gradient exactly once and the wrapper clears nothing.
// Limits: K <= 15 ((K + 1) * 8 rows in the two m64 tiles), a window's
// columns nb * T_out <= kTilesCols, in bf16 T_out even where nb > 1 (a
// register pairs two columns of one batch).  Times beside the whole-row
// kernel and traces (kernel_trace.py --windows) are in PERF.md.
constexpr int kTilesCols = 64;          // a window's columns at most (WGRAD_TILES_COLS)
constexpr int kZeroRows = 16;           // rows of the zero tile (a box of the zero stores)
constexpr int kTilesMaxEntries = 2048;  // entries of wgrad_row staged (WGRAD_TILES_MAX_ENTRIES)
constexpr int kRefill = 32;             // the thread that issues the copies (warp 1's first)

__host__ __device__ __forceinline__ size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

struct WgradTilesLayout {
  int R, Lh, rsx;  // x: a batch's padded columns of a stride phase, a phase's, a row (elements)
  int ks;          // k-steps of the window's columns (8 f32 or 16 bf16 a step)
  size_t gbytes, xbytes, bplane;  // gy's part of the g stage; x's stage; a B plane
  size_t out, zero, graw, xraw, xs, bt, lists, tab, total;  // byte offsets in shared memory
};

// Barriers (g's copies, x's two stages), the two output tiles (64 rows of
// the chunk's 8K values, dense), the zero tile (kZeroRows such rows), the g
// stage (gy's rows p0.. of the window's nb batches, then y's), x's two
// stages (nb batches' 8 channel rows), x padded by stride phase (two
// buffers: f32 a value's TF32 big and small parts, 8 bytes, rows 4 mod 16
// of them apart; bf16 rows 8 mod 64 values apart, one more for the second
// value of the last register pair), the two B tiles (k-steps of 2 KB; f32
// a big plane, then a small one), the entries' lists (wgrad_row,
// wgrad_chunk: an int2 an entry) and the padding's table (an int2 a padded
// column of a batch).  `esz`: the element's bytes.
__host__ __device__ inline WgradTilesLayout wgrad_tiles_layout(int K, int stride, int nb,
                                                               int T_in, int T_out, int t_ld,
                                                               int entries, int esz) {
  WgradTilesLayout L;
  L.R = T_out + (K + stride - 1) / stride - 1;
  L.Lh = nb * L.R;
  const int len = stride * L.Lh;
  L.rsx = esz == 4 ? frag_stride(len) : half_stride(len + 1);
  const int kw = esz == 4 ? 8 : 16;
  L.ks = (nb * T_out + kw - 1) / kw;
  L.gbytes = size_t(nb) * kRows * t_ld * esz;
  L.xbytes = size_t(nb) * kCC * T_in * esz;
  L.bplane = size_t(L.ks) * 2048;
  L.out = 128;
  L.zero = L.out + 2 * align128(size_t(kRows) * kCC * K * esz);
  L.graw = L.zero + align128(size_t(kZeroRows) * kCC * K * esz);
  L.xraw = L.graw + align128(2 * L.gbytes);
  L.xs = L.xraw + 2 * align128(L.xbytes);
  L.bt = L.xs + align128(size_t(2) * kCC * L.rsx * (esz == 4 ? 8 : 2));
  L.lists = L.bt + 2 * (esz == 4 ? 2 : 1) * L.bplane;
  L.tab = L.lists + align128(size_t(entries) * 8);
  L.total = L.tab + align128(size_t(stride) * L.R * 8);
  return L;
}

// Block `blk` of `blocks`: the units [lo, hi) of `units`.
__host__ __device__ inline void wgrad_tiles_run(int units, int blocks, int blk, int& lo,
                                                int& hi) {
  lo = static_cast<int>(static_cast<long long>(units) * blk / blocks);
  hi = static_cast<int>(static_cast<long long>(units) * (blk + 1) / blocks);
}

// One box of a 3D tensor map from shared memory into global memory (a
// bulk-group store of this thread).
__device__ __forceinline__ void tensor_store3(const CUtensorMap* map, const void* src, int x0,
                                              int y0, int z0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(x0), "r"(y0), "r"(z0), "r"(smem_addr(src))
      : "memory");
}

// Four 8x8 matrices of 16-bit values, transposed, into shared memory: lane
// l's register v[i] holds row l/4, columns 2(l%4), +1 of matrix i (an mma
// fragment; the lower column in the low half); lane 8i + r gives the
// address (16-byte aligned) where column r of matrix i goes, 8 consecutive
// values (its rows).
__device__ __forceinline__ void stmatrix_trans(void* row, const uint32_t (&v)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_addr(row)),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's stores have read their shared memory (read) or are done.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// gw_map: the windows' gradients (windows, P, C*K), boxes of (8K, 64, 1);
// zero_map: the same tensor, boxes of (8K, kZeroRows, 1); nb batches a
// window; T float or __nv_bfloat16 (gy, y, x, the gradients).
template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 2 ? kThreads + 32 : kThreads, 2)
wgrad_tiles_kernel(const __grid_constant__ CUtensorMap gw_map,
                   const __grid_constant__ CUtensorMap zero_map, const T* __restrict__ gy,
                   const T* __restrict__ y, const T* __restrict__ x,
                   const int* __restrict__ wrow, const int* __restrict__ wchunk,
                   T* __restrict__ gb, int entries, int windows, int nb, int C, int T_in, int K,
                   int P, int T_out, int t_ld, int stride, int padding, int reflect,
                   float slope) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kPlanes = ItemStep<T>::kPlanes;
  constexpr int kGran = 16 / sizeof(T);  // values of a 16-byte granule
  using X = typename ItemStep<T>::X;
  count_run(&g_runs[1]);
  const WgradTilesLayout L =
      wgrad_tiles_layout(K, stride, nb, T_in, T_out, t_ld, entries, sizeof(T));

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);    // g's copies, x's two stages
  T* graw = reinterpret_cast<T*>(smem + L.graw);         // gy [nb][64][t_ld], then y
  T* xraw = reinterpret_cast<T*>(smem + L.xraw);         // [2][nb][8][T_in]
  X* xs = reinterpret_cast<X*>(smem + L.xs);             // [2][8][rsx]
  unsigned char* bt = smem + L.bt;                       // [2][kPlanes][ks][2 KB]
  int2* lists = reinterpret_cast<int2*>(smem + L.lists);  // [entries]: (row tile, chunk)
  int2* tab = reinterpret_cast<int2*>(smem + L.tab);      // [stride * R]
  const size_t x_stage = align128(L.xbytes) / sizeof(T);
  const size_t out_tile = align128(size_t(kRows) * kCC * K * sizeof(T));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // bf16: a ninth warp (the producer) issues the copies and the stores, off
  // the products' path (a warpgroup issues wgmma together, so a warp that
  // issued them held its warpgroup's products back); f32 keeps 256 threads
  // for its registers, thread 0 storing, warp 2 the zeros, kRefill the
  // copies.  The 256 threads of the warpgroups are the consumers.
  constexpr bool kProducer = kBf16;
  const bool consumer = tid < kThreads;
  constexpr int kStorer = kProducer ? kThreads : 0;
  constexpr int kIssuer = kProducer ? kThreads : kRefill;
  constexpr int kZeroWarp = kProducer ? kThreads / 32 : 2;
  int u_lo, u_hi;
  wgrad_tiles_run(entries * windows, gridDim.x, blockIdx.x, u_lo, u_hi);
  const int n = u_hi - u_lo;
  const int ncols = nb * T_out, nch = C / kCC, row_k = kCC * K;

  struct Unit {
    int win, e, rt, chunk;
  };
  // the lists, staged in the prologue: an entry's row tile and chunk
  auto unit = [&](int u) {
    Unit q;
    q.win = u / entries;
    q.e = u - q.win * entries;
    const int2 rc = lists[q.e];
    q.rt = rc.x;
    q.chunk = rc.y;
    return q;
  };
  // The first unit past u's (window, row tile): the window's first entry
  // past the row tile's (the row tiles ascend within a window).
  auto group_end = [&](int u) {
    const int win = u / entries, e = u - win * entries, rt = lists[e].x;
    int lo = e + 1, hi = entries;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lists[mid].x > rt)
        hi = mid;
      else
        lo = mid + 1;
    }
    return win * entries + lo;
  };
  // Thread kIssuer's copies: gy's and y's rows of unit q's row tile for its
  // window's batches into the g stage; unit i's (local) x rows, unit q's,
  // into stage i & 1 (a row tile with no live tile reads none).
  // the same from device memory, for the prologue's first copies (issued
  // while the block stages the lists)
  auto unit_dev = [&](int u) {
    Unit q;
    q.win = u / entries;
    q.e = u - q.win * entries;
    q.rt = wrow[q.e];
    q.chunk = wchunk[q.e];
    return q;
  };
  auto issue_g = [&](const Unit& q) {
    const int p0 = q.rt * kRows;
    const uint32_t bytes = min(kRows, P - p0) * t_ld * sizeof(T);
    mbar_expect(smem_addr(bars), 2 * nb * bytes);
    for (int bb = 0; bb < nb; ++bb) {
      const size_t src = (size_t(q.win) * nb + bb) * P * t_ld + size_t(p0) * t_ld;
      bulk_copy(graw + bb * kRows * t_ld, gy + src, bytes, bars);
      bulk_copy(graw + L.gbytes / sizeof(T) + bb * kRows * t_ld, y + src, bytes, bars);
    }
  };
  auto issue_x = [&](int i, const Unit& q) {
    uint64_t* bar = bars + 1 + (i & 1);
    const uint32_t bytes = q.chunk >= 0 ? kCC * T_in * sizeof(T) : 0;
    mbar_expect(smem_addr(bar), nb * bytes);
    if (bytes == 0) return;
    for (int bb = 0; bb < nb; ++bb)
      bulk_copy(xraw + (i & 1) * x_stage + bb * kCC * T_in,
                x + ((size_t(q.win) * nb + bb) * C + q.chunk * kCC) * T_in, bytes, bar);
  };

  // Unit u's g = gy * act'(y) into B tile `buf`: 64 rows p x the window's
  // columns (batch n / T_out's column n % T_out), K-major core matrices
  // (the two 16-byte halves of a k-step 128 bytes apart, row groups 256,
  // k-steps 2 KB); zeros past the columns and the tile's rows.  A thread
  // takes a 16-byte group of a row, consecutive threads consecutive rows,
  // each row's groups rotated by the row (so that 8 lanes reading rows t_ld
  // apart, read as 16-byte loads where a group lies in one batch's row,
  // and writing the tile's 16-byte slots spread over the banks).
  auto build_b = [&](int u, int buf) {
    const Unit q = unit(u);
    const int nrows = min(kRows, P - q.rt * kRows), ngrp = 2 * L.ks;
    unsigned char* bo = bt + buf * kPlanes * L.bplane;
    const T* gys = graw;
    const T* ys = graw + L.gbytes / sizeof(T);
    for (int it = tid; it < kRows * ngrp; it += kThreads) {
      const int r = it % kRows, grp = (it / kRows + r) % ngrp, c0 = grp * kGran;
      float gv[kGran], yv[kGran], v[kGran];
#pragma unroll
      for (int q2 = 0; q2 < kGran; ++q2) gv[q2] = yv[q2] = 0.f;
      if (r < nrows && c0 < ncols) {
        if (T_out % kGran == 0) {  // the group lies in one batch's row
          const int bb = nb == 1 ? 0 : c0 / T_out;
          const int o = (bb * kRows + r) * t_ld + c0 - bb * T_out;
          load_vals<kGran>(gv, gys + o);
          load_vals<kGran>(yv, ys + o);
        } else {
#pragma unroll
          for (int q2 = 0; q2 < kGran; ++q2) {
            const int c = min(c0 + q2, ncols - 1), bb = nb == 1 ? 0 : c / T_out;
            const int o = (bb * kRows + r) * t_ld + c - bb * T_out;
            gv[q2] = to_f(gys[o]);
            yv[q2] = to_f(ys[o]);
          }
        }
      }
#pragma unroll
      for (int q2 = 0; q2 < kGran; ++q2)
        v[q2] = c0 + q2 < ncols ? act_grad(gv[q2], yv[q2], slope) : 0.f;
      unsigned char* out = bo + (grp >> 1) * 2048 + (grp & 1) * 128 + (r >> 3) * 256 + (r & 7) * 16;
      if constexpr (kBf16) {
        *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      } else {
        float4 big, small;
        float* bv = reinterpret_cast<float*>(&big);
        float* sv = reinterpret_cast<float*>(&small);
#pragma unroll
        for (int q2 = 0; q2 < 4; ++q2) {
          const float2 sp = split_tf32(v[q2]);
          bv[q2] = sp.x;
          sv[q2] = sp.y;
        }
        *reinterpret_cast<float4*>(out) = big;
        *reinterpret_cast<float4*>(out + L.bplane) = small;
      }
    }
  };
  // Unit i's (local) x, padded and split by stride phase into buffer i & 1:
  // batch bb's padded column u = w*stride + ph at [row][ph*Lh + bb*R + w],
  // x's column tab[u].y of its staged row (-1: a zero, under a zero padding
  // or past the row), through the table of a batch's padded columns.
  const int U = stride * L.R;
  const uint32_t u_magic = static_cast<uint32_t>((0x100000000ull + U - 1) / U);
  auto build_x = [&](int i) {
    const bool has_x = unit(u_lo + i).chunk >= 0;
    const T* raw = xraw + (i & 1) * x_stage;
    X* xo = xs + (i & 1) * kCC * L.rsx;
    for (uint32_t q = tid; q < nb * kCC * U; q += kThreads) {
      const uint32_t row = __umulhi(q, u_magic), u = q - row * U;  // row: batch * 8 + channel
      const int2 tu = tab[u];
      const float v = has_x && tu.y >= 0 ? to_f(raw[row * T_in + tu.y]) : 0.f;
      xo[(row & 7) * L.rsx + (row >> 3) * L.R + tu.x] = ItemStep<T>::x(v);
    }
  };

  // The products: gW^T (rows m, columns p) = X * g^T, the rows in the
  // output tile's order: m = c*K + k (channel c, tap k) for m < 8K, the
  // bias at m = 8K, zeros past it; warpgroup wg takes rows 64wg.., its warp
  // w rows 16(w % 4).. (a lane rows lane/4 and lane/4 + 8), so that 8 rows
  // of a fragment are 8 consecutive values of an output row (the epilogue's
  // bf16 stores are stmatrix, 16 bytes a row).  A is x at the lane's columns
  // of the k-step, read from the x buffer at the row's channel and tap
  // (xoff; the bias row: ones; rows past it: zeros; columns past the
  // window's: column 0, whose g is zero); B the B tile.
  int xoff[2], kind[2];  // kind: 0 a tap, 1 the bias, 2 a zero row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 64 * (warp >> 2) + 16 * (warp & 3) + gid + 8 * h, c = m / K, k = m - c * K;
    kind[h] = m < row_k ? 0 : m == row_k ? 1 : 2;
    xoff[h] = m < row_k ? c * L.rsx + (k % stride) * L.Lh + k / stride : 0;
  }
  const int gap = L.R - T_out;
  auto load_a = [&](uint32_t (&ab)[4], uint32_t (&as)[4], int ks, const X* xi) {
    int col[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = kBf16 ? ks * 16 + 2 * tig + 8 * h2 : ks * 8 + tig + 4 * h2;
      col[h2] = c < ncols ? c + (nb == 1 ? 0 : gap * (c / T_out)) : 0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = q & 1;
      const X* p = xi + xoff[h] + col[q >> 1];
      if constexpr (kBf16) {
        ab[q] = kind[h] == 0 ? pack_bf16(p[0], p[1]) : kind[h] == 1 ? 0x3F803F80u : 0u;
      } else {
        const float2 v = kind[h] == 0 ? p[0] : make_float2(kind[h] == 1 ? 1.f : 0.f, 0.f);
        ab[q] = __float_as_uint(v.x);
        as[q] = __float_as_uint(v.y);
      }
    }
  };
  float acc[32], sum[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = sum[r] = 0.f;
  // nk (1-4) k-steps from ks0, the A registers of one loaded while the one
  // before multiplies; the last k-step's products are left in flight
  auto issue_chunk = [&](const X* xi, uint32_t b0, int ks0, int nk) {
    uint32_t ab[2][4], as[2][4];
    load_a(ab[0], as[0], ks0, xi);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < nk) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint32_t big = b0 + (ks0 + s) * 2048;
        if constexpr (kBf16) {
          wgmma_rs_bf16(acc, ab[s & 1], gmma_desc(big), s > 0);
        } else {
          wgmma_rs_tf32(acc, as[s & 1], gmma_desc(big), s > 0);
          wgmma_rs_tf32(acc, ab[s & 1], gmma_desc(big + static_cast<uint32_t>(L.bplane)), 1);
          wgmma_rs_tf32(acc, ab[s & 1], gmma_desc(big), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (s + 1 < nk) {
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          load_a(ab[(s + 1) & 1], as[(s + 1) & 1], ks0 + s + 1, xi);
        }
      }
    }
  };
  // a chunk's products done; f32: their sums added in f32
  auto finish = [&]() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if constexpr (!kBf16) {
#pragma unroll
      for (int r = 0; r < 32; ++r) sum[r] += acc[r];
    }
  };
  // Unit i's products on B tile `buf`: bf16 all k-steps (at most 4) in one
  // run of the accumulators; f32 chunks of 4, every chunk but the last
  // finished here.  The last is left in flight (finish).
  auto products = [&](int i, int buf) {
    const X* xi = xs + (i & 1) * kCC * L.rsx;
    const uint32_t b0 = smem_addr(bt + buf * kPlanes * L.bplane);
    if constexpr (kBf16) {
      issue_chunk(xi, b0, 0, L.ks);
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) sum[r] = 0.f;
      for (int ks0 = 0;; ks0 += 4) {
        issue_chunk(xi, b0, ks0, min(4, L.ks - ks0));
        if (ks0 + 4 >= L.ks) break;
        finish();
      }
    }
  };

  if (n <= 0) return;
  if (tid == kIssuer) {
    for (int s = 0; s < 3; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue_g(unit_dev(u_lo));
    issue_x(0, unit_dev(u_lo));
    if (n > 1) issue_x(1, unit_dev(u_lo + 1));
  }
  if (consumer) {
    for (int e = tid; e < entries; e += kThreads) lists[e] = make_int2(wrow[e], wchunk[e]);
    // a batch's padded column u = w*stride + ph (w < R) at ph*Lh + w of its
    // x row, and the column of x it holds
    for (int u = tid; u < U; u += kThreads) {
      int s = u - padding;
      if (reflect && (s < 0 || s >= T_in) && u < T_in + 2 * padding)
        s = s < 0 ? -s : 2 * (T_in - 1) - s;
      tab[u] = make_int2((u % stride) * L.Lh + u / stride, s >= 0 && s < T_in ? s : -1);
    }
    // the zero tile, and zeros past each x row's padded columns (the second
    // value of the last register pairs there; never written by a build)
    for (int q = tid; q < kZeroRows * row_k * static_cast<int>(sizeof(T)) / 16; q += kThreads)
      reinterpret_cast<uint4*>(smem + L.zero)[q] = make_uint4(0u, 0u, 0u, 0u);
    const int pad_x = L.rsx - stride * L.Lh;
    for (int q = tid; q < 2 * kCC * pad_x; q += kThreads)
      xs[(q / pad_x) * L.rsx + stride * L.Lh + q % pad_x] = ItemStep<T>::x(0.f);
    fence_async();  // the zero tile's writes before the stores read it
  }
  __syncthreads();
  // thread kIssuer: the first unit of the next row tile to copy g for
  int g_next = tid == kIssuer ? group_end(u_lo) : 0;
  uint32_t g_phase = 0;
  if (consumer) {
    mbar_wait(smem_addr(bars), g_phase);
    build_b(u_lo, 0);
    mbar_wait(smem_addr(bars + 1), 0);
    build_x(0);
    fence_async();  // the B tile's writes before the products read it
  }
  g_phase ^= 1;
  __syncthreads();  // the first unit is staged; the g stage and x's stage 0 are read
  if (tid == kIssuer) {
    fence_async();  // the stages' reads by the block come before these writes
    if (g_next < u_hi) {
      issue_g(unit(g_next));
      g_next = group_end(g_next);
    }
    if (n > 2) issue_x(2, unit(u_lo + 2));
  }

  // Unit i: its products issued; the next unit's B tile (at a new row tile)
  // and x built while they run; then its epilogue: the tile into output
  // buffer i & 1, stored after the barrier by thread kStorer (whose wait
  // before it let the store of unit i - 1 read its buffer), the dead chunks
  // from the zero tile by warp kZeroWarp's lanes, the refills by thread
  // kIssuer.
  Unit cur = unit(u_lo);
  int gbuf = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const Unit nx = i + 1 < n ? unit(u_lo + i + 1) : cur;
    const bool new_group = i + 1 < n && (nx.win != cur.win || nx.rt != cur.rt);
    const int p0 = cur.rt * kRows, nrows = min(kRows, P - p0);
    const bool first = cur.e == 0 || lists[cur.e - 1].x != cur.rt;
    T* ob = reinterpret_cast<T*>(smem + L.out + (i & 1) * out_tile);  // [64][8K]
    if (consumer) {
      products(i, gbuf);
      if (i + 1 < n) {
        if (new_group) {
          mbar_wait(smem_addr(bars), g_phase);
          g_phase ^= 1;
          build_b(u_lo + i + 1, gbuf ^ 1);
        }
        mbar_wait(smem_addr(bars + 1 + ((i + 1) & 1)), ((i + 1) >> 1) & 1);
        build_x(i + 1);
      }
      fence_async();  // the B tile's writes before the products read it
      finish();
      // the lane's rows m (h: + 8) and columns p = 8j + 2*tig (+1) of
      // acc[4j + 2h (+1)]; the bias (m = 8K) to gb at the row tile's first
      // entry
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kind[h] == 1 && first) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 4 * j + 2 * h + e, p = 8 * j + 2 * tig + e;
              if (p < nrows) gb[size_t(cur.win) * P + p0 + p] = from_f<T>(kBf16 ? acc[r] : sum[r]);
            }
        }
      }
      if (cur.chunk >= 0) {
        const int mw = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's first row
        if constexpr (kBf16) {
          // 8x8 blocks (rows m0 = mw + 8h.., columns 8j..), transposed by
          // stmatrix into 8 rows p of 8 consecutive values m; blocks past
          // the tile's 8K values (the bias's and the zero rows') are not
          // stored
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (mw + 8 * h + 8 > row_k) continue;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              uint32_t v[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                v[j] = pack_bf16(acc[4 * (4 * q + j) + 2 * h], acc[4 * (4 * q + j) + 2 * h + 1]);
              const int p = 8 * (4 * q + (lane >> 3)) + (lane & 7);
              stmatrix_trans(ob + p * row_k + mw + 8 * h, v);
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const int m = mw + gid + 8 * ((r >> 1) & 1), p = 8 * (r >> 2) + 2 * tig + (r & 1);
            if (m < row_k) ob[p * row_k + m] = sum[r];
          }
        }
      }
      fence_async();  // the output tile's writes before the store reads it
    }
    if (tid == kStorer) bulk_wait_read();
    __syncthreads();  // unit i's tile is written; unit i - 1's store has read its buffer
    if (tid == kStorer && cur.chunk >= 0) {
      tensor_store3(&gw_map, ob, cur.chunk * row_k, p0, cur.win);
      bulk_commit();
    }
    if (warp == kZeroWarp) {
      // the dead chunks [a0, a1) before the unit's chunk and [b0, b1) after
      // it (past the row tile's last entry), in boxes of kZeroRows rows
      int a0 = 0, a1 = nch, b0 = 0, b1 = 0;
      if (cur.chunk >= 0) {
        const bool last = cur.e + 1 == entries || lists[cur.e + 1].x != cur.rt;
        a0 = first ? 0 : lists[cur.e - 1].y + 1;
        a1 = cur.chunk;
        b0 = cur.chunk + 1;
        b1 = last ? nch : b0;
      }
      const int boxes = (nrows + kZeroRows - 1) / kZeroRows, na = a1 - a0;
      for (int q = lane; q < (na + b1 - b0) * boxes; q += 32) {
        const int d = q / boxes, z = d < na ? a0 + d : b0 + d - na;
        tensor_store3(&zero_map, smem + L.zero, z * row_k, p0 + (q - d * boxes) * kZeroRows,
                      cur.win);
      }
      bulk_commit();
    }
    if (tid == kIssuer) {
      fence_async();  // the stages' reads by the block come before these writes
      if (new_group && g_next < u_hi) {
        issue_g(unit(g_next));
        g_next = group_end(g_next);
      }
      if (i + 3 < n) issue_x(i + 3, unit(u_lo + i + 3));
    }
    if (new_group) gbuf ^= 1;
    cur = nx;
  }
  // the stores are done before the block's memory goes
  if (tid == kStorer || warp == kZeroWarp) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// dgrad over many windows' short rows (the test-time solve)
//
// dgrad_tiles_kernel<T, NT> (T float or __nv_bfloat16) replaces the same
// JAX autodiff as dgrad_kernel (hm_vae_tpu/models/hm_vae.py:200) under
// jax.vmap over the solve's windows (hm_vae_tpu/apps/latent_opt.py:423),
// where each window holds one or a few batches' short rows and its own
// folded weight: the decoder levels at 10 windows of one batch, T_out 8-64.
// There the whole-row kernel ran one block a pair of chunks and window
// (140-420 blocks a level) whose M side, one batch's padded row of 22-78
// columns, left most of its 8 warps idle, each stage a serial chain (the
// stage's wait, g's build, a barrier, the products, the refill), g rebuilt
// by every block of a window, the weight read at ~0.45 TB/s.  What bounds
// the work on an H100 is bytes: each window's folded weight read once (195
// MB in f32, 98 in bf16 over the 4 levels, PERF.md), not the operations.
//
// The design turns the product around so that the weight is the operand
// that streams.  A unit is one (window w, chunk of 8 input channels c0..):
//
//   Z[m = c*K + k, n] = sum_p Wf_w[p, c0 + c, k] * g_w[p, n]
//
// over the chunk's live row tiles (dgrad_chunk_start / dgrad_chunk_row in
// pack_structure: 64 rows p each), n a column of the window (batch n /
// T_out's column n % T_out), then gxpad[c, t*stride + k] += Z[c*K + k, t],
// the padding's adjoint folded into gx, and the chunk's 8 rows of gx of the
// window's batches stored.  Every element of gx is written once (a chunk
// with no live row tile writes its zeros), so the wrapper allocates gx
// uncleared.
// - M = 8K <= 120 rows in two m64 tiles, one a warpgroup; a weight tile's
//   row p is exactly the 8K contiguous values (c, k) of rows m, so the
//   weight is read in its own layout: one 2D box of a 3D tensor map over
//   the windows' weights (windows, P, C*K), 64 rows p x 8K values (rows
//   past P read as zeros), a live (row tile, chunk) a box;
// - N = NT, the window's columns nb * T_out rounded up to 8, 16, 32 or 64
//   (a template parameter: wgmma's N is in the instruction), zeros past
//   them; the reduction runs over p;
// - g = gy * act'(y) for all P rows of the window is built once, when a
//   block's run enters the window, into the products' B tile (K-major along
//   p, core matrices as the other wgmma kernels'; f32 TF32 big and small
//   planes, bf16 rounded once as the plain version rounds it), and serves
//   every chunk unit of that window; a thread loads four (f32) or two
//   (bf16) 16-byte slots' values before it writes any, so that its loads
//   fly together (more in registers, or 16-byte granules of gy's rows
//   scattered into the slots, spilled and were slower, PERF.md);
// - a producer warp streams the weight tiles of the block's run, as many
//   stages in flight as shared memory holds after the B tile and the Z tile
//   (at most kDgradTilesMaxStages: 4-6 at the decoder levels; f32 one block
//   an SM, bf16 two, each within half an SM), so that the copies run on
//   through g's builds and the epilogues;
// - persistent blocks, min(units, SMs x blocks an SM), each a contiguous
//   run of units in window-major order, cut by the live tiles they hold
//   (a unit costs its tiles + 1: dgrad_tiles_run), so that dec0's uneven
//   chunks balance and a run builds g for one to three windows; a unit's
//   whole reduction stays in one block: no cluster, no atomics, the same
//   bits every run;
// - the products: wgmma with A = the weight tile's rows m from registers
//   (TF32 wgmma takes only K-major operands from shared memory, and the
//   tile is M-major): f32 each lane loads and splits its fragment (3xTF32,
//   small*big, big*small, big*big), the tensor cores' sums added in f32
//   after each row tile (64 rows p); bf16 by ldmatrix.trans (8 rows p of 8
//   consecutive m, transposed into the fragment: one instruction for four
//   registers, no split, and no MN-major descriptor, whose core matrices
//   the box's 240-byte rows p do not form), one m64nNTk16 a k-step, the
//   unit's sums kept in the accumulators (f32); each output rounded once,
//   at its store.  A row tile's k-steps are one wgmma group, all their A
//   registers loaded first, and its stage is released once the group is
//   issued (a group a k-step, each waited for, took ~1 us a tile in f32),
//   its k-steps past P issued too, on the copy's zero rows: a wgmma under
//   a branch gets a warpgroup arrive of its own, and ptxas then serializes
//   every wgmma of the kernel;
// - the epilogue: the sums into the Z tile (f32, rows m), a barrier of the
//   two warpgroups, the shift-add and the padding's adjoint in a fixed
//   order with no division (stride 1 or 2: shifts and masks; a division by
//   the runtime stride a tap cost ~5.8 us a unit, kernel_trace.py), the
//   chunk's gx rows stored (a batch's 8 channel rows are 8 * T_in
//   contiguous values).
// Limits: K <= 15, a window's columns nb * T_out <= 64, stride 1 or 2,
// reflect or zero padding, a block within its share of shared memory with
// two stages at least.
constexpr int kDgradTilesThreads = kThreads + 32;  // two warpgroups, the producer warp
constexpr int kDgradTilesMaxStages = 6;
constexpr int kDgradTilesMaxK = 15;

// The N tile of a window's `cols` columns (0 where none fits).
__host__ __device__ inline int dgrad_tiles_nt(int cols) {
  return cols <= 8 ? 8 : cols <= 16 ? 16 : cols <= 32 ? 32 : cols <= 64 ? 64 : 0;
}

struct DgradTilesLayout {
  int nt, zp, ks, stages;           // N tile, Z's row pitch (floats), g's k-steps, stages
  size_t wstage, bplane;            // a weight stage, a B plane (bytes)
  size_t z, lists, bt, st, total;  // byte offsets in shared memory
};

// The barriers (full and empty, kDgradTilesMaxStages each), the Z tile (8K
// rows of zp floats, zp 8 mod 32: a warp's 8-byte stores of a fragment hit
// every bank once), the lists (the chunks' starts, then their live row
// tiles), the B tile (g's k-steps over all P rows: f32 a big plane, then a
// small one), then the weight stages (64 rows p of 8K values each), as
// many as fit the block's share: the whole of an SM's shared memory in f32
// (one block an SM), half of it in bf16 (two).  `esz`: the element's bytes.
__host__ __device__ inline DgradTilesLayout dgrad_tiles_layout(int K, int P, int cols, int nch,
                                                               int entries, int esz) {
  DgradTilesLayout L;
  const int row_k = kCC * K, kw = esz == 4 ? 8 : 16;
  L.nt = dgrad_tiles_nt(cols);
  L.zp = (L.nt + 23) / 32 * 32 + 8;
  L.ks = (P + kw - 1) / kw;
  L.bplane = size_t(L.ks) * (L.nt / 8) * 256;
  L.wstage = align128(size_t(kRows) * row_k * esz);
  L.z = 128;
  L.lists = L.z + align128(size_t(row_k) * L.zp * 4);
  L.bt = L.lists + align128(size_t(nch + 1 + entries) * 4);
  L.st = L.bt + (esz == 4 ? 2 : 1) * L.bplane;
  const size_t budget = esz == 4 ? size_t(kMaxSmem) : size_t(kSmemPerSM / 2 - 1024);
  const size_t fit = budget > L.st ? (budget - L.st) / L.wstage : 0;
  L.stages = static_cast<int>(fit < size_t(kDgradTilesMaxStages) ? fit : kDgradTilesMaxStages);
  L.total = L.st + size_t(L.stages) * L.wstage;
  return L;
}

// Block `blk` of `blocks`: its units [lo, hi) of the windows x nch units,
// unit u = w * nch + c costing its chunk's live row tiles + 1; the runs are
// cut where the units' summed cost passes each block's share.  `start`:
// the chunks' starts in the list of live row tiles (nch + 1, the last the
// entries).
__host__ __device__ inline void dgrad_tiles_run(const int* start, int nch, int windows,
                                                int blocks, int blk, int& lo, int& hi) {
  const long long per = static_cast<long long>(start[nch]) + nch;
  const long long total = per * windows;
  const int units = windows * nch;
  auto first = [&](long long b) {  // the first unit whose cost before it reaches b's share
    int a = 0, z = units;
    while (a < z) {
      const int mid = (a + z) >> 1, w = mid / nch, c = mid - w * nch;
      if ((w * per + start[c] + c) * blocks >= total * b)
        z = mid;
      else
        a = mid + 1;
    }
    return a;
  };
  lo = first(blk);
  hi = first(blk + 1);
}

// d = A (64 x 8, tf32, in registers, as wgmma_rs_tf32's) * B (8 x 8 or 8 x
// 16, tf32, K-major in shared memory) + (acc ? d : 0); d as wgmma_rs_tf32's.
__device__ __forceinline__ void wgmma_rs_tf32_n8(float (&d)[4], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs_tf32_n16(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
// the same in bf16, k-steps of 16 (A as wgmma_rs_bf16_n32's)
__device__ __forceinline__ void wgmma_rs_bf16_n8(float (&d)[4], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs_bf16_n16(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// One wgmma of N = NT columns: f32 as TF32 (k-step 8), bf16 (k-step 16).
template <typename T, int NT>
__device__ __forceinline__ void wgmma_rs_nt(float (&d)[NT / 2], const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (NT == 8) wgmma_rs_tf32_n8(d, a, b, acc);
    else if constexpr (NT == 16) wgmma_rs_tf32_n16(d, a, b, acc);
    else if constexpr (NT == 32) wgmma_rs_tf32_n32(d, a, b, acc);
    else wgmma_rs_tf32(d, a, b, acc);
  } else {
    if constexpr (NT == 8) wgmma_rs_bf16_n8(d, a, b, acc);
    else if constexpr (NT == 16) wgmma_rs_bf16_n16(d, a, b, acc);
    else if constexpr (NT == 32) wgmma_rs_bf16_n32(d, a, b, acc);
    else wgmma_rs_bf16(d, a, b, acc);
  }
}

// Four 8x8 matrices of 16-bit values from shared memory, transposed: lane
// 8i + r gives the address of row r of matrix i (16 consecutive bytes); lane
// l's v[i] holds rows 2(l%4) and 2(l%4) + 1 of matrix i at column l/4 (the
// lower row in the low half).
__device__ __forceinline__ void ldmatrix_trans(uint32_t (&v)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(smem_addr(row)));
}

// An arrive on `bar` where `pred`, predicated inside the instruction: a
// branch around it, taken by one lane, while a wgmma group flies makes
// ptxas serialize the wgmma (C7520).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::
          "r"(bar), "r"(static_cast<int>(pred))
      : "memory");
}

// The two warpgroups (not the producer warp) at named barrier 1.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// w_map: the windows' folded weights (windows, P, C*K), boxes of (8K, 64,
// 1); chunk_start (nch + 1) / chunk_row: each 8-channel chunk's live row
// tiles; nb batches a window; `stages` weight stages (dgrad_tiles_layout).
template <typename T, int NT>
__global__ void __launch_bounds__(kDgradTilesThreads, sizeof(T) == 2 ? 2 : 1)
dgrad_tiles_kernel(const __grid_constant__ CUtensorMap w_map, const T* __restrict__ gy,
                   const T* __restrict__ y, const int* __restrict__ chunk_start,
                   const int* __restrict__ chunk_row, T* __restrict__ gx, int entries,
                   int windows, int nb, int C, int T_in, int K, int P, int T_out, int t_ld,
                   int stride, int padding, int reflect, float slope) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kKw = kBf16 ? 16 : 8;     // rows p of a k-step
  constexpr int kGran = 16 / sizeof(T);   // rows p of a 16-byte slot of the B tile
  constexpr int kNA = NT / 2;             // accumulators a thread
  count_run(&g_runs[0]);
  const int nch = C / kCC, row_k = kCC * K, ncols = nb * T_out;
  const DgradTilesLayout L = dgrad_tiles_layout(K, P, ncols, nch, entries, sizeof(T));
  const int nst = L.stages;  // weight stages

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);     // [kDgradTilesMaxStages]
  uint64_t* empty = full + kDgradTilesMaxStages;           // [kDgradTilesMaxStages]
  float* zt = reinterpret_cast<float*>(smem + L.z);        // [8K][zp]
  int* lst = reinterpret_cast<int*>(smem + L.lists);       // [nch + 1], then [entries]
  unsigned char* bt = smem + L.bt;                         // [planes][ks][NT / 8][256]
  unsigned char* st = smem + L.st;                         // [stages][64][8K]
  const int* lrow = lst + nch + 1;
  const size_t kstep = size_t(NT / 8) * 256;  // bytes of a B k-step

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (tid == kThreads) {
    for (int s = 0; s < kDgradTilesMaxStages; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), kWarps);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int q = tid; q < nch + 1 + entries; q += kDgradTilesThreads)
    lst[q] = q <= nch ? chunk_start[q] : chunk_row[q - nch - 1];
  __syncthreads();
  int u_lo, u_hi;
  dgrad_tiles_run(lst, nch, windows, gridDim.x, blockIdx.x, u_lo, u_hi);
  if (u_lo >= u_hi) return;

  if (warp == kWarps) {
    // the producer: the run's live (row tile, chunk) boxes, in the
    // consumers' order, each into the next free stage
    if (lane == 0) {
      const uint32_t box = kRows * row_k * sizeof(T);
      int it = 0;
      for (int u = u_lo; u < u_hi; ++u) {
        const int w = u / nch, c = u - w * nch;
        for (int j = lst[c]; j < lst[c + 1]; ++j, ++it) {
          const int slot = it % nst;
          if (it >= nst) mbar_wait(smem_addr(empty + slot), (it / nst - 1) & 1);
          mbar_expect(smem_addr(full + slot), box);
          tensor_copy3(st + slot * L.wstage, &w_map, c * row_k, lrow[j] * kRows, w, full + slot);
        }
      }
    }
    return;
  }

  // g = gy * act'(y) of window w into the B tile: a 16-byte slot (k-step
  // ks, half h, column n) holds kGran consecutive rows p of column n;
  // consecutive threads take consecutive columns (coalesced loads of a row
  // of gy, a core matrix's 128 bytes a quarter warp's stores).  Zeros past
  // the columns and the rows.  A thread loads kBatch slots' values before
  // it writes any, so that its loads fly together.
  const int items = L.ks * 2 * NT;
  constexpr int kBatch = kBf16 ? 2 : 4;  // slots a thread loads before it writes any
  auto build_g = [&](int w) {
    for (int base = tid; base < items; base += kBatch * kThreads) {
      float gv[kBatch][kGran], yv[kBatch][kGran];
#pragma unroll
      for (int b4 = 0; b4 < kBatch; ++b4) {
        const int it = base + b4 * kThreads, n = it % NT, p0 = (it / NT) * kGran;
        const int bb = n / T_out, t = n - bb * T_out;
        const T* gr = gy + (size_t(w * nb + bb) * P + p0) * t_ld + t;
        const T* yr = y + (size_t(w * nb + bb) * P + p0) * t_ld + t;
#pragma unroll
        for (int q = 0; q < kGran; ++q) {
          const bool in = it < items && n < ncols && p0 + q < P;
          gv[b4][q] = in ? to_f(gr[q * t_ld]) : 0.f;
          yv[b4][q] = in ? to_f(yr[q * t_ld]) : 0.f;
        }
      }
#pragma unroll
      for (int b4 = 0; b4 < kBatch; ++b4) {
        const int it = base + b4 * kThreads;
        if (it >= items) break;
        const int n = it % NT, slot = it / NT;  // slot: k-step * 2 + half
        unsigned char* out = bt + (slot >> 1) * kstep + (n >> 3) * 256 + (slot & 1) * 128 +
                             (n & 7) * 16;
        float v[kGran];
#pragma unroll
        for (int q = 0; q < kGran; ++q) v[q] = act_grad(gv[b4][q], yv[b4][q], slope);
        if constexpr (kBf16) {
          *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                      pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        } else {
          float4 big, small;
          float* bv = reinterpret_cast<float*>(&big);
          float* sv = reinterpret_cast<float*>(&small);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 sp = split_tf32(v[q]);
            bv[q] = sp.x;
            sv[q] = sp.y;
          }
          *reinterpret_cast<float4*>(out) = big;
          *reinterpret_cast<float4*>(out + L.bplane) = small;
        }
      }
    }
  };

  // The products: warpgroup wg takes rows m 64wg.., its warp rows 16(warp %
  // 4).. (a lane rows gid and gid + 8).  A: the stage's rows p of the
  // k-step at the lane's rows m (f32: zeros past 8K); B: the B tile's
  // k-step.  Rows m past 8K are multiplied but never stored.
  const int wg = warp >> 2, mw = 64 * wg + 16 * (warp & 3);
  float acc[kNA], sum[kNA];
  // f32: the lane's A values (rows mw + gid (+8), columns tig (+4) of k-step
  // ks) split into TF32 big and small parts
  auto load_a32 = [&](uint32_t (&ab)[4], uint32_t (&as)[4], const float* ws, int ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = mw + gid + 8 * (q & 1), p = ks * 8 + tig + 4 * (q >> 1);
      const float2 v = split_tf32(m < row_k ? ws[p * row_k + m] : 0.f);
      ab[q] = __float_as_uint(v.x);
      as[q] = __float_as_uint(v.y);
    }
  };
  // bf16: matrix i = lane / 8 of ldmatrix: rows p 8(i / 2).. of the k-step,
  // values m mw + 8(i % 2)..; an 8-row group past 8K reads row group 0
  // (rows m past 8K are never stored)
  const int lq = lane >> 3, lm = mw + 8 * (lq & 1);
  auto load_a16 = [&](uint32_t (&a)[4], const __nv_bfloat16* ws, int ks) {
    const int p = ks * 16 + 8 * (lq >> 1) + (lane & 7);
    ldmatrix_trans(a, ws + p * row_k + (lm < row_k ? lm : 0));
  };
  // A row tile's products, one wgmma group: the A registers of all its
  // k-steps loaded first, then a wgmma each, with no branch (a wgmma in a
  // conditional block gets a warpgroup arrive of its own there, and ptxas
  // serializes them all): the k-steps past P (nks the ones inside) multiply
  // the stage's rows p past P, the copy's zeros, by the tile's first
  // k-step of B; f32 from a fresh accumulator (its sums added in f32 after
  // the tile), bf16 onto the unit's (fresh at its first tile).  Left in
  // flight.
  constexpr int kSteps = kRows / kKw;  // k-steps of a row tile
  auto issue = [&](const T* ws, uint32_t b0, int nks, bool fresh) {
    uint32_t ab[kSteps][4], as[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kBf16)
        load_a16(ab[s], ws, s);
      else
        load_a32(ab[s], as[s], ws, s);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint32_t big = b0 + static_cast<uint32_t>(s < nks ? s * kstep : 0);
      if constexpr (kBf16) {
        wgmma_rs_nt<T, NT>(acc, ab[s], gmma_desc(big), s > 0 || !fresh);
      } else {
        wgmma_rs_nt<T, NT>(acc, as[s], gmma_desc(big), s > 0);
        wgmma_rs_nt<T, NT>(acc, ab[s], gmma_desc(big + static_cast<uint32_t>(L.bplane)), 1);
        wgmma_rs_nt<T, NT>(acc, ab[s], gmma_desc(big), 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  auto finish = [&]() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if constexpr (!kBf16) {
#pragma unroll
      for (int r = 0; r < kNA; ++r) sum[r] += acc[r];
    }
  };

  const uint32_t bt_addr = smem_addr(bt);
  // the epilogue's outputs (a batch's 8 channel rows of T_in) and Z's step
  // from a tap to the next; rem / T_in as a multiply-high (exact for rem <
  // 8 * T_in while 8 * T_in^2 < 2^32; at T_in 1 the quotient is rem)
  const int n_el = nb * kCC * T_in, sh = stride >> 1, zstep = stride * L.zp - 1;
  const uint32_t tin_magic = static_cast<uint32_t>((0x100000000ull + T_in - 1) / T_in);
  int it = 0, cur_w = -1;
#pragma unroll 1
  for (int u = u_lo; u < u_hi; ++u) {
    const int w = u / nch, c = u - w * nch;
    if (w != cur_w) {  // the run enters window w: its g, once
      consumers_sync();  // the products on the last window's B tile are done
      build_g(w);
      fence_async();  // the B tile's writes before the products read it
      consumers_sync();
      cur_w = w;
    }
#pragma unroll
    for (int r = 0; r < kNA; ++r) acc[r] = sum[r] = 0.f;
    bool fresh = true;
    for (int j = lst[c]; j < lst[c + 1]; ++j, ++it) {
      const int slot = it % nst, p0 = lrow[j] * kRows;
      const int nks = min(kRows / kKw, (P - p0 + kKw - 1) / kKw);  // k-steps inside P
      mbar_wait(smem_addr(full + slot), (it / nst) & 1);
      const T* ws = reinterpret_cast<const T*>(st + slot * L.wstage);
      const uint32_t b0 = bt_addr + static_cast<uint32_t>(lrow[j] * kSteps * kstep);
      issue(ws, b0, nks, fresh);
      fresh = false;
      // the A registers are loaded (the warp's wgmma issued on them): the
      // stage is read, and its refill flies while the products run
      mbar_arrive_if(smem_addr(empty + slot), lane == 0);
      finish();
    }
    if constexpr (kBf16) {
      fence_acc(acc);
#pragma unroll
      for (int r = 0; r < kNA; ++r) sum[r] = acc[r];
    }

    // the epilogue: Z's rows m < 8K (d[r]: row mw + gid (+8 if r & 2),
    // column 8(r / 4) + 2 tig + (r & 1)), then the shift-add and the
    // padding's adjoint, in a fixed order, into the chunk's gx rows
    consumers_sync();  // the last unit's Z is read
#pragma unroll
    for (int r = 0; r < kNA; r += 2) {
      const int m = mw + gid + 8 * ((r >> 1) & 1), n = 8 * (r >> 2) + 2 * tig;
      if (m < row_k)
        *reinterpret_cast<float2*>(zt + m * L.zp + n) = make_float2(sum[r], sum[r + 1]);
    }
    consumers_sync();  // Z is written
    for (int el = tid; el < n_el; el += kThreads) {
      const int bb = nb == 1 ? 0 : el / (kCC * T_in), rem = el - bb * (kCC * T_in);
      const int cc = T_in == 1 ? rem : __umulhi(static_cast<uint32_t>(rem), tin_magic);
      const int i = rem - cc * T_in;
      const float* zc = zt + cc * K * L.zp + bb * T_out;  // row c*K + k at k * zp
      // gxpad at padded column v: Z[c*K + k][t] over t*stride + k = v, k
      // ascending (stride 1 or 2: no division, which cost ~5.8 us a unit),
      // a tap stride rows of Z down and a column left of the one before
      auto column = [&](int v) {
        float s = 0.f;
        int k = max(0, v - (T_out - 1) * stride);
        k += (v - k) & (stride - 1);
        const float* z = zc + k * L.zp + ((v - k) >> sh);
        for (const int k1 = min(K - 1, v); k <= k1; k += stride, z += zstep) s += *z;
        return s;
      };
      // the padded columns that read x[b, c, i]: i + padding, and under
      // reflect the mirrored columns
      float v = column(i + padding);
      if (reflect && i >= 1 && i <= padding) v += column(padding - i);
      if (reflect && i <= T_in - 2 && i >= T_in - 1 - padding)
        v += column(padding + 2 * (T_in - 1) - i);
      gx[(size_t(w * nb + bb) * C + c * kCC + cc) * T_in + i] = from_f<T>(v);
    }
  }
}

// Sets a kernel's shared-memory cap once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&ready)[kMaxDevices], int device) {
  if (ready[device]) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) ready[device] = true;
  return err;
}

// Rows of gy and y (t_ld values) are whole 16-byte granules: 4 f32 or 8
// bf16 values (esz bytes each).
bool shape_ok(int B, int C, int T_in, int K, int P, int T_out, int t_ld, int stride,
              int padding, int reflect, int device, const void* const* ptrs, int n_ptrs,
              int esz) {
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return false;
  return B > 0 && C > 0 && C % kCC == 0 && T_in > 0 && K > 0 && K <= kMaxK && P > 0 &&
         T_out > 0 && t_ld >= T_out && t_ld % (16 / esz) == 0 && stride > 0 && padding >= 0 &&
         !(reflect && padding >= T_in) && (T_out - 1) * stride + K <= T_in + 2 * padding &&
         T_in + 2 * padding - K < T_out * stride && device >= 0 && device < kMaxDevices &&
         static_cast<long long>(B) * C * T_in < 0x7FFFFFFFLL &&
         static_cast<long long>(B) * P * t_ld < 0x7FFFFFFFLL;
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, int cluster_z, int cluster_x,
                           size_t smem, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster_z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (no link against libcuda); null where it is missing.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

// A 2D tensor map over `rows` rows of t_ld values of `esz` bytes (gy or y
// of the item kernel over one batch's columns, f32 or bf16): boxes of a
// chunk's 128 bytes (32 f32 or 64 bf16 columns) x 64 rows, 128-byte
// swizzle.  False where the encoder is missing or refuses the map.
bool span_row_map(CUtensorMap* map, const void* base, int t_ld, long long rows, int esz) {
  const auto encode = tensor_map_encoder();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(t_ld), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(t_ld) * esz};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esz), kRows};
  const cuuint32_t steps[2] = {1, 1};
  return encode != nullptr &&
         encode(map, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3D tensor map over a (batches, rows, cols) tensor of `esz`-byte values
// (gy, y or x of the item kernel over several batches' rows), boxes of
// (nbb, box_rows, cols), box_merge(cols, rows, box_rows) rows a box row, no
// swizzle: a box lands dense, a batch's rows after another's.  False where
// the encoder is missing or refuses the map.
bool batch_rows_map(CUtensorMap* map, const void* base, int cols, int rows, int batches,
                    int box_rows, int nbb, int esz) {
  const auto encode = tensor_map_encoder();
  const int m = box_merge(cols, rows, box_rows);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(m) * cols,
                              static_cast<cuuint64_t>(rows / m),
                              static_cast<cuuint64_t>(batches)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(m) * cols * esz,
                                 static_cast<cuuint64_t>(cols) * rows * esz};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(m * cols),
                             static_cast<cuuint32_t>(box_rows / m),
                             static_cast<cuuint32_t>(nbb)};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plans of the last dgrad and wgrad launches in this process
// (hmvae_conv_bwd_last_plan): dgrad nbb, groups, split, span, spans, smem,
// stages, channels a block, and the tile kernel's blocks (0 for the other
// dgrad kernels); wgrad sb, split, span, smem, and the tile kernel's blocks
// (0 for the other wgrad kernels).
int last_dgrad[9] = {};
int last_wgrad[5] = {};

// One whole-row dgrad_kernel launch in element type T (after its checks).
template <typename T>
int dgrad_rows(bool (&ready)[kMaxDevices], int device, dim3 grid, int split, size_t smem,
               void* stream, const void* gy, const void* y, const void* w,
               const void* dgrad_start, const void* dgrad_row, void* gx, int B, int C, int T_in,
               int K, int P, int T_out, int t_ld, int stride, int padding, int reflect,
               float slope, int nbb, int gpw, size_t w_stride) {
  cudaError_t err = allow_smem(dgrad_kernel<T>, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_cluster(
      dgrad_kernel<T>, grid, kThreads, split, 1, smem, stream, static_cast<const T*>(gy),
      static_cast<const T*>(y), static_cast<const T*>(w), static_cast<const int*>(dgrad_start),
      static_cast<const int*>(dgrad_row), static_cast<T*>(gx), B, C, T_in, K, P, T_out, t_ld,
      stride, padding, reflect, slope, nbb, gpw, w_stride));
}

// One dgrad_span_kernel launch in element type T (after its checks).
template <typename T>
int dgrad_spans(bool (&ready)[kMaxDevices], int device, dim3 grid, int split, size_t smem,
                void* stream, const void* gy, const void* y, const void* wpk,
                const void* span_start, const void* span_row, void* gx, int B, int C, int T_in,
                int P, int T_out, int t_ld, int K, int stride, int padding, int reflect,
                float slope, int span, int nspans, int nbb, int gpw) {
  cudaError_t err = allow_smem(dgrad_span_kernel<T>, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_cluster(
      dgrad_span_kernel<T>, grid, kSpanThreads, split, 1, smem, stream,
      static_cast<const T*>(gy), static_cast<const T*>(y), static_cast<const T*>(wpk),
      static_cast<const int*>(span_start), static_cast<const int*>(span_row),
      static_cast<T*>(gx), B, C, T_in, P, T_out, t_ld, K, stride, padding, reflect, slope, span,
      nspans, nbb, gpw));
}

// The most clusters of `split` dgrad_span_kernel<T> blocks of `smem` bytes
// that the current device runs at once (cudaOccupancyMaxActiveClusters): a
// cluster's blocks share a GPC, so clusters of 4 or 6 one-SM blocks leave
// SMs idle and fewer than sms / split fit (PERF.md).
template <typename T>
int span_clusters(bool (&ready)[kMaxDevices], int device, int split, size_t smem, int* out) {
  cudaError_t err = allow_smem(dgrad_span_kernel<T>, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, split);
  cfg.blockDim = dim3(kSpanThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, dgrad_span_kernel<T>, &cfg));
}

// One dgrad_span_pack_kernel launch in element type T.
template <typename T>
int span_pack(const void* w, const void* span_row, const void* span_group, void* out,
              int entries, int P, int C, int K, int windows, void* stream) {
  constexpr int kKS = SpanStep<T>::kRowsP;
  const size_t smem = size_t(kKS) * (kSpanC * K + 4 / sizeof(T)) * sizeof(T);
  dgrad_span_pack_kernel<T><<<dim3(entries * (kRows / kKS), windows), 256, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const int*>(span_row),
      static_cast<const int*>(span_group), static_cast<T*>(out), P, C, K, entries);
  return static_cast<int>(cudaGetLastError());
}

// One whole-row wgrad_kernel launch, NQ tap tiles a warp, element type T.
template <int NQ, typename T>
int wgrad_rows(bool (&ready)[kMaxDevices], int device, dim3 grid, int split, size_t smem,
               void* stream, const void* gy, const void* y, const void* x, const void* wrow,
               const void* wchunk, void* gw, void* gb, int B, int C, int T_in, int K, int P,
               int T_out, int t_ld, int stride, int padding, int reflect, float slope, int sb) {
  cudaError_t err = allow_smem(wgrad_kernel<NQ, T>, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_cluster(
      wgrad_kernel<NQ, T>, grid, kThreads, 1, split, smem, stream, static_cast<const T*>(gy),
      static_cast<const T*>(y), static_cast<const T*>(x), static_cast<const int*>(wrow),
      static_cast<const int*>(wchunk), static_cast<T*>(gw), static_cast<T*>(gb), B, C, T_in, K,
      P, T_out, t_ld, stride, padding, reflect, slope, sb));
}

// One wgrad_span_kernel launch, NT m64 tiles a warpgroup, element type T,
// items of several batches' rows or not (after its checks).
template <int NT, typename T, bool kRowsMode>
int wgrad_items(bool (&ready)[kMaxDevices], int device, dim3 grid, int split, size_t smem,
                void* stream, const CUtensorMap& gy_map, const CUtensorMap& y_map,
                const CUtensorMap& x_map, const void* gy, const void* y, const void* x,
                const void* wrow,
                const void* wchunk, void* gw, void* gb, int B, int C, int T_in, int K, int P,
                int T_out, int t_ld, int stride, int padding, int reflect, float slope,
                int span, int nbb) {
  cudaError_t err = allow_smem(wgrad_span_kernel<NT, T, kRowsMode>, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_cluster(
      wgrad_span_kernel<NT, T, kRowsMode>, grid, kThreads, 1, split, smem, stream, gy_map, y_map,
      x_map,
      static_cast<const T*>(gy), static_cast<const T*>(y), static_cast<const T*>(x),
      static_cast<const int*>(wrow), static_cast<const int*>(wchunk), static_cast<T*>(gw),
      static_cast<T*>(gb), B, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, slope, span,
      nbb));
}

// A 3D tensor map over the windows' gradients gw (windows, P, C*K values
// of `esz` bytes) for the tile kernel's stores: boxes of a chunk's 8K
// values x `rows` rows p x one window, no swizzle (the box lies dense in
// shared memory, as the gradient lies).  False where the encoder is missing
// or refuses the map.
bool tiles_map(CUtensorMap* map, void* gw, int C, int K, int P, int windows, int rows,
               int esz) {
  const auto encode = tensor_map_encoder();
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C) * K, static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(windows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(C) * K * esz,
                                 static_cast<cuuint64_t>(P) * C * K * esz};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kCC * K), static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, gw, dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One wgrad_tiles_kernel launch in element type T (after its checks).
template <typename T>
int wgrad_tiles(bool (&ready)[kMaxDevices], int device, int blocks, size_t smem, void* stream,
                const CUtensorMap& gw_map, const CUtensorMap& zero_map, const void* gy,
                const void* y, const void* x, const void* wrow, const void* wchunk, void* gb,
                int entries, int windows, int nb, int C, int T_in, int K, int P, int T_out,
                int t_ld, int stride, int padding, int reflect, float slope) {
  cudaError_t err = allow_smem(wgrad_tiles_kernel<T>, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // bf16: the warpgroups and a producer warp (wgrad_tiles_kernel)
  const int threads = sizeof(T) == 2 ? kThreads + 32 : kThreads;
  wgrad_tiles_kernel<T><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      gw_map, zero_map, static_cast<const T*>(gy), static_cast<const T*>(y),
      static_cast<const T*>(x), static_cast<const int*>(wrow), static_cast<const int*>(wchunk),
      static_cast<T*>(gb), entries, windows, nb, C, T_in, K, P, T_out, t_ld, stride, padding,
      reflect, slope);
  return static_cast<int>(cudaGetLastError());
}

// One dgrad_tiles_kernel launch in element type T, N tile NT (after its
// checks).
template <typename T, int NT>
int dgrad_tiles(bool (&ready)[kMaxDevices], int device, int blocks, size_t smem, void* stream,
                const CUtensorMap& w_map, const void* gy, const void* y, const void* chunk_start,
                const void* chunk_row, void* gx, int entries, int windows, int nb, int C,
                int T_in, int K, int P, int T_out, int t_ld, int stride, int padding, int reflect,
                float slope) {
  cudaError_t err = allow_smem(dgrad_tiles_kernel<T, NT>, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dgrad_tiles_kernel<T, NT><<<blocks, kDgradTilesThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      w_map, static_cast<const T*>(gy), static_cast<const T*>(y),
      static_cast<const int*>(chunk_start), static_cast<const int*>(chunk_row),
      static_cast<T*>(gx), entries, windows, nb, C, T_in, K, P, T_out, t_ld, stride, padding,
      reflect, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Input gradient gx (B, C, T_in) of a level from gy, y (B, P, rows of t_ld
// >= T_out values, whole 16-byte granules) and the folded weight w
// (windows x (P, C, K): window i of the batch, B / windows batches, reads
// the i-th), all f32 (dtype 0) or all bf16 (dtype 1), C a multiple of 8,
// every pointer 16-byte aligned; dgrad_start / dgrad_row: the row tiles live
// in either chunk of each pair of 8-channel chunks (pack_structure).  The
// plan (dgrad_plan in the wrapper): batch groups of nbb batches within a
// window, the row tiles (dgrad_span_kernel: a group's stages, contiguous
// runs) split over `split` blocks of a cluster; span = 0
// for whole padded rows (dgrad_kernel), else dgrad_span_kernel (span a
// multiple of 64*stride, at most kSpanWG M tiles of 64 columns) over
// whole padded rows of nbb batches a span where they fit its M tiles
// (dgrad_span_period), else (nbb 1) spans of one batch's row, the first
// narrower by dgrad_span_shift.  A span launch reads the weight as wpk, the
// folded weight's live row tiles of each group of four chunks laid out by
// hmvae_dgrad_span_pack, and its lists dgrad_start / dgrad_row are the
// groups' (dgrad_span_start / dgrad_span_row); wpk is unread for whole
// rows.  Launches on `stream`, returns the first CUDA error (0 on success).
int hmvae_conv_dgrad(const void* gy, const void* y, const void* w, const void* dgrad_start,
                     const void* dgrad_row, void* gx, const void* wpk, int B, int C, int T_in,
                     int K, int P, int T_out, int t_ld, int stride, int padding, int reflect,
                     float slope, int nbb, int split, int span, int windows, int dtype,
                     int device, void* stream) {
  const void* ptrs[] = {gy, y, w, gx, span > 0 ? wpk : gy};
  const int esz = dtype == 1 ? 2 : 4;
  if (!shape_ok(B, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, device, ptrs, 5, esz) ||
      dtype < 0 || dtype > 1 || windows < 1 || B % windows != 0 || nbb < 1 ||
      nbb > B / windows || split < 1 || split > kMaxSplit || span < 0 ||
      (span > 0 && wpk == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_win = B / windows;
  const int gpw = (n_win + nbb - 1) / nbb;  // batch groups of a window
  const int pairs = (C + kDC - 1) / kDC, groups = (C + kSpanC - 1) / kSpanC;
  // dgrad_kernel f32, the span kernel f32, dgrad_kernel bf16, the span kernel bf16
  static bool ready[4][kMaxDevices] = {};
  const int Tp = T_in + 2 * padding;
  if (span > 0) {
    const DgradSpanLayout L = dgrad_span_layout(K, stride, span, esz);
    // whole M tiles of each phase, at most one a consumer warpgroup
    if (span % (64 * stride) != 0 || span / 64 > kSpanWG || L.stages < 2 ||
        L.total > static_cast<size_t>(kMaxSmem))
      return static_cast<int>(cudaErrorInvalidValue);
    const bool rows = nbb * dgrad_span_period(T_in, K, T_out, stride, padding) <= span / stride;
    int nspans = 1;
    dim3 grid(groups, windows * gpw, split);
    if (rows) {
      // the batches' rows of a stage are one copy each, within the stage's rows
      if (nbb * t_ld > L.gw || static_cast<long long>(windows) * gpw > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
      // spans of one batch's row: the reflected columns of each edge inside one span
      const int shift = dgrad_span_shift(Tp, span, stride, padding, reflect);
      nspans = (Tp + shift + span - 1) / span;
      const int last = Tp - ((nspans - 1) * span - shift);
      if (nbb != 1 || static_cast<long long>(B) * nspans > 65535 ||
          (reflect && nspans > 1 && (span - shift <= 2 * padding || last <= 2 * padding)))
        return static_cast<int>(cudaErrorInvalidValue);
      grid.y = B * nspans;
    }
    const int plan[9] = {nbb, gpw, split, span, nspans, static_cast<int>(L.total), L.stages,
                         kSpanC, 0};
    for (int i = 0; i < 9; ++i) last_dgrad[i] = plan[i];
    auto launch = dtype == 1 ? dgrad_spans<__nv_bfloat16> : dgrad_spans<float>;
    return launch(ready[dtype == 1 ? 3 : 1], device, grid, split, L.total, stream, gy, y, wpk,
                  dgrad_start, dgrad_row, gx, n_win, C, T_in, P, T_out, t_ld, K, stride,
                  padding, reflect, slope, span, nspans, rows ? nbb : 0, gpw);
  }
  const DgradLayout L = dgrad_layout(T_in, K, T_out, t_ld, stride, padding, nbb, esz);
  int tiles = 0;  // 16-column tiles of a batch group's columns: one per warp
  for (int phi = 0; phi < stride; ++phi)
    tiles += (nbb * ((L.Tp - phi + stride - 1) / stride) + 15) / 16;
  if (tiles > kWarps * kMaxTiles || L.total > static_cast<size_t>(kMaxSmem) ||
      static_cast<long long>(windows) * gpw > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int plan[9] = {nbb, gpw, split, 0, 1, static_cast<int>(L.total), kStages, kDC, 0};
  for (int i = 0; i < 9; ++i) last_dgrad[i] = plan[i];
  const dim3 grid(pairs, windows * gpw, split);
  auto launch = dtype == 1 ? dgrad_rows<__nv_bfloat16> : dgrad_rows<float>;
  return launch(ready[dtype == 1 ? 2 : 0], device, grid, split, L.total, stream, gy, y, w,
                dgrad_start, dgrad_row, gx, n_win, C, T_in, K, P, T_out, t_ld, stride, padding,
                reflect, slope, nbb, gpw, size_t(P) * C * K);
}

// The folded weight w (windows x (P, C, K), f32 (dtype 0) or bf16 (dtype
// 1)) laid out for dgrad_span_kernel into out (16-byte aligned: windows x
// entries x the k-steps of a row tile x K taps x planes: f32 8 rows p, big
// and small TF32 planes; bf16 16 rows p, one plane; each 1 KB, 32
// channels), entry e the row tile span_row[e] of the group of 32 channels
// span_group[e] (pack_structure's dgrad_span_row / dgrad_span_group).
// Launches on `stream`, returns the first CUDA error (0 on success).
int hmvae_dgrad_span_pack(const void* w, const void* span_row, const void* span_group, void* out,
                          int entries, int P, int C, int K, int windows, int dtype,
                          void* stream) {
  if (w == nullptr || out == nullptr || entries < 1 || P < 1 || C < 1 || K < 1 ||
      K > kMaxK || windows < 1 || windows > 65535 || dtype < 0 || dtype > 1 ||
      static_cast<long long>(entries) * kRows > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 1 ? span_pack<__nv_bfloat16>(w, span_row, span_group, out, entries, P, C, K,
                                               windows, stream)
                    : span_pack<float>(w, span_row, span_group, out, entries, P, C, K, windows,
                                       stream);
}

// Folded-weight gradient gw (windows x (P, C, K)) on the n_tiles entries of
// wgrad_row / wgrad_chunk (pack_structure: the live tiles by row tile,
// chunk -1 for a row tile with none; the caller zeroes the rest) and bias
// gradient gb (windows x (P,)), from gy, y (B, P, rows of t_ld values,
// whole 16-byte granules) and x (B, C, T_in), all f32 (dtype 0) or all
// bf16 (dtype 1), C a multiple of 8, every pointer 16-byte aligned.
// Window i's gradient sums over its own B / windows batches only.  The plan
// (wgrad_plan in the wrapper): span = 0, a window's batches split over
// `split` blocks of a cluster, staged sb at a time (wgrad_kernel: whole
// rows); span > 0 (a multiple of a chunk, 32 f32 or 64 bf16 columns, up to
// kSpanCols), the window's items split over the cluster in contiguous runs
// (wgrad_span_kernel): sb 1, items of one batch's span output columns (rows
// of any length); sb > 1, items of the whole rows of sb batches (sb * T_out
// <= span; in bf16 T_out even, so that no register's pair of columns
// straddles two batches).
int hmvae_conv_wgrad(const void* gy, const void* y, const void* x, const void* wrow,
                     const void* wchunk, void* gw, void* gb, int n_tiles, int B, int C,
                     int T_in, int K, int P, int T_out, int t_ld, int stride, int padding,
                     int reflect, float slope, int sb, int split, int span, int windows,
                     int dtype, int device, void* stream) {
  const void* ptrs[] = {gy, y, x, gw};
  const int esz = dtype == 1 ? 2 : 4;
  if (!shape_ok(B, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, device, ptrs, 4, esz) ||
      dtype < 0 || dtype > 1 || n_tiles < 0 || n_tiles > 65535 || sb < 1 || split < 1 ||
      split > kMaxSplit || windows < 1 || windows > 65535 || B % windows != 0 || span < 0 ||
      span % (128 / esz) != 0 || span > kSpanCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_win = B / windows;
  const bool rows = span > 0 && sb > 1;  // items of several batches' whole rows
  // their 3D boxes: rows of whole 16-byte granules, at most 256 values a box
  // side; K <= 15 (one m64 tile a warpgroup)
  if (rows && (sb > n_win || sb * T_out > span || (dtype == 1 && T_out % 2 != 0) ||
               (T_in * esz) % 16 != 0 || T_in > 256 || t_ld > 256 || sb > 256 ||
               (K + 1) * kCC > 2 * 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = span == 0 ? n_win
                    : rows    ? (n_win + sb - 1) / sb
                              : n_win * ((T_out + span - 1) / span);
  if (split > items) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const size_t smem =
      span > 0 ? wgrad_span_layout(K, stride, span, esz, rows ? sb : 1, T_in, T_out, t_ld).total
               : wgrad_layout(n_win, T_in, K, T_out, t_ld, stride, sb, split, esz).total;
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  // K + 1 tap tiles over the 8 warps: 2 a warp up to K = 15, 3 up to 23, 4 up to 31
  const int nq = (K + kWarps) / kWarps;
  // (K + 1) * 8 (tap, channel) rows of the item kernel in m64 tiles over its two warpgroups
  const bool nt2 = (K + 1) * kCC > 2 * 64;
  // whole rows f32 (0-2) and bf16 (3-5); the item kernels f32 (6, 7) and
  // bf16 (8, 9), over several batches' rows f32 (10) and bf16 (11)
  const int sel = span == 0 ? max(nq, 2) - 2 + 3 * dtype
                  : rows    ? 10 + dtype
                            : 6 + 2 * dtype + nt2;
  static bool ready[12][kMaxDevices] = {};
  const int plan[5] = {sb, split, span, static_cast<int>(smem), 0};
  for (int i = 0; i < 5; ++i) last_wgrad[i] = plan[i];
  const dim3 grid(split, n_tiles, windows);
  if (span > 0) {
    CUtensorMap gy_map = {}, y_map = {}, x_map = {};
    const bool mapped =
        rows ? batch_rows_map(&gy_map, gy, t_ld, P, B, min(kRows, P), sb, esz) &&
                   batch_rows_map(&y_map, y, t_ld, P, B, min(kRows, P), sb, esz) &&
                   batch_rows_map(&x_map, x, T_in, C, B, kCC, sb, esz)
             : span_row_map(&gy_map, gy, t_ld, static_cast<long long>(B) * P, esz) &&
                   span_row_map(&y_map, y, t_ld, static_cast<long long>(B) * P, esz);
    if (!mapped) return static_cast<int>(cudaErrorNotSupported);
    auto launch = rows ? (dtype == 1 ? wgrad_items<1, __nv_bfloat16, true>
                                     : wgrad_items<1, float, true>)
                  : dtype == 1 ? (nt2 ? wgrad_items<2, __nv_bfloat16, false>
                                      : wgrad_items<1, __nv_bfloat16, false>)
                               : (nt2 ? wgrad_items<2, float, false> : wgrad_items<1, float, false>);
    return launch(ready[sel], device, grid, split, smem, stream, gy_map, y_map, x_map, gy, y, x,
                  wrow, wchunk, gw, gb, n_win, C, T_in, K, P, T_out, t_ld, stride, padding,
                  reflect, slope, span, rows ? sb : 1);
  }
  auto launch = dtype == 1 ? (nq <= 2   ? wgrad_rows<2, __nv_bfloat16>
                              : nq == 3 ? wgrad_rows<3, __nv_bfloat16>
                                        : wgrad_rows<4, __nv_bfloat16>)
                           : (nq <= 2 ? wgrad_rows<2, float>
                              : nq == 3 ? wgrad_rows<3, float> : wgrad_rows<4, float>);
  return launch(ready[sel], device, grid, split, smem, stream, gy, y, x, wrow, wchunk, gw, gb,
                n_win, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, slope, sb);
}

// Folded-weight gradients gw (windows x (P, C, K)) and bias gradients gb
// (windows x (P,)) of `windows` windows of B / windows batches each, from
// gy, y (B, P, rows of t_ld values, whole 16-byte granules) and x (B, C,
// T_in), all f32 (dtype 0) or all bf16 (dtype 1), C a multiple of 8, every
// pointer 16-byte aligned: wgrad_tiles_kernel over the n_tiles entries of
// wgrad_row / wgrad_chunk of every window, in `blocks` persistent blocks
// (at most the units, n_tiles x windows; wgrad_tiles_plan in the wrapper),
// every element of gw written (the dead tiles' zeros too), so the caller
// clears nothing.  A window's columns (B / windows x T_out) at most
// kTilesCols, K <= 15, in bf16 T_out even where a window has several
// batches.  Launches on `stream`, returns the first CUDA error (0 on
// success).
int hmvae_conv_wgrad_tiles(const void* gy, const void* y, const void* x, const void* wrow,
                           const void* wchunk, void* gw, void* gb, int n_tiles, int B, int C,
                           int T_in, int K, int P, int T_out, int t_ld, int stride, int padding,
                           int reflect, float slope, int blocks, int windows, int dtype,
                           int device, void* stream) {
  const void* ptrs[] = {gy, y, x, gw, gb};
  const int esz = dtype == 1 ? 2 : 4;
  if (!shape_ok(B, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, device, ptrs, 4, esz) ||
      dtype < 0 || dtype > 1 || gb == nullptr || n_tiles < 1 || windows < 1 ||
      B % windows != 0 || (K + 1) * kCC > 2 * 64 ||
      static_cast<long long>(n_tiles) * windows > 0x7FFFFFFFLL || blocks < 1 ||
      blocks > n_tiles * windows || blocks > 0x7FFFFFFF / kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = B / windows;
  if (nb * T_out > kTilesCols || (dtype == 1 && nb > 1 && T_out % 2 != 0) ||
      n_tiles > kTilesMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wgrad_tiles_layout(K, stride, nb, T_in, T_out, t_ld, n_tiles, esz).total;
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap gw_map = {}, zero_map = {};
  if (!tiles_map(&gw_map, gw, C, K, P, windows, kRows, esz) ||
      !tiles_map(&zero_map, gw, C, K, P, windows, kZeroRows, esz))
    return static_cast<int>(cudaErrorNotSupported);
  const int plan[5] = {1, 1, 0, static_cast<int>(smem), blocks};
  for (int i = 0; i < 5; ++i) last_wgrad[i] = plan[i];
  static bool ready[2][kMaxDevices] = {};
  auto launch = dtype == 1 ? wgrad_tiles<__nv_bfloat16> : wgrad_tiles<float>;
  return launch(ready[dtype], device, blocks, smem, stream, gw_map, zero_map, gy, y, x, wrow,
                wchunk, gb, n_tiles, windows, nb, C, T_in, K, P, T_out, t_ld, stride, padding,
                reflect, slope);
}

// Input gradients gx (B, C, T_in) of `windows` windows of B / windows
// batches each, window i's batches through its own folded weight w
// (windows x (P, C, K)), from gy, y (B, P, rows of t_ld values, whole
// 16-byte granules), all f32 (dtype 0) or all bf16 (dtype 1), C a multiple
// of 8, every pointer 16-byte aligned: dgrad_tiles_kernel over the windows'
// (window, 8-channel chunk) units, a chunk's live row tiles
// chunk_start[c]..chunk_start[c + 1] of chunk_row (pack_structure's
// dgrad_chunk_start / dgrad_chunk_row, `entries` of them), in `blocks`
// persistent blocks (at most the units; dgrad_tiles_plan in the wrapper),
// every element of gx written.  A window's columns (B / windows x T_out)
// at most 64, K <= 15, stride 1 or 2.  Launches on `stream`, returns the
// first CUDA error (0 on success).
int hmvae_conv_dgrad_tiles(const void* gy, const void* y, const void* w, const void* chunk_start,
                           const void* chunk_row, void* gx, int entries, int B, int C, int T_in,
                           int K, int P, int T_out, int t_ld, int stride, int padding,
                           int reflect, float slope, int blocks, int windows, int dtype,
                           int device, void* stream) {
  const void* ptrs[] = {gy, y, w, gx};
  const int esz = dtype == 1 ? 2 : 4;
  if (!shape_ok(B, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, device, ptrs, 4, esz) ||
      dtype < 0 || dtype > 1 || chunk_start == nullptr || entries < 0 ||
      (chunk_row == nullptr && entries > 0) ||
      windows < 1 || windows > 65535 || B % windows != 0 || K > kDgradTilesMaxK || stride > 2 ||
      blocks < 1 || static_cast<long long>(blocks) > static_cast<long long>(windows) * (C / kCC))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = B / windows, nch = C / kCC;
  const DgradTilesLayout L = dgrad_tiles_layout(K, P, nb * T_out, nch, entries, esz);
  if (L.nt == 0 || L.stages < 2 || L.total > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap w_map = {};
  if (!tiles_map(&w_map, const_cast<void*>(w), C, K, P, windows, kRows, esz))
    return static_cast<int>(cudaErrorNotSupported);
  const int plan[9] = {nb, 1, 1, 0, 1, static_cast<int>(L.total), L.stages, kCC, blocks};
  for (int i = 0; i < 9; ++i) last_dgrad[i] = plan[i];
  // f32 then bf16, N tiles 8, 16, 32, 64
  static bool ready[8][kMaxDevices] = {};
  using Launch = int (*)(bool (&)[kMaxDevices], int, int, size_t, void*, const CUtensorMap&,
                         const void*, const void*, const void*, const void*, void*, int, int, int,
                         int, int, int, int, int, int, int, int, int, float);
  static const Launch launches[8] = {
      dgrad_tiles<float, 8>,          dgrad_tiles<float, 16>,
      dgrad_tiles<float, 32>,         dgrad_tiles<float, 64>,
      dgrad_tiles<__nv_bfloat16, 8>,  dgrad_tiles<__nv_bfloat16, 16>,
      dgrad_tiles<__nv_bfloat16, 32>, dgrad_tiles<__nv_bfloat16, 64>};
  const int sel = 4 * dtype + (L.nt == 8 ? 0 : L.nt == 16 ? 1 : L.nt == 32 ? 2 : 3);
  return launches[sel](ready[sel], device, blocks, L.total, stream, w_map, gy, y, chunk_start,
                       chunk_row, gx, entries, windows, nb, C, T_in, K, P, T_out, t_ld, stride,
                       padding, reflect, slope);
}

// The most clusters of `split` (1 to kMaxSplit) dgrad_span_kernel blocks of
// span `span` at K, stride, f32 (dtype 0) or bf16 (dtype 1), that `device`
// (current) runs at once, into *out; returns the first CUDA error.
int hmvae_dgrad_span_clusters(int K, int stride, int span, int split, int dtype, int device,
                              int* out) {
  if (K < 1 || K > kMaxK || stride < 1 || span < 1 || split < 1 || split > kMaxSplit ||
      dtype < 0 || dtype > 1 || device < 0 || device >= kMaxDevices || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[2][kMaxDevices] = {};
  const size_t smem = dgrad_span_layout(K, stride, span, dtype == 1 ? 2 : 4).total;
  return dtype == 1 ? span_clusters<__nv_bfloat16>(ready[1], device, split, smem, out)
                    : span_clusters<float>(ready[0], device, split, smem, out);
}

// The plans of the last launches (see last_dgrad, last_wgrad): dgrad's nine
// ints into out[0..8], wgrad's five into out[9..13].
void hmvae_conv_bwd_last_plan(int* out) {
  for (int i = 0; i < 9; ++i) out[i] = last_dgrad[i];
  for (int i = 0; i < 5; ++i) out[9 + i] = last_wgrad[i];
}

// The runs on `device` of the dgrad kernels, then the wgrad kernels, since the last
// reset (run_counter.h), after the device has finished its work, into
// out[2]; then 0 where `reset`.
int hmvae_conv_bwd_device_runs(int device, int reset, unsigned long long* out) {
  return static_cast<int>(read_runs(g_runs, device, reset, out));
}

const char* hmvae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
