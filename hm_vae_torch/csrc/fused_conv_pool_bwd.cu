// The backward of one skeleton-conv level (fused_conv_pool.cu's forward) on
// Hopper, in f32: the input gradient (dgrad) and the folded weight's and
// bias's gradients (wgrad), two kernels on the tensor cores.
//
// The JAX package has no backward kernel: it differentiates its XLA level in
// hm_vae_tpu/models/hm_vae.py (SkeletonConv: the conv on the folded weight
// P @ (W*mask) @ U, bias P @ b, then LeakyReLU).  These kernels are the
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
// the tensor cores, 165 as 3xTF32).  At the len-64 model's batch of 8 each
// kernel does ~1/3 of the forward's multiply-adds per level (a few GFLOP
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
//   is staged;
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
//   source (the padding's adjoint) and stores gx row by row;
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
//   16-byte loads.
// - windows: the test-time solver gives every window of its batch its own
//   decoder clone (hm_vae_tpu/apps/latent_opt.py, jax.vmap over windows
//   with the decoder on axis 0).  Both kernels then take `windows` weights
//   (dgrad) or gradients (wgrad), one after the other: a dgrad block's
//   batch group lies inside one window and stages that window's weight
//   rows; a wgrad block (grid z: the window) sums over its window's batches
//   only, its cluster split too.  One window is the kernels' plain form.
// Limits: f32, C a multiple of 8 (the wrappers pad), K <= 31 (wgrad's 32
// tap tiles), and shared memory: dgrad's two weight stages are 32 rows of
// 16 channels x K taps (127 KB at K 31, so one block an SM there) beside
// g's padded rows; dgrad's padded rows of a batch group fill at most 16
// column tiles (dgrad_plan gives a group of several batches at most one
// tile a warp, so a padded row of up to 256 / stride columns).
// Times against the bounds, and traces of both kernels (kernel_trace.py),
// are in PERF.md.

#include <cooperative_groups.h>
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

__device__ unsigned long long g_runs[2];  // dgrad_kernel, wgrad_kernel (run_counter.h)

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

// The smallest row stride >= len (in 8-byte words) that is 4 mod 16: a
// half-warp's 16 lanes, four rows of four consecutive words, read 16
// different bank pairs.
__host__ __device__ __forceinline__ int frag_stride(int len) { return (len + 11) / 16 * 16 + 4; }

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// ---------------------------------------------------------------------------
// dgrad

struct DgradLayout {
  int Tp, off, rs, wr;  // padded width, g's time offset (a phase's taps - 1),
                        // g2's row stride (8-byte words), a weight row (floats)
  size_t bars, w, g, g2, out, total;  // byte offsets in shared memory
};

// A stage is half a row tile: 32 weight rows of the block's 16 channels and
// the same rows of gy and y, so that two blocks fit an SM.  Two weight
// stages in flight (a stage's rows are read by the products); one stage of
// gy and y, refilled as soon as it is rewritten into g2.  gxpad (16
// channels x the group's padded rows) reuses the weight stages.
__host__ __device__ inline DgradLayout dgrad_layout(int T_in, int K, int T_out, int t_ld,
                                                    int stride, int padding, int nbb) {
  DgradLayout L;
  L.Tp = T_in + 2 * padding;
  L.off = (K + stride - 1) / stride - 1;
  const int V0 = (L.Tp + stride - 1) / stride;
  L.rs = frag_stride(L.off + (V0 > T_out ? V0 : T_out));
  L.wr = kDC * K + 8;  // 16-byte rows; 8 more floats spread a fragment's rows over the banks
  L.bars = 0;
  L.w = 64;
  L.g = L.w + align16(size_t(kStages) * kHalf * L.wr * 4);
  L.g2 = L.g + align16(size_t(2) * nbb * kHalf * t_ld * 4);
  const size_t out_bytes = size_t(kDC) * nbb * L.Tp * 4;
  const size_t g2_end = L.g2 + size_t(nbb) * kHalf * L.rs * 8;
  L.out = out_bytes <= L.g - L.w ? L.w : align16(g2_end);
  L.total = L.out == L.w ? g2_end : L.out + out_bytes;
  return L;
}

__global__ void __launch_bounds__(kThreads, 2)
dgrad_kernel(const float* __restrict__ gy, const float* __restrict__ y,
             const float* __restrict__ w, const int* __restrict__ dgrad_start,
             const int* __restrict__ dgrad_row, float* __restrict__ gx, int B, int C, int T_in,
             int K, int P, int T_out, int t_ld, int stride, int padding, int reflect,
             float slope, int nbb, int gpw, size_t w_stride) {
  count_run(&g_runs[0]);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const DgradLayout L = dgrad_layout(T_in, K, T_out, t_ld, stride, padding, nbb);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // weight [kStages], then g
  float* w_s = reinterpret_cast<float*>(smem + L.w);             // [kStages][32][wr]
  float* g_s = reinterpret_cast<float*>(smem + L.g);             // [2][nbb][32][t_ld]
  float2* g2 = reinterpret_cast<float2*>(smem + L.g2);           // [nbb][32][rs]
  float* out_s = reinterpret_cast<float*>(smem + L.out);         // [16][nbb][Tp]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * kDC;
  const int cw = min(kDC, C - c0);  // 16, or 8 for a last odd chunk
  // window `win` owns the batches [win*B, (win+1)*B) in gpw groups, and its
  // own folded weight
  const int win = blockIdx.y / gpw;
  const int b0 = win * B + (blockIdx.y - win * gpw) * nbb;
  const int nbl = min(nbb, (win + 1) * B - b0);
  const float* wwin = w + win * w_stride;
  const int first = dgrad_start[blockIdx.x];
  const int live = dgrad_start[blockIdx.x + 1] - first;
  // stages: both halves of each of the block's live row tiles
  const int n_mine = live > rank ? 2 * ((live - rank + split - 1) / split) : 0;
  const int wt = kHalf * L.wr;        // floats of a weight stage
  const int gt = nbb * kHalf * t_ld;  // floats of gy (or y) in a stage
  auto stage_row = [&](int i) {
    return dgrad_row[first + rank + (i >> 1) * split] * kRows + (i & 1) * kHalf;
  };

  // Stage i: its weight rows (cw*K contiguous floats each; thread r copies
  // row r) into weight stage `slot`, or the batches' rows of gy and y (one
  // contiguous run each; threads 32.. copy).  Thread 0 arms the barrier; a
  // copy may land before it does, the phase completes only after both.
  auto issue_w = [&](int i, int slot) {
    const int p0 = stage_row(i), nrows = max(0, min(kHalf, P - p0));
    const uint32_t w_row = cw * K * 4;
    if (tid == 0) mbar_expect(smem_addr(bars + slot), nrows * w_row);
    if (tid < nrows) {
      fence_async();
      bulk_copy(w_s + slot * wt + tid * L.wr, wwin + (size_t(p0 + tid) * C + c0) * K, w_row,
                bars + slot);
    }
  };
  auto issue_g = [&](int i) {
    const int p0 = stage_row(i), nrows = max(0, min(kHalf, P - p0));
    const uint32_t g_bytes = nrows * t_ld * 4;
    if (tid == 0) mbar_expect(smem_addr(bars + kStages), 2 * nbl * g_bytes);
    const int q = tid - kHalf;
    if (nrows > 0 && q >= 0 && q < 2 * nbl) {
      const int which = q / nbl, bb = q - which * nbl;
      fence_async();
      bulk_copy(g_s + which * gt + bb * kHalf * t_ld,
                (which ? y : gy) + (size_t(b0 + bb) * P + p0) * t_ld, g_bytes,
                bars + kStages);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages + 1; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // g's time padding stays zero (a stage writes only t in [0, T_out)), and
  // so do the weight rows' second chunk where the block has one chunk
  for (int q = tid; q < nbb * kHalf * L.rs; q += kThreads) g2[q] = make_float2(0.f, 0.f);
  if (cw < kDC)
    for (int q = tid; q < kStages * wt; q += kThreads) w_s[q] = 0.f;
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
      V = (L.Tp - phi + stride - 1) / stride;
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
      base[w][h] = has_tile && bb < nbl ? bb * kHalf * L.rs + L.off + r - bb * Vs[w] : L.off;
    }
  }

  float sum[kMaxTiles][2][4] = {};  // per tile, the two chunks' 16 x 8 tiles
  for (int i = 0; i < n_mine; ++i) {
    const int slot = i % kStages;
    const int nrows = max(0, min(kHalf, P - stage_row(i)));
    mbar_wait(smem_addr(bars + kStages), i & 1);
    // g = gy * act'(y), split, into its zero-padded rows
    for (int q = tid; q < nbl * kHalf * T_out; q += kThreads) {
      const int bb = q / (kHalf * T_out), rem = q - bb * (kHalf * T_out);
      const int r = rem / T_out, t = rem - r * T_out;
      const int o = (bb * kHalf + r) * t_ld + t;
      const float v = r < nrows ? act_grad(g_s[o], g_s[gt + o], slope) : 0.f;
      g2[(bb * kHalf + r) * L.rs + L.off + t] = split_tf32(v);
    }
    mbar_wait(smem_addr(bars + slot), (i / kStages) & 1);
    // weight rows past P (a ragged last tile) read as zeros
    for (int q = nrows * L.wr + tid; q < wt; q += kThreads) w_s[slot * wt + q] = 0.f;
    __syncthreads();  // g and the weight rows are staged
    if (i + 1 < n_mine) issue_g(i + 1);  // overlaps the products

#pragma unroll
    for (int w = 0; w < kMaxTiles; ++w) {
      // per chunk four independent sums (small and big products, even and
      // odd rows of 8), so that consecutive mma.sync do not wait on each
      // other, added in f32 after each tap; each g fragment feeds both chunks
      const float* ws = w_s + slot * wt;
      for (int m = 0; m < taps[w]; ++m) {
        const int k = phis[w] + stride * m;
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
    __syncthreads();  // every warp is done with this stage's weight rows and g2
    if (i + kStages < n_mine) issue_w(i + kStages, slot);
  }

  // gxpad of the block's rows -> out_s (over the weight stages, now unread);
  // a block alone in its cluster skips the cluster barriers
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
    const int n_el = cw * nbl * T_in;
    const int lo = n_el * rank / split, hi = n_el * (rank + 1) / split;
    for (int el = lo + tid; el < hi; el += kThreads) {
      const int c = el / (nbl * T_in), rem = el - c * (nbl * T_in);
      const int bb = rem / T_in, i = rem - bb * T_in;
      const int row = (c * nbb + bb) * L.Tp;
      // the padded columns that read x[b, c, i]: i + padding, and under
      // reflect the mirrored columns, each summed over the cluster in order
      auto column = [&](int u) {
        float s = part[0][row + u];
#pragma unroll
        for (int q = 1; q < kMaxSplit; ++q)
          if (q < split) s += part[q][row + u];
        return s;
      };
      float v = column(i + padding);
      if (reflect && i >= 1 && i <= padding) v += column(padding - i);
      if (reflect && i <= T_in - 2 && i >= T_in - 1 - padding)
        v += column(padding + 2 * (T_in - 1) - i);
      gx[(size_t(b0 + bb) * C + c0 + c) * T_in + i] = v;
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its partial gxpad
}

// ---------------------------------------------------------------------------
// wgrad

struct WgradLayout {
  int Lh, rsx;       // x: a stride phase's padded columns, the row stride (8-byte words)
  int ks, rj;        // k-steps of a stage; a row of the gradient tile: (c, k), the bias, pad
  int nb_max, slots;  // the most batches of a block; stages of gy and y in flight
  size_t bars, xp, g, gf, total;  // byte offsets in shared memory
};

// x's raw rows wait in the fragment buffer until x is padded; the partial
// gradient tile reuses the stages at the end.  Two stages of gy and y are
// in flight where the block still fits two to an SM, else one.
__host__ __device__ inline WgradLayout wgrad_layout(int B, int T_in, int K, int T_out, int t_ld,
                                                    int stride, int sb, int split) {
  WgradLayout L;
  L.nb_max = (B + split - 1) / split;
  const int n_st = (L.nb_max + sb - 1) / sb;
  const int Lx = (T_out - 1) * stride + K;  // padded columns the taps read
  L.Lh = (Lx + stride - 1) / stride;
  L.rsx = frag_stride(stride * L.Lh);
  L.ks = (sb * T_out + 7) / 8;
  L.rj = kCC * K + 4;  // 16-byte rows
  L.bars = 0;
  L.xp = 64;
  L.g = L.xp + align16(size_t(L.nb_max) * kCC * L.rsx * 8);
  const size_t stage = align16(size_t(2) * sb * kRows * t_ld * 4);
  const size_t gf = size_t(L.ks) * 4 * 32 * 8 * 4;
  const size_t x_raw = size_t(L.nb_max) * kCC * T_in * 4;
  const size_t red = size_t(kRows) * L.rj * 4;
  for (L.slots = n_st < kStages ? n_st : kStages;; --L.slots) {
    L.gf = L.g + L.slots * stage;
    L.total = L.gf + (gf > x_raw ? gf : x_raw);
    if (L.total < L.g + red) L.total = L.g + red;
    if (L.slots == 1 || L.total <= kSmemPerSM / 2 - 1024) break;
  }
  return L;
}

template <int NQ>  // 8-column tiles of the gradient (taps, then the bias) per warp
__global__ void __launch_bounds__(kThreads, NQ == 2 ? 2 : 1)
wgrad_kernel(const float* __restrict__ gy, const float* __restrict__ y,
             const float* __restrict__ x, const int* __restrict__ wrow,
             const int* __restrict__ wchunk, float* __restrict__ gw, float* __restrict__ gb,
             int B, int C, int T_in, int K, int P, int T_out, int t_ld, int stride, int padding,
             int reflect, float slope, int sb) {
  count_run(&g_runs[1]);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const WgradLayout L = wgrad_layout(B, T_in, K, T_out, t_ld, stride, sb, split);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // x, then [slots]
  float2* xp = reinterpret_cast<float2*>(smem + L.xp);           // [nb_max][8][rsx]
  float* g_s = reinterpret_cast<float*>(smem + L.g);             // [slots][2][sb][64][t_ld]
  float4* gf = reinterpret_cast<float4*>(smem + L.gf);           // [ks][4][32][2]
  float* x_s = reinterpret_cast<float*>(smem + L.gf);            // [nb_max][8][T_in], first
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
  float* gw_w = gw + size_t(win) * P * C * K;
  float* gb_w = gb + size_t(win) * P;
  const int n_st = (nb + sb - 1) / sb;
  const int gt = sb * kRows * t_ld;  // floats of gy (or y) in a stage
  const size_t stage_floats = (L.gf - L.g) / 4 / L.slots;

  // Stage i into `slot`: batches b_lo + i*sb .. of gy and y, rows p0.. (one
  // contiguous run per batch and tensor).  Thread 0 issues.
  auto issue = [&](int i, int slot) {
    const int nbs = min(sb, nb - i * sb);
    const uint32_t bytes = nrows * t_ld * 4;
    float* dst = g_s + slot * stage_floats;
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
      const uint32_t bytes = kCC * T_in * 4;
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
  const int Tp = T_in + 2 * padding;
  for (int q = tid; q < nb * kCC * stride * L.Lh; q += kThreads) {
    const int row = q / (stride * L.Lh), idx = q - row * (stride * L.Lh);
    const int ph = idx / L.Lh, u = (idx - ph * L.Lh) * stride + ph;
    int s = u - padding;
    if ((s < 0 || s >= T_in) && u < Tp) s = reflect ? (s < 0 ? -s : 2 * (T_in - 1) - s) : -1;
    const float v = has_x && s >= 0 && s < T_in ? x_s[row * T_in + s] : 0.f;
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
    // g = gy * act'(y), split, in the A fragments' order: a thread writes
    // one lane's four values of one k-step and row tile (rows r, r + 8 at
    // columns n, n + 4) as a 16-byte big and a 16-byte small part
    const float* gys = g_s + slot * stage_floats;
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
          v[2 * h + lo] = n < ncols && r < nrows ? act_grad(gys[o], gys[gt + o], slope) : 0.f;
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
    __syncthreads();  // the fragments are staged; the stage's copies are read
    if (tid == 0 && i + L.slots < n_st) {  // the next copy overlaps the products
      fence_async();
      issue(i + L.slots, slot);
    }

    for (int ks = 0; ks < L.ks; ++ks) {
      // B: x at the lane's two columns n = 8*ks + tig (+4); padded columns
      // past the stage read column 0 (their g is zero)
      uint32_t bbig[NQ][2], bsml[NQ][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = ks * 8 + tig + 4 * h;
        const int bb = n < ncols ? n / T_out : 0, t = n < ncols ? n - bb * T_out : 0;
        const int xb = ((i * sb + bb) * kCC + gid) * L.rsx + t;
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
          const int q = warp + kWarps * qq;
          const float2 v = q < K ? xp[xb + koff[qq]]
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
      // 3xTF32, each kind over all 4*NQ independent tiles before the next;
      // a k-step's sum (24 products) is added in f32
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
  }

  // The partial gradient tile -> red[p][c*K + k] (bias at 8*K), over the
  // stages, now unread; then block `rank` sums its rows over the cluster in
  // rank order and stores them, 16 bytes at a time (row p's chunk is 8*K
  // contiguous floats of gw).  A block alone in its cluster skips the
  // cluster barriers.
  __syncthreads();
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
          red[p * L.rj + c * K + q] = sum[a][qq][r];
        else if (c == 0)
          red[p * L.rj + kCC * K] = sum[a][qq][r];
      }
    }
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
    const int o = r * L.rj + 4 * j4;
    float4 v = *reinterpret_cast<const float4*>(part[0] + o);
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q) {
      if (q >= split) break;
      const float4 w = *reinterpret_cast<const float4*>(part[q] + o);
      v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
    }
    *reinterpret_cast<float4*>(gw_w + (size_t(p0 + r) * C + c0) * K + 4 * j4) = v;
  }
  if (writes_bias && tid < r_hi - r_lo) {
    const int o = (r_lo + tid) * L.rj + kCC * K;
    float v = part[0][o];
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q)
      if (q < split) v += part[q][o];
    gb_w[p0 + r_lo + tid] = v;
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its partial tile
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

bool shape_ok(int B, int C, int T_in, int K, int P, int T_out, int t_ld, int stride,
              int padding, int reflect, int device, const void* const* ptrs, int n_ptrs) {
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return false;
  return B > 0 && C > 0 && C % kCC == 0 && T_in > 0 && K > 0 && K <= kMaxK && P > 0 &&
         T_out > 0 && t_ld >= T_out && t_ld % 4 == 0 && stride > 0 && padding >= 0 &&
         !(reflect && padding >= T_in) && (T_out - 1) * stride + K <= T_in + 2 * padding &&
         T_in + 2 * padding - K < T_out * stride && device >= 0 && device < kMaxDevices &&
         static_cast<long long>(B) * C * T_in < 0x7FFFFFFFLL &&
         static_cast<long long>(B) * P * t_ld < 0x7FFFFFFFLL;
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int cluster_z, int cluster_x, size_t smem,
                           void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
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

}  // namespace

extern "C" {

// Input gradient gx (B, C, T_in) of a level from gy, y (B, P, rows of t_ld
// >= T_out floats) and the folded weight w (windows x (P, C, K): window i
// of the batch, B / windows batches, reads the i-th), all f32, C a
// multiple of 8, every pointer 16-byte aligned; dgrad_start / dgrad_row:
// the row tiles live in either chunk of each pair of 8-channel chunks
// (pack_structure).  The plan (dgrad_plan in the wrapper): batch groups of
// nbb batches within a window, the row tiles of a pair split over `split`
// blocks of a cluster.  Launches on `stream`, returns the first CUDA error
// (0 on success).
int hmvae_conv_dgrad(const void* gy, const void* y, const void* w, const void* dgrad_start,
                     const void* dgrad_row, void* gx, int B, int C, int T_in, int K, int P,
                     int T_out, int t_ld, int stride, int padding, int reflect, float slope,
                     int nbb, int split, int windows, int device, void* stream) {
  const void* ptrs[] = {gy, y, w, gx};
  if (!shape_ok(B, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, device, ptrs, 4) ||
      windows < 1 || B % windows != 0 || nbb < 1 || nbb > B / windows || split < 1 ||
      split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_win = B / windows;
  const DgradLayout L = dgrad_layout(T_in, K, T_out, t_ld, stride, padding, nbb);
  int tiles = 0;  // 16-column tiles of a batch group: one per warp
  for (int phi = 0; phi < stride; ++phi)
    tiles += (nbb * ((L.Tp - phi + stride - 1) / stride) + 15) / 16;
  const int gpw = (n_win + nbb - 1) / nbb;  // batch groups of a window
  if (tiles > kWarps * kMaxTiles || L.total > static_cast<size_t>(kMaxSmem) ||
      static_cast<long long>(windows) * gpw > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_smem(dgrad_kernel, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_cluster(
      dgrad_kernel, dim3((C + kDC - 1) / kDC, windows * gpw, split), split, 1, L.total, stream,
      static_cast<const float*>(gy), static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<const int*>(dgrad_start), static_cast<const int*>(dgrad_row),
      static_cast<float*>(gx), n_win, C, T_in, K, P, T_out, t_ld, stride, padding, reflect,
      slope, nbb, gpw, size_t(P) * C * K));
}

// Folded-weight gradient gw (windows x (P, C, K)) on the n_tiles entries of
// wgrad_row / wgrad_chunk (pack_structure: the live tiles by row tile,
// chunk -1 for a row tile with none; the caller zeroes the rest) and bias
// gradient gb (windows x (P,)), from gy, y (B, P, rows of t_ld floats) and x
// (B, C, T_in), all f32, C a multiple of 8, every pointer 16-byte aligned.
// Window i's gradient sums over its own B / windows batches only.  The plan
// (wgrad_plan in the wrapper): a window's batches split over `split` blocks
// of a cluster, staged sb at a time.
int hmvae_conv_wgrad(const void* gy, const void* y, const void* x, const void* wrow,
                     const void* wchunk, void* gw, void* gb, int n_tiles, int B, int C,
                     int T_in, int K, int P, int T_out, int t_ld, int stride, int padding,
                     int reflect, float slope, int sb, int split, int windows, int device,
                     void* stream) {
  const void* ptrs[] = {gy, y, x, gw};
  if (!shape_ok(B, C, T_in, K, P, T_out, t_ld, stride, padding, reflect, device, ptrs, 4) ||
      n_tiles < 0 || n_tiles > 65535 || sb < 1 || split < 1 || split > kMaxSplit ||
      windows < 1 || windows > 65535 || B % windows != 0 || split > B / windows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const int n_win = B / windows;
  const WgradLayout L = wgrad_layout(n_win, T_in, K, T_out, t_ld, stride, sb, split);
  if (L.total > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  // K + 1 tap tiles over the 8 warps: 2 a warp up to K = 15, 3 up to 23, 4 up to 31
  const int nq = (K + kWarps) / kWarps;
  auto kernel = nq <= 2 ? wgrad_kernel<2> : nq == 3 ? wgrad_kernel<3> : wgrad_kernel<4>;
  static bool ready[3][kMaxDevices] = {};
  cudaError_t err = allow_smem(kernel, ready[max(nq, 2) - 2], device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_cluster(
      kernel, dim3(split, n_tiles, windows), 1, split, L.total, stream,
      static_cast<const float*>(gy), static_cast<const float*>(y), static_cast<const float*>(x),
      static_cast<const int*>(wrow), static_cast<const int*>(wchunk), static_cast<float*>(gw),
      static_cast<float*>(gb), n_win, C, T_in, K, P, T_out, t_ld, stride, padding, reflect,
      slope, sb));
}

// The runs on `device` of dgrad_kernel, then wgrad_kernel, since the last
// reset (run_counter.h), after the device has finished its work, into
// out[2]; then 0 where `reset`.
int hmvae_conv_bwd_device_runs(int device, int reset, unsigned long long* out) {
  return static_cast<int>(read_runs(g_runs, device, reset, out));
}

const char* hmvae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
