// One level of the skeleton-aware VAE as a block-sparse implicit GEMM on
// Hopper: the level's conv weight with the skeleton mask, the pool and the
// unpool folded in, bf16 products on the tensor cores (wgmma), weight tiles
// brought by bulk asynchronous copies (cp.async.bulk + mbarrier).
//
// Replaces the Pallas TPU kernel hm_vae_tpu/ops/pallas_kernels.py
// (fused_conv_pool, body _fused_kernel).  The wrapper
// (hm_vae_torch/ops/fused_conv_pool.py) folds the operands once, as the JAX
// module does (hm_vae_tpu/models/hm_vae.py: P @ (W*mask) @ U, P @ b), into
// Wf (P, C_in, K) and bf (P,), and this kernel computes
//
//   out[b, p, t] = act( bf[p] + sum_{c,k} Wf[p, c, k] * xpad[b, c, t*stride + k] )
//
// for x (B, C_in, T_in), where xpad is x padded in time by `padding`
// (reflect without edge repeat, or zeros) and act(v) = v >= 0 ? v : slope*v.
// x must be 16-byte aligned with C_in a multiple of 8 (the wrapper pads
// other shapes), so that every chunk's rows of x are whole bulk copies.
// As a GEMM: rows p, reduction j = (c, k), columns n = (b, t); the columns'
// operand is the im2col of xpad, built here in shared memory.
//
// Packed weight (pack_level in the wrapper): rows in tiles of 64, the
// reduction in chunks of CC input channels (16 in bf16, 8 in f32), so a
// chunk is J = CC*K reduction steps (240 at K = 15), tap-major (j = k*CC +
// c): one wgmma k-step per tap.  Only the (row tile, chunk) tiles holding a
// nonzero are stored, one after the other, each in the layout wgmma reads
// from shared memory (8x16-byte core matrices, no swizzle: row group stride
// 256 B, k half stride 128 B, k-step stride 2048 B), so one bulk copy
// brings a whole tile.  tile_start[rt] ..
// tile_start[rt+1] index the live tiles of row tile rt, tile_chunk their
// channel chunk.  In f32 a tile is two planes: big = Wf rounded to TF32 and
// small = Wf - big; the products are 3xTF32 (big*big + big*small +
// small*big, f32 accumulate), which keeps ~21 bits of the operands.  The
// tensor cores sum one chunk at a time; the chunks' sums add in f32 on the
// CUDA cores, which keeps long reductions (dec0: 42-84 chunks) accurate.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 989 TFLOP/s bf16 and
// 495 TFLOP/s TF32 dense).  At the len-64 model's batch of 8 the eight
// levels stream ~23 MB of live bf16 weight (46 MB as f32 big+small) for
// 1.6 GFLOP: a few microseconds of bytes and under 2 us of products, so a
// level is bound by the weight stream and by launch and pipeline latency;
// the products are tiny next to them.  At refine_vibe's batch of 237 the
// same levels need ~48 GFLOP for the same bytes: bound by operations
// (~50 us in bf16).
//
// What the design does about it:
// - block-sparse: all-zero 64x16-channel weight tiles (the skeleton mask
//   and pool leave 0-69% of them per level) are neither stored nor loaded;
// - a block owns a 64-row x 64-column output tile; each of its two
//   warpgroups runs wgmma.m64n32k16 (bf16) or m64n32k8 (TF32) on 32 of the
//   columns, f32 sums in registers, and both build the im2col tile;
// - thread 0 keeps kStages chunks in flight with cp.async.bulk: the weight
//   tile and, for each batch the block's columns touch, the chunk's rows
//   x[b, c0:c0+CC, :] (contiguous), all completing on the stage's mbarrier,
//   so no thread waits on a load of its own and the copies overlap the
//   products and the im2col work;
// - with the reduction tap-major, a 16-byte group of the im2col tile is
//   one tap's 8 (4) channels at one time step, gathered from shared memory
//   with padding and stride as index arithmetic on the time step;
// - levels with few output tiles (enc3: 11 at batch 8) split the live
//   chunks of a row tile over a thread-block cluster of up to 8 blocks and
//   sum the partial tiles in a fixed order through distributed shared
//   memory: no atomics, no second pass, the same bits every run;
// - the epilogue adds bf, applies LeakyReLU, casts and stores (B, P, T_out);
// - windows: the test-time solver gives every window of its batch its own
//   decoder clone (hm_vae_tpu/apps/latent_opt.py, jax.vmap over windows
//   with the decoder on axis 0).  The packed weights and biases of the
//   windows then lie one after the other, and the columns are tiled window
//   by window, so that a block's columns read one window's weight tiles (at
//   the decoder's T_out of 8-64 steps and one batch a window, a 64-column
//   tile is then 1/8 to all full).  One window is the kernel's plain form.
// - long kernels: a stage is one chunk's weight tile and im2col tile, both
//   CC x K wide.  Where two stages and the im2col tile of all K taps do not
//   fit a block's shared memory (f32 at K = 31, the trajectory model: a
//   127 KB tile), each chunk runs as ceil(K / seg) stages of at most `seg`
//   taps: the tap range's k-steps of each plane (contiguous in the packing)
//   are one bulk copy each, and the im2col tile is built for those taps
//   only.  The launcher picks the fewest segments that fit; at K <= 16 a
//   chunk is one stage, as before.
// - long rows: where whole rows do not fit shared memory, or fit only with
//   more tap segments, and a row is longer than the window a block's 64
//   output columns can read ((64 - 1) * stride + K columns, or padding + 1
//   where reflect folds more back), a stage holds, per batch the block
//   touches, only the columns [lo, hi] of each of the chunk's rows that its
//   outputs read, the padding resolved into the unpadded row: one bulk copy
//   a row, widened to whole 16-byte granules (so a row starts d < 16 bytes
//   into its slot), issued by the lanes of warp 0 together (the
//   conv_gemm_kernel<T, true> instantiation).  Its shared memory depends on
//   stride and K only, never on T, so any sequence length runs.  Where both
//   fit, whole rows are staged, one bulk copy of a batch's CC rows: fewer
//   copies a stage, and faster (PERF.md).
// - the plan (whole rows or windows, tap segments, shared memory, cluster
//   split) is fused_conv_pool_plan.h's, plain C++ that the wrapper also
//   builds for the host; hmvae_fused_conv_pool_last_plan returns the plan
//   the last launch ran.
// A block builds a stage's im2col tile and then runs its products; two
// blocks per SM (bf16) overlap the two.  Times against the bounds are in
// PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "fused_conv_pool_plan.h"
#include "run_counter.h"

namespace cg = cooperative_groups;

namespace {

using namespace hmvae_fwd;  // kBM, kBN, kMaxSplit, kRedBytes, kMaxSmem, the plan

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWN = 32;        // columns per warpgroup (wgmma N)
constexpr int kKStep = 2048;   // bytes of one k-step of a 64-row operand
constexpr int kMaxDevices = 64;

__device__ unsigned long long g_runs[1];  // conv_gemm_kernel (run_counter.h)

template <typename T> struct Traits;
template <> struct Traits<__nv_bfloat16> {
  static constexpr Elem kElem = kBf16;
  static constexpr int kCC = kElem.cc;          // input channels per chunk
  static constexpr int kPlanes = kElem.planes;  // weight and im2col planes
  static constexpr int kVec = 8;                // values per 16-byte core-matrix row
  static constexpr int kStages = kElem.stages;  // weight tiles in flight
};
template <> struct Traits<float> {
  static constexpr Elem kElem = kF32;
  static constexpr int kCC = kElem.cc;
  static constexpr int kPlanes = kElem.planes;  // TF32 big and small
  static constexpr int kVec = 4;
  static constexpr int kStages = kElem.stages;
};
static_assert(Traits<float>::kElem.bytes == sizeof(float) &&
                  Traits<__nv_bfloat16>::kElem.bytes == sizeof(__nv_bfloat16),
              "the plan's element sizes");

// The plan of the last launch in this process (hmvae_fused_conv_pool_last_plan).
Plan last_plan = {};

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
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, no swizzle, K-major: core matrices of
// 8 rows x 16 bytes; the two along k 128 bytes apart (leading byte offset),
// row groups of 8 rows 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HMVAE_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HMVAE_ACC16(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])

// d = A (64 x 16, bf16) * B (16 x 32, bf16) + (acc ? d : 0), A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HMVAE_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HMVAE_ACC16(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d = A (64 x 8, tf32) * B (8 x 32, tf32) + (acc ? d : 0), A and B K-major
// in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " HMVAE_D16
      ", %16, %17, p, 1, 1;\n}\n"
      : HMVAE_ACC16(d)
      : "l"(a), "l"(b), "r"(acc));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t tf32_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The byte offset of the 16-byte core-matrix row (row r, value group g) in a
// 64-row operand tile: k-step g/2, k half g%2, row group r/8, row r%8.
__device__ __forceinline__ int core_offset(int r, int g) {
  return (g >> 1) * kKStep + (g & 1) * 128 + (r >> 3) * 256 + (r & 7) * 16;
}

// The columns [lo, hi] of batch b's unpadded row that the output columns
// [n0, n1) read, the padding resolved: reflect folds padded positions back
// into the row, zeros read nothing (hi < lo: no column).
__device__ __forceinline__ void row_window(int b, int n0, int n1, int T_out, int T_in, int K,
                                           int stride, int padding, int reflect, int& lo,
                                           int& hi) {
  const int t0 = max(n0 - b * T_out, 0), t1 = min(n1 - b * T_out, T_out) - 1;
  const int s0 = t0 * stride - padding, s1 = t1 * stride - padding + K - 1;
  lo = max(s0, 0);
  hi = min(s1, T_in - 1);
  if (lo > hi) lo = T_in, hi = -1;
  if (reflect && s0 < 0) lo = min(lo, -min(s1, -1)), hi = max(hi, -s0);
  if (reflect && s1 >= T_in)
    lo = min(lo, 2 * T_in - 2 - s1), hi = max(hi, 2 * T_in - 2 - max(s0, T_in));
}

// kWin: rows staged as windows (xp: a row's slot), else whole (xp = T_in).
template <typename T, bool kWin>
__global__ void __launch_bounds__(kThreads, 2)
conv_gemm_kernel(const T* __restrict__ x, const T* __restrict__ wpack,
                 const float* __restrict__ bias, const int* __restrict__ tile_start,
                 const int* __restrict__ tile_chunk, T* __restrict__ out, int C_in, int T_in,
                 int K, int P, int T_out, int win_cols, int win_tiles, size_t w_stride,
                 int stride, int padding, int reflect, float slope, int nb_max, int seg,
                 int xp) {
  count_run(&g_runs[0]);
  using Tr = Traits<T>;
  constexpr int CC = Tr::kCC;
  constexpr int G = 16 / static_cast<int>(sizeof(T));  // values of a 16-byte granule
  static_assert(CC == 2 * Tr::kVec, "a tap's CC channels are two 16-byte groups");
  static_assert(G == Tr::kVec, "a thread's channel group is one granule wide");
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());

  const int J = CC * K;  // reduction per chunk, one k-step per tap
  const uint32_t plane_bytes = static_cast<uint32_t>(kBM) * J * sizeof(T);
  const uint32_t tile_bytes = plane_bytes * Tr::kPlanes;
  // a stage: `seg` taps of a chunk (all K where they fit), nseg stages a chunk
  const int nseg = (K + seg - 1) / seg;
  const uint32_t seg_plane = static_cast<uint32_t>(kBM) * CC * seg * sizeof(T);
  const uint32_t seg_bytes = seg_plane * Tr::kPlanes;
  const uint32_t b_bytes = seg_bytes > kRedBytes ? seg_bytes : kRedBytes;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);                 // [kStages]
  float* bias_s = reinterpret_cast<float*>(smem + 64);                // [kBM]
  int* chunk_s = reinterpret_cast<int*>(smem + 320);                  // [kStages]
  unsigned char* a_s = smem + 384;                                    // [kStages][tile]
  unsigned char* b_s = a_s + static_cast<size_t>(Tr::kStages) * seg_bytes;  // im2col
  T* xs = reinterpret_cast<T*>(b_s + b_bytes);  // [kStages][nb_max][x_row]
  float* red = reinterpret_cast<float*>(b_s);                         // [kBM][kBN], at the end

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroup: columns 32*wg.. of the tile
  // Window `win` of the batch owns the columns [win*win_cols, n_end), its
  // own packed weight and bias; a column tile never straddles two windows.
  const int win = blockIdx.x / win_tiles;
  const int n_end = (win + 1) * win_cols;
  const int n0 = win * win_cols + (blockIdx.x - win * win_tiles) * kBN;
  const T* wtiles = wpack + win * w_stride;
  const float* bias_w = bias + static_cast<size_t>(win) * gridDim.y * kBM;
  const int rt = blockIdx.y;
  const int p0 = rt * kBM;
  const int first = tile_start[rt];
  const int live = tile_start[rt + 1] - first;
  const int n_mine = live > split ? (live - split + n_split - 1) / n_split * nseg : 0;

  // The batches this block's columns read, and the im2col work of this
  // thread: column `col`, channel group h, taps kp, kp+2, ...
  const int b_lo = n0 / T_out;
  const int b_hi = (min(n0 + kBN, n_end) - 1) / T_out;
  const int n_b = b_hi - b_lo + 1;
  const int col = wg * kWN + (tid & 31);
  const int h = (tid >> 5) & 1, kp = (tid >> 6) & 1;
  const int n = n0 + col;
  const bool col_ok = n < n_end;
  const int b_n = col_ok ? n / T_out : b_lo;
  const int t_base = (n - b_n * T_out) * stride - padding;
  // A batch's CC rows of x, xp values apart (whole rows: xp = T_in; windows:
  // row c's columns [lo, hi] from d_c, its granule offset in x, on), 16
  // bytes apart from the next batch's so that columns of different batches
  // read different banks.
  const int x_row = CC * xp + G;
  const int xs_stage = nb_max * x_row;  // elements of x a stage holds
  const int n1 = min(n0 + kBN, n_end);
  int lo_n = 0, hi_n = 0;  // windows: the columns of x this column's batch stages
  if constexpr (kWin)
    row_window(b_n, n0, n1, T_out, T_in, K, stride, padding, reflect, lo_n, hi_n);
  const int x_col = (b_n - b_lo) * x_row + h * Tr::kVec * xp - lo_n;

  if (tid < kBM) bias_s[tid] = p0 + tid < P ? bias_w[p0 + tid] : 0.f;
  // Stage `slot` of the ring: stage i's taps of its chunk's weight tile (the
  // whole tile in one bulk copy, or one copy per plane) and
  // x[b_lo:b_lo+n_b, c0:c0+nc, :], all completing on the slot's barrier.
  // Whole rows: thread 0 issues every copy, one a batch.  Windows: one copy
  // a row, issued by lane bb * CC + c of warp 0.
  constexpr int kIssuers = kWin ? 32 : 1;
  const int lane = tid & 31;
  auto issue = [&](int i, int slot) {
    const int idx = first + split + (i / nseg) * n_split;
    const int k0 = (i % nseg) * seg, nk = min(seg, K - k0);
    const int c0 = tile_chunk[idx] * CC, nc = min(CC, C_in - c0);
    const uint32_t bar = smem_addr(bars + slot);
    T* xd = xs + slot * xs_stage;
    const uint32_t rows_bytes = static_cast<uint32_t>(nc * T_in * sizeof(T));  // whole rows
    uint32_t x_bytes = rows_bytes * n_b;
    uint32_t mine = 0, dst = 0;  // windows: this lane's row copy
    const T* src_x = x;
    if constexpr (kWin) {
      const int bb = lane / CC, c = lane % CC;
      int lo, hi;
      if (bb < n_b && c < nc) {
        row_window(b_lo + bb, n0, n1, T_out, T_in, K, stride, padding, reflect, lo, hi);
        if (hi >= lo) {
          const size_t e0 = (static_cast<size_t>(b_lo + bb) * C_in + c0 + c) * T_in + lo;
          // ng * G <= xp by the launcher's choice of xp; no check here: a
          // trap on this path, which only warp 0 takes, makes ptxas
          // serialize the wgmma (C7520)
          const size_t g0 = e0 / G, ng = (e0 + (hi - lo)) / G - g0 + 1;
          mine = static_cast<uint32_t>(ng * 16);
          src_x = x + g0 * G;
          dst = smem_addr(xd + bb * x_row + c * xp);
        }
      }
      x_bytes = __reduce_add_sync(0xffffffffu, mine);
    }
    if (tid == 0) {
      chunk_s[slot] = c0;  // published to the block by the barrier's phase
      const uint32_t w_bytes = static_cast<uint32_t>(nk) * kKStep;  // a plane's taps
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wtiles) +
                                 static_cast<size_t>(idx) * tile_bytes +
                                 static_cast<size_t>(k0) * kKStep;
      mbar_expect(bar, w_bytes * Tr::kPlanes + x_bytes);
      if (nk == K) {
        bulk_copy(smem_addr(a_s + slot * seg_bytes), src, tile_bytes, bar);
      } else {
        for (int pl = 0; pl < Tr::kPlanes; ++pl)
          bulk_copy(smem_addr(a_s + slot * seg_bytes + pl * seg_plane), src + pl * plane_bytes,
                    w_bytes, bar);
      }
      if constexpr (!kWin)
        for (int bb = 0; bb < n_b; ++bb)
          bulk_copy(smem_addr(xd + bb * x_row),
                    x + (static_cast<size_t>(b_lo + bb) * C_in + c0) * T_in, rows_bytes, bar);
    }
    if constexpr (kWin) {
      __syncwarp();  // the barrier expects the bytes before any copy lands
      if (mine) bulk_copy(dst, src_x, mine, bar);
    }
  };
  if (tid < kIssuers) {
    if (tid == 0) {
      for (int s = 0; s < Tr::kStages; ++s) mbar_init(smem_addr(bars + s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (kWin) __syncwarp();
    for (int i = 0; i < Tr::kStages && i < n_mine; ++i) issue(i, i);
  }

  // acc: one stage's products (a chunk, or a tap segment of one), summed by
  // the tensor cores; sum: the stages' sums, added in f32 here, so that no
  // tensor-core sum runs longer than a chunk (J terms)
  float acc[16], sum[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = sum[i] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    const int stage = i % Tr::kStages;
    // Every thread has waited for the previous wgmma and reads nothing of
    // the previous stage any more: refill that stage.
    __syncthreads();
    if (tid < kIssuers && i > 0 && i - 1 + Tr::kStages < n_mine)
      issue(i - 1 + Tr::kStages, (i - 1) % Tr::kStages);
    mbar_wait(smem_addr(bars + stage), (i / Tr::kStages) & 1);

    // The im2col tile of the stage's taps k0 + k.  A chunk's reduction runs
    // tap-major (j = k*CC + c), so the 16-byte group 2k + h of a column is
    // the kVec channels h*kVec.. of x at time t*stride + k0 + k - padding.
    const int k0 = (i % nseg) * seg, nk = min(seg, K - k0);
    const int c0 = chunk_s[stage];
    const bool group_ok = col_ok && h * Tr::kVec < C_in - c0;
    // this thread's kVec rows of x in the stage, from s = 0: whole rows T_in
    // apart; a window's row at its slot, d_j values in (its granule offset)
    const T* xcol = xs + stage * xs_stage + x_col;
    int xo[Tr::kVec];
    const unsigned e0 = kWin ? static_cast<unsigned>(b_n * C_in + c0 + h * Tr::kVec) *
                                       static_cast<unsigned>(T_in) +
                                   static_cast<unsigned>(lo_n)
                             : 0u;
#pragma unroll
    for (int j = 0; j < Tr::kVec; ++j)
      xo[j] = j * xp + (kWin ? static_cast<int>((e0 + j * static_cast<unsigned>(T_in)) & (G - 1))
                             : 0);
#pragma unroll 4
    for (int k = kp; k < nk; k += 2) {
      int s = t_base + k0 + k;
      if (s < 0 || s >= T_in) s = reflect ? (s < 0 ? -s : 2 * (T_in - 1) - s) : -1;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (group_ok && s >= 0) {
        uint32_t* qv = reinterpret_cast<uint32_t*>(&q);
        if constexpr (Tr::kPlanes == 1) {
          const uint16_t* xv = reinterpret_cast<const uint16_t*>(xcol) + s;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            qv[e] = static_cast<uint32_t>(xv[xo[2 * e]]) |
                    (static_cast<uint32_t>(xv[xo[2 * e + 1]]) << 16);
        } else {
          const uint32_t* xv = reinterpret_cast<const uint32_t*>(xcol) + s;
#pragma unroll
          for (int e = 0; e < 4; ++e) qv[e] = xv[xo[e]];
        }
      }
      unsigned char* dst = b_s + core_offset(col, 2 * k + h);
      if constexpr (Tr::kPlanes == 1) {
        *reinterpret_cast<uint4*>(dst) = q;
      } else {
        uint4 big, small;
        const uint32_t* v = reinterpret_cast<const uint32_t*>(&q);
        uint32_t* bp = reinterpret_cast<uint32_t*>(&big);
        uint32_t* sp = reinterpret_cast<uint32_t*>(&small);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bp[e] = tf32_round(__uint_as_float(v[e]));
          sp[e] = __float_as_uint(__uint_as_float(v[e]) - __uint_as_float(bp[e]));
        }
        *reinterpret_cast<uint4*>(dst) = big;
        *reinterpret_cast<uint4*>(dst + seg_plane) = small;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the im2col tile is complete

    // This warpgroup's 64 x 32 part of the tile: B columns 32*wg.. start
    // four row groups (1024 bytes) into each k-step.
    const uint32_t a0 = smem_addr(a_s + stage * seg_bytes);
    const uint32_t b0 = smem_addr(b_s) + wg * (kWN / 8) * 256;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    for (int k = 0; k < nk; ++k) {
      const uint32_t off = k * kKStep;
      if constexpr (Tr::kPlanes == 1) {
        wgmma_bf16(acc, gmma_desc(a0 + off), gmma_desc(b0 + off), k > 0);
      } else {
        wgmma_tf32(acc, gmma_desc(a0 + seg_plane + off), gmma_desc(b0 + off), k > 0);
        wgmma_tf32(acc, gmma_desc(a0 + off), gmma_desc(b0 + seg_plane + off), 1);
        wgmma_tf32(acc, gmma_desc(a0 + off), gmma_desc(b0 + off), 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
#pragma unroll
    for (int r = 0; r < 16; ++r) sum[r] += acc[r];
  }

  // wgmma's accumulator: warp w of a warpgroup holds rows 16w..16w+15;
  // register r is row lane/4 (+8 if r&2), column 8*(r/4) + 2*(lane%4) +
  // (r&1) of the warpgroup's 32.
  const int warp = (tid >> 5) & 3;
  auto store = [&](int row, int c, float v) {
    const int p = p0 + row, nn = n0 + c;
    if (p < P && nn < n_end) {
      v += bias_s[row];
      v = v >= 0.f ? v : slope * v;
      const int b = nn / T_out, t = nn - b * T_out;
      out[(static_cast<size_t>(b) * P + p) * T_out + t] = from_f32<T>(v);
    }
  };
  if (n_split == 1) {  // the whole sum is in registers: store it
#pragma unroll
    for (int r = 0; r < 16; ++r)
      store(warp * 16 + (lane >> 2) + ((r & 2) ? 8 : 0),
            wg * kWN + (r >> 2) * 8 + (lane & 3) * 2 + (r & 1), sum[r]);
    return;
  }

  // Partial tile -> red, then block `split` sums its slice of rows over the
  // cluster, in rank order.
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 16; r += 2) {
    const int row = warp * 16 + (lane >> 2) + ((r & 2) ? 8 : 0);
    const int c = wg * kWN + (r >> 2) * 8 + (lane & 3) * 2;
    *reinterpret_cast<float2*>(red + row * kBN + c) = make_float2(sum[r], sum[r + 1]);
  }
  cluster.sync();  // every block's partial tile is in its shared memory
  {
    const float* part[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) part[q] = cluster.map_shared_rank(red, min(q, n_split - 1));
    const int lo = kBM * split / n_split, hi = kBM * (split + 1) / n_split;
#pragma unroll 4
    for (int e = lo * kBN + tid; e < hi * kBN; e += kThreads) {
      float v = part[0][e];
#pragma unroll
      for (int q = 1; q < kMaxSplit; ++q)
        if (q < n_split) v += part[q][e];
      store(e / kBN, e % kBN, v);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial tile
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* tile_start,
                   const void* tile_chunk, void* out, int B, int C_in, int T_in, int K, int P,
                   int T_out, int stride, int padding, int reflect, float slope, int max_live,
                   int windows, int n_tiles, int device, int sms, cudaStream_t stream) {
  using Tr = Traits<T>;
  // The shared-memory cap is set once per device, not per launch.
  static bool ready[kMaxDevices] = {};
  if (!ready[device]) {
    decltype(&conv_gemm_kernel<T, false>) kernels[] = {conv_gemm_kernel<T, false>,
                                                       conv_gemm_kernel<T, true>};
    for (auto k : kernels) {
      cudaError_t err =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
    }
    ready[device] = true;
  }
  // the batch is `windows` windows of B / windows batches each
  const int win_cols = B / windows * T_out;
  const int win_tiles = (win_cols + kBN - 1) / kBN;
  const Plan plan =
      plan_forward(Tr::kElem, B, T_in, K, P, T_out, stride, padding, windows, max_live, sms);
  last_plan = plan;
  if (!plan.fits) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(plan.smem);
  const size_t tile = static_cast<size_t>(kBM) * Tr::kCC * K * sizeof(T) * Tr::kPlanes;
  auto kernel = plan.window ? conv_gemm_kernel<T, true> : conv_gemm_kernel<T, false>;
  const int nt = windows * win_tiles, rts = (P + kBM - 1) / kBM, split = plan.split;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt, rts, split);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_chunk), static_cast<T*>(out), C_in, T_in, K, P, T_out,
      win_cols, win_tiles, static_cast<size_t>(n_tiles) * (tile / sizeof(T)), stride, padding,
      reflect, slope, plan.nb, plan.seg, plan.xp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
// w, bias, tile_start, tile_chunk: a level packed by pack_level or repack
// (the wrapper); max_live: the most live tiles of any row tile.  windows:
// the batch's windows, each of B / windows batches with its own packed
// weight (n_tiles live tiles) and bias, one after the other in w and bias
// (1: one weight for the whole batch).  dtype: 0 = float32, 1 = bfloat16.
// device: the CUDA device of the tensors; sms: its multiprocessor count.
int hmvae_fused_conv_pool(const void* x, const void* w, const void* bias,
                          const void* tile_start, const void* tile_chunk, void* out, int B,
                          int C_in, int T_in, int K, int P, int T_out, int stride, int padding,
                          int reflect, float negative_slope, int max_live, int windows,
                          int n_tiles, int dtype, int device, int sms, void* stream) {
  if (B <= 0 || C_in <= 0 || T_in <= 0 || K <= 0 || P <= 0 || T_out <= 0 || stride <= 0 ||
      windows <= 0 || B % windows != 0 || n_tiles < 0 ||
      padding < 0 || (reflect && padding >= T_in) ||
      (T_out - 1) * stride + K > T_in + 2 * padding || max_live < 0 || device < 0 ||
      C_in % 8 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      device >= kMaxDevices || sms <= 0 || static_cast<long long>(B) * T_out > 0x7FFFFFFFLL ||
      (P + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, w, bias, tile_start, tile_chunk, out, B, C_in, T_in,
                                          K, P, T_out, stride, padding, reflect, negative_slope,
                                          max_live, windows, n_tiles, device, sms, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, w, bias, tile_start, tile_chunk, out, B,
                                                  C_in, T_in, K, P, T_out, stride, padding,
                                                  reflect, negative_slope, max_live, windows,
                                                  n_tiles, device, sms, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan (hm_vae_torch/csrc/fused_conv_pool_plan.h) of the last launch in
// this process, on any thread, into out[kPlanInts]; zeros before the first.
void hmvae_fused_conv_pool_last_plan(int* out) { plan_ints(last_plan, out); }

// The kernel's runs on `device` since the last reset (run_counter.h), after
// the device has finished its work, into *out; then 0 where `reset`.
int hmvae_fused_conv_pool_device_runs(int device, int reset, unsigned long long* out) {
  return static_cast<int>(read_runs(g_runs, device, reset, out));
}

const char* hmvae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
