// One level of the skeleton-aware VAE in one kernel: masked temporal
// convolution (+ bias), an optional channel-pool matrix, then LeakyReLU.
//
// Replaces the Pallas TPU kernel hm_vae_tpu/ops/pallas_kernels.py
// (fused_conv_pool, body _fused_kernel).  It computes what that kernel
// computes, for x (B, C_in, T), weight (C_out, C_in, K), mask (C_out, C_in),
// bias (C_out), pool (P, C_out):
//
//   out[b, p, t] = act( sum_o pool[p, o] * (bias[o] + sum_{c,k} mask[o, c]
//                       * weight[o, c, k] * xpad[b, c, t*stride + k]) )
//
// where xpad is x padded in time by `padding` (reflect without edge repeat,
// or zeros), act(v) = v >= 0 ? v : slope * v, and a null bias / mask / pool
// means zero / all ones / identity.  Operands are f32 or bf16 (all of one
// type); products are summed in f32 and the output has the operands' type.
//
// What bounds it on an H100: at the len-64 model's batch of 8 one level
// reads 1.4-15.5 MB and does 0.08-0.43 GFLOP once the neighbourhood mask's
// zeros are skipped: 0.2-6.5 us at the data-sheet 3.35 TB/s and 67 TFLOP/s
// (f32 without tensor cores), so f32 levels sit near the balance of bytes
// and FMA rate and bf16 ones are bound by bytes.  The levels are small
// matrix products (C_out <= 672 rows, B*T_out = 32..512 columns) with a
// long reduction (C_in*K = 2,160..10,080): output tiles alone give too few
// blocks for 132 SMs, and a sum of one output per thread runs at the
// latency of its load-and-FMA chain.
//
// What the design does about it:
// - each output is a column n = (b, t) of a product over (c, k); a block
//   owns 32 output rows x 32 columns, and each thread sums a 4 x 8 register
//   tile, 32 FMAs for every 6 shared-memory loads;
// - the reduction is split over the 8 warps of a block (each takes every
//   8th (c, k) of a staged chunk) and over the S blocks of a thread-block
//   cluster (each takes every S-th chunk of 8 input channels); the partial
//   tiles are summed through shared and distributed shared memory, so a
//   level launches 168-320 blocks without a second pass or atomics;
// - a chunk whose mask tile (32 rows x 8 channels) is all zero is skipped
//   before anything is loaded: the skeleton mask removes 60-80% of most
//   levels' products, mostly in such whole tiles;
// - weights are read once per block from L2 (the whole f32 model, ~48 MB,
//   fits in its 50 MB), staged with the mask applied; padding and stride
//   are index arithmetic on the staged input (the TPU kernel padded outside
//   and strided through a 0/1 decimation matmul, a lane workaround);
// - with a pool matrix a block lists the conv rows its 32 pooled rows read
//   (nonzero pool columns, 1-2 per row for a skeleton mean-pool), computes
//   them in passes of 32 and applies the pool rows to each pass in shared
//   memory, so the pre-pool activation never reaches device memory.
// It uses no tensor cores (no wgmma, no TMA): the products run on the f32
// FMA units in both dtypes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 32;       // conv rows per pass (4 per lane, 8 lane rows)
constexpr int kBN = 32;       // columns (b, t) per block (8 per lane, 4 lane columns)
constexpr int kTP = 32;       // output rows per block
constexpr int kCC = 8;        // input channels per staged chunk
constexpr int kMaxSplit = 8;  // blocks per cluster (the portable maximum)
constexpr int kTile = kBM * kBN;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Row stride of the staged weight tile: >= J and 1 mod 8, so that the 8 lane
// rows of a warp (4 rows apart) read 8 different banks.
__host__ __device__ inline int padded_j(int J) { return J + (9 - J % 8) % 8; }

// Floats of shared memory before the int row list.
__host__ __device__ inline size_t smem_floats(int J) {
  const size_t stage = (size_t)kBM * padded_j(J) + (size_t)J * kBN;
  const size_t partial = (size_t)kWarps * kTile;
  return (stage > partial ? stage : partial) + 4 * (size_t)kTile + (size_t)kBM * kCC;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_conv_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, const T* __restrict__ mask,
                       const T* __restrict__ pool, T* __restrict__ out,
                       int C_in, int T_in, int C_out, int K, int P, int T_out,
                       int N, int stride, int padding, int reflect, float slope) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int n_split = (int)cluster.num_blocks();

  const int J = kCC * K;
  const int Jp = padded_j(J);
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                    // [kBM][Jp] masked weights of a chunk
  float* xs = ws + (size_t)kBM * Jp;   // [J][kBN] input of a chunk
  float* part = smem;                  // [kWarps][kTile], after the chunks
  float* red = smem + smem_floats(J) - 4 * (size_t)kTile - (size_t)kBM * kCC;
  float* conv = red + kTile;           // [kBM][kBN] summed over the cluster, + bias
  float* ps = conv + kTile;            // [kTP][kBM] pool columns of a pass
  float* pacc = ps + kTile;            // [kTP][kBN] pooled sums
  float* ms = pacc + kTile;            // [kBM][kCC] mask tile of a chunk
  int* rows = reinterpret_cast<int*>(ms + kBM * kCC);  // [C_out]
  __shared__ int warp_base[kWarps];
  __shared__ int n_rows_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kTP;
  const int n0 = blockIdx.y * kBN;
  const int np = min(kTP, P - p0);
  const int nn = min(kBN, N - n0);

  // 1. The conv rows this block reads: its own rows, or with a pool matrix
  //    the columns of pool[p0:p0+np] holding a nonzero, in ascending order.
  if (pool == nullptr) {
    for (int r = tid; r < np; r += kThreads) rows[r] = p0 + r;
    if (tid == 0) n_rows_s = np;
  } else {
    if (tid == 0) n_rows_s = 0;
    __syncthreads();
    for (int base = 0; base < C_out; base += kThreads) {
      const int o = base + tid;
      bool used = false;
      if (o < C_out)
        for (int p = 0; p < np; ++p)
          used |= to_f32(pool[(size_t)(p0 + p) * C_out + o]) != 0.f;
      const unsigned ballot = __ballot_sync(0xffffffffu, used);
      if (lane == 0) warp_base[warp] = __popc(ballot);
      __syncthreads();
      if (tid == 0) {
        int acc = n_rows_s;
        for (int i = 0; i < kWarps; ++i) {
          const int n = warp_base[i];
          warp_base[i] = acc;
          acc += n;
        }
        n_rows_s = acc;
      }
      __syncthreads();
      if (used) rows[warp_base[warp] + __popc(ballot & ((1u << lane) - 1u))] = o;
      __syncthreads();
    }
  }
  for (int e = tid; e < kTile; e += kThreads) pacc[e] = 0.f;
  __syncthreads();
  const int n_rows = n_rows_s;

  // The column this thread stages: n = n0 + lane, i.e. (b, t).
  const int n_st = n0 + lane;
  const bool col_ok = lane < nn;
  const int b_st = col_ok ? n_st / T_out : 0;
  const int t_st = n_st - b_st * T_out;
  const T* xb = x + (size_t)b_st * C_in * T_in;
  const int src0 = t_st * stride - padding;
  // The register tile this thread sums: rows 4*lr.., columns 8*lc..
  const int lr = lane & 7, lc = lane >> 3;
  const int n_chunks = (C_in + kCC - 1) / kCC;

  for (int pr = 0; pr < n_rows; pr += kBM) {
    const int rows_here = min(kBM, n_rows - pr);
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;

    for (int ch = split; ch < n_chunks; ch += n_split) {
      const int c0 = ch * kCC;
      const int nc = min(kCC, C_in - c0);
      // 2a. The mask tile; skip the chunk if it is all zero.  The barrier
      //     also ends the previous chunk's reads of ws and xs.
      float m = 0.f;
      {
        const int r = tid / kCC, c = tid % kCC;
        if (r < rows_here && c < nc)
          m = mask ? to_f32(mask[(size_t)rows[pr + r] * C_in + c0 + c]) : 1.f;
        ms[tid] = m;
      }
      if (!__syncthreads_or(m != 0.f)) continue;
      // 2b. Stage the masked weights [kBM][J] and the input [J][kBN].
      for (int e = tid; e < kBM * J; e += kThreads) {
        const int r = e / J;
        const int j = e - r * J;
        const int c = j / K;
        float v = 0.f;
        if (r < rows_here && c < nc) {
          const float mv = ms[r * kCC + c];
          if (mv != 0.f) v = mv * to_f32(w[((size_t)rows[pr + r] * C_in + c0) * K + j]);
        }
        ws[r * Jp + j] = v;
      }
      for (int j = warp; j < J; j += kWarps) {
        const int c = j / K;
        const int k = j - c * K;
        float v = 0.f;
        if (col_ok && c < nc) {
          int src = src0 + k;
          if (src < 0 || src >= T_in)
            src = reflect ? (src < 0 ? -src : 2 * (T_in - 1) - src) : -1;
          if (src >= 0) v = to_f32(xb[(size_t)(c0 + c) * T_in + src]);
        }
        xs[j * kBN + lane] = v;
      }
      __syncthreads();
      // 2c. This warp's share of the chunk's (c, k): every kWarps-th.
      for (int j = warp; j < J; j += kWarps) {
        const float4 xa = *reinterpret_cast<const float4*>(xs + j * kBN + lc * 8);
        const float4 xc = *reinterpret_cast<const float4*>(xs + j * kBN + lc * 8 + 4);
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wv = ws[(lr * 4 + i) * Jp + j];
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(wv, xv[q], acc[i][q]);
        }
      }
    }

    // 3. Sum the warps' tiles into red, then the cluster's into block 0's
    //    conv (+ bias), each block summing one slice.
    __syncthreads();  // the last chunk's reads of ws/xs are done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* dst = part + (size_t)warp * kTile + (lr * 4 + i) * kBN + lc * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    for (int e = tid; e < kTile; e += kThreads) {
      float v = 0.f;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) v += part[(size_t)g * kTile + e];
      red[e] = v;
    }
    cluster.sync();  // every block's red is complete
    {
      float* conv0 = cluster.map_shared_rank(conv, 0);
      const int lo = kTile * split / n_split, hi = kTile * (split + 1) / n_split;
      for (int e = lo + tid; e < hi; e += kThreads) {
        float v = 0.f;
        for (int q = 0; q < n_split; ++q) v += cluster.map_shared_rank(red, q)[e];
        const int r = e / kBN;
        if (bias != nullptr && r < rows_here) v += to_f32(bias[rows[pr + r]]);
        conv0[e] = v;
      }
    }
    cluster.sync();  // block 0's conv is complete; no block reads red any more

    // 4. Block 0: activation and store, or this pass's pool rows.
    if (split != 0) continue;
    if (pool == nullptr) {  // a single pass: rows_here == np
      for (int e = tid; e < kTile; e += kThreads) {
        const int p = e / kBN, n = e - p * kBN;
        if (p >= np || n >= nn) continue;
        float v = conv[e];
        v = v >= 0.f ? v : slope * v;
        const int b = (n0 + n) / T_out, t = (n0 + n) - b * T_out;
        out[((size_t)b * P + p0 + p) * T_out + t] = from_f32<T>(v);
      }
    } else {
      for (int e = tid; e < kTile; e += kThreads) {
        const int p = e / kBM, r = e - p * kBM;
        ps[e] = (p < np && r < rows_here)
                    ? to_f32(pool[(size_t)(p0 + p) * C_out + rows[pr + r]]) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < kTile; e += kThreads) {
        const int p = e / kBN, n = e - p * kBN;
        float v = pacc[e];
        for (int r = 0; r < rows_here; ++r) v = fmaf(ps[p * kBM + r], conv[r * kBN + n], v);
        pacc[e] = v;
      }
    }
  }

  if (pool != nullptr && split == 0) {
    __syncthreads();
    for (int e = tid; e < kTile; e += kThreads) {
      const int p = e / kBN, n = e - p * kBN;
      if (p >= np || n >= nn) continue;
      float v = pacc[e];
      v = v >= 0.f ? v : slope * v;
      const int b = (n0 + n) / T_out, t = (n0 + n) - b * T_out;
      out[((size_t)b * P + p0 + p) * T_out + t] = from_f32<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* mask, const void* pool, void* out, int B,
                   int C_in, int T_in, int C_out, int K, int P, int T_out,
                   int stride, int padding, int reflect, float slope,
                   cudaStream_t stream) {
  const int N = B * T_out;
  const size_t smem = sizeof(float) * smem_floats(kCC * K) + sizeof(int) * (size_t)C_out;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = fused_conv_pool_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  const int gx = (P + kTP - 1) / kTP, gy = (N + kBN - 1) / kBN;
  const int n_chunks = (C_in + kCC - 1) / kCC;
  // enough clusters' blocks for two per SM, each keeping a chunk or more
  int split = (2 * sms + gx * gy - 1) / (gx * gy);
  split = max(1, min(split, min(kMaxSplit, n_chunks)));

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, split);
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(w),
                           static_cast<const T*>(bias), static_cast<const T*>(mask),
                           static_cast<const T*>(pool), static_cast<T*>(out), C_in, T_in,
                           C_out, K, P, T_out, N, stride, padding, reflect, slope);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
// dtype: 0 = float32, 1 = bfloat16.  bias, mask and pool may be null.
int hmvae_fused_conv_pool(const void* x, const void* w, const void* bias,
                          const void* mask, const void* pool, void* out, int B,
                          int C_in, int T_in, int C_out, int K, int P,
                          int T_out, int stride, int padding, int reflect,
                          float negative_slope, int dtype, void* stream) {
  if (B <= 0 || C_in <= 0 || T_in <= 0 || C_out <= 0 || K <= 0 || P <= 0 ||
      T_out <= 0 || stride <= 0 || padding < 0 || (reflect && padding >= T_in) ||
      (T_out - 1) * stride + K > T_in + 2 * padding || (pool == nullptr && P != C_out) ||
      (long long)B * T_out > 65535LL * kBN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, bias, mask, pool, out, B, C_in, T_in, C_out, K, P,
                              T_out, stride, padding, reflect, negative_slope, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, bias, mask, pool, out, B, C_in, T_in, C_out,
                                      K, P, T_out, stride, padding, reflect,
                                      negative_slope, s);
  return (int)cudaErrorInvalidValue;
}

const char* hmvae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
