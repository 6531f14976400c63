// The backward of one skeleton-conv level (fused_conv_pool.cu's forward) on
// Hopper, in f32: the input gradient (dgrad) and the folded weight's and
// bias's gradients (wgrad), two kernels on the CUDA cores.
//
// The JAX package has no backward kernel: it differentiates its XLA level in
// hm_vae_tpu/models/hm_vae.py (SkeletonConv: the conv on the folded weight
// P @ (W*mask) @ U, bias P @ b, then LeakyReLU).  These kernels are the
// counterparts of that autodiff for the port, whose forward is a kernel.
// For the forward
//
//   y[b, p, t] = act( bf[p] + sum_{c,k} Wf[p, c, k] * xpad[b, c, t*stride + k] )
//
// with x (B, C_in, T_in), xpad x padded in time by `padding` (reflect
// without edge repeat, or zeros) and act(v) = v >= 0 ? v : slope*v, and the
// output gradient gy, both kernels read g = gy * act'(y), act'(y) = y >= 0 ?
// 1 : slope (slope > 0, so y >= 0 exactly where the pre-activation is):
//
//   dgrad: gx[b, c, i] = sum over the padded columns u that read x[., ., i]
//          (u = i + padding, and under reflect the mirrored columns) of
//          sum_{p, k: u = t*stride + k} Wf[p, c, k] * g[b, p, t];
//   wgrad: gWf[p, c, k] = sum_{b, t} g[b, p, t] * xpad[b, c, t*stride + k],
//          gbf[p] = sum_{b, t} g[b, p, t].
//
// Both walk only the live tiles of the folded weight (64 rows x 8 input
// channels, the f32 packing of pack_structure in the wrapper,
// hm_vae_torch/ops/fused_conv_pool.py): the dgrad kernel a channel chunk's
// live row tiles (chunk_start / chunk_row), the wgrad kernel one live tile a
// block (tile_row / tile_chunk).  Entries of dead tiles are structural zeros
// of the fold: wgrad leaves them as the wrapper zeroed them.
//
// What bounds them on an H100 (data sheet: 3.35 TB/s, 67 TFLOP/s f32 on the
// CUDA cores).  At the len-64 model's batch of 8 each kernel does ~1/3 of the
// forward's multiply-adds per level over the live tiles (a few GFLOP over the
// eight levels) and moves the folded weight (or its gradient), x, y and gy:
// tens of megabytes.  Both bounds are microseconds; a simple kernel is far
// from them.  The design is the simple one, exact and deterministic:
// - f32 FMA: at least as accurate as the forward's 3xTF32, so the GPU's
//   training trajectory tracks the CPU's;
// - every output is summed by one thread in a fixed order (no atomics, no
//   split reductions), so a step gives the same bits every run;
// - dgrad: a block owns 8 channels x 128 (b, i) columns; a thread 4
//   channels of one column.  For each live row tile of its chunk the block
//   stages the weight (64 rows x K taps x 8 channels) and g (64 rows x the
//   block's batches x T_out) in shared memory; a thread sums over the
//   padded columns of its input step, the taps of matching stride phase and
//   the 64 rows, with the weight's four channels as one 16-byte read;
// - wgrad: a block owns one live tile (64 rows x 8*K reduction entries) and
//   walks the B*T_out columns 32 at a time: x rows of the batches touched,
//   g (64 x 32) and the im2col tile (32 x 8*K) are staged in shared memory,
//   and a thread sums a 4-row x 8-entry register tile.  One more block per
//   row tile sums the bias gradient.
// Times against the bounds are in PERF.md.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;    // rows of a weight tile
constexpr int kCC = 8;       // input channels of a chunk (f32 packing)
constexpr int kCols = 128;   // dgrad: (b, i) columns per block
constexpr int kNB = 32;      // wgrad: reduction columns staged at a time
constexpr int kGS = kRows + 4;  // wgrad: g row stride (16-byte aligned, fewer conflicts)
constexpr int kMaxK = 16;    // wgrad: 8*K reduction entries <= 16 threads x 8
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

// The input step a padded column s - padding reads, or -1 (zero padding).
__device__ __forceinline__ int source_step(int s, int T_in, int reflect) {
  if (s >= 0 && s < T_in) return s;
  if (!reflect) return -1;
  return s < 0 ? -s : 2 * (T_in - 1) - s;
}

__device__ __forceinline__ float act_grad(const float* gy, const float* y, size_t o,
                                          float slope) {
  const float v = gy[o];
  return y[o] >= 0.f ? v : v * slope;
}

__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const float* __restrict__ gy, const float* __restrict__ y,
             const float* __restrict__ w, const int* __restrict__ chunk_start,
             const int* __restrict__ chunk_row, float* __restrict__ gx, int B, int C_in,
             int T_in, int K, int P, int T_out, int stride, int padding, int reflect,
             float slope) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                    // [kRows][K][kCC]
  float* g_s = w_s + kRows * K * kCC;   // [batch][kRows][T_out]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kCC;
  const int n0 = blockIdx.x * kCols;
  const int N = B * T_in;
  const int b_lo = n0 / T_in;
  const int n_b = (min(n0 + kCols, N) - 1) / T_in - b_lo + 1;
  const int half = tid / kCols;  // channels c0 + 4*half ..
  const int n = n0 + tid % kCols;
  const bool col_ok = n < N;
  const int b = col_ok ? n / T_in : b_lo;
  const int i = col_ok ? n - b * T_in : 0;

  // the padded columns that read x[b, ., i]
  int u[3];
  int nu = 0;
  u[nu++] = i + padding;
  if (reflect && i >= 1 && i <= padding) u[nu++] = padding - i;
  if (reflect && i <= T_in - 2 && i >= T_in - 1 - padding) u[nu++] = padding + 2 * (T_in - 1) - i;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int e_end = chunk_start[blockIdx.y + 1];
  for (int e = chunk_start[blockIdx.y]; e < e_end; ++e) {
    const int p0 = chunk_row[e] * kRows;
    __syncthreads();  // the previous tile is read
    for (int q = tid; q < kRows * kCC * K; q += kThreads) {
      const int r = q / (kCC * K), rem = q - r * (kCC * K);
      const int c = rem / K, k = rem - c * K;
      const int p = p0 + r, cc = c0 + c;
      w_s[(r * K + k) * kCC + c] =
          (p < P && cc < C_in) ? w[(static_cast<size_t>(p) * C_in + cc) * K + k] : 0.f;
    }
    for (int q = tid; q < n_b * kRows * T_out; q += kThreads) {
      const int bb = q / (kRows * T_out), rem = q - bb * (kRows * T_out);
      const int r = rem / T_out, t = rem - r * T_out;
      const int p = p0 + r;
      g_s[q] = p < P ? act_grad(gy, y, (static_cast<size_t>(b_lo + bb) * P + p) * T_out + t,
                                slope)
                     : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    const float* gcol = g_s + (b - b_lo) * kRows * T_out;
    for (int a = 0; a < nu; ++a) {
      const int uu = u[a];
      // taps k = uu - t*stride, 0 <= k < K, 0 <= t < T_out
      const int k_lo = max(uu % stride, uu - (T_out - 1) * stride);
      const int k_hi = min(K - 1, uu);
      for (int k = k_lo; k <= k_hi; k += stride) {
        const float* wr = w_s + k * kCC + half * 4;
        const float* gr = gcol + (uu - k) / stride;
#pragma unroll 8
        for (int r = 0; r < kRows; ++r) {
          const float gv = gr[r * T_out];
          const float4 wv = *reinterpret_cast<const float4*>(wr + r * K * kCC);
          acc[0] = fmaf(wv.x, gv, acc[0]);
          acc[1] = fmaf(wv.y, gv, acc[1]);
          acc[2] = fmaf(wv.z, gv, acc[2]);
          acc[3] = fmaf(wv.w, gv, acc[3]);
        }
      }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + half * 4 + q;
    if (c < C_in) gx[(static_cast<size_t>(b) * C_in + c) * T_in + i] = acc[q];
  }
}

__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ gy, const float* __restrict__ y,
             const float* __restrict__ x, const int* __restrict__ tile_row,
             const int* __restrict__ tile_chunk, float* __restrict__ gw,
             float* __restrict__ gb, int n_live, int B, int C_in, int T_in, int K, int P,
             int T_out, int stride, int padding, int reflect, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int N = B * T_out;

  if (static_cast<int>(blockIdx.x) >= n_live) {
    // the bias gradient of row tile blockIdx.x - n_live: four threads a
    // row, each a fixed quarter of the columns, added in order
    const int p = (blockIdx.x - n_live) * kRows + tid / 4, part = tid % 4;
    float s = 0.f;
    if (p < P)
      for (int n = part; n < N; n += 4) {
        const int b = n / T_out, t = n - b * T_out;
        s += act_grad(gy, y, (static_cast<size_t>(b) * P + p) * T_out + t, slope);
      }
    smem[tid] = s;
    __syncthreads();
    if (part == 0 && p < P) gb[p] = ((smem[tid] + smem[tid + 1]) + smem[tid + 2]) + smem[tid + 3];
    return;
  }

  const int J = kCC * K;                  // reduction entries j = c*K + k
  float* g_s = smem;                      // [kNB][kGS]
  float* col_s = g_s + kNB * kGS;         // [kNB][J]
  float* x_s = col_s + kNB * J;           // [batch][kCC][T_in]
  const int p0 = tile_row[blockIdx.x] * kRows;
  const int c0 = tile_chunk[blockIdx.x] * kCC;
  const int rg = tid / 16, jl = tid % 16;  // rows 4*rg.., entries jl + 16*q

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kNB) {
    const int n_cols = min(kNB, N - n0);
    const int b_lo = n0 / T_out;
    const int n_b = (n0 + n_cols - 1) / T_out - b_lo + 1;
    __syncthreads();  // the previous columns are read
    for (int q = tid; q < n_b * kCC * T_in; q += kThreads) {
      const int bb = q / (kCC * T_in), rem = q - bb * (kCC * T_in);
      const int c = rem / T_in, s = rem - c * T_in;
      x_s[q] = c0 + c < C_in ? x[(static_cast<size_t>(b_lo + bb) * C_in + c0 + c) * T_in + s]
                             : 0.f;
    }
    for (int q = tid; q < kNB * kRows; q += kThreads) {
      const int r = q / kNB, nn = q - r * kNB;
      const int nc = n0 + nn, p = p0 + r;
      float v = 0.f;
      if (nn < n_cols && p < P) {
        const int b = nc / T_out, t = nc - b * T_out;
        v = act_grad(gy, y, (static_cast<size_t>(b) * P + p) * T_out + t, slope);
      }
      g_s[nn * kGS + r] = v;
    }
    __syncthreads();  // x rows staged
    for (int q = tid; q < kNB * J; q += kThreads) {
      const int nn = q / J, j = q - nn * J;
      const int c = j / K, k = j - c * K;
      float v = 0.f;
      if (nn < n_cols) {
        const int nc = n0 + nn;
        const int b = nc / T_out, t = nc - b * T_out;
        const int s = source_step(t * stride + k - padding, T_in, reflect);
        if (s >= 0) v = x_s[((b - b_lo) * kCC + c) * T_in + s];
      }
      col_s[q] = v;
    }
    __syncthreads();  // g and the im2col tile staged
    for (int nn = 0; nn < n_cols; ++nn) {
      const float4 gv = *reinterpret_cast<const float4*>(g_s + nn * kGS + rg * 4);
      const float* cr = col_s + nn * J + jl;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float cv = jl + 16 * q < J ? cr[16 * q] : 0.f;
        acc[0][q] = fmaf(gv.x, cv, acc[0][q]);
        acc[1][q] = fmaf(gv.y, cv, acc[1][q]);
        acc[2][q] = fmaf(gv.z, cv, acc[2][q]);
        acc[3][q] = fmaf(gv.w, cv, acc[3][q]);
      }
    }
  }

  // gWf (P, C_in, K): the tile's row p holds entries c0*K .. c0*K + J
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + rg * 4 + r;
    if (p >= P) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = jl + 16 * q;
      if (j < J && c0 + j / K < C_in)
        gw[static_cast<size_t>(p) * C_in * K + static_cast<size_t>(c0) * K + j] = acc[r][q];
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

bool shape_ok(int B, int C_in, int T_in, int K, int P, int T_out, int stride, int padding,
              int reflect, int device) {
  return B > 0 && C_in > 0 && T_in > 0 && K > 0 && K <= kMaxK && P > 0 && T_out > 0 &&
         stride > 0 && padding >= 0 && !(reflect && padding >= T_in) &&
         (T_out - 1) * stride + K <= T_in + 2 * padding &&
         T_in + 2 * padding - K < T_out * stride && device >= 0 && device < kMaxDevices &&
         static_cast<long long>(B) * T_in < 0x7FFFFFFFLL &&
         static_cast<long long>(B) * T_out < 0x7FFFFFFFLL;
}

}  // namespace

extern "C" {

// Input gradient gx (B, C_in, T_in) of a level from gy, y (B, P, T_out) and
// the folded weight w (P, C_in, K), all f32; chunk_start / chunk_row: the
// live tiles by 8-channel chunk (pack_structure).  Launches on `stream`,
// returns the first CUDA error (0 on success).
int hmvae_conv_dgrad(const void* gy, const void* y, const void* w, const void* chunk_start,
                     const void* chunk_row, void* gx, int B, int C_in, int T_in, int K, int P,
                     int T_out, int stride, int padding, int reflect, float slope, int device,
                     void* stream) {
  if (!shape_ok(B, C_in, T_in, K, P, T_out, stride, padding, reflect, device))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_smem(dgrad_kernel, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int N = B * T_in;
  const int n_b = min(B, (kCols - 1) / T_in + 2);  // batches 128 columns span, at most
  const size_t smem = (static_cast<size_t>(kRows) * K * kCC +
                       static_cast<size_t>(n_b) * kRows * T_out) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kCols - 1) / kCols, (C_in + kCC - 1) / kCC);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dgrad_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gy), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<const int*>(chunk_start),
      static_cast<const int*>(chunk_row), static_cast<float*>(gx), B, C_in, T_in, K, P, T_out,
      stride, padding, reflect, slope);
  return static_cast<int>(cudaGetLastError());
}

// Folded-weight gradient gw (P, C_in, K) on the n_live live tiles (tile_row,
// tile_chunk: pack_structure; the caller zeroes the rest) and bias gradient
// gb (P,), from gy, y (B, P, T_out) and x (B, C_in, T_in), all f32.
int hmvae_conv_wgrad(const void* gy, const void* y, const void* x, const void* tile_row,
                     const void* tile_chunk, void* gw, void* gb, int n_live, int row_tiles,
                     int B, int C_in, int T_in, int K, int P, int T_out, int stride,
                     int padding, int reflect, float slope, int device, void* stream) {
  if (!shape_ok(B, C_in, T_in, K, P, T_out, stride, padding, reflect, device) || n_live < 0 ||
      row_tiles != (P + kRows - 1) / kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_smem(wgrad_kernel, ready, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_b = min(B, (kNB - 1) / T_out + 2);  // batches 32 columns span, at most
  const size_t smem = (static_cast<size_t>(kNB) * kGS + static_cast<size_t>(kNB) * kCC * K +
                       static_cast<size_t>(n_b) * kCC * T_in) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  wgrad_kernel<<<n_live + row_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gy), static_cast<const float*>(y),
      static_cast<const float*>(x), static_cast<const int*>(tile_row),
      static_cast<const int*>(tile_chunk), static_cast<float*>(gw), static_cast<float*>(gb),
      n_live, B, C_in, T_in, K, P, T_out, stride, padding, reflect, slope);
  return static_cast<int>(cudaGetLastError());
}

const char* hmvae_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
