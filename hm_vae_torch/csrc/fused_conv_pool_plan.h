// The forward kernel's launch plan (fused_conv_pool.cu): how a block stages
// its rows of x (whole rows or windows), how many taps a stage takes, the
// block's shared memory and the cluster split.
//
// Plain C++, no CUDA: fused_conv_pool.cu includes it and its launcher plans
// every launch here, and the wrapper (hm_vae_torch/ops/fused_conv_pool.py:
// forward_plan) compiles this file alone for the host, so the CPU tests and
// the card read the same planner.

#ifndef HMVAE_FUSED_CONV_POOL_PLAN_H_
#define HMVAE_FUSED_CONV_POOL_PLAN_H_

#include <stddef.h>

#include <algorithm>

namespace hmvae_fwd {

constexpr int kBM = 64;             // rows per tile (wgmma M)
constexpr int kBN = 64;             // columns per tile
constexpr int kMaxSplit = 8;        // blocks per cluster (the portable maximum)
constexpr int kRedBytes = kBM * kBN * 4;
constexpr int kSmemPerSM = 233472;  // 228 KB
constexpr int kMaxSmem = 232448;    // 227 KB a block

// An element type's staging: bytes a value, input channels a chunk, weight
// and im2col planes (TF32 big and small in f32), chunks in flight.
struct Elem {
  int bytes, cc, planes, stages;
};
constexpr Elem kF32 = {4, 8, 2, 2};
constexpr Elem kBf16 = {2, 16, 1, 2};

struct Plan {
  int window;    // 1: rows staged as windows (conv_gemm_kernel<T, true>)
  int win;       // columns a block's 64 outputs read (window rows), else 0
  int nb;        // batches one block's 64 columns span, at most
  int xp;        // values of a staged row's slot (T_in for whole rows)
  int seg;       // taps a stage
  int segments;  // stages a chunk
  int smem;      // a block's dynamic shared memory, bytes
  int split;     // blocks of a cluster
  int fits;      // smem <= kMaxSmem (else the launch fails)
};
constexpr int kPlanInts = 9;  // Plan's fields, in order, as plan_ints writes them

inline void plan_ints(const Plan& p, int* out) {
  const int v[kPlanInts] = {p.window, p.win,  p.nb,    p.xp,  p.seg,
                            p.segments, p.smem, p.split, p.fits};
  std::copy(v, v + kPlanInts, out);
}

// A block's shared memory with x's rows in slots of xp values, nb of them a
// stage, and the fewest tap segments (of `seg` taps) a chunk splits into for
// it to fit.
inline size_t stage_bytes(const Elem& e, int K, int xp, int nb, int& seg) {
  const int G = 16 / e.bytes;  // values of a 16-byte granule
  const size_t xs_bytes = static_cast<size_t>(e.stages) * nb * (e.cc * xp + G) * e.bytes;
  for (int nseg = 1;; ++nseg) {
    seg = (K + nseg - 1) / nseg;
    const size_t stage = static_cast<size_t>(kBM) * e.cc * seg * e.bytes * e.planes;
    const size_t bytes = 384 + 127 + e.stages * stage +
                         std::max(stage, static_cast<size_t>(kRedBytes)) + xs_bytes;
    if (bytes <= static_cast<size_t>(kMaxSmem) || seg == 1) return bytes;
  }
}

// The batch is `windows` windows of B / windows batches each; P rows, the
// most live tiles of a row tile max_live, sms multiprocessors.
inline Plan plan_forward(const Elem& e, int B, int T_in, int K, int P, int T_out, int stride,
                         int padding, int windows, int max_live, int sms) {
  const int G = 16 / e.bytes;
  Plan p = {};
  p.nb = std::min(B / windows, (kBN - 1) / T_out + 2);
  // Whole rows (xp = T_in), unless they do not fit or take more tap
  // segments than windows: the padded columns 64 outputs read, or, where
  // reflect folds back more, padding + 1, in slots widened to whole 16-byte
  // granules at both ends (then T_out >= 64, so nb <= 2).  Whole rows are
  // the faster staging where both fit (one copy a batch, not one a row).
  p.xp = T_in;
  size_t smem = stage_bytes(e, K, T_in, p.nb, p.seg);
  const int win = std::max((kBN - 1) * stride + K, padding + 1);
  if (win < T_in) {
    int seg_w;
    const int xp_w = (win + G - 1) / G * G + G;
    const size_t smem_w = stage_bytes(e, K, xp_w, p.nb, seg_w);
    if (smem > static_cast<size_t>(kMaxSmem) ||
        (K + p.seg - 1) / p.seg > (K + seg_w - 1) / seg_w) {
      p.window = 1, p.win = win, p.xp = xp_w, p.seg = seg_w, smem = smem_w;
    }
  }
  p.segments = (K + p.seg - 1) / p.seg;
  p.fits = smem <= static_cast<size_t>(kMaxSmem);
  p.smem = static_cast<int>(std::min(smem, static_cast<size_t>(1) << 30));
  // split the live chunks until the grid fills the card once
  const int win_tiles = (B / windows * T_out + kBN - 1) / kBN;
  const int nt = windows * win_tiles, rts = (P + kBM - 1) / kBM;
  const int per_sm = std::max(1, std::min(8, kSmemPerSM / (p.smem + 1024)));
  const int split = (per_sm * sms + nt * rts - 1) / (nt * rts);
  p.split = std::max(1, std::min(split, std::min(kMaxSplit, max_live)));
  return p;
}

}  // namespace hmvae_fwd

extern "C" {

// The plan of a forward launch of the given shape into out[kPlanInts]
// (Plan's fields in order); dtype 0 = float32, 1 = bfloat16.  Returns 0, or
// 1 for arguments no launch takes.
int hmvae_fused_conv_pool_plan(int dtype, int B, int T_in, int K, int P, int T_out, int stride,
                               int padding, int windows, int max_live, int sms, int* out) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || T_in <= 0 || K <= 0 || P <= 0 || T_out <= 0 ||
      stride <= 0 || padding < 0 || windows <= 0 || B % windows != 0 || max_live < 0 ||
      sms <= 0)
    return 1;
  hmvae_fwd::plan_ints(
      hmvae_fwd::plan_forward(dtype == 0 ? hmvae_fwd::kF32 : hmvae_fwd::kBf16, B, T_in, K, P,
                              T_out, stride, padding, windows, max_live, sms),
      out);
  return 0;
}

}  // extern "C"

#endif  // HMVAE_FUSED_CONV_POOL_PLAN_H_
