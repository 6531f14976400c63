// Native batch sampler for 579-dim motion sequences.
//
// The TPU train step consumes ~165k seqs/sec at the reference batch size;
// a Python/numpy per-window sampler becomes the bottleneck long before that.
// This loader keeps all sequences memory-resident, samples windows with a
// per-thread xorshift RNG, fuses z-normalisation into the copy, and runs a
// configurable thread pool filling a bounded batch queue.
//
// Exposed as a plain C ABI consumed via ctypes (hm_vae_tpu/data/native_loader.py).
// Scope notes: .npy parsing is deliberately minimal — float32, C-order,
// 2-D (T, D) files, which is exactly what our converters write.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libmotion_loader.so loader.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Sequence {
  std::vector<float> data;  // T * dim
  std::vector<float> aa;    // T * 72 axis-angle sidecar (built on demand)
  int64_t T = 0;
  int64_t dim = 0;
};

struct Batch {
  std::vector<float> raw;   // B * L * dim
  std::vector<float> norm;  // B * L * dim
};

struct Loader {
  std::vector<Sequence> seqs;
  std::vector<float> mean, inv_std;
  int64_t dim = 0;

  // prefetch machinery
  std::vector<std::thread> workers;
  std::queue<Batch*> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  int batch = 0, seq_len = 0, depth = 0;
  bool fps_aug = false;
  uint64_t seed = 0;
  std::atomic<uint64_t> worker_id{0};

  // release store in build_aa_sidecar / acquire load at the fast-path check:
  // the unsynchronized read in ml_sample_compact_aa_mt would otherwise race
  // with the write under aa_mu (formal UB; benign only by call ordering)
  std::atomic<bool> aa_built{false};
  std::mutex aa_mu;
};

// minimal .npy reader: float32, C-order, 2-D
bool read_npy(const char* path, Sequence* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    fclose(f);
    return false;
  }
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) { fclose(f); return false; }
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) { fclose(f); return false; }
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
  }
  std::string header(hlen, '\0');
  if (fread(&header[0], 1, hlen, f) != hlen) { fclose(f); return false; }
  if (header.find("'<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    fclose(f);
    return false;
  }
  auto sp = header.find("'shape': (");
  if (sp == std::string::npos) { fclose(f); return false; }
  int64_t T = 0, dim = 0;
  if (sscanf(header.c_str() + sp, "'shape': (%ld, %ld)", &T, &dim) != 2) {
    fclose(f);
    return false;
  }
  out->T = T;
  out->dim = dim;
  out->data.resize(size_t(T) * dim);
  size_t n = fread(out->data.data(), sizeof(float), out->data.size(), f);
  fclose(f);
  return n == out->data.size();
}

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  // unbiased-enough bounded draw for data sampling
  int64_t below(int64_t n) { return int64_t(next() % uint64_t(n)); }
};

const int kFpsStrides[] = {1, 2, 3, 4, 5, 6, 8, 10, 12};

// 579-dim frame layout offsets (hm_vae_tpu/data/layout.py)
constexpr int64_t kRot6d = 0, kRotMat = 144, kCoord = 360, kLinV = 432,
                  kAngV = 504, kRootV = 576, kDim = 579;

struct FieldPtrs {
  float* rot6d;      // raw
  float* rotmat;     // raw
  float* rotpos;     // raw
  float* jointpos;   // normalised
  float* linv;       // normalised
  float* angv;       // normalised
  float* rootv;      // normalised
};

// pick a window (same retry policy as fill_one) and write the 7 field
// buffers directly — no second pass, no Python-side copies.  idx selects the
// sample slot in each (B, T, ...) field buffer.
void fill_one_fields(const Loader& L, XorShift& rng, int seq_len,
                     bool fps_aug, const FieldPtrs& p, int64_t idx) {
  float* rot6d = p.rot6d + idx * seq_len * 144;
  float* rotmat = p.rotmat + idx * seq_len * 216;
  float* rotpos = p.rotpos + idx * seq_len * 72;
  float* jointpos = p.jointpos + idx * seq_len * 72;
  float* linv = p.linv + idx * seq_len * 72;
  float* angv = p.angv + idx * seq_len * 72;
  float* rootv = p.rootv + idx * seq_len * 3;
  for (int attempt = 0; attempt < 64; ++attempt) {
    const Sequence& s = L.seqs[rng.below((int64_t)L.seqs.size())];
    int stride = 1;
    if (fps_aug) {
      for (int t = 0; t < 10; ++t) {
        int cand = kFpsStrides[rng.below(9)];
        if ((s.T + cand - 1) / cand >= seq_len) {
          stride = cand;
          break;
        }
      }
    }
    int64_t eff_T = (s.T + stride - 1) / stride;
    if (eff_T < seq_len) continue;
    int64_t t0 = rng.below(eff_T - seq_len + 1);
    const float* mean = L.mean.data();
    const float* inv = L.inv_std.data();
    for (int64_t i = 0; i < seq_len; ++i) {
      const float* src = s.data.data() + (t0 + i) * stride * kDim;
      memcpy(rot6d + i * 144, src + kRot6d, 144 * sizeof(float));
      memcpy(rotmat + i * 216, src + kRotMat, 216 * sizeof(float));
      memcpy(rotpos + i * 72, src + kCoord, 72 * sizeof(float));
      float* jp = jointpos + i * 72;
      float* lv = linv + i * 72;
      float* av = angv + i * 72;
      for (int d = 0; d < 72; ++d) {
        jp[d] = (src[kCoord + d] - mean[kCoord + d]) * inv[kCoord + d];
        lv[d] = (src[kLinV + d] - mean[kLinV + d]) * inv[kLinV + d];
        av[d] = (src[kAngV + d] - mean[kAngV + d]) * inv[kAngV + d];
      }
      float* rv = rootv + i * 3;
      for (int d = 0; d < 3; ++d)
        rv[d] = (src[kRootV + d] - mean[kRootV + d]) * inv[kRootV + d];
    }
    return;
  }
}

void fill_one(const Loader& L, XorShift& rng, int seq_len, bool fps_aug,
              float* raw, float* norm) {
  const int64_t dim = L.dim;
  for (int attempt = 0; attempt < 64; ++attempt) {
    const Sequence& s = L.seqs[rng.below((int64_t)L.seqs.size())];
    int stride = 1;
    if (fps_aug) {
      // retry up to 10x for a stride that leaves enough frames
      for (int t = 0; t < 10; ++t) {
        int cand = kFpsStrides[rng.below(9)];
        if ((s.T + cand - 1) / cand >= seq_len) {
          stride = cand;
          break;
        }
      }
    }
    int64_t eff_T = (s.T + stride - 1) / stride;
    if (eff_T < seq_len) continue;
    int64_t t0 = rng.below(eff_T - seq_len + 1);
    for (int64_t i = 0; i < seq_len; ++i) {
      const float* src = s.data.data() + (t0 + i) * stride * dim;
      float* r = raw + i * dim;
      float* n = norm + i * dim;
      for (int64_t d = 0; d < dim; ++d) {
        float v = src[d];
        r[d] = v;
        n[d] = (v - L.mean[d]) * L.inv_std[d];
      }
    }
    return;
  }
  // pathological fallback: zero fill
  memset(raw, 0, sizeof(float) * seq_len * dim);
  memset(norm, 0, sizeof(float) * seq_len * dim);
}

void worker_loop(Loader* L) {
  XorShift rng(L->seed + 0x1234567 * (1 + L->worker_id.fetch_add(1)));
  const int64_t dim = L->dim;
  while (!L->stop.load()) {
    Batch* b = new Batch();
    b->raw.resize(size_t(L->batch) * L->seq_len * dim);
    b->norm.resize(size_t(L->batch) * L->seq_len * dim);
    for (int i = 0; i < L->batch; ++i) {
      fill_one(*L, rng, L->seq_len, L->fps_aug,
               b->raw.data() + size_t(i) * L->seq_len * dim,
               b->norm.data() + size_t(i) * L->seq_len * dim);
    }
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_push.wait(lk, [L] {
      return L->stop.load() || (int)L->queue.size() < L->depth;
    });
    if (L->stop.load()) {
      delete b;
      return;
    }
    L->queue.push(b);
    L->cv_pop.notify_one();
  }
}

// Robust SO(3) log map: row-major 3x3 rotation -> axis-angle.  The aa wire
// ships 3 floats/joint (vs rot6d's 6), reconstructed on device by Rodrigues;
// this inverse runs ONCE per frame at sidecar-build time, not per sample.
void rotmat_to_aa3(const float* R, float* aa) {
  double tr = R[0] + R[4] + R[8];
  // v = (R21-R12, R02-R20, R10-R01) = 2 sin(theta) * axis
  double vx = R[7] - R[5], vy = R[2] - R[6], vz = R[3] - R[1];
  double vn = std::sqrt(vx * vx + vy * vy + vz * vz);
  // theta = atan2(2 sin, 2 cos): well-conditioned over ALL of [0, pi],
  // unlike acos((tr-1)/2) whose derivative blows up as 1/sin(theta) near pi
  // (trace noise of ~1e-7 there becomes ~1e-4 rad of angle error)
  double theta = std::atan2(vn, tr - 1.0);
  if (theta < 3.0) {
    // axis from the skew part; theta/vn -> 1/2 smoothly as theta -> 0
    double k = (vn < 1e-12) ? 0.5 : theta / vn;
    aa[0] = float(k * vx);
    aa[1] = float(k * vy);
    aa[2] = float(k * vz);
    return;
  }
  // theta near pi: the skew part shrinks toward the f32 noise floor, so take
  // the axis from the symmetric part, a_i^2 = (R_ii - cos)/(1 - cos), whose
  // conditioning is O(1) there; signs fixed off the largest component, the
  // overall sign from v (arbitrary at exactly pi — both encode the rotation).
  double cos_t = std::min(1.0, std::max(-1.0, (tr - 1.0) / 2.0));
  double d = 1.0 - cos_t;
  double ax = std::sqrt(std::max(0.0, (R[0] - cos_t) / d));
  double ay = std::sqrt(std::max(0.0, (R[4] - cos_t) / d));
  double az = std::sqrt(std::max(0.0, (R[8] - cos_t) / d));
  if (ax >= ay && ax >= az) {
    if (ax > 0) {
      ay = (R[1] + R[3]) / (2.0 * d * ax);
      az = (R[2] + R[6]) / (2.0 * d * ax);
    }
  } else if (ay >= az) {
    ax = (R[1] + R[3]) / (2.0 * d * ay);
    az = (R[5] + R[7]) / (2.0 * d * ay);
  } else {
    ax = (R[2] + R[6]) / (2.0 * d * az);
    ay = (R[5] + R[7]) / (2.0 * d * az);
  }
  if (vx * ax + vy * ay + vz * az < 0) { ax = -ax; ay = -ay; az = -az; }
  aa[0] = float(theta * ax);
  aa[1] = float(theta * ay);
  aa[2] = float(theta * az);
}

void build_aa_sidecar(Loader* L, int threads) {
  std::lock_guard<std::mutex> lk(L->aa_mu);
  if (L->aa_built.load(std::memory_order_acquire)) return;
  std::atomic<size_t> next{0};
  auto work = [&] {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= L->seqs.size()) return;
      Sequence& s = L->seqs[i];
      s.aa.resize(size_t(s.T) * 72);
      for (int64_t t = 0; t < s.T; ++t) {
        const float* frame = s.data.data() + t * kDim + kRotMat;
        float* dst = s.aa.data() + t * 72;
        for (int j = 0; j < 24; ++j)
          rotmat_to_aa3(frame + j * 9, dst + j * 3);
      }
    }
  };
  if (threads <= 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) ts.emplace_back(work);
    for (auto& th : ts) th.join();
  }
  L->aa_built.store(true, std::memory_order_release);
}

}  // namespace

extern "C" {

void* ml_open(const char** paths, int n, const float* mean, const float* std,
              int64_t dim) {
  Loader* L = new Loader();
  L->dim = dim;
  L->mean.assign(mean, mean + dim);
  L->inv_std.resize(dim);
  for (int64_t d = 0; d < dim; ++d)
    L->inv_std[d] = std[d] != 0.0f ? 1.0f / std[d] : 1.0f;
  for (int i = 0; i < n; ++i) {
    Sequence s;
    if (!read_npy(paths[i], &s) || s.dim != dim) {
      delete L;
      return nullptr;
    }
    L->seqs.push_back(std::move(s));
  }
  if (L->seqs.empty()) {
    delete L;
    return nullptr;
  }
  return L;
}

int64_t ml_num_seqs(void* h) { return ((Loader*)h)->seqs.size(); }

// synchronous batch (no threads) — used for tests and deterministic paths
void ml_sample_batch(void* h, int batch, int seq_len, uint64_t seed,
                     int fps_aug, float* out_raw, float* out_norm) {
  Loader* L = (Loader*)h;
  XorShift rng(seed);
  for (int i = 0; i < batch; ++i) {
    fill_one(*L, rng, seq_len, fps_aug != 0,
             out_raw + size_t(i) * seq_len * L->dim,
             out_norm + size_t(i) * seq_len * L->dim);
  }
}

// one-shot multithreaded fill directly into caller buffers — the preferred
// path for K-step super-batches (no queue, no extra copies)
void ml_sample_batch_mt(void* h, int batch, int seq_len, uint64_t seed,
                        int fps_aug, float* out_raw, float* out_norm,
                        int threads) {
  Loader* L = (Loader*)h;
  if (threads <= 1 || batch < threads) {
    ml_sample_batch(h, batch, seq_len, seed, fps_aug, out_raw, out_norm);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (batch + threads - 1) / threads;
  const int64_t item = int64_t(seq_len) * L->dim;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(batch, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=] {
      XorShift rng(seed + 0x9e3779b9ull * (t + 1));
      for (int64_t i = lo; i < hi; ++i) {
        fill_one(*L, rng, seq_len, fps_aug != 0, out_raw + i * item,
                 out_norm + i * item);
      }
    });
  }
  for (auto& th : ts) th.join();
}

// field-buffer variant: writes the training batch dict's buffers directly
void ml_sample_fields_mt(void* h, int batch, int seq_len, uint64_t seed,
                         int fps_aug, float* rot6d, float* rotmat,
                         float* rotpos, float* jointpos, float* linv,
                         float* angv, float* rootv, int threads) {
  Loader* L = (Loader*)h;
  FieldPtrs p{rot6d, rotmat, rotpos, jointpos, linv, angv, rootv};
  if (threads <= 1 || batch < 2 * threads) {
    XorShift rng(seed);
    for (int i = 0; i < batch; ++i)
      fill_one_fields(*L, rng, seq_len, fps_aug != 0, p, i);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (batch + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(batch, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=] {
      XorShift rng(seed + 0x9e3779b9ull * (t + 1));
      for (int64_t i = lo; i < hi; ++i)
        fill_one_fields(*L, rng, seq_len, fps_aug != 0, p, i);
    });
  }
  for (auto& th : ts) th.join();
}

// compact variant: a single layout slice (+ optionally normalised root_v) —
// the minimal host->device transfer for training (everything else derives on
// device from the rotations).  offset/width select the slice: rot_mat
// (144, 216) for the rotmat wire, rot_6d (0, 144) for the 6D wire (the
// device re-orthonormalizes 6D -> rotmat; 33% fewer wire bytes).
void ml_sample_compact_slice_mt(void* h, int batch, int seq_len,
                                uint64_t seed, int fps_aug, float* out,
                                float* rootv, int threads, int64_t offset,
                                int64_t width) {
  Loader* L = (Loader*)h;
  // from_aa: read the axis-angle sidecar (width 72/frame) instead of a
  // 579-layout slice; the window/RNG policy is identical either way.
  const bool from_aa = (offset < 0);
  auto fill = [&](int64_t lo, int64_t hi, uint64_t s2) {
    XorShift rng(s2);
    const float* mean = L->mean.data();
    const float* inv = L->inv_std.data();
    for (int64_t idx = lo; idx < hi; ++idx) {
      float* rm = out + idx * seq_len * width;
      float* rv = rootv ? rootv + idx * seq_len * 3 : nullptr;
      for (int attempt = 0; attempt < 64; ++attempt) {
        const Sequence& s = L->seqs[rng.below((int64_t)L->seqs.size())];
        int stride = 1;
        if (fps_aug) {
          for (int t = 0; t < 10; ++t) {
            int cand = kFpsStrides[rng.below(9)];
            if ((s.T + cand - 1) / cand >= seq_len) {
              stride = cand;
              break;
            }
          }
        }
        int64_t eff_T = (s.T + stride - 1) / stride;
        if (eff_T < seq_len) continue;
        int64_t t0 = rng.below(eff_T - seq_len + 1);
        for (int64_t i = 0; i < seq_len; ++i) {
          const int64_t row = (t0 + i) * stride;
          const float* payload =
              from_aa ? s.aa.data() + row * width
                      : s.data.data() + row * kDim + offset;
          memcpy(rm + i * width, payload, width * sizeof(float));
          if (rv) {
            const float* src = s.data.data() + row * kDim;
            for (int d = 0; d < 3; ++d)
              rv[i * 3 + d] =
                  (src[kRootV + d] - mean[kRootV + d]) * inv[kRootV + d];
          }
        }
        break;
      }
    }
  };
  if (threads <= 1 || batch < 2 * threads) {
    fill(0, batch, seed);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (batch + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(batch, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(fill, lo, hi, seed + 0x9e3779b9ull * (t + 1));
  }
  for (auto& th : ts) th.join();
}

// axis-angle wire: ships 24x3 floats/frame from the precomputed sidecar
// (built on first use by ml_build_aa) — half the rot6d wire's bytes; the
// device reconstructs rotations by Rodrigues.
void ml_build_aa(void* h, int threads) { build_aa_sidecar((Loader*)h, threads); }

void ml_sample_compact_aa_mt(void* h, int batch, int seq_len, uint64_t seed,
                             int fps_aug, float* out, float* rootv,
                             int threads) {
  Loader* L = (Loader*)h;
  if (!L->aa_built.load(std::memory_order_acquire))
    build_aa_sidecar(L, threads);
  ml_sample_compact_slice_mt(h, batch, seq_len, seed, fps_aug, out, rootv,
                             threads, /*offset=*/-1, /*width=*/72);
}

// back-compat wrapper: the rot_mat wire
void ml_sample_compact_mt(void* h, int batch, int seq_len, uint64_t seed,
                          int fps_aug, float* rotmat, float* rootv,
                          int threads) {
  ml_sample_compact_slice_mt(h, batch, seq_len, seed, fps_aug, rotmat, rootv,
                             threads, kRotMat, 216);
}

void ml_start_prefetch(void* h, int batch, int seq_len, int depth,
                       int threads, uint64_t seed, int fps_aug) {
  Loader* L = (Loader*)h;
  L->batch = batch;
  L->seq_len = seq_len;
  L->depth = depth;
  L->seed = seed;
  L->fps_aug = fps_aug != 0;
  L->stop.store(false);
  for (int i = 0; i < threads; ++i)
    L->workers.emplace_back(worker_loop, L);
}

// blocking pop; copies into caller buffers
void ml_next_batch(void* h, float* out_raw, float* out_norm) {
  Loader* L = (Loader*)h;
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [L] { return !L->queue.empty(); });
    b = L->queue.front();
    L->queue.pop();
    L->cv_push.notify_one();
  }
  memcpy(out_raw, b->raw.data(), b->raw.size() * sizeof(float));
  memcpy(out_norm, b->norm.data(), b->norm.size() * sizeof(float));
  delete b;
}

void ml_close(void* h) {
  Loader* L = (Loader*)h;
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
