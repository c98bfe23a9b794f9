// Dense CRF mean-field inference with Gaussian + bilateral pairwise terms.
//
// Role parity: the reference vendors the Krähenbühl densecrf library (a
// permutohedral lattice) behind a torch extension
// (uwsod/projects/WSL/wsl/layers/csrc/crf/crf_cpu.cpp:143-472, used by the
// WSJDS segmentation branch). This is an independent implementation of the
// same mean-field algorithm:
//
//   Q ∝ exp(-U)                                   (init)
//   Q ∝ exp(-U + Σ_k w_k (K_k ⊗ Q))               (iterate; Potts labels)
//
// with K_1 a spatial Gaussian (pos_x_std, pos_y_std) and K_2 a joint
// spatial/color bilateral Gaussian (bi_{x,y}_std, bi_{r,g,b}_std). The
// high-dimensional Gaussian convolutions use the splat/blur/slice bilateral
// grid of Paris & Durand (a regular-grid alternative to the permutohedral
// lattice), with symmetric normalization norm = K ⊗ 1 as in densecrf.
//
// Built as a plain shared library; Python binds via ctypes
// (sos_wsod_tpu/ops/dense_crf.py). No torch, no python headers.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// N-dimensional bilateral grid filter.
//
// features: (n, d) grid-space coordinates (already divided by the stds)
// values:   (n, c)
// out:      (n, c)  ~ gaussian-weighted average with sigma = 1 in grid space
void grid_filter(const float* features, const float* values, float* out,
                 int64_t n, int d, int c) {
  // grid extents
  std::vector<float> lo(d, 1e30f), hi(d, -1e30f);
  for (int64_t i = 0; i < n; i++) {
    for (int k = 0; k < d; k++) {
      float f = features[i * d + k];
      if (f < lo[k]) lo[k] = f;
      if (f > hi[k]) hi[k] = f;
    }
  }
  std::vector<int64_t> dims(d), stride(d);
  int64_t cells = 1;
  for (int k = 0; k < d; k++) {
    dims[k] = (int64_t)std::floor(hi[k] - lo[k]) + 3;  // +1 pad each side
    cells *= dims[k];
  }
  stride[d - 1] = 1;
  for (int k = d - 2; k >= 0; k--) stride[k] = stride[k + 1] * dims[k + 1];

  std::vector<float> grid((size_t)cells * c, 0.0f);
  std::vector<float> gbuf((size_t)cells * c, 0.0f);

  const int corners = 1 << d;
  std::vector<int64_t> base(d);
  std::vector<float> frac(d);

  // splat (multilinear)
  for (int64_t i = 0; i < n; i++) {
    for (int k = 0; k < d; k++) {
      float g = features[i * d + k] - lo[k] + 1.0f;  // +1: pad cell
      float fl = std::floor(g);
      base[k] = (int64_t)fl;
      frac[k] = g - fl;
    }
    for (int m = 0; m < corners; m++) {
      float w = 1.0f;
      int64_t idx = 0;
      for (int k = 0; k < d; k++) {
        int b = (m >> k) & 1;
        w *= b ? frac[k] : (1.0f - frac[k]);
        idx += (base[k] + b) * stride[k];
      }
      if (w == 0.0f) continue;
      float* cell = &grid[(size_t)idx * c];
      const float* v = &values[i * c];
      for (int ch = 0; ch < c; ch++) cell[ch] += w * v[ch];
    }
  }

  // blur: [1 2 1]/4 along each grid axis (gaussian with sigma ~1 cell)
  for (int k = 0; k < d; k++) {
    const int64_t s = stride[k];
    const int64_t dk = dims[k];
    // iterate all cells; neighbors at +-s along axis k
    for (int64_t idx = 0; idx < cells; idx++) {
      int64_t coord = (idx / s) % dk;
      const float* c0 = &grid[(size_t)idx * c];
      const float* cm = coord > 0 ? &grid[(size_t)(idx - s) * c] : nullptr;
      const float* cp = coord < dk - 1 ? &grid[(size_t)(idx + s) * c] : nullptr;
      float* o = &gbuf[(size_t)idx * c];
      for (int ch = 0; ch < c; ch++) {
        float v = 2.0f * c0[ch];
        if (cm) v += cm[ch];
        if (cp) v += cp[ch];
        o[ch] = 0.25f * v;
      }
    }
    grid.swap(gbuf);
  }

  // slice (multilinear)
  for (int64_t i = 0; i < n; i++) {
    for (int k = 0; k < d; k++) {
      float g = features[i * d + k] - lo[k] + 1.0f;
      float fl = std::floor(g);
      base[k] = (int64_t)fl;
      frac[k] = g - fl;
    }
    float* o = &out[i * c];
    for (int ch = 0; ch < c; ch++) o[ch] = 0.0f;
    for (int m = 0; m < corners; m++) {
      float w = 1.0f;
      int64_t idx = 0;
      for (int k = 0; k < d; k++) {
        int b = (m >> k) & 1;
        w *= b ? frac[k] : (1.0f - frac[k]);
        idx += (base[k] + b) * stride[k];
      }
      if (w == 0.0f) continue;
      const float* cell = &grid[(size_t)idx * c];
      for (int ch = 0; ch < c; ch++) o[ch] += w * cell[ch];
    }
  }
}

// filter with symmetric normalization: out = norm^-1/2 K (norm^-1/2 v),
// norm = K 1 (densecrf DenseKernel NORMALIZE_SYMMETRIC).
struct NormalizedFilter {
  std::vector<float> feats;   // (n, d)
  std::vector<float> norm;    // (n,)
  int64_t n;
  int d;

  void init(std::vector<float> f, int64_t n_, int d_) {
    feats = std::move(f);
    n = n_;
    d = d_;
    std::vector<float> ones(n, 1.0f);
    norm.assign(n, 0.0f);
    grid_filter(feats.data(), ones.data(), norm.data(), n, d, 1);
    for (int64_t i = 0; i < n; i++)
      norm[i] = 1.0f / std::sqrt(norm[i] + 1e-20f);
  }

  void apply(const float* v, float* out, int c,
             std::vector<float>& tmp) const {
    tmp.resize((size_t)n * c);
    for (int64_t i = 0; i < n; i++)
      for (int ch = 0; ch < c; ch++)
        tmp[(size_t)i * c + ch] = v[(size_t)i * c + ch] * norm[i];
    grid_filter(feats.data(), tmp.data(), out, n, d, c);
    for (int64_t i = 0; i < n; i++)
      for (int ch = 0; ch < c; ch++) out[(size_t)i * c + ch] *= norm[i];
  }
};

void exp_and_normalize(float* q, const float* in, int64_t n, int c) {
  for (int64_t i = 0; i < n; i++) {
    const float* row = &in[(size_t)i * c];
    float mx = row[0];
    for (int ch = 1; ch < c; ch++)
      if (row[ch] > mx) mx = row[ch];
    float sum = 0.0f;
    float* qr = &q[(size_t)i * c];
    for (int ch = 0; ch < c; ch++) {
      qr[ch] = std::exp(row[ch] - mx);
      sum += qr[ch];
    }
    for (int ch = 0; ch < c; ch++) qr[ch] /= sum;
  }
}

}  // namespace

extern "C" {

// Raw gaussian grid filter (exposed for tests).
void sos_grid_filter(const float* features, const float* values, float* out,
                     int64_t n, int d, int c) {
  grid_filter(features, values, out, n, d, c);
}

// Mean-field dense CRF.
//   unary: (H*W, C) energies (the reference passes max(prob, 1e-4) directly,
//          crf_cpu.cpp:74-94 — the caller decides)
//   image: (H, W, 3) uint8
//   out:   (H*W, C) marginal probabilities
// Returns 0 on success.
int sos_dense_crf(const float* unary, const uint8_t* image, int height,
                  int width, int c, int max_iter, float pos_w,
                  float pos_x_std, float pos_y_std, float bi_w,
                  float bi_x_std, float bi_y_std, float bi_r_std,
                  float bi_g_std, float bi_b_std, float* out) {
  const int64_t n = (int64_t)height * width;

  NormalizedFilter spatial, bilateral;
  {
    std::vector<float> f((size_t)n * 2);
    for (int y = 0; y < height; y++)
      for (int x = 0; x < width; x++) {
        f[(size_t)(y * width + x) * 2 + 0] = x / pos_x_std;
        f[(size_t)(y * width + x) * 2 + 1] = y / pos_y_std;
      }
    spatial.init(std::move(f), n, 2);
  }
  {
    std::vector<float> f((size_t)n * 5);
    for (int y = 0; y < height; y++)
      for (int x = 0; x < width; x++) {
        size_t i = (size_t)y * width + x;
        f[i * 5 + 0] = x / bi_x_std;
        f[i * 5 + 1] = y / bi_y_std;
        f[i * 5 + 2] = image[i * 3 + 0] / bi_r_std;
        f[i * 5 + 3] = image[i * 3 + 1] / bi_g_std;
        f[i * 5 + 4] = image[i * 3 + 2] / bi_b_std;
      }
    bilateral.init(std::move(f), n, 5);
  }

  std::vector<float> q((size_t)n * c), tmp1((size_t)n * c),
      msg((size_t)n * c), scratch;
  // init: Q = softmax(-U)
  for (size_t i = 0; i < (size_t)n * c; i++) tmp1[i] = -unary[i];
  exp_and_normalize(q.data(), tmp1.data(), n, c);

  for (int it = 0; it < max_iter; it++) {
    for (size_t i = 0; i < (size_t)n * c; i++) tmp1[i] = -unary[i];
    spatial.apply(q.data(), msg.data(), c, scratch);
    for (size_t i = 0; i < (size_t)n * c; i++) tmp1[i] += pos_w * msg[i];
    bilateral.apply(q.data(), msg.data(), c, scratch);
    for (size_t i = 0; i < (size_t)n * c; i++) tmp1[i] += bi_w * msg[i];
    exp_and_normalize(q.data(), tmp1.data(), n, c);
  }

  std::memcpy(out, q.data(), (size_t)n * c * sizeof(float));
  return 0;
}

}  // extern "C"
