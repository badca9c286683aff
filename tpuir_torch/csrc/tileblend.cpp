// Host side of the tiled engine: patch gather and Gaussian-window
// blend-stitch, float32, for tpuir_torch/core/native.py (g++, ctypes).
//
// A copy of the same three functions of native/tileblend.cpp, so that the
// port's engine reproduces the JAX engine's host arithmetic bit for bit:
// blend_accumulate adds patch after patch in patch order, as the
// original's Python loop does. All images are float32 HWC row-major;
// coordinates are (row, col) pairs.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Gather n patches of (ph, pw, c) from img (h, w, c) at coords[2*i..].
void extract_patches(const float* img, int64_t h, int64_t w, int64_t c,
                     const int64_t* coords, int64_t n, int64_t ph, int64_t pw,
                     float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t hi = coords[2 * i], wi = coords[2 * i + 1];
    for (int64_t r = 0; r < ph; ++r) {
      const float* src = img + ((hi + r) * w + wi) * c;
      float* dst = out + ((i * ph + r) * pw) * c;
      std::memcpy(dst, src, sizeof(float) * pw * c);
    }
  }
}

// Accumulate preds (n, ph, pw, c) * window into out/wmap (h, w, c), in
// patch order.
void blend_accumulate(float* out, float* wmap, int64_t h, int64_t w, int64_t c,
                      const float* preds, const int64_t* coords, int64_t n,
                      int64_t ph, int64_t pw, const float* window) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t hi = coords[2 * i], wi = coords[2 * i + 1];
    for (int64_t r = 0; r < ph; ++r) {
      float* orow = out + ((hi + r) * w + wi) * c;
      float* wrow = wmap + ((hi + r) * w + wi) * c;
      const float* prow = preds + ((i * ph + r) * pw) * c;
      const float* wnrow = window + (r * pw) * c;
      for (int64_t k = 0; k < pw * c; ++k) {
        orow[k] += prow[k] * wnrow[k];
        wrow[k] += wnrow[k];
      }
    }
  }
}

// out /= max(wmap, eps)
void blend_normalize(float* out, const float* wmap, int64_t numel, float eps) {
  for (int64_t i = 0; i < numel; ++i) out[i] /= std::max(wmap[i], eps);
}

}  // extern "C"
