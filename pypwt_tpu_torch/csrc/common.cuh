// Shared pieces of the separable 2D DWT level kernels (dwt2d.cu, idwt2d.cu).
#pragma once

#include <cuda_runtime.h>

namespace pypwt {

// MAX_FILTER_WIDTH of the filter registry (pypwt_tpu_torch/filters).
constexpr int kMaxTaps = 40;
constexpr int kThreads = 256;

// The bank's two filters of one direction, float32, passed to the kernel by
// value (kernel parameter space): no device copy of the taps per call.
struct Taps {
  float lo[kMaxTaps];
  float hi[kMaxTaps];
};

inline Taps make_taps(const float* lo, const float* hi, int hlen) {
  Taps t{};
  for (int k = 0; k < hlen; ++k) {
    t.lo[k] = lo[k];
    t.hi[k] = hi[k];
  }
  return t;
}

// k mod n in [0, n) for any k. A single wrap is not enough: at deep levels
// or on small planes the periodic pad is wider than the plane itself.
__device__ __forceinline__ int wrap(int k, int n) {
  if (static_cast<unsigned>(k) < static_cast<unsigned>(n)) return k;
  k %= n;
  return k < 0 ? k + n : k;
}

}  // namespace pypwt
