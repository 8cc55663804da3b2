// K4: one periodized batched-1D synthesis level, float32.
//
// Replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::idwt1d_fused
// (_build_idwt1d, :2104), and computes the map of the folded long-signal
// kernel ::idwt1d_long_fused (_build_idwt1d_long, :2506) on a (1, L) view.
//
// Map (pypwt_tpu/core/conv.py:133-180, synthesis_last with n_out = 2L),
// for a, d of (R, L) and an output of (R, 2L), even hlen <= 40, each row on
// its own: the polyphase sum of common.cuh (Polyphase),
//   out[r, 2m + p] = sum_{j < hlen/2} g_p_lo[j] * a[r, (m + delta_p + j - c) mod L]
//                                   + g_p_hi[j] * d[r, (m + delta_p + j - c) mod L].
// An odd output length (n_out = 2L - 1) is not taken: the wrapper declines
// it, as the TPU build function does (pallas_dwt.py:2091).
//
// Bound: per output sample a level reads 4 bytes (half an a and half a d
// coefficient) and writes 4, with hlen FMAs: hlen/4 flop per byte, under
// the H100's float32 ridge of ~20 flop per byte, so memory-bound.
//
// Design: one flat grid axis of (row, tile) pairs, as in K3. Each block
// owns TC coefficients of one row (2 TC outputs); it stages the a and d
// windows (TC + hlen/2 coefficients each, true periodic wrap, in-range fast
// path) into shared memory once, and writes its outputs with consecutive
// threads on consecutive samples. Neighbouring threads of one parity pair
// read the same or the next word: no bank conflicts. Row offsets are
// 64-bit.

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TC = 1024;                // coefficients per block
constexpr int kWin = TC + kHalfTaps;    // window coefficients

__global__ void __launch_bounds__(kThreads)
idwt1d_kernel(const float* __restrict__ a, const float* __restrict__ d,
              float* __restrict__ out, int len, int tiles, Taps taps,
              int hlen) {
  extern __shared__ float smem[];
  float* s_a = smem;              // [kWin] coefficient windows
  float* s_d = s_a + kWin;
  float* g_lo = s_d + kWin;       // [2][kHalfTaps] polyphase taps per parity
  float* g_hi = g_lo + 2 * kHalfTaps;

  const Polyphase ph(hlen);
  const int tid = threadIdx.x;
  const int row = blockIdx.x / tiles;
  const int m0 = (blockIdx.x - row * tiles) * TC;
  const int cnt = min(TC, len - m0);   // coefficients of this block
  const int w = cnt + ph.h2;           // window coefficients
  const int q0 = m0 - ph.c;            // window origin
  const long long ib = static_cast<long long>(row) * len;

  load_polyphase_taps(taps, hlen, g_lo, g_hi);
  if (q0 >= 0 && q0 + w <= len) {
    for (int q = tid; q < w; q += kThreads) {
      s_a[q] = a[ib + q0 + q];
      s_d[q] = d[ib + q0 + q];
    }
  } else {
    for (int q = tid; q < w; q += kThreads) {
      const int k = wrap(q0 + q, len);
      s_a[q] = a[ib + k];
      s_d[q] = d[ib + k];
    }
  }
  __syncthreads();

  // Output 2m + p reads window coefficients m + delta_p + j.
  const long long ob = 2 * ib + 2LL * m0;
  for (int i = tid; i < 2 * cnt; i += kThreads) {
    const int p = i & 1;
    const int base = (i >> 1) + ph.delta(p);
    const float* gl = g_lo + p * kHalfTaps;
    const float* gh = g_hi + p * kHalfTaps;
    float s = 0.f;
    for (int j = 0; j < ph.h2; ++j) {
      s = fmaf(s_a[base + j], gl[j], s);
      s = fmaf(s_d[base + j], gh[j], s);
    }
    out[ob + i] = s;
  }
}

}  // namespace
}  // namespace pypwt

// Returns a cudaError_t; launches on `stream`, does not synchronise and
// allocates nothing. rec_lo/rec_hi are host arrays of hlen floats; the
// output has 2 * len samples per row.
extern "C" int pypwt_idwt1d(const float* a, const float* d, float* out,
                            int rows, int len, const float* rec_lo,
                            const float* rec_hi, int hlen, int device,
                            void* stream) {
  using namespace pypwt;
  const int tiles = (len + TC - 1) / TC;
  if (hlen < 2 || hlen > kMaxTaps || (hlen & 1) || len < 1 ||
      len > 0x3fffffff || rows < 1 ||
      static_cast<long long>(rows) * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * (2 * kWin + 4 * kHalfTaps);
  idwt1d_kernel<<<rows * tiles, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      a, d, out, len, tiles, make_taps(rec_lo, rec_hi, hlen), hlen);
  return static_cast<int>(cudaGetLastError());
}
