// K4: one periodized batched-1D synthesis level, float32.
//
// Replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::idwt1d_fused
// (_build_idwt1d, :2104), and computes the map of the folded long-signal
// kernel ::idwt1d_long_fused (_build_idwt1d_long, :2506) on a (1, L) view.
//
// Map (pypwt_tpu/core/conv.py:133-180, synthesis_last), for a, d of (R, L),
// an output of (R, n_out) and 2 <= hlen <= 40, each row on its own: the
// polyphase sum of common.cuh (Polyphase),
//   out[r, 2m + p] = sum_{j < hlen/2} g_p_lo[j] * a[r, (m + delta_p + j - c) mod L]
//                                   + g_p_hi[j] * d[r, (m + delta_p + j - c) mod L],
// for 2m + p < n_out (n_out = 2L, or 2L - 1 on an odd level: the last
// sample is cropped, as conv.synthesis_core does).
//
// Bound: per output sample a level reads 4 bytes (half an a and half a d
// coefficient) and writes 4, with hlen FMAs: hlen/4 flop per byte, under
// the H100's float32 ridge of ~20 flop per byte, so memory-bound.
//
// Design: one flat grid axis of (row, tile) pairs, as in K3 (rows past the
// grid's 2^31 - 1 blocks go in further launches). Each block owns TC
// coefficient positions of one row (2 TC outputs); it stages the a and d
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
              float* __restrict__ out, int len, int n_out, int tiles,
              Taps taps, int hlen, long long row0) {
  extern __shared__ float smem[];
  float* s_a = smem;              // [kWin] coefficient windows
  float* s_d = s_a + kWin;
  float* g_lo = s_d + kWin;       // [2][kHalfTaps] polyphase taps per parity
  float* g_hi = g_lo + 2 * kHalfTaps;

  const Polyphase ph(hlen);
  const int tid = threadIdx.x;
  const int bt = blockIdx.x / tiles;
  const int m0 = (blockIdx.x - bt * tiles) * TC;
  const long long row = row0 + bt;
  const int cnt = min(TC, (n_out + 1) / 2 - m0);  // positions of this block
  const int w = cnt + ph.h2;           // window coefficients
  const int q0 = m0 - ph.c;            // window origin
  const long long ib = row * len;

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
  const long long ob = row * n_out + 2LL * m0;
  const int outs = min(2 * cnt, n_out - 2 * m0);
  for (int i = tid; i < outs; i += kThreads) {
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
// output has n_out samples per row.
extern "C" int pypwt_idwt1d(const float* a, const float* d, float* out,
                            int rows, int len, int n_out, const float* rec_lo,
                            const float* rec_hi, int hlen, int device,
                            void* stream) {
  using namespace pypwt;
  const int tiles = ((n_out + 1) / 2 + TC - 1) / TC;
  if (hlen < 2 || hlen > kMaxTaps || len < 1 || len > 0x3fffffff ||
      n_out < 1 || n_out > 0x3fffffff || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * (2 * kWin + 4 * kHalfTaps);
  const Taps taps = make_taps(rec_lo, rec_hi, hlen);
  const long long chunk = 0x7fffffffLL / tiles;  // rows per launch
  for (long long r0 = 0; r0 < rows; r0 += chunk) {
    const long long nrows = std::min<long long>(rows - r0, chunk);
    idwt1d_kernel<<<static_cast<unsigned>(nrows * tiles), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        a, d, out, len, n_out, tiles, taps, hlen, r0);
  }
  return static_cast<int>(cudaGetLastError());
}
