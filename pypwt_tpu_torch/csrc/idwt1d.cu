// K4: one periodized batched-1D synthesis level, float32 or float64; and
// K29b, the same level of one segment of longer rows.
//
// Replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::idwt1d_fused
// (_build_idwt1d, :2104), and computes the map of the folded long-signal
// kernel ::idwt1d_long_fused (_build_idwt1d_long, :2506) on a (1, L) view.
// K29b (pypwt_syn_lanes) replaces ::build_syn_padded_lanes (:1751), the
// lane-axis synthesis of the grid and sequence layouts of
// pypwt_tpu/parallel/spatial.py (_synthesis_axis_sharded): the same kernel
// with the LaneHalo coefficient source (common.cuh), each coefficient row's
// samples before and after the shard read from the exchanged halos.
//
// Map (pypwt_tpu/core/conv.py:133-180, synthesis_last), for a, d of (R, L),
// an output of (R, n_out) and 2 <= hlen <= 40, each row on its own: the
// polyphase sum of common.cuh (Polyphase),
//   out[r, 2m + p] = sum_{j < hlen/2} g_p_lo[j] * a[r, (m + delta_p + j - c) mod L]
//                                   + g_p_hi[j] * d[r, (m + delta_p + j - c) mod L],
// for 2m + p < n_out (n_out = 2L, or 2L - 1 on an odd level: the last
// sample is cropped, as conv.synthesis_core does). K29b: n_out = 2L, and
// coefficient k of the extended axis [-c, L + rp) in place of the wrapped
// one (conv.synthesis_core on the halo-extended rows, rp of
// conv.synthesis_pads).
//
// Bound: per output sample a level reads 4 bytes (half an a and half a d
// coefficient) and writes 4, with hlen FMAs: hlen/4 flop per byte, under
// the H100's float32 ridge of ~20 flop per byte, so memory-bound.
//
// Design: one flat grid axis of (row, tile) pairs, as in K3 (rows past the
// grid's 2^31 - 1 blocks go in further launches). Each block owns TC
// coefficient positions of one row (2 TC outputs); it stages the a and d
// windows (TC + hlen/2 coefficients each, true periodic wrap or the halo
// source, in-range fast path) into shared memory once, and writes its
// outputs with consecutive threads on consecutive samples. Neighbouring
// threads of one parity pair read the same or the next word: no bank
// conflicts. Row offsets are 64-bit. A float64 instance (pypwt_idwt1d_f64,
// pypwt_syn_lanes_f64) stages 16.7 KB.

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TC = 1024;                // coefficients per block
constexpr int kWin = TC + kHalfTaps;    // window coefficients

// Lanes: Wrapped (K4), or the LaneHalo<T, 2> of the rows a, d (K29b).
template <class T, class Lanes>
__global__ void __launch_bounds__(kThreads)
idwt1d_kernel(const T* __restrict__ a, const T* __restrict__ d,
              T* __restrict__ out, int len, int n_out, int tiles,
              TapsT<T> taps, int hlen, long long row0, Lanes lanes) {
  T* s_a = dynamic_smem<T>();     // [kWin] coefficient windows
  T* s_d = s_a + kWin;
  T* g_lo = s_d + kWin;           // [2][kHalfTaps] polyphase taps per parity
  T* g_hi = g_lo + 2 * kHalfTaps;

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
      if constexpr (Lanes::kHalo) {
        s_a[q] = lanes.at(0, a + ib, row, q0 + q, len);
        s_d[q] = lanes.at(1, d + ib, row, q0 + q, len);
      } else {
        const int k = wrap(q0 + q, len);
        s_a[q] = a[ib + k];
        s_d[q] = d[ib + k];
      }
    }
  }
  __syncthreads();

  // Output 2m + p reads window coefficients m + delta_p + j.
  const long long ob = row * n_out + 2LL * m0;
  const int outs = min(2 * cnt, n_out - 2 * m0);
  for (int i = tid; i < outs; i += kThreads) {
    const int p = i & 1;
    const int base = (i >> 1) + ph.delta(p);
    const T* gl = g_lo + p * kHalfTaps;
    const T* gh = g_hi + p * kHalfTaps;
    T s = 0;
    for (int j = 0; j < ph.h2; ++j) {
      s = fmadd(s_a[base + j], gl[j], s);
      s = fmadd(s_d[base + j], gh[j], s);
    }
    out[ob + i] = s;
  }
}

template <class T, class Lanes = Wrapped>
int launch(const T* a, const T* d, T* out, int rows, int len, int n_out,
           const T* rec_lo, const T* rec_hi, int hlen, int device,
           void* stream, Lanes lanes = Lanes{}) {
  const int tiles = ((n_out + 1) / 2 + TC - 1) / TC;
  if (hlen < 2 || hlen > kMaxTaps || len < 1 || len > 0x3fffffff ||
      n_out < 1 || n_out > 0x3fffffff || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Lanes::kHalo) {
    if (n_out != 2 * len || !synthesis_halos_ok(hlen, lanes.lp, lanes.rp))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(T) * (2 * kWin + 4 * kHalfTaps);
  const TapsT<T> taps = make_taps(rec_lo, rec_hi, hlen);
  const long long chunk = 0x7fffffffLL / tiles;  // rows per launch
  for (long long r0 = 0; r0 < rows; r0 += chunk) {
    const long long nrows = std::min<long long>(rows - r0, chunk);
    idwt1d_kernel<T, Lanes><<<static_cast<unsigned>(nrows * tiles),
                              kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        a, d, out, len, n_out, tiles, taps, hlen, r0, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pypwt

// Both return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. rec_lo/rec_hi are host arrays of hlen values of the
// data's type; the output has n_out samples per row.
extern "C" int pypwt_idwt1d(const float* a, const float* d, float* out,
                            int rows, int len, int n_out, const float* rec_lo,
                            const float* rec_hi, int hlen, int device,
                            void* stream) {
  return pypwt::launch(a, d, out, rows, len, n_out, rec_lo, rec_hi, hlen,
                       device, stream);
}

extern "C" int pypwt_idwt1d_f64(const double* a, const double* d,
                                double* out, int rows, int len, int n_out,
                                const double* rec_lo, const double* rec_hi,
                                int hlen, int device, void* stream) {
  return pypwt::launch(a, d, out, rows, len, n_out, rec_lo, rec_hi, hlen,
                       device, stream);
}

// K29b: out of (rows, 2 len) from the rows a, d of (rows, len), halos their
// four halo rows in JAX's order (a_left, a_right, d_left, d_right), lefts of
// (rows, lp) and rights of (rows, rp), lp and rp the synthesis pads of hlen.
extern "C" int pypwt_syn_lanes(const float* a, const float* d,
                               const float* const* halos, float* out,
                               int rows, int len, int lp, int rp,
                               const float* rec_lo, const float* rec_hi,
                               int hlen, int device, void* stream) {
  return pypwt::launch(a, d, out, rows, len, 2 * len, rec_lo, rec_hi, hlen,
                       device, stream,
                       pypwt::make_lane_halo<float, 2>(halos, lp, rp));
}

extern "C" int pypwt_syn_lanes_f64(const double* a, const double* d,
                                   const double* const* halos,
                                   double* out, int rows, int len, int lp,
                                   int rp, const double* rec_lo,
                                   const double* rec_hi, int hlen,
                                   int device, void* stream) {
  return pypwt::launch(a, d, out, rows, len, 2 * len, rec_lo, rec_hi, hlen,
                       device, stream,
                       pypwt::make_lane_halo<double, 2>(halos, lp, rp));
}
