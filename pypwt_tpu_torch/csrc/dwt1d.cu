// K3: one periodized batched-1D analysis level, float32 or float64; and
// K29a, the same level of one segment of longer rows.
//
// Replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::dwt1d_fused
// (_build_dwt1d, :2064), and computes the map of the folded long-signal
// kernel ::dwt1d_long_fused (_build_dwt1d_long, :2438) on a (1, n) view.
// K29a (pypwt_ana_lanes) replaces ::build_ana_padded_lanes (:1719), the
// lane-axis analysis of the grid and sequence layouts of
// pypwt_tpu/parallel/spatial.py (_analysis_axis_sharded): the same kernel
// with the LaneHalo sample source (common.cuh), the samples before and after
// the shard read from its neighbours' exchanged halos where they lie (no
// padded copy, and no fold of a long signal into per-row windows: a signal
// shard is a (1, n) row, or (B, n) rows).
//
// Map (pypwt_tpu/core/conv.py:78-118, analysis_last), for x of (R, n) and
// any hlen <= 40 (an odd one padded by make_analysis_taps), each row on its
// own:
//   lo[r, i] = sum_j dec_lo[hlen-1-j] * x[r, (2i + j - lpad) mod M],
//   hi the same with dec_hi, lpad = hlen - 1 - hlen/2 (common.cuh), where an
// odd row is extended by its last sample (M = n + 1, wrap_ext) and an even
// one has M = n; ceil(n/2) outputs per row. K29a: n even, and sample k of
// the extended axis [-lpad, n + rpad) in place of x[(k) mod M]
// (conv.analysis_core on the halo-extended rows), n/2 outputs per row.
//
// Bound: per input sample a level reads 4 bytes and writes 4 (half a lo
// and half a hi output) and does hlen FMAs: hlen/4 flop per byte, under the
// H100's float32 ridge of ~20 flop per byte (67 TFLOP/s over 3.35 TB/s)
// for every hlen <= 40, so memory-bound (K29a: the halos add hlen - 2
// samples per row).
//
// Design: the grid is one flat axis of (row, tile) pairs, so a single
// signal of 4 Mi samples and a 2048 x 2048 stack both give thousands of
// blocks (grid y and z, limited to 65535, are not used; rows past the grid's
// 2^31 - 1 blocks go in further launches). Each block owns TC
// outputs of one row; it stages its input window (2 TC + hlen - 2 samples,
// with a true periodic wrap or the halo source, and an in-range fast path)
// into shared memory once, split into even and odd samples so that the
// decimating taps read consecutive words (no bank conflicts), as K1 does
// along its last axis. Row offsets are 64-bit. A float64 instance
// (pypwt_dwt1d_f64, pypwt_ana_lanes_f64) doubles the bytes: its window of
// 2 (TC + 20) samples takes 16.6 KB of shared memory, under the 48 KB a
// block has without opting in.

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TC = 1024;  // outputs per block
constexpr int kWinHalf = TC + kHalfTaps;  // window samples of one parity

// Lanes: Wrapped (K3), or the LaneHalo<T, 1> of the rows x (K29a).
template <class T, class Lanes>
__global__ void __launch_bounds__(kThreads)
dwt1d_kernel(const T* __restrict__ x, T* __restrict__ a, T* __restrict__ d,
             int n, int tiles, TapsT<T> taps, int hlen, long long row0,
             Lanes lanes) {
  T* s_ev = dynamic_smem<T>();    // [kWinHalf] even window samples
  T* s_od = s_ev + kWinHalf;      // [kWinHalf] odd window samples
  T* f_lo = s_od + kWinHalf;      // reversed taps: f[j] = dec[hlen-1-j]
  T* f_hi = f_lo + kMaxTaps;

  const int tid = threadIdx.x;
  const int bt = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - bt * tiles) * TC;
  const long long row = row0 + bt;
  const int len = (n + 1) >> 1;
  const int cnt = min(TC, len - c0);    // outputs of this block
  const int wc = 2 * (cnt + hlen / 2 - 1);  // window samples
  const int col0 = 2 * c0 - analysis_lpad(hlen);
  const T* xr = x + row * n;

  load_reversed_taps(taps, hlen, f_lo, f_hi);
  if (col0 >= 0 && col0 + wc <= n) {
    for (int i = tid; i < wc; i += kThreads)
      (i & 1 ? s_od : s_ev)[i >> 1] = xr[col0 + i];
  } else {
    for (int i = tid; i < wc; i += kThreads) {
      T v;
      if constexpr (Lanes::kHalo) {
        v = lanes.at(0, xr, row, col0 + i, n);
      } else {
        v = xr[wrap_ext(col0 + i, n)];
      }
      (i & 1 ? s_od : s_ev)[i >> 1] = v;
    }
  }
  __syncthreads();

  // Window sample 2i + j feeds output i.
  const long long ob = row * len + c0;
  for (int i = tid; i < cnt; i += kThreads) {
    const T* ev = s_ev + i;
    const T* od = s_od + i;
    T lo = 0, hi = 0;
    for (int j = 0; j < hlen; j += 2) {
      const T e = ev[j >> 1], o = od[j >> 1];
      lo = fmadd(e, f_lo[j], lo);
      hi = fmadd(e, f_hi[j], hi);
      lo = fmadd(o, f_lo[j + 1], lo);
      hi = fmadd(o, f_hi[j + 1], hi);
    }
    a[ob + i] = lo;
    d[ob + i] = hi;
  }
}

template <class T, class Lanes = Wrapped>
int launch(const T* x, T* a, T* d, int rows, int n, const T* dec_lo,
           const T* dec_hi, int hlen, int device, void* stream,
           Lanes lanes = Lanes{}) {
  const int tiles = ((n + 1) / 2 + TC - 1) / TC;
  if (hlen < 1 || hlen > kMaxTaps || n < 1 || n > 0x3fffffff || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Lanes::kHalo) {
    if (n % 2 || !analysis_halos_ok(hlen, lanes.lp, lanes.rp))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  TapsT<T> taps;
  hlen = make_analysis_taps(dec_lo, dec_hi, hlen, &taps);
  const size_t smem = sizeof(T) * (2 * kWinHalf + 2 * kMaxTaps);
  const long long chunk = 0x7fffffffLL / tiles;  // rows per launch
  for (long long r0 = 0; r0 < rows; r0 += chunk) {
    const long long nrows = std::min<long long>(rows - r0, chunk);
    dwt1d_kernel<T, Lanes><<<static_cast<unsigned>(nrows * tiles), kThreads,
                             smem, static_cast<cudaStream_t>(stream)>>>(
        x, a, d, n, tiles, taps, hlen, r0, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pypwt

// Both return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. dec_lo/dec_hi are host arrays of hlen values of the
// data's type.
extern "C" int pypwt_dwt1d(const float* x, float* a, float* d, int rows,
                           int n, const float* dec_lo, const float* dec_hi,
                           int hlen, int device, void* stream) {
  return pypwt::launch(x, a, d, rows, n, dec_lo, dec_hi, hlen, device,
                       stream);
}

extern "C" int pypwt_dwt1d_f64(const double* x, double* a, double* d,
                               int rows, int n, const double* dec_lo,
                               const double* dec_hi, int hlen, int device,
                               void* stream) {
  return pypwt::launch(x, a, d, rows, n, dec_lo, dec_hi, hlen, device,
                       stream);
}

// K29a: the level of rows x of (rows, n), n even, their samples before and
// after from left (rows, lp) and right (rows, rp), lp and rp the analysis
// pads of hlen; a, d of (rows, n/2).
extern "C" int pypwt_ana_lanes(const float* x, const float* left,
                               const float* right, float* a, float* d,
                               int rows, int n, int lp, int rp,
                               const float* dec_lo, const float* dec_hi,
                               int hlen, int device, void* stream) {
  const float* halos[2] = {left, right};
  return pypwt::launch(x, a, d, rows, n, dec_lo, dec_hi, hlen, device, stream,
                       pypwt::make_lane_halo<float, 1>(halos, lp, rp));
}

extern "C" int pypwt_ana_lanes_f64(const double* x, const double* left,
                                   const double* right, double* a,
                                   double* d, int rows, int n, int lp,
                                   int rp, const double* dec_lo,
                                   const double* dec_hi, int hlen,
                                   int device, void* stream) {
  const double* halos[2] = {left, right};
  return pypwt::launch(x, a, d, rows, n, dec_lo, dec_hi, hlen, device, stream,
                       pypwt::make_lane_halo<double, 1>(halos, lp, rp));
}
