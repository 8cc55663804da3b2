// K29c / K29d: one decimating analysis (K29c) and one polyphase synthesis
// (K29d) along axis -2 of one shard of a grid, float32 or float64.
//
// K29c replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::
// build_ana_padded_rows (:1785), K29d ::build_syn_padded_rows (:1821): the
// row passes of the grid layout of pypwt_tpu/parallel/spatial.py
// (_analysis_axis_sharded / _synthesis_axis_sharded along axis -2, after the
// column pass), which JAX runs on a halo-padded copy of the shard with no
// transpose. Here the rows above and below the shard come through the Halo
// row source (common.cuh) from its neighbours' exchanged rows, where they
// lie: no padded copy, and no transpose either.
//
// Maps (conv.analysis_core / conv.synthesis_core along axis -2 on the
// halo-extended rows; the port's plain versions in ops/fused_dwt.py):
//   K29c: x (nr, nc), nr even, rows [-lp, nr + rp) of the extended axis,
//         lp, rp = conv.analysis_pads(hlen):
//         lo[i, c] = sum_j dec_lo[hlen-1-j] x[2i + j - lp, c], hi the same
//         with dec_hi; two (nr/2, nc) outputs. An odd hlen runs with a zero
//         tap in front (make_analysis_taps), which meets a zero row.
//   K29d: a, d (L, nc), rows [-lp, L + rp), lp, rp = conv.synthesis_pads(
//         hlen, L, 2L): out[2m + p, c] = sum_{j < h2} g_p_lo[j] a[m + delta_p
//         + j - c_ph, c] + g_p_hi[j] d[...] (common.cuh's Polyphase); out
//         (2L, nc).
//
// Bound: K29c reads 4 bytes per input sample (and the halo rows) and writes
// 4 (half a lo and half a hi), with hlen FMAs; K29d reads 4 per output
// sample and writes 4: hlen/4 flop per byte, under the H100's float32 ridge
// of ~20 flop per byte, so memory-bound (two 2048 x 2048 outputs of a
// 4096 x 2048 shard level: 64 MiB, ~20 us at 3.35 TB/s).
//
// Design: K1's / K2's axis -2 stage taken alone. A block owns a tile of TR
// output rows (K29d: coefficient rows, 2 TR output rows) by TC columns; it
// stages the tile's window rows (2 TR + hlen - 2; K29d TR + hlen/2 of each
// plane) into shared memory once, threads walking the columns, so each
// warp's loads and stores are 32 consecutive samples of one row; a row past
// both halos stages as zero. The taps go to shared memory (reversed, or by
// polyphase parity) and every thread sums its outputs' taps down a column
// of the window: consecutive threads read consecutive words. Column blocks
// run on the grid's x axis, row tiles on y (in chunks past 65535:
// launch_chunks). Offsets are 64-bit. The float64 instances stage at most
// 27.3 KB, under the 48 KB a block has without opting in.

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TR = 32;  // output rows (K29d: coefficient rows) per tile
constexpr int TC = 32;  // columns per tile

template <class T>
__global__ void __launch_bounds__(kThreads)
ana_rows_kernel(const T* __restrict__ x, T* __restrict__ lo,
                T* __restrict__ hi, int nr, int nc, TapsT<T> taps, int hlen,
                int y0, Halo<T, 1> rows) {
  const int wr = 2 * TR + hlen - 2;  // window rows
  T* s_w = dynamic_smem<T>();        // [wr][TC] window
  T* f_lo = s_w + wr * TC;           // reversed taps: f[j] = dec[hlen-1-j]
  T* f_hi = f_lo + kMaxTaps;

  const int tid = threadIdx.x;
  const int len = nr >> 1;
  const int r0 = (y0 + blockIdx.y) * TR, c0 = blockIdx.x * TC;
  const int row0 = 2 * r0 - analysis_lpad(hlen);

  load_reversed_taps(taps, hlen, f_lo, f_hi);
  for (int i = tid; i < wr * TC; i += kThreads) {
    const int r = i / TC, c = i - r * TC;
    const T* src = rows.row(0, x, row0 + r, nr, nc);
    s_w[i] = src && c0 + c < nc ? src[c0 + c] : T(0);
  }
  __syncthreads();

  // Window row 2r + j feeds output row r.
  for (int i = tid; i < TR * TC; i += kThreads) {
    const int r = i / TC, c = i - r * TC;
    const int orow = r0 + r, ocol = c0 + c;
    if (orow >= len || ocol >= nc) continue;
    const T* w = s_w + 2 * r * TC + c;
    T sl = 0, sh = 0;
    for (int j = 0; j < hlen; ++j) {
      const T v = w[j * TC];
      sl = fmadd(v, f_lo[j], sl);
      sh = fmadd(v, f_hi[j], sh);
    }
    const long long o = static_cast<long long>(orow) * nc + ocol;
    lo[o] = sl;
    hi[o] = sh;
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
syn_rows_kernel(const T* __restrict__ a, const T* __restrict__ d,
                T* __restrict__ out, int len, int nc, TapsT<T> taps, int hlen,
                int y0, Halo<T, 2> rows) {
  const Polyphase ph(hlen);
  const int wr = TR + ph.h2;     // window coefficient rows
  T* s_a = dynamic_smem<T>();    // [wr][TC] windows of a and d
  T* s_d = s_a + wr * TC;
  T* g_lo = s_d + wr * TC;       // [2][kHalfTaps] taps per output parity
  T* g_hi = g_lo + 2 * kHalfTaps;

  const int tid = threadIdx.x;
  const int m0 = (y0 + blockIdx.y) * TR, c0 = blockIdx.x * TC;

  load_polyphase_taps(taps, hlen, g_lo, g_hi);
  // window origin: coefficient row m0 - c
  for (int i = tid; i < wr * TC; i += kThreads) {
    const int r = i / TC, c = i - r * TC;
    const bool in = c0 + c < nc;
    const T* sa = rows.row(0, a, m0 - ph.c + r, len, nc);
    const T* sd = rows.row(1, d, m0 - ph.c + r, len, nc);
    s_a[i] = sa && in ? sa[c0 + c] : T(0);
    s_d[i] = sd && in ? sd[c0 + c] : T(0);
  }
  __syncthreads();

  // Output row 2(m0 + m) + p reads window rows m + delta_p + j.
  for (int i = tid; i < 2 * TR * TC; i += kThreads) {
    const int q = i / TC, c = i - q * TC;
    const int orow = 2 * m0 + q, ocol = c0 + c;
    if (orow >= 2 * len || ocol >= nc) continue;
    const int p = q & 1;
    const int base = ((q >> 1) + ph.delta(p)) * TC + c;
    const T* gl = g_lo + p * kHalfTaps;
    const T* gh = g_hi + p * kHalfTaps;
    T s = 0;
    for (int j = 0; j < ph.h2; ++j) {
      s = fmadd(s_a[base + j * TC], gl[j], s);
      s = fmadd(s_d[base + j * TC], gh[j], s);
    }
    out[static_cast<long long>(orow) * nc + ocol] = s;
  }
}

bool sizes_ok(int nr, int nc) {
  return nr >= 1 && nc >= 1 && nr <= 0x3fffffff && nc <= 0x3fffffff;
}

template <class T>
int launch_ana(const T* x, const T* top, const T* bot, T* lo, T* hi, int nr,
               int nc, int lp, int rp, const T* dec_lo, const T* dec_hi,
               int hlen, int device, void* stream) {
  if (hlen < 1 || hlen > kMaxTaps || !sizes_ok(nr, nc) || nr % 2 ||
      !analysis_halos_ok(hlen, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  TapsT<T> taps;
  hlen = make_analysis_taps(dec_lo, dec_hi, hlen, &taps);
  const size_t smem =
      sizeof(T) * ((2 * TR + hlen - 2) * TC + 2 * kMaxTaps);
  const Halo<T, 1> halo = make_halo(top, bot, lp, rp);
  launch_chunks((nc + TC - 1) / TC, (nr / 2 + TR - 1) / TR, 1,
                [&](dim3 grid, int y0, int) {
                  ana_rows_kernel<T><<<grid, kThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
                      x, lo, hi, nr, nc, taps, hlen, y0, halo);
                });
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_syn(const T* a, const T* d, const T* const* halos, T* out,
               int len, int nc, int lp, int rp, const T* rec_lo,
               const T* rec_hi, int hlen, int device, void* stream) {
  if (hlen < 2 || hlen > kMaxTaps || !sizes_ok(len, nc) ||
      len > 0x1fffffff || !synthesis_halos_ok(hlen, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TapsT<T> taps = make_taps(rec_lo, rec_hi, hlen);
  const size_t smem =
      sizeof(T) * (2 * (TR + hlen / 2) * TC + 4 * kHalfTaps);
  Halo<T, 2> halo;
  halo.top[0] = halos[0];
  halo.bot[0] = halos[1];
  halo.top[1] = halos[2];
  halo.bot[1] = halos[3];
  halo.lp = lp;
  halo.rp = rp;
  launch_chunks((nc + TC - 1) / TC, (len + TR - 1) / TR, 1,
                [&](dim3 grid, int y0, int) {
                  syn_rows_kernel<T><<<grid, kThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
                      a, d, out, len, nc, taps, hlen, y0, halo);
                });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pypwt

// All return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. The filters are host arrays of hlen values of the
// data's type.
// K29c: lo, hi of (nr/2, nc) from the shard x of (nr, nc), its rows above
// from top (lp, nc) and below from bot (rp, nc), lp and rp the analysis
// pads of hlen.
extern "C" int pypwt_ana_rows(const float* x, const float* top,
                              const float* bot, float* lo, float* hi, int nr,
                              int nc, int lp, int rp, const float* dec_lo,
                              const float* dec_hi, int hlen, int device,
                              void* stream) {
  return pypwt::launch_ana(x, top, bot, lo, hi, nr, nc, lp, rp, dec_lo,
                           dec_hi, hlen, device, stream);
}

extern "C" int pypwt_ana_rows_f64(const double* x, const double* top,
                                  const double* bot, double* lo, double* hi,
                                  int nr, int nc, int lp, int rp,
                                  const double* dec_lo, const double* dec_hi,
                                  int hlen, int device, void* stream) {
  return pypwt::launch_ana(x, top, bot, lo, hi, nr, nc, lp, rp, dec_lo,
                           dec_hi, hlen, device, stream);
}

// K29d: out of (2 len, nc) from a, d of (len, nc), halos their four halo
// tensors in JAX's order (a_top, a_bot, d_top, d_bot), tops of (lp, nc) and
// bottoms of (rp, nc), lp and rp the synthesis pads of hlen.
extern "C" int pypwt_syn_rows(const float* a, const float* d,
                              const float* const* halos, float* out, int len,
                              int nc, int lp, int rp, const float* rec_lo,
                              const float* rec_hi, int hlen, int device,
                              void* stream) {
  return pypwt::launch_syn(a, d, halos, out, len, nc, lp, rp, rec_lo, rec_hi,
                           hlen, device, stream);
}

extern "C" int pypwt_syn_rows_f64(const double* a, const double* d,
                                  const double* const* halos, double* out,
                                  int len, int nc, int lp, int rp,
                                  const double* rec_lo, const double* rec_hi,
                                  int hlen, int device, void* stream) {
  return pypwt::launch_syn(a, d, halos, out, len, nc, lp, rp, rec_lo, rec_hi,
                           hlen, device, stream);
}
