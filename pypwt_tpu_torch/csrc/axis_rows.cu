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
// Design of K29c: K1's axis -2 stage taken alone. A block owns a tile of
// TR output rows by TC columns; it stages the tile's 2 TR + hlen - 2
// window rows into shared memory once, threads walking the columns, so
// each warp's loads and stores are 32 consecutive samples of one row; a row
// past both halos stages as zero. The reversed taps go to shared memory
// and every thread sums its outputs' taps down a column of the window:
// consecutive threads read consecutive words. Column blocks run on the
// grid's x axis, row tiles on y (in chunks past 65535: launch_chunks).
// Offsets are 64-bit. The float64 instance stages at most 26.8 KB, under
// the 48 KB a block has without opting in.
//
// Design of K29d: persistent blocks on row_walk.cuh's walk, shared with
// K29h. A tile is 32 coefficient rows (64 output rows) by 64 columns, at
// every level: tiles of 8 rows at level 2 of a 4096^2 grid block (512^2
// coefficients: 512 blocks of 2 warps where 32-row tiles give 128 of 8)
// measured no faster, and slower for wide banks (PERF.md). The grid is what
// the SMs hold at once (the occupancy API); while a block's warps compute
// one tile, the windows of a and d of its next tile (32 + span - 1 rows
// each, span = h2 + sigma the window rows a coefficient row meets) are in
// flight in the other of two slots, staged by cp.async from a table of
// their source rows (the shard's rows and halo rows resolved once per
// window row, null past both halos), 16-byte copies where nc is a whole
// number of 16-byte runs and the row is aligned, zero past nc. A thread
// computes both parities of 4 coefficient rows down two adjacent columns:
// it reads each of its 4 + span - 1 window rows of a and d once, as a
// pair, and adds it to every output that meets it, with the taps indexed
// by window sample (pair::Taps, a kernel parameter: each FMA takes its tap
// as an operand; h2 a template parameter, 20 instances a type). Every
// output keeps the first version's order of summation: from zero, j
// ascending, a then d for each j, each by one fused multiply-add. A warp
// stores 32 pairs of one output row (8-byte pair stores in float32,
// 16-byte in float64, where nc is even and out aligned; else one sample
// at a time). Offsets are 64-bit.

#include <array>
#include <utility>

#include "common.cuh"
#include "level2d.cuh"
#include "row_walk.cuh"

namespace pypwt {
namespace {

constexpr int TR = 32;  // K29c: output rows per tile
constexpr int TC = 32;  // K29c: columns per tile

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

// K29d's tile: kSynRows coefficient rows (kSynR a warp) by kSynCols
// columns (a warp's 32 column pairs).
constexpr int kSynR = 4;
constexpr int kSynRows = kSynR * kThreads / 32;
constexpr int kSynCols = 64;

// The window rows of a tile at h2 taps a parity: the tile's rows and the
// span - 1 = h2 + sigma - 1 below them that its last row meets.
__host__ __device__ constexpr int syn_window_rows(int h2) {
  return kSynRows + h2 + ((h2 & 1) ? 0 : 1) - 1;
}

// K29d on h2 = kH2 (hlen 2 kH2 or 2 kH2 + 1): window row r of the tile at
// coefficient rows q0 .. holds coefficient row q0 - c + r of a and d (the
// polyphase centre c; a halo row past the shard, zero past both halos).
// Coefficient row q0 + m meets window rows m + k, k < span, output parity 0
// with tap g[0][k] where k < h2, parity 1 with g[1][k] where k >= sigma.
template <class T, int kH2>
__global__ void __launch_bounds__(kThreads)
syn_rows_kernel(const T* __restrict__ a, const T* __restrict__ d,
                T* __restrict__ out, int len, int nc, pair::Taps<T> g,
                row_walk::Plan plan, Halo<T, 2> rows) {
  constexpr int kSigma = (kH2 & 1) ? 0 : 1;
  constexpr int kSpan = kH2 + kSigma;
  constexpr int kC = kH2 >> 1;
  constexpr int kWin = syn_window_rows(kH2);
  constexpr int kPlane = kWin * kSynCols;
  T* in = dynamic_smem<T>();  // [2 slots][a, d][kWin][kSynCols]
  const row_walk::Slots<T> sm{
      in, reinterpret_cast<const T**>(in + 4 * kPlane), kWin, kSynCols,
      kPlane, 2 * kPlane, 2 * kWin};
  const T* const planes[2] = {a, d};
  const bool pairs = (nc & 1) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(T) - 1)) == 0;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * kSynR;
  row_walk::walk_tiles<T, kSynCols, 2>(
      sm, plan, kSynRows, nc,
      [&](int q0, const T** src) {
        const int r = threadIdx.x;
        if (r < kWin) {
#pragma unroll
          for (int p = 0; p < 2; ++p)
            src[p * kWin + r] = rows.row(p, planes[p], q0 - kC + r, len, nc);
        }
      },
      [] { return 0; },
      [&](int q0, int c0, const T* w, int) {
        const T* wa = w + m0 * kSynCols + 2 * lane;
        const T* wd = wa + kPlane;
        T acc[kSynR][2][2] = {};  // [row][parity][column]
#pragma unroll
        for (int r = 0; r < kSynR + kSpan - 1; ++r) {
          T a0, a1, d0, d1;
          pair::load_pair(wa + r * kSynCols, a0, a1);
          pair::load_pair(wd + r * kSynCols, d0, d1);
#pragma unroll
          for (int m = 0; m < kSynR; ++m) {
            const int k = r - m;  // the window sample row m meets here
            if (k < 0 || k >= kSpan) continue;
            if (k < kH2) {
              acc[m][0][0] = fmadd(a0, g.lo[0][k], acc[m][0][0]);
              acc[m][0][0] = fmadd(d0, g.hi[0][k], acc[m][0][0]);
              acc[m][0][1] = fmadd(a1, g.lo[0][k], acc[m][0][1]);
              acc[m][0][1] = fmadd(d1, g.hi[0][k], acc[m][0][1]);
            }
            if (k >= kSigma) {
              acc[m][1][0] = fmadd(a0, g.lo[1][k], acc[m][1][0]);
              acc[m][1][0] = fmadd(d0, g.hi[1][k], acc[m][1][0]);
              acc[m][1][1] = fmadd(a1, g.lo[1][k], acc[m][1][1]);
              acc[m][1][1] = fmadd(d1, g.hi[1][k], acc[m][1][1]);
            }
          }
        }
        const int ocol = c0 + 2 * lane;
#pragma unroll
        for (int m = 0; m < kSynR; ++m) {
          const int q = q0 + m0 + m;
          if (q >= len || ocol >= nc) continue;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            T* o = out + (2 * static_cast<long long>(q) + p) * nc + ocol;
            if (pairs) {
              store_pair(o, acc[m][p][0], acc[m][p][1]);
            } else {
              o[0] = acc[m][p][0];
              if (ocol + 1 < nc) o[1] = acc[m][p][1];
            }
          }
        }
      });
}

template <class T>
using SynRowsKernel = void (*)(const T*, const T*, T*, int, int,
                               pair::Taps<T>, row_walk::Plan, Halo<T, 2>);

// The instance of h2 = kH2: its dynamic shared memory holds two slots of
// the windows of a and d and of their source rows.
template <class T, int kH2>
TileInstance<SynRowsKernel<T>> syn_rows_instance() {
  constexpr int kWin = syn_window_rows(kH2);
  return {syn_rows_kernel<T, kH2>,
          sizeof(T) * 4 * kWin * kSynCols + sizeof(const T*) * 4 * kWin,
          kSynRows, kSynCols};
}

template <class T, int... kI>
std::array<TileInstance<SynRowsKernel<T>>, sizeof...(kI)> syn_rows_instances(
    std::integer_sequence<int, kI...>) {
  return {syn_rows_instance<T, kI + 1>()...};
}

// K29d's instance for hlen taps (h2 = hlen / 2 of 1 .. kHalfTaps).
template <class T>
TileInstance<SynRowsKernel<T>> pick_syn_rows(int hlen) {
  static const auto kInstances =
      syn_rows_instances<T>(std::make_integer_sequence<int, kHalfTaps>{});
  return kInstances[(hlen >> 1) - 1];
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
  const auto inst = pick_syn_rows<T>(hlen);
  row_walk::Plan plan;
  unsigned grid = 0;
  const cudaError_t err =
      row_walk::plan_tiles(inst, len, nc, device, &plan, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pair::Taps<T> taps = pair::make_taps(rec_lo, rec_hi, hlen);
  Halo<T, 2> halo;
  halo.top[0] = halos[0];
  halo.bot[0] = halos[1];
  halo.top[1] = halos[2];
  halo.bot[1] = halos[3];
  halo.lp = lp;
  halo.rp = rp;
  inst.kernel<<<grid, kThreads, inst.smem,
                static_cast<cudaStream_t>(stream)>>>(a, d, out, len, nc, taps,
                                                     plan, halo);
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

// The occupancy API's resident blocks per SM, the dynamic shared memory in
// bytes and the tile shape (coefficient rows and columns) of K29d's
// instance for hlen taps, float64 where f64 is 1: figures for reports.
extern "C" int pypwt_syn_rows_occupancy(int hlen, int f64, int device,
                                        int* blocks, int* smem,
                                        int* tile_rows, int* tile_cols) {
  using namespace pypwt;
  if (hlen < 2 || hlen > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return f64 ? report_occupancy(pick_syn_rows<double>(hlen), blocks, smem,
                                tile_rows, tile_cols)
             : report_occupancy(pick_syn_rows<float>(hlen), blocks, smem,
                                tile_rows, tile_cols);
}
