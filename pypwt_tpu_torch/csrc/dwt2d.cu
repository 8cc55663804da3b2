// K1: one periodized separable 2D analysis level, float32 or float64; K19,
// the same level of a circularly shifted float32 plane with an optional
// threshold of its detail subbands; and K26a, the level of one row shard of
// a larger plane, float32 or float64.
//
// K1 replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::dwt2d_fused
// (_build_dwt2d, :287; and its column-split grid _build_dwt2d_colsplit,
// :418, which computes the same map for wide planes). K19 replaces
// ::dwt2d_fused_shifted (_build_dwt2d_shifted, :609), and, with the shift a
// runtime argument, the analysis halves of the phase-select, dynamic-shift
// and multi-shift kernels (_build_dwt2d_phasesel :841, _build_dwt2d_dynshift
// :1074, _build_dwt2d_multishift :1297: one K19 launch per spin). K26a
// replaces ::build_dwt2d_sharded (:1483), the shard_map-local level of
// pypwt_tpu/parallel/spatial.py's row-sharded path.
//
// Map (pypwt_tpu/core/dwt.py:195-201 on conv.analysis_last), for
// x of (B?, Nr, Nc) and any hlen <= 40 (an odd one padded by
// make_analysis_taps):
//   lo[i] = sum_j dec[hlen-1-j] * x[(2i + j - lpad) mod M],
//   (lpad, rpad) = analysis_pads(hlen) = (hlen-1-hlen/2, hlen/2-1)
// first along the last axis (lo -> a, h; hi -> v, d), then along axis -2:
//   a = lo(lo), h = hi(lo), v = lo(hi), d = hi(hi).
// An odd axis of n samples is extended by its last sample (M = n + 1,
// wrap_ext); an even one has M = n. K19 reads x rolled by (sr, sc),
// x_s[i, j] = x[(i - sr) mod Nr, (j - sc) mod Nc], before the extension
// (pipeline.py:114-131), and soft- or hard-thresholds h, v and d by a
// runtime beta before the store (pallas_dwt.py:552-557).
//
// Bound: one level moves 4*Nr*Nc bytes in and 4*Nr*Nc out (8 bytes per
// input pixel) and does hlen FMAs per input pixel in each pass, 2*hlen in
// all: hlen/2 flop per byte, under the H100's float32 ridge of ~20 flop per
// byte (67 TFLOP/s over 3.35 TB/s) for every hlen < 40, so memory-bound.
// The shift and the threshold add no traffic.
//
// Design. K1, K26a and K19 run ana_pair::tile (level2d.cuh). Each block
// owns a tile of the four outputs, a shape picked on the host by type, hlen
// and level size (pick_ana): up to hlen 10, 16 x 64 outputs in float32 and
// 16 x 32 in float64; from hlen 12, 32 x 32 and 32 x 16, whose taller windows
// hold fewer halo rows per output row; a level that would give an SM less
// than one such block takes 8 x 64 or 16 x 32 (float64: 8 x 32). A table of
// the window's source rows is built once per block (the plane's rows
// wrapped, wrap_ext on an odd axis, or the shard's own rows and its halos'
// rows, null past both halos: no per-sample halo test, row wrap or
// division), then the (2 tile rows + hlen - 2)-row input window is staged
// by cp.async, every copy of a thread in flight before one wait: 16-byte
// copies from the 16-byte boundary below the window's first column where
// nc allows, else sample copies with the column wrap resolved once per
// copy; zero for a row past the halos. Every block of a launch starts its
// window the same number of samples before its first output's first
// sample, (-lpad) mod 16 bytes, so that shift is a template parameter
// (dispatched on the host) and the tap loops index the window by constants.
// The window stays contiguous: in the last-axis pass each thread reads a
// 16-byte aligned run of its window row as 16-byte words (consecutive
// threads on consecutive words, no bank conflict) and computes lo and hi of
// the 2 (float) or 1 (double) output columns it holds; in the axis -2 pass
// each thread reads two adjacent columns of lo and hi as pairs and
// computes a, h, v, d of those columns for 1 or 2 output rows, stored as
// one 8-byte (float) or 16-byte (double) pair per plane where lc is even
// and the planes aligned, else one store per column within the crop. The
// taps are kernel parameters (ana_pair::Taps), so the unrolled tap loops
// take them as operands, and each loop runs over an output's own taps
// only. Each output keeps ana::tile's order of summation (j ascending per
// accumulator), so the outputs are bit for bit those of the body before.
// The intermediate never leaves the SM; each input sample is read from
// device memory once per tile that meets it (the tiles' overlap, and for
// K26a the halo rows, 2 (hlen/2 - 1) per shard).
//
// K19 is K1's kernel with a Roll for its rows (level2d.cuh), float32 only,
// in K1's tile shapes: the row table holds the rolled plane's rows, each
// resolved once as the extension, then the roll (wrap_ext, then minus sr);
// the window starts kShift = (-lpad - sc) mod 4 samples before its first
// output's first sample in the rolled plane, which puts its first source
// column on a 16-byte boundary where nc is a multiple of 4, so a launch's
// blocks share that read shift and the four instances of each tile shape
// cover every sc; rows of another length take sample copies, each column
// rolled after the odd extension's clamp, once per copy, so an odd axis,
// shifted or not, runs the same body. The soft or hard threshold of h, v
// and d runs on the values of each pair store, by a runtime mode (16
// instances, one per tile shape and read shift; a template mode would make
// 48).
// Each output keeps ana::tile's order of summation, so K19's outputs are
// ana::tile's bit for bit.
//
// All: the batch is the grid's z axis, row tiles its y axis, in chunks
// where a level holds more than a grid's 65535 (launch_chunks). Offsets
// into the planes are 64-bit.

#include "level2d.cuh"

namespace pypwt {
namespace {

// K1, K26a and K19: one level on the pair body (level2d.cuh) in tiles of
// kTR x kTC outputs, kShift = ana_pair::shift_of<T>(hlen) (K19's: of hlen
// and sc); Rows: Wrapped (K1), the Halo<T, 1> of a shard (K26a), moved to
// the block's plane here, or a Roll (K19).
template <class T, int kTR, int kTC, int kShift, class Rows>
__global__ void __launch_bounds__(kThreads)
dwt2d_pair_kernel(const T* __restrict__ x, T* __restrict__ a,
                  T* __restrict__ h, T* __restrict__ v, T* __restrict__ d,
                  int nr, int nc, ana_pair::Taps<T> taps, int hlen, int y0,
                  Rows rows) {
  const long long pi = static_cast<long long>(blockIdx.z) * nr * nc;
  const long long po =
      static_cast<long long>(blockIdx.z) * ((nr + 1) >> 1) * ((nc + 1) >> 1);
  const int r0 = kTR * (y0 + blockIdx.y), c0 = kTC * blockIdx.x;
  T* smem = dynamic_smem<T>();
  if constexpr (Rows::kHalo) {
    ana_pair::tile<T, kTR, kTC, kShift>(x + pi, a + po, h + po, v + po,
                                        d + po, nr, nc, hlen, taps, r0, c0,
                                        smem, rows.plane(blockIdx.z, nc));
  } else {
    ana_pair::tile<T, kTR, kTC, kShift>(x + pi, a + po, h + po, v + po,
                                        d + po, nr, nc, hlen, taps, r0, c0,
                                        smem, rows);
  }
}

template <class T, class Rows>
using PairKernel = void (*)(const T*, T*, T*, T*, T*, int, int,
                            ana_pair::Taps<T>, int, int, Rows);

template <class T, class Rows>
using PairInstance = TileInstance<PairKernel<T, Rows>>;

template <class T, class Rows, int kTR, int kTC, int kShift = 0>
PairInstance<T, Rows> ana_instance(int hlen, int shift) {
  if constexpr (kShift + 1 < 16 / static_cast<int>(sizeof(T))) {
    if (shift != kShift)
      return ana_instance<T, Rows, kTR, kTC, kShift + 1>(hlen, shift);
  }
  return {dwt2d_pair_kernel<T, kTR, kTC, kShift, Rows>,
          ana_pair::Geometry<T>(kTR, kTC, hlen, kShift).smem_bytes(), kTR,
          kTC};
}

// The tile shape of a level of (batch, nr, nc) inputs at the padded hlen,
// in outputs (PERF.md: the shapes measured). Narrow banks take wide tiles
// (64 float32 or 32 float64 columns: fewer column halos); banks of
// kWideHlen taps or more take 32-row tiles, whose 2 tr + hlen - 2 window
// rows hold fewer halo rows per output row, and fewer columns, which keep
// two or more blocks per SM. A level that would give an SM less than one
// such block takes the shape with half the rows (float64: 8 x 32). shift:
// the window's read shift, ana_pair::shift_of<T>(hlen), or K19's.
constexpr int kWideHlen = 12;

template <class T, class Rows>
PairInstance<T, Rows> pick_ana(int hlen, int shift, int batch, int nr,
                               int nc, int sms) {
  const int lr = (nr + 1) / 2, lc = (nc + 1) / 2;
  const auto fills = [&](int tr, int tc) {
    return static_cast<long long>(batch) * ((lr + tr - 1) / tr) *
               ((lc + tc - 1) / tc) >= sms;
  };
  if constexpr (std::is_same_v<T, float>) {
    if (hlen >= kWideHlen)
      return fills(32, 32) ? ana_instance<T, Rows, 32, 32>(hlen, shift)
                           : ana_instance<T, Rows, 16, 32>(hlen, shift);
    return fills(16, 64) ? ana_instance<T, Rows, 16, 64>(hlen, shift)
                         : ana_instance<T, Rows, 8, 64>(hlen, shift);
  } else {
    if (hlen >= kWideHlen)
      return fills(32, 16) ? ana_instance<T, Rows, 32, 16>(hlen, shift)
                           : ana_instance<T, Rows, 8, 32>(hlen, shift);
    return fills(16, 32) ? ana_instance<T, Rows, 16, 32>(hlen, shift)
                         : ana_instance<T, Rows, 8, 32>(hlen, shift);
  }
}

// The window's read shift of a level of the padded hlen on rows `rows`.
template <class T, class Rows>
int read_shift(int hlen, const Rows& rows) {
  if constexpr (std::is_same_v<Rows, Roll>)
    return ana_pair::shift_of<T>(hlen, rows.sc);
  else
    return ana_pair::shift_of<T>(hlen);
}

// Launch one analysis level of (batch, nr, nc) inputs on the pair body (the
// caller validated the arguments).
template <class T, class Rows>
int launch_pair(const T* x, T* a, T* h, T* v, T* d, int batch, int nr,
                int nc, const T* dec_lo, const T* dec_hi, int hlen,
                const Rows& rows, int device, void* stream) {
  int sms = 0;
  cudaError_t err = device_sms(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  TapsT<T> padded;
  hlen = make_analysis_taps(dec_lo, dec_hi, hlen, &padded);
  const PairInstance<T, Rows> inst = pick_ana<T, Rows>(
      hlen, read_shift<T>(hlen, rows), batch, nr, nc, sms);
  err = allow_smem(inst);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ana_pair::Taps<T> taps = ana_pair::make_taps(padded, hlen);
  const int lr = (nr + 1) / 2, lc = (nc + 1) / 2;
  launch_chunks((lc + inst.tc - 1) / inst.tc, (lr + inst.tr - 1) / inst.tr,
                batch, [&](dim3 grid, int y0, int z0) {
                  const long long pi = static_cast<long long>(z0) * nr * nc;
                  const long long po = static_cast<long long>(z0) * lr * lc;
                  Rows rz = rows;
                  if constexpr (Rows::kHalo) rz = rows.plane(z0, nc);
                  inst.kernel<<<grid, kThreads, inst.smem,
                                static_cast<cudaStream_t>(stream)>>>(
                      x + pi, a + po, h + po, v + po, d + po, nr, nc, taps,
                      hlen, y0, rz);
                });
  return static_cast<int>(cudaGetLastError());
}

// report_occupancy of the instance that a level of nr x nc inputs at hlen
// runs on rows `rows` (tile shape in outputs).
template <class T, class Rows>
int pair_occupancy(int nr, int nc, int hlen, const Rows& rows, int device,
                   int* blocks, int* smem, int* tr, int* tc) {
  if (hlen < 1 || hlen > kMaxTaps || nr < 1 || nc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = device_sms(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  hlen += hlen & 1;
  return report_occupancy(
      pick_ana<T, Rows>(hlen, read_shift<T>(hlen, rows), 1, nr, nc, sms),
      blocks, smem, tr, tc);
}

template <class T>
int launch_sharded(const T* x, const T* top, const T* bot, T* a, T* h, T* v,
                   T* d, int batch, int nr, int nc, int lp, int rp,
                   const T* dec_lo, const T* dec_hi, int hlen, int device,
                   void* stream) {
  if (hlen < 1 || hlen > kMaxTaps || nr < 2 || (nr & 1) || nc < 1 ||
      nr > 0x3fffffff || nc > 0x3fffffff || batch < 1 ||
      !analysis_halos_ok(hlen, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_pair(x, a, h, v, d, batch, nr, nc, dec_lo, dec_hi, hlen,
                     make_halo(top, bot, lp, rp), device, stream);
}

template <class T>
int launch(const T* x, T* a, T* h, T* v, T* d, int batch, int nr, int nc,
           const T* dec_lo, const T* dec_hi, int hlen, int sr, int sc,
           int mode, float beta, int device, void* stream) {
  if (hlen < 1 || hlen > kMaxTaps || nr < 1 || nc < 1 || nr > 0x3fffffff ||
      nc > 0x3fffffff || batch < 1 || sr < 0 || sr >= nr || sc < 0 ||
      sc >= nc || mode < kNone || mode > kHard)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shift = sr || sc || mode != kNone;
  if (!shift)
    return launch_pair(x, a, h, v, d, batch, nr, nc, dec_lo, dec_hi, hlen,
                       Wrapped{}, device, stream);
  if constexpr (!std::is_same_v<T, float>) {
    return static_cast<int>(cudaErrorInvalidValue);  // K19 is float32 only
  } else {
    return launch_pair(x, a, h, v, d, batch, nr, nc, dec_lo, dec_hi, hlen,
                       Roll{sr, sc, mode, beta}, device, stream);
  }
}

}  // namespace
}  // namespace pypwt

// All return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. dec_lo/dec_hi are host arrays of hlen values of the
// data's type.
// K1: a, h, v, d of (batch, ceil(nr/2), ceil(nc/2)).
extern "C" int pypwt_dwt2d(const float* x, float* a, float* h, float* v,
                           float* d, int batch, int nr, int nc,
                           const float* dec_lo, const float* dec_hi, int hlen,
                           int device, void* stream) {
  return pypwt::launch(x, a, h, v, d, batch, nr, nc, dec_lo, dec_hi, hlen, 0,
                       0, pypwt::kNone, 0.f, device, stream);
}

extern "C" int pypwt_dwt2d_f64(const double* x, double* a, double* h,
                               double* v, double* d, int batch, int nr,
                               int nc, const double* dec_lo,
                               const double* dec_hi, int hlen, int device,
                               void* stream) {
  return pypwt::launch(x, a, h, v, d, batch, nr, nc, dec_lo, dec_hi, hlen, 0,
                       0, pypwt::kNone, 0.f, device, stream);
}

// K19: the level of x rolled by (sr, sc), each reduced into [0, n) by the
// caller; mode 0 stores h, v, d as they are, 1 soft- and 2 hard-thresholds
// them by beta.
extern "C" int pypwt_dwt2d_shifted(const float* x, float* a, float* h,
                                   float* v, float* d, int batch, int nr,
                                   int nc, int sr, int sc, int mode,
                                   float beta, const float* dec_lo,
                                   const float* dec_hi, int hlen, int device,
                                   void* stream) {
  return pypwt::launch(x, a, h, v, d, batch, nr, nc, dec_lo, dec_hi, hlen, sr,
                       sc, mode, beta, device, stream);
}

// K26a: the level of one row shard x of (batch, nr, nc), nr even, whose
// rows above and below are top (batch, lp, nc) and bot (batch, rp, nc), lp
// and rp the analysis pads of hlen; a, h, v, d of (batch, nr/2,
// ceil(nc/2)).
extern "C" int pypwt_dwt2d_sharded(const float* x, const float* top,
                                   const float* bot, float* a, float* h,
                                   float* v, float* d, int batch, int nr,
                                   int nc, int lp, int rp,
                                   const float* dec_lo, const float* dec_hi,
                                   int hlen, int device, void* stream) {
  return pypwt::launch_sharded(x, top, bot, a, h, v, d, batch, nr, nc, lp,
                               rp, dec_lo, dec_hi, hlen, device, stream);
}

extern "C" int pypwt_dwt2d_sharded_f64(const double* x, const double* top,
                                       const double* bot, double* a,
                                       double* h, double* v, double* d,
                                       int batch, int nr, int nc, int lp,
                                       int rp, const double* dec_lo,
                                       const double* dec_hi, int hlen,
                                       int device, void* stream) {
  return pypwt::launch_sharded(x, top, bot, a, h, v, d, batch, nr, nc, lp,
                               rp, dec_lo, dec_hi, hlen, device, stream);
}

// K1's and K26a's instance on a level of nr x nc inputs at hlen (f64: the
// float64 one; halo: K26a's): resident blocks per SM, dynamic shared memory
// in bytes, and the tile's output rows and columns.
extern "C" int pypwt_dwt2d_occupancy(int nr, int nc, int hlen, int f64,
                                     int halo, int device, int* blocks,
                                     int* smem, int* tile_rows,
                                     int* tile_cols) {
  using namespace pypwt;
  if (f64)
    return halo ? pair_occupancy<double>(nr, nc, hlen, Halo<double, 1>{},
                                         device, blocks, smem, tile_rows,
                                         tile_cols)
                : pair_occupancy<double>(nr, nc, hlen, Wrapped{}, device,
                                         blocks, smem, tile_rows, tile_cols);
  return halo ? pair_occupancy<float>(nr, nc, hlen, Halo<float, 1>{}, device,
                                      blocks, smem, tile_rows, tile_cols)
              : pair_occupancy<float>(nr, nc, hlen, Wrapped{}, device, blocks,
                                      smem, tile_rows, tile_cols);
}

// K19's instance on a level of nr x nc inputs at hlen rolled by (sr, sc),
// each in [0, n): as pypwt_dwt2d_occupancy.
extern "C" int pypwt_dwt2d_shifted_occupancy(int nr, int nc, int hlen,
                                             int sr, int sc, int device,
                                             int* blocks, int* smem,
                                             int* tile_rows, int* tile_cols) {
  using namespace pypwt;
  if (sr < 0 || sr >= nr || sc < 0 || sc >= nc)
    return static_cast<int>(cudaErrorInvalidValue);
  return pair_occupancy<float>(nr, nc, hlen, Roll{sr, sc, kNone, 0.f}, device,
                               blocks, smem, tile_rows, tile_cols);
}

extern "C" const char* pypwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
