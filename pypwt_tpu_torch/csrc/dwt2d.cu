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
// Design. K1 and K26a run ana_pair::tile (level2d.cuh). Each block owns a
// tile of the four outputs, a shape picked on the host by type, hlen and
// level size (pick_ana): up to hlen 10, 16 x 64 outputs in float32 and 16 x
// 32 in float64; from hlen 12, 32 x 32 and 32 x 16, whose taller windows
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
// K19 runs ana::tile (which K24 shares): a TR x TC = 32 x 32 output tile, its
// (2TR + hlen - 2) x (2TC + hlen - 2) window staged by a gather, one sample
// per thread and step, with the shift and the odd extension in the gather's
// source index, split into even and odd columns so that the decimating taps
// read consecutive words; the taps from shared memory; one output per thread
// and item in each pass, and the threshold before the store. dwt2d_kernel
// keeps its type and shift parameters, though only its float32 shifted
// instances are built, so that K19's machine code stays as it was.
//
// All: the batch is the grid's z axis, row tiles its y axis, in chunks
// where a level holds more than a grid's 65535 (launch_chunks). Offsets
// into the planes are 64-bit.

#include "level2d.cuh"

namespace pypwt {
namespace {

template <class T, bool kOdd, bool kShift, int kMode>
__global__ void __launch_bounds__(kThreads)
dwt2d_kernel(const T* __restrict__ x, T* __restrict__ a, T* __restrict__ h,
             T* __restrict__ v, T* __restrict__ d, int nr, int nc,
             TapsT<T> taps, int hlen, int y0, int sr, int sc, float beta) {
  T* smem = dynamic_smem<T>();
  T* f_lo = ana::taps(smem, hlen);
  load_reversed_taps(taps, hlen, f_lo, f_lo + kMaxTaps);
  const long long pi = static_cast<long long>(blockIdx.z) * nr * nc;
  const long long po =
      static_cast<long long>(blockIdx.z) * ((nr + 1) >> 1) * ((nc + 1) >> 1);
  ana::tile<T, kOdd, kShift, kMode, false>(
      x + pi, a + po, h + po, v + po, d + po, nr, nc, hlen,
      (y0 + blockIdx.y) * ana::TR, blockIdx.x * ana::TC, sr, sc, beta, smem);
}

// K1 and K26a: one level on the pair body (level2d.cuh) in tiles of kTR x
// kTC outputs, kShift = ana_pair::shift_of<T>(hlen); Rows: Wrapped (K1), or
// the Halo<T, 1> of a shard (K26a), moved to the block's plane here.
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
PairInstance<T, Rows> ana_instance(int hlen) {
  if constexpr (kShift + 1 < 16 / static_cast<int>(sizeof(T))) {
    if (ana_pair::shift_of<T>(hlen) != kShift)
      return ana_instance<T, Rows, kTR, kTC, kShift + 1>(hlen);
  }
  return {dwt2d_pair_kernel<T, kTR, kTC, kShift, Rows>,
          ana_pair::Geometry<T>(kTR, kTC, hlen).smem_bytes(), kTR, kTC};
}

// The tile shape of a level of (batch, nr, nc) inputs at the padded hlen,
// in outputs (PERF.md: the shapes measured). Narrow banks take wide tiles
// (64 float32 or 32 float64 columns: fewer column halos); banks of
// kWideHlen taps or more take 32-row tiles, whose 2 tr + hlen - 2 window
// rows hold fewer halo rows per output row, and fewer columns, which keep
// two or more blocks per SM. A level that would give an SM less than one
// such block takes the shape with half the rows (float64: 8 x 32).
constexpr int kWideHlen = 12;

template <class T, class Rows>
PairInstance<T, Rows> pick_ana(int hlen, int batch, int nr, int nc,
                               int sms) {
  const int lr = (nr + 1) / 2, lc = (nc + 1) / 2;
  const auto fills = [&](int tr, int tc) {
    return static_cast<long long>(batch) * ((lr + tr - 1) / tr) *
               ((lc + tc - 1) / tc) >= sms;
  };
  if constexpr (std::is_same_v<T, float>) {
    if (hlen >= kWideHlen)
      return fills(32, 32) ? ana_instance<T, Rows, 32, 32>(hlen)
                           : ana_instance<T, Rows, 16, 32>(hlen);
    return fills(16, 64) ? ana_instance<T, Rows, 16, 64>(hlen)
                         : ana_instance<T, Rows, 8, 64>(hlen);
  } else {
    if (hlen >= kWideHlen)
      return fills(32, 16) ? ana_instance<T, Rows, 32, 16>(hlen)
                           : ana_instance<T, Rows, 8, 32>(hlen);
    return fills(16, 32) ? ana_instance<T, Rows, 16, 32>(hlen)
                         : ana_instance<T, Rows, 8, 32>(hlen);
  }
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
  const PairInstance<T, Rows> inst =
      pick_ana<T, Rows>(hlen, batch, nr, nc, sms);
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
// runs (tile shape in outputs).
template <class T, class Rows>
int pair_occupancy(int nr, int nc, int hlen, int device, int* blocks,
                   int* smem, int* tr, int* tc) {
  if (hlen < 1 || hlen > kMaxTaps || nr < 1 || nc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = device_sms(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  return report_occupancy(pick_ana<T, Rows>(hlen + (hlen & 1), 1, nr, nc, sms),
                          blocks, smem, tr, tc);
}

template <class T>
using Kernel = void (*)(const T*, T*, T*, T*, T*, int, int, TapsT<T>, int,
                        int, int, int, float);

// K19's instance (float32): a shift, an epilogue, or both.
template <int kMode>
Kernel<float> pick(bool odd) {
  return odd ? dwt2d_kernel<float, true, true, kMode>
             : dwt2d_kernel<float, false, true, kMode>;
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
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    TapsT<T> taps;
    hlen = make_analysis_taps(dec_lo, dec_hi, hlen, &taps);
    const bool odd = (nr | nc) & 1;
    const Kernel<T> kernel = mode == kSoft   ? pick<kSoft>(odd)
                             : mode == kHard ? pick<kHard>(odd)
                                             : pick<kNone>(odd);
    const size_t smem = ana::smem_bytes<T>(hlen);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int lr = (nr + 1) / 2, lc = (nc + 1) / 2;
    launch_chunks((lc + ana::TC - 1) / ana::TC, (lr + ana::TR - 1) / ana::TR,
                  batch, [&](dim3 grid, int y0, int z0) {
                    const long long pi = static_cast<long long>(z0) * nr * nc;
                    const long long po = static_cast<long long>(z0) * lr * lc;
                    kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
                        x + pi, a + po, h + po, v + po, d + po, nr, nc, taps,
                        hlen, y0, sr, sc, beta);
                  });
    return static_cast<int>(cudaGetLastError());
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
    return halo ? pair_occupancy<double, Halo<double, 1>>(
                      nr, nc, hlen, device, blocks, smem, tile_rows,
                      tile_cols)
                : pair_occupancy<double, Wrapped>(nr, nc, hlen, device,
                                                  blocks, smem, tile_rows,
                                                  tile_cols);
  return halo ? pair_occupancy<float, Halo<float, 1>>(
                    nr, nc, hlen, device, blocks, smem, tile_rows, tile_cols)
              : pair_occupancy<float, Wrapped>(nr, nc, hlen, device, blocks,
                                               smem, tile_rows, tile_cols);
}

extern "C" const char* pypwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
