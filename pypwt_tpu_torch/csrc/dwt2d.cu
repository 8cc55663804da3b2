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
// Design (ana::tile of level2d.cuh, which K24 shares): each block owns a
// TR x TC tile of the four outputs. It stages
// the (2TR + hlen - 2) x (2TC + hlen - 2) input window into shared memory
// once, with a true periodic wrap, split into even and odd columns so that
// the decimating taps read consecutive words (no bank conflicts). The
// last-axis pass writes lo/hi rows into shared memory, the axis -2 pass
// reads them and writes a, h, v, d. Each input element is read from device
// memory once (plus the halo), and the intermediate never leaves the SM.
// The shift and the odd extension only change the index of the staging
// gather, so K19 is this kernel with another source index: template flags
// compile them in where a call needs them, and the even, unshifted K1
// instance is the plain gather. K26a is the even unshifted instance with
// the Halo row source (common.cuh): window rows above and below the shard
// are read from the halo tensors where they lie, so the shard is never
// copied into a padded buffer (the TPU kernel's _edge_override did the same
// for its edge bands); its bytes are K1's plus the halo rows, 2 (hlen/2 - 1)
// rows per shard, read once per tile that meets them. The batch is the
// grid's z axis, row tiles
// its y axis, in chunks where a level holds more than a grid's 65535
// (launch_chunks). Offsets into the planes are 64-bit. The float64
// instance (pypwt_dwt2d_f64; K1 only) stages twice the bytes: 139 KB at
// hlen 40, within the 227 KB a block may opt into.

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

template <class T>
using Kernel = void (*)(const T*, T*, T*, T*, T*, int, int, TapsT<T>, int,
                        int, int, int, float);

template <class T, bool kShift, int kMode>
Kernel<T> pick(bool odd) {
  return odd ? dwt2d_kernel<T, true, kShift, kMode>
             : dwt2d_kernel<T, false, kShift, kMode>;
}

// K1's instance, or K19's (float32 only) for a shift or an epilogue.
template <class T>
Kernel<T> pick_kernel(bool odd, bool shift, int mode) {
  if constexpr (std::is_same_v<T, float>) {
    if (shift)
      return mode == kSoft   ? pick<T, true, kSoft>(odd)
             : mode == kHard ? pick<T, true, kHard>(odd)
                             : pick<T, true, kNone>(odd);
  }
  return pick<T, false, kNone>(odd);
}

// K26a: K1's level of one row shard, its edge rows from the halos.
template <class T, bool kOdd>
__global__ void __launch_bounds__(kThreads)
dwt2d_sharded_kernel(const T* __restrict__ x, T* __restrict__ a,
                     T* __restrict__ h, T* __restrict__ v, T* __restrict__ d,
                     int nr, int nc, Halo<T, 1> halo, TapsT<T> taps,
                     int hlen, int y0) {
  T* smem = dynamic_smem<T>();
  T* f_lo = ana::taps(smem, hlen);
  load_reversed_taps(taps, hlen, f_lo, f_lo + kMaxTaps);
  const long long pi = static_cast<long long>(blockIdx.z) * nr * nc;
  const long long po =
      static_cast<long long>(blockIdx.z) * (nr >> 1) * ((nc + 1) >> 1);
  ana::tile<T, kOdd, false, kNone, false>(
      x + pi, a + po, h + po, v + po, d + po, nr, nc, hlen,
      (y0 + blockIdx.y) * ana::TR, blockIdx.x * ana::TC, 0, 0, 0.f, smem,
      halo.plane(blockIdx.z, nc));
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  TapsT<T> taps;
  hlen = make_analysis_taps(dec_lo, dec_hi, hlen, &taps);
  auto kernel = (nc & 1) ? dwt2d_sharded_kernel<T, true>
                         : dwt2d_sharded_kernel<T, false>;
  const size_t smem = ana::smem_bytes<T>(hlen);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Halo<T, 1> halo = make_halo(top, bot, lp, rp);
  const int lr = nr / 2, lc = (nc + 1) / 2;
  launch_chunks((lc + ana::TC - 1) / ana::TC, (lr + ana::TR - 1) / ana::TR,
                batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long pi = static_cast<long long>(z0) * nr * nc;
                  const long long po = static_cast<long long>(z0) * lr * lc;
                  kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
                      x + pi, a + po, h + po, v + po, d + po, nr, nc,
                      halo.plane(z0, nc), taps, hlen, y0);
                });
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const T* x, T* a, T* h, T* v, T* d, int batch, int nr, int nc,
           const T* dec_lo, const T* dec_hi, int hlen, int sr, int sc,
           int mode, float beta, int device, void* stream) {
  if (hlen < 1 || hlen > kMaxTaps || nr < 1 || nc < 1 || nr > 0x3fffffff ||
      nc > 0x3fffffff || batch < 1 || sr < 0 || sr >= nr || sc < 0 ||
      sc >= nc || mode < kNone || mode > kHard)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  TapsT<T> taps;
  hlen = make_analysis_taps(dec_lo, dec_hi, hlen, &taps);
  const bool odd = (nr | nc) & 1;
  const bool shift = sr || sc || mode != kNone;
  if (shift && !std::is_same_v<T, float>)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel<T> kernel = pick_kernel<T>(odd, shift, mode);
  const size_t smem = ana::smem_bytes<T>(hlen);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lr = (nr + 1) / 2, lc = (nc + 1) / 2;
  launch_chunks((lc + ana::TC - 1) / ana::TC, (lr + ana::TR - 1) / ana::TR,
                batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long pi = static_cast<long long>(z0) * nr * nc;
                  const long long po = static_cast<long long>(z0) * lr * lc;
                  kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
                      x + pi, a + po, h + po, v + po, d + po, nr, nc, taps,
                      hlen, y0, sr, sc, beta);
                });
  return static_cast<int>(cudaGetLastError());
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

extern "C" const char* pypwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
