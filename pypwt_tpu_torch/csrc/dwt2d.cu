// K1: one periodized separable 2D analysis level, float32 or float64, and
// K19, the same level of a circularly shifted float32 plane with an
// optional threshold of its detail subbands.
//
// K1 replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::dwt2d_fused
// (_build_dwt2d, :287; and its column-split grid _build_dwt2d_colsplit,
// :418, which computes the same map for wide planes). K19 replaces
// ::dwt2d_fused_shifted (_build_dwt2d_shifted, :609), and, with the shift a
// runtime argument, the analysis halves of the phase-select, dynamic-shift
// and multi-shift kernels (_build_dwt2d_phasesel :841, _build_dwt2d_dynshift
// :1074, _build_dwt2d_multishift :1297: one K19 launch per spin).
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
// Design: each block owns a TR x TC tile of the four outputs. It stages
// the (2TR + hlen - 2) x (2TC + hlen - 2) input window into shared memory
// once, with a true periodic wrap, split into even and odd columns so that
// the decimating taps read consecutive words (no bank conflicts). The
// last-axis pass writes lo/hi rows into shared memory, the axis -2 pass
// reads them and writes a, h, v, d. Each input element is read from device
// memory once (plus the halo), and the intermediate never leaves the SM.
// The shift and the odd extension only change the index of the staging
// gather, so K19 is this kernel with another source index: template flags
// compile them in where a call needs them, and the even, unshifted K1
// instance is the plain gather. The batch is the grid's z axis, row tiles
// its y axis, in chunks where a level holds more than a grid's 65535
// (launch_chunks). Offsets into the planes are 64-bit. The float64
// instance (pypwt_dwt2d_f64; K1 only) stages twice the bytes: 139 KB at
// hlen 40, within the 227 KB a block may opt into.

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TR = 32;  // output rows per block
constexpr int TC = 32;  // output columns per block

enum Thresh { kNone = 0, kSoft = 1, kHard = 2 };

__host__ __device__ inline int win_rows(int hlen) { return 2 * TR + hlen - 2; }
// window columns of one parity: (2TC + hlen - 2) / 2
__host__ __device__ inline int win_half_cols(int hlen) { return TC + hlen / 2 - 1; }

template <class T>
inline size_t smem_bytes(int hlen) {
  const size_t wr = win_rows(hlen), wc2 = win_half_cols(hlen);
  return sizeof(T) * (2 * wr * wc2 + 2 * wr * TC + 2 * kMaxTaps);
}

// Source index of window sample k of an axis of n samples, for a plane
// rolled by s in [0, n) (kShift) and extended by its last sample where n
// is odd (kOdd).
template <bool kOdd, bool kShift>
__device__ __forceinline__ int source(int k, int n, int s) {
  if (!kShift) return kOdd ? wrap_ext(k, n) : wrap(k, n);
  if (!kOdd) return wrap(k - s, n);
  const int i = wrap_ext(k, n) - s;
  return i < 0 ? i + n : i;
}

// The epilogue of K19 (float32 only: the float64 instance is kNone).
template <int kMode>
__device__ __forceinline__ float threshold(float x, float beta) {
  if (kMode == kSoft) return copysignf(fmaxf(fabsf(x) - beta, 0.f), x);
  if (kMode == kHard) return fabsf(x) > beta ? x : 0.f;
  return x;
}

template <int kMode>
__device__ __forceinline__ double threshold(double x, float) {
  static_assert(kMode == kNone, "K19 is float32 only");
  return x;
}

template <class T, bool kOdd, bool kShift, int kMode>
__global__ void __launch_bounds__(kThreads)
dwt2d_kernel(const T* __restrict__ x, T* __restrict__ a, T* __restrict__ h,
             T* __restrict__ v, T* __restrict__ d, int nr, int nc,
             TapsT<T> taps, int hlen, int y0, int sr, int sc, float beta) {
  const int wr = win_rows(hlen), wc2 = win_half_cols(hlen), wc = 2 * wc2;
  T* s_ev = dynamic_smem<T>();     // [wr][wc2] even window columns
  T* s_od = s_ev + wr * wc2;       // [wr][wc2] odd window columns
  T* s_lo = s_od + wr * wc2;       // [wr][TC] last-axis low-pass
  T* s_hi = s_lo + wr * TC;        // [wr][TC] last-axis high-pass
  T* f_lo = s_hi + wr * TC;        // reversed taps: f[j] = dec[hlen-1-j]
  T* f_hi = f_lo + kMaxTaps;

  const int tid = threadIdx.x;
  const int lr = (nr + 1) >> 1, lc = (nc + 1) >> 1;
  const int r0 = (y0 + blockIdx.y) * TR, c0 = blockIdx.x * TC;
  const int lpad = analysis_lpad(hlen);
  const T* xb = x + static_cast<long long>(blockIdx.z) * nr * nc;
  const long long ob = static_cast<long long>(blockIdx.z) * lr * lc;

  load_reversed_taps(taps, hlen, f_lo, f_hi);
  const int row0 = 2 * r0 - lpad, col0 = 2 * c0 - lpad;
  for (int i = tid; i < wr * wc; i += kThreads) {
    const int r = i / wc, c = i - r * wc;
    const T val =
        xb[static_cast<long long>(source<kOdd, kShift>(row0 + r, nr, sr)) * nc +
           source<kOdd, kShift>(col0 + c, nc, sc)];
    (c & 1 ? s_od : s_ev)[r * wc2 + (c >> 1)] = val;
  }
  __syncthreads();

  // Last axis: window column 2c + j feeds output column c.
  for (int i = tid; i < wr * TC; i += kThreads) {
    const int r = i / TC, c = i - r * TC;
    const T* ev = s_ev + r * wc2 + c;
    const T* od = s_od + r * wc2 + c;
    T lo = 0, hi = 0;
    for (int j = 0; j < hlen; j += 2) {
      const T e = ev[j >> 1], o = od[j >> 1];
      lo = fmadd(e, f_lo[j], lo);
      hi = fmadd(e, f_hi[j], hi);
      lo = fmadd(o, f_lo[j + 1], lo);
      hi = fmadd(o, f_hi[j + 1], hi);
    }
    s_lo[i] = lo;
    s_hi[i] = hi;
  }
  __syncthreads();

  // Axis -2: window row 2r + j feeds output row r.
  for (int i = tid; i < TR * TC; i += kThreads) {
    const int r = i / TC, c = i - r * TC;
    const int orow = r0 + r, ocol = c0 + c;
    if (orow >= lr || ocol >= lc) continue;
    const T* lo = s_lo + 2 * r * TC + c;
    const T* hi = s_hi + 2 * r * TC + c;
    T sa = 0, sh = 0, sv = 0, sd = 0;
    for (int j = 0; j < hlen; ++j) {
      const T l = lo[j * TC], g = hi[j * TC];
      sa = fmadd(l, f_lo[j], sa);
      sh = fmadd(l, f_hi[j], sh);
      sv = fmadd(g, f_lo[j], sv);
      sd = fmadd(g, f_hi[j], sd);
    }
    const long long o = ob + static_cast<long long>(orow) * lc + ocol;
    a[o] = sa;
    h[o] = threshold<kMode>(sh, beta);
    v[o] = threshold<kMode>(sv, beta);
    d[o] = threshold<kMode>(sd, beta);
  }
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
  const size_t smem = smem_bytes<T>(hlen);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lr = (nr + 1) / 2, lc = (nc + 1) / 2;
  launch_chunks((lc + TC - 1) / TC, (lr + TR - 1) / TR, batch,
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

extern "C" const char* pypwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
