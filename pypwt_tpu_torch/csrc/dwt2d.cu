// K1: one periodized separable 2D analysis level, float32, and K19, the
// same level of a circularly shifted plane with an optional threshold of
// its detail subbands.
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
// (launch_chunks). Offsets into the planes are 64-bit.

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TR = 32;  // output rows per block
constexpr int TC = 32;  // output columns per block

enum Thresh { kNone = 0, kSoft = 1, kHard = 2 };

__host__ __device__ inline int win_rows(int hlen) { return 2 * TR + hlen - 2; }
// window columns of one parity: (2TC + hlen - 2) / 2
__host__ __device__ inline int win_half_cols(int hlen) { return TC + hlen / 2 - 1; }

inline size_t smem_bytes(int hlen) {
  const size_t wr = win_rows(hlen), wc2 = win_half_cols(hlen);
  return sizeof(float) * (2 * wr * wc2 + 2 * wr * TC + 2 * kMaxTaps);
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

template <int kMode>
__device__ __forceinline__ float threshold(float x, float beta) {
  if (kMode == kSoft) return copysignf(fmaxf(fabsf(x) - beta, 0.f), x);
  if (kMode == kHard) return fabsf(x) > beta ? x : 0.f;
  return x;
}

template <bool kOdd, bool kShift, int kMode>
__global__ void __launch_bounds__(kThreads)
dwt2d_kernel(const float* __restrict__ x, float* __restrict__ a,
             float* __restrict__ h, float* __restrict__ v,
             float* __restrict__ d, int nr, int nc, Taps taps, int hlen,
             int y0, int sr, int sc, float beta) {
  extern __shared__ float smem[];
  const int wr = win_rows(hlen), wc2 = win_half_cols(hlen), wc = 2 * wc2;
  float* s_ev = smem;              // [wr][wc2] even window columns
  float* s_od = s_ev + wr * wc2;   // [wr][wc2] odd window columns
  float* s_lo = s_od + wr * wc2;   // [wr][TC] last-axis low-pass
  float* s_hi = s_lo + wr * TC;    // [wr][TC] last-axis high-pass
  float* f_lo = s_hi + wr * TC;    // reversed taps: f[j] = dec[hlen-1-j]
  float* f_hi = f_lo + kMaxTaps;

  const int tid = threadIdx.x;
  const int lr = (nr + 1) >> 1, lc = (nc + 1) >> 1;
  const int r0 = (y0 + blockIdx.y) * TR, c0 = blockIdx.x * TC;
  const int lpad = analysis_lpad(hlen);
  const float* xb = x + static_cast<long long>(blockIdx.z) * nr * nc;
  const long long ob = static_cast<long long>(blockIdx.z) * lr * lc;

  load_reversed_taps(taps, hlen, f_lo, f_hi);
  const int row0 = 2 * r0 - lpad, col0 = 2 * c0 - lpad;
  for (int i = tid; i < wr * wc; i += kThreads) {
    const int r = i / wc, c = i - r * wc;
    const float val =
        xb[static_cast<long long>(source<kOdd, kShift>(row0 + r, nr, sr)) * nc +
           source<kOdd, kShift>(col0 + c, nc, sc)];
    (c & 1 ? s_od : s_ev)[r * wc2 + (c >> 1)] = val;
  }
  __syncthreads();

  // Last axis: window column 2c + j feeds output column c.
  for (int i = tid; i < wr * TC; i += kThreads) {
    const int r = i / TC, c = i - r * TC;
    const float* ev = s_ev + r * wc2 + c;
    const float* od = s_od + r * wc2 + c;
    float lo = 0.f, hi = 0.f;
    for (int j = 0; j < hlen; j += 2) {
      const float e = ev[j >> 1], o = od[j >> 1];
      lo = fmaf(e, f_lo[j], lo);
      hi = fmaf(e, f_hi[j], hi);
      lo = fmaf(o, f_lo[j + 1], lo);
      hi = fmaf(o, f_hi[j + 1], hi);
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
    const float* lo = s_lo + 2 * r * TC + c;
    const float* hi = s_hi + 2 * r * TC + c;
    float sa = 0.f, sh = 0.f, sv = 0.f, sd = 0.f;
    for (int j = 0; j < hlen; ++j) {
      const float l = lo[j * TC], g = hi[j * TC];
      sa = fmaf(l, f_lo[j], sa);
      sh = fmaf(l, f_hi[j], sh);
      sv = fmaf(g, f_lo[j], sv);
      sd = fmaf(g, f_hi[j], sd);
    }
    const long long o = ob + static_cast<long long>(orow) * lc + ocol;
    a[o] = sa;
    h[o] = threshold<kMode>(sh, beta);
    v[o] = threshold<kMode>(sv, beta);
    d[o] = threshold<kMode>(sd, beta);
  }
}

using Kernel = void (*)(const float*, float*, float*, float*, float*, int, int,
                        Taps, int, int, int, int, float);

template <bool kShift, int kMode>
Kernel pick(bool odd) {
  return odd ? dwt2d_kernel<true, kShift, kMode>
             : dwt2d_kernel<false, kShift, kMode>;
}

int launch(const float* x, float* a, float* h, float* v, float* d, int batch,
           int nr, int nc, const float* dec_lo, const float* dec_hi, int hlen,
           int sr, int sc, int mode, float beta, int device, void* stream) {
  if (hlen < 1 || hlen > kMaxTaps || nr < 1 || nc < 1 || nr > 0x3fffffff ||
      nc > 0x3fffffff || batch < 1 || sr < 0 || sr >= nr || sc < 0 ||
      sc >= nc || mode < kNone || mode > kHard)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Taps taps;
  hlen = make_analysis_taps(dec_lo, dec_hi, hlen, &taps);
  const bool odd = (nr | nc) & 1;
  const bool shift = sr || sc || mode != kNone;
  const Kernel kernel = !shift           ? pick<false, kNone>(odd)
                        : mode == kSoft  ? pick<true, kSoft>(odd)
                        : mode == kHard  ? pick<true, kHard>(odd)
                                         : pick<true, kNone>(odd);
  const size_t smem = smem_bytes(hlen);
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

// Both return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. dec_lo/dec_hi are host arrays of hlen floats.
// K1: a, h, v, d of (batch, ceil(nr/2), ceil(nc/2)).
extern "C" int pypwt_dwt2d(const float* x, float* a, float* h, float* v,
                           float* d, int batch, int nr, int nc,
                           const float* dec_lo, const float* dec_hi, int hlen,
                           int device, void* stream) {
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
