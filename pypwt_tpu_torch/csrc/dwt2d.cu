// K1: one periodized separable 2D analysis level, float32.
//
// Replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::dwt2d_fused
// (_build_dwt2d, :287; and its column-split grid _build_dwt2d_colsplit,
// :418, which computes the same map for wide planes).
//
// Map (pypwt_tpu/core/dwt.py:195-201 on conv.analysis_last), for
// x of (B?, Nr, Nc) with even Nr, Nc and even hlen <= 40:
//   lo[i] = sum_j dec[hlen-1-j] * x[(2i + j - lpad) mod N],
//   (lpad, rpad) = analysis_pads(hlen) = (hlen-1-hlen/2, hlen/2-1)
// first along the last axis (lo -> a, h; hi -> v, d), then along axis -2:
//   a = lo(lo), h = hi(lo), v = lo(hi), d = hi(hi).
//
// Bound: one level moves 4*Nr*Nc bytes in and 4*Nr*Nc out (8 bytes per
// input pixel) and does hlen FMAs per input pixel in each pass, 2*hlen in
// all: hlen/2 flop per byte, under the H100's float32 ridge of ~20 flop per
// byte (67 TFLOP/s over 3.35 TB/s) for every hlen < 40, so memory-bound.
//
// Design: each block owns a TR x TC tile of the four outputs. It stages
// the (2TR + hlen - 2) x (2TC + hlen - 2) input window into shared memory
// once, with a true periodic wrap, split into even and odd columns so that
// the decimating taps read consecutive words (no bank conflicts). The
// last-axis pass writes lo/hi rows into shared memory, the axis -2 pass
// reads them and writes a, h, v, d. Each input element is read from device
// memory once (plus the halo), and the intermediate never leaves the SM.
// The batch is the grid's z axis. Offsets into the planes are 64-bit.

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TR = 32;  // output rows per block
constexpr int TC = 32;  // output columns per block

__host__ __device__ inline int win_rows(int hlen) { return 2 * TR + hlen - 2; }
// window columns of one parity: (2TC + hlen - 2) / 2
__host__ __device__ inline int win_half_cols(int hlen) { return TC + hlen / 2 - 1; }

inline size_t smem_bytes(int hlen) {
  const size_t wr = win_rows(hlen), wc2 = win_half_cols(hlen);
  return sizeof(float) * (2 * wr * wc2 + 2 * wr * TC + 2 * kMaxTaps);
}

__global__ void __launch_bounds__(kThreads)
dwt2d_kernel(const float* __restrict__ x, float* __restrict__ a,
             float* __restrict__ h, float* __restrict__ v,
             float* __restrict__ d, int nr, int nc, Taps taps, int hlen) {
  extern __shared__ float smem[];
  const int wr = win_rows(hlen), wc2 = win_half_cols(hlen), wc = 2 * wc2;
  float* s_ev = smem;              // [wr][wc2] even window columns
  float* s_od = s_ev + wr * wc2;   // [wr][wc2] odd window columns
  float* s_lo = s_od + wr * wc2;   // [wr][TC] last-axis low-pass
  float* s_hi = s_lo + wr * TC;    // [wr][TC] last-axis high-pass
  float* f_lo = s_hi + wr * TC;    // reversed taps: f[j] = dec[hlen-1-j]
  float* f_hi = f_lo + kMaxTaps;

  const int tid = threadIdx.x;
  const int lr = nr >> 1, lc = nc >> 1;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int lpad = hlen - 1 - hlen / 2;
  const float* xb = x + static_cast<long long>(blockIdx.z) * nr * nc;
  const long long ob = static_cast<long long>(blockIdx.z) * lr * lc;

  if (tid < hlen) {
    f_lo[tid] = taps.lo[hlen - 1 - tid];
    f_hi[tid] = taps.hi[hlen - 1 - tid];
  }
  const int row0 = 2 * r0 - lpad, col0 = 2 * c0 - lpad;
  for (int i = tid; i < wr * wc; i += kThreads) {
    const int r = i / wc, c = i - r * wc;
    const float val =
        xb[static_cast<long long>(wrap(row0 + r, nr)) * nc + wrap(col0 + c, nc)];
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
    h[o] = sh;
    v[o] = sv;
    d[o] = sd;
  }
}

}  // namespace
}  // namespace pypwt

// Returns a cudaError_t; launches on `stream`, does not synchronise and
// allocates nothing. dec_lo/dec_hi are host arrays of hlen floats.
extern "C" int pypwt_dwt2d(const float* x, float* a, float* h, float* v,
                           float* d, int batch, int nr, int nc,
                           const float* dec_lo, const float* dec_hi, int hlen,
                           int device, void* stream) {
  using namespace pypwt;
  const int lr = nr / 2, lc = nc / 2;
  const int gy = (lr + TR - 1) / TR;
  if (hlen < 2 || hlen > kMaxTaps || (hlen & 1) || nr < 2 || nc < 2 ||
      (nr & 1) || (nc & 1) || batch < 1 || batch > 65535 || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(hlen);
  err = cudaFuncSetAttribute(dwt2d_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lc + TC - 1) / TC, gy, batch);
  dwt2d_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, a, h, v, d, nr, nc, make_taps(dec_lo, dec_hi, hlen), hlen);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pypwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
