// K2: one periodized separable 2D synthesis level, float32.
//
// Replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::idwt2d_fused
// (_build_idwt2d, :477).
//
// Map (pypwt_tpu/core/dwt.py:214-223 on conv.synthesis_core), for a, h, v,
// d of (B?, Lr, Lc) and an output of (B?, 2Lr, 2Lc), even hlen <= 40:
// a polyphase synthesis along axis -2 of (a, h) -> t1 and of (v, d) -> t2,
// then one along the last axis of (t1, t2). One axis, as a direct modulo
// index per output parity p (n = 2m + p, L coefficients):
//   h2 = hlen/2, c = h2/2, sigma = (h2 even), delta = (p + sigma) >> 1,
//   off = 1 - ((p + sigma) & 1), g_p[j] = rec[hlen - 1 - 2j - off]
//   out[n] = sum_{j < h2} g_p_lo[j] * lo[(m + delta + j - c) mod L]
//                       + g_p_hi[j] * hi[(m + delta + j - c) mod L]
// (the sigma/c/delta/off/base centering of conv.synthesis_core, :133-167,
// and of the reference's separable.cu:252-287).
//
// Bound: 4*Nr*Nc bytes in and 4*Nr*Nc out per level (8 bytes per output
// pixel), about hlen FMAs per output pixel per axis, 2*hlen in all: hlen/2
// flop per byte, under the H100's float32 ridge of ~20 flop per byte for
// every hlen < 40, so memory-bound.
//
// Design: each block owns a (2TR) x (2TC) output tile. It stages the
// (TR + h2) x (TC + h2) windows of all four inputs into shared memory once,
// with a true periodic wrap, runs the axis -2 synthesis into two shared
// tiles (t1, t2: 2TR rows x (TC + h2) columns), then the last-axis
// synthesis, and writes the output tile with consecutive threads on
// consecutive columns. The batch is the grid's z axis; plane offsets are
// 64-bit.

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TR = 32;  // coefficient rows per block (2TR output rows)
constexpr int TC = 32;  // coefficient columns per block (2TC output columns)

inline size_t smem_bytes(int hlen) {
  const size_t h2 = hlen / 2, wr = TR + h2, ww = TC + h2;
  return sizeof(float) * (4 * wr * ww + 2 * (2 * TR) * ww + 4 * kHalfTaps);
}

__global__ void __launch_bounds__(kThreads)
idwt2d_kernel(const float* __restrict__ a, const float* __restrict__ h,
              const float* __restrict__ v, const float* __restrict__ d,
              float* __restrict__ out, int lr, int lc, Taps taps, int hlen) {
  extern __shared__ float smem[];
  const Polyphase ph(hlen);
  const int h2 = ph.h2, c = ph.c;
  const int wr = TR + h2, ww = TC + h2;
  float* s_a = smem;               // [wr][ww] coefficient windows
  float* s_h = s_a + wr * ww;
  float* s_v = s_h + wr * ww;
  float* s_d = s_v + wr * ww;
  float* t1 = s_d + wr * ww;       // [2TR][ww] axis -2 synthesis of (a, h)
  float* t2 = t1 + 2 * TR * ww;    // [2TR][ww] axis -2 synthesis of (v, d)
  float* g_lo = t2 + 2 * TR * ww;  // [2][kHalfTaps] polyphase taps per parity
  float* g_hi = g_lo + 2 * kHalfTaps;

  const int tid = threadIdx.x;
  const int nr = 2 * lr, nc = 2 * lc;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const long long ib = static_cast<long long>(blockIdx.z) * lr * lc;
  const long long obase = static_cast<long long>(blockIdx.z) * nr * nc;

  load_polyphase_taps(taps, hlen, g_lo, g_hi);
  // window origin: coefficient (r0 - c, c0 - c)
  for (int i = tid; i < wr * ww; i += kThreads) {
    const int r = i / ww, q = i - r * ww;
    const long long o = ib + static_cast<long long>(wrap(r0 - c + r, lr)) * lc +
                        wrap(c0 - c + q, lc);
    s_a[i] = a[o];
    s_h[i] = h[o];
    s_v[i] = v[o];
    s_d[i] = d[o];
  }
  __syncthreads();

  // Axis -2: output row q = 2m + p reads window rows m + delta_p + j.
  for (int i = tid; i < 2 * TR * ww; i += kThreads) {
    const int q = i / ww, w = i - q * ww;
    const int p = q & 1;
    const int base = ((q >> 1) + ph.delta(p)) * ww + w;
    const float* gl = g_lo + p * kHalfTaps;
    const float* gh = g_hi + p * kHalfTaps;
    float x1 = 0.f, x2 = 0.f;
    for (int j = 0; j < h2; ++j) {
      const int k = base + j * ww;
      x1 = fmaf(s_a[k], gl[j], x1);
      x1 = fmaf(s_h[k], gh[j], x1);
      x2 = fmaf(s_v[k], gl[j], x2);
      x2 = fmaf(s_d[k], gh[j], x2);
    }
    t1[i] = x1;
    t2[i] = x2;
  }
  __syncthreads();

  // Last axis: output column n = 2m + p reads window columns m + delta_p + j.
  for (int i = tid; i < 4 * TR * TC; i += kThreads) {
    const int q = i / (2 * TC), n = i - q * (2 * TC);
    const int orow = 2 * r0 + q, ocol = 2 * c0 + n;
    if (orow >= nr || ocol >= nc) continue;
    const int p = n & 1;
    const int base = q * ww + (n >> 1) + ph.delta(p);
    const float* gl = g_lo + p * kHalfTaps;
    const float* gh = g_hi + p * kHalfTaps;
    float s = 0.f;
    for (int j = 0; j < h2; ++j) {
      s = fmaf(t1[base + j], gl[j], s);
      s = fmaf(t2[base + j], gh[j], s);
    }
    out[obase + static_cast<long long>(orow) * nc + ocol] = s;
  }
}

}  // namespace
}  // namespace pypwt

// Returns a cudaError_t; launches on `stream`, does not synchronise and
// allocates nothing. rec_lo/rec_hi are host arrays of hlen floats.
extern "C" int pypwt_idwt2d(const float* a, const float* h, const float* v,
                            const float* d, float* out, int batch, int lr,
                            int lc, const float* rec_lo, const float* rec_hi,
                            int hlen, int device, void* stream) {
  using namespace pypwt;
  const int gy = (lr + TR - 1) / TR;
  if (hlen < 2 || hlen > kMaxTaps || (hlen & 1) || lr < 1 || lc < 1 ||
      batch < 1 || batch > 65535 || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(hlen);
  err = cudaFuncSetAttribute(idwt2d_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lc + TC - 1) / TC, gy, batch);
  idwt2d_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, h, v, d, out, lr, lc, make_taps(rec_lo, rec_hi, hlen), hlen);
  return static_cast<int>(cudaGetLastError());
}
