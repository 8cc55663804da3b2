// K18a / K18b: one periodized non-separable 2D stationary (a-trous) level
// and its inverse, float32 or float64, with four dense hlen x hlen
// filters.
//
// Replace the TPU kernel pypwt_tpu/ops/nonsep_pallas.py::_build_ns_swt2d
// (:344; one build function with an `inverse` flag behind ns_swt2d_fused,
// :358, and ins_swt2d_fused, :375) as two kernels.
//
// Maps (pypwt_tpu/core/nonsep.py:283-352), planes of (B?, Nr, Nc), any
// hlen <= 40, level l >= 1, factor f = 2^(l-1):
//   K18a: out_b[r, c] = sum_{k,l} F_b[k, l] * x[r + (s-k) f, c + (s-l) f],
//         s = hlen/2, for the four analysis filters b = a, h, v, d;
//   K18b: out[r, c] = 1/4 sum_b sum_{k,l} R_b[k, l] * p_b[r + (s-k) f,
//         c + (s-l) f], s = hlen/2 - 1 for even hlen and hlen/2 for odd,
//         over the four planes p_b = a, h, v, d and synthesis filters R_b;
// indices wrapped mod Nr and Nc, with the centre s given by the caller
// (conv.swt_centre). The first filter index runs along axis -2.
//
// The TPU kernel factors each filter into rank-1 terms by SVD because
// Mosaic lowers no dense 2D stencil; this is the direct stencil of the
// reference CUDA kernels (nonseparable.cu:304-401), which needs no
// factoring and takes every bank.
//
// Bound: 4 hlen^2 FMAs per pixel against 20 bytes moved to and from device
// memory: at hlen 6, 144 FMAs. The hlen^2 (K18b: 4 hlen^2) loads per pixel
// through L1, and the FMAs, bound it before device memory does.
//
// Design: one thread per output pixel, a block a BR x BC tile; row tiles
// on the grid's y axis and planes on its z axis, in chunks where a launch
// cannot hold them all (launch_chunks in common.cuh). Each tap of
// a warp reads 32 consecutive words of one plane row through the read-only
// cache; neighbouring taps hit the same lines in L1. Row and column tap
// offsets are reduced mod Nr and Nc on the host, so any level and any wrap
// wider than the plane take one conditional subtraction.
// The bank (4 hlen^2 floats, up to 25,600 bytes at hlen 40) is a kernel
// parameter struct: CUDA 12.1+ on sm_90 takes up to 32,764 bytes of
// parameters, so a call copies nothing to the device and two launches with
// different banks cannot race, as a __constant__ bank set per call could.
// The host interleaves the four filters tap by tap ([k][l][b]), and the
// block copies them into shared memory once: a warp then reads the four
// filters' taps of one (k, l) as one 16-byte word, which shared memory
// broadcasts, so each input sample costs one tap load for its four FMAs.
// The float64 instances (pypwt_ns_swt2d_f64, pypwt_ins_swt2d_f64) read a
// bank the wrapper uploaded once (BankPtr): 51,200 bytes at hlen 40, past
// the parameter limit, and as many of shared memory, past the 48 KB a
// block gets without opting in.

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int BR = 8;   // output rows per block
constexpr int BC = 32;  // output columns per block: one warp per row
static_assert(BR * BC == kThreads, "one thread per output pixel");

__device__ __forceinline__ int wrap_once(int i, int n) {
  return i >= n ? i - n : i;
}

template <class T, class Bank>
__device__ __forceinline__ void load_bank(const Bank& bank, int n2,
                                          const TapOffsets& roff,
                                          const TapOffsets& coff, int hlen,
                                          Vec4<T>* s_f, int* s_roff,
                                          int* s_coff) {
  T* dst = reinterpret_cast<T*>(s_f);
  for (int i = threadIdx.x; i < 4 * n2; i += kThreads) dst[i] = bank.f[i];
  if (threadIdx.x < hlen) {
    s_roff[threadIdx.x] = roff.k[threadIdx.x];
    s_coff[threadIdx.x] = coff.k[threadIdx.x];
  }
  __syncthreads();
}

template <class T, class Bank>
__global__ void __launch_bounds__(kThreads)
ns_swt2d_kernel(const T* __restrict__ x, T* __restrict__ a,
                T* __restrict__ h, T* __restrict__ v, T* __restrict__ d,
                int nr, int nc, Bank bank, TapOffsets roff, TapOffsets coff,
                int hlen, int y0) {
  using V4 = Vec4<T>;
  V4* s_f = dynamic_smem<V4>();  // [hlen][hlen], one tap of each filter
  __shared__ int s_roff[kMaxTaps], s_coff[kMaxTaps];
  const int n2 = hlen * hlen;
  load_bank<T>(bank, n2, roff, coff, hlen, s_f, s_roff, s_coff);

  const int r = (y0 + blockIdx.y) * BR + threadIdx.x / BC;
  const int c = blockIdx.x * BC + threadIdx.x % BC;
  if (r >= nr || c >= nc) return;
  const long long plane = static_cast<long long>(nr) * nc;
  const T* xb = x + blockIdx.z * plane;
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  for (int k = 0; k < hlen; ++k) {
    const T* xr =
        xb + static_cast<long long>(wrap_once(r + s_roff[k], nr)) * nc;
    const V4* f = s_f + k * hlen;
    for (int l = 0; l < hlen; ++l) {
      const T val = __ldg(xr + wrap_once(c + s_coff[l], nc));
      const V4 t = f[l];
      s0 = fmadd(val, t.x, s0);
      s1 = fmadd(val, t.y, s1);
      s2 = fmadd(val, t.z, s2);
      s3 = fmadd(val, t.w, s3);
    }
  }
  const long long o = blockIdx.z * plane + static_cast<long long>(r) * nc + c;
  a[o] = s0;
  h[o] = s1;
  v[o] = s2;
  d[o] = s3;
}

template <class T, class Bank>
__global__ void __launch_bounds__(kThreads)
ins_swt2d_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ v, const T* __restrict__ d,
                 T* __restrict__ out, int nr, int nc, Bank quarter_bank,
                 TapOffsets roff, TapOffsets coff, int hlen, int y0) {
  using V4 = Vec4<T>;
  V4* s_f = dynamic_smem<V4>();  // [hlen][hlen] x 4 filters, x 1/4
  __shared__ int s_roff[kMaxTaps], s_coff[kMaxTaps];
  const int n2 = hlen * hlen;
  load_bank<T>(quarter_bank, n2, roff, coff, hlen, s_f, s_roff, s_coff);

  const int r = (y0 + blockIdx.y) * BR + threadIdx.x / BC;
  const int c = blockIdx.x * BC + threadIdx.x % BC;
  if (r >= nr || c >= nc) return;
  const long long plane = static_cast<long long>(nr) * nc;
  const long long pb = blockIdx.z * plane;
  T s = 0;
  for (int k = 0; k < hlen; ++k) {
    const long long rb =
        pb + static_cast<long long>(wrap_once(r + s_roff[k], nr)) * nc;
    const V4* f = s_f + k * hlen;
    for (int l = 0; l < hlen; ++l) {
      const long long j = rb + wrap_once(c + s_coff[l], nc);
      const V4 t = f[l];
      s = fmadd(__ldg(a + j), t.x, s);
      s = fmadd(__ldg(h + j), t.y, s);
      s = fmadd(__ldg(v + j), t.z, s);
      s = fmadd(__ldg(d + j), t.w, s);
    }
  }
  out[pb + static_cast<long long>(r) * nc + c] = s;
}

// The level's tap offsets, or false if the arguments are out of range.
bool plan_level(int batch, int nr, int nc, int level, int s, int hlen,
                TapOffsets* roff, TapOffsets* coff) {
  if (hlen < 1 || hlen > kMaxTaps || s < 0 || s >= hlen || nr < 1 ||
      nc < 1 || nr > 0x3fffffff || nc > 0x3fffffff || level < 1 || batch < 1)
    return false;
  *roff = dilated_offsets(hlen, s, level, nr);
  *coff = dilated_offsets(hlen, s, level, nc);
  return true;
}

// The level's tap offsets and the kernel's dynamic shared memory (the
// bank: up to 25.6 KB in float32, 51.2 KB in float64 at hlen 40, opted
// into), or an error.
template <class T, class Kernel>
cudaError_t prepare(Kernel kernel, int batch, int nr, int nc, int level,
                    int centre, int hlen, int device, TapOffsets* roff,
                    TapOffsets* coff, size_t* smem) {
  if (!plan_level(batch, nr, nc, level, centre, hlen, roff, coff))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  *smem = sizeof(Vec4<T>) * hlen * hlen;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// K18a with its bank (Bank2D by value, or BankPtr to device memory).
template <class T, class Bank>
int launch_swt(const T* x, T* a, T* h, T* v, T* d, int batch, int nr, int nc,
               int level, int centre, const Bank& bank, int hlen, int device,
               void* stream) {
  const auto kernel = ns_swt2d_kernel<T, Bank>;
  TapOffsets roff, coff;
  size_t smem;
  const cudaError_t err = prepare<T>(kernel, batch, nr, nc, level, centre,
                                     hlen, device, &roff, &coff, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_chunks((nc + BC - 1) / BC, (nr + BR - 1) / BR, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long p = static_cast<long long>(z0) * nr * nc;
                  kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
                      x + p, a + p, h + p, v + p, d + p, nr, nc, bank, roff,
                      coff, hlen, y0);
                });
  return static_cast<int>(cudaGetLastError());
}

// K18b with its bank (the synthesis filters x 1/4).
template <class T, class Bank>
int launch_iswt(const T* a, const T* h, const T* v, const T* d, T* out,
                int batch, int nr, int nc, int level, int centre,
                const Bank& bank, int hlen, int device, void* stream) {
  const auto kernel = ins_swt2d_kernel<T, Bank>;
  TapOffsets roff, coff;
  size_t smem;
  const cudaError_t err = prepare<T>(kernel, batch, nr, nc, level, centre,
                                     hlen, device, &roff, &coff, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_chunks((nc + BC - 1) / BC, (nr + BR - 1) / BR, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long p = static_cast<long long>(z0) * nr * nc;
                  kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
                      a + p, h + p, v + p, d + p, out + p, nr, nc, bank,
                      roff, coff, hlen, y0);
                });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pypwt

// All return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. `centre` is the a-trous centre s of the direction.
// dec/rec: host arrays of 4 * hlen * hlen floats, [b][k][l].
extern "C" int pypwt_ns_swt2d(const float* x, float* a, float* h, float* v,
                              float* d, int batch, int nr, int nc, int level,
                              int centre, const float* dec, int hlen,
                              int device, void* stream) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_swt(x, a, h, v, d, batch, nr, nc, level, centre,
                    make_bank(dec, hlen, 1.f), hlen, device, stream);
}

extern "C" int pypwt_ins_swt2d(const float* a, const float* h, const float* v,
                               const float* d, float* out, int batch, int nr,
                               int nc, int level, int centre, const float* rec,
                               int hlen, int device, void* stream) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  // rec / 4 is exact in float32: the reference's 1/4 of the inverse
  return launch_iswt(a, h, v, d, out, batch, nr, nc, level, centre,
                     make_bank(rec, hlen, 0.25f), hlen, device, stream);
}

// The float64 K18a/K18b: `bank` is the device copy of pypwt_ns_bank_f64's
// layout 2 (K18a) or 3 (K18b, x 1/4).
extern "C" int pypwt_ns_swt2d_f64(const double* x, double* a, double* h,
                                  double* v, double* d, int batch, int nr,
                                  int nc, int level, int centre,
                                  const double* bank, int hlen, int device,
                                  void* stream) {
  return pypwt::launch_swt(x, a, h, v, d, batch, nr, nc, level, centre,
                           pypwt::BankPtr<double>{bank}, hlen, device,
                           stream);
}

extern "C" int pypwt_ins_swt2d_f64(const double* a, const double* h,
                                   const double* v, const double* d,
                                   double* out, int batch, int nr, int nc,
                                   int level, int centre, const double* bank,
                                   int hlen, int device, void* stream) {
  return pypwt::launch_iswt(a, h, v, d, out, batch, nr, nc, level, centre,
                            pypwt::BankPtr<double>{bank}, hlen, device,
                            stream);
}
