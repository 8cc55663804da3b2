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
// memory: at hlen 6, 144 FMAs, 18 us of float32 FMAs at 2048^2 against 25
// us of bytes, so device memory bounds both kernels at small banks and the
// FMAs at hlen 8 and up.
//
// K18a's design: one thread per output pixel, a block a BR x BC tile; row
// tiles on the grid's y axis and planes on its z axis, in chunks where a
// launch cannot hold them all (launch_chunks in common.cuh). Each tap of
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
// the parameter limit.
//
// K18b's design: a block owns output rows of one residue class mod the
// dilation (K9's tiling, swt2d.cu), so its taps read only tr + hlen - 1
// rows at any level; it resolves each staged row's four source rows once
// (a row table) and stages the four planes' column windows, tc + (hlen -
// 1) (f mod Nc) samples wide, in shared memory by cp.async
// (stage::copy_windows of level2d.cuh: 16-byte copies from the 16-byte
// boundary below the window where Nc and the plane allow, read shifted;
// one-sample copies otherwise), or, where the windows do not fit
// kStencilBudget (deep levels, wide banks, float64), reads the same rows
// through the read-only cache. A thread computes several rows of one
// column and walks its staged rows once, loading each sample once for
// every output it meets: (8 + hlen - 1) 4 hlen shared-memory loads per 8
// outputs, 39 a pixel at hlen 6, not the 144 through L1 of one thread per
// pixel. Each output keeps one
// accumulator and sums by fmadd in the map's order (k, then l, then a, h,
// v, d), whatever the form or tile. Two forms run this walk:
// - the fast form (float32, hlen <= 8, levels whose dilation mod Nc is at
//   most 4, so levels 1-3 of any plane): one instance per hlen, the walk
//   unrolled whole, the taps kernel parameters that the FMAs take as
//   operands, windows at compile-time strides, so each sample is one
//   shared-memory load at a constant offset from one of hlen column
//   pointers; 32 x 64 tiles of 8 rows a thread (16 x 64, 4 rows, at hlen
//   7-8, whose walk would spill), two blocks per SM;
// - the generic form (any level, bank and type): taps copied to shared
//   memory per block, the walk unrolled for hlen <= 8 (else over the taps of
//   a row only), 32 x 64 tiles of 8 rows a thread staged, else 16 x 64 of 4
//   staged, else 32 x 64 read directly.
// Measured on an H100 (PERF.md): the staging and the walk take about 45
// and 39 us of a 2048^2 level alone and overlap only in part; persistent
// blocks with two window buffers, bulk copies (cp.async.bulk) and 128-
// column tiles did not shorten the level.

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "level2d.cuh"

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

// -- K18b: the stencil synthesis ---------------------------------------------
//
// One level of K18b's tiling (host): output rows of one residue class, as
// K9's RowPlan (swt2d.cu), and the column windows of its SynPlan.
struct StencilPlan {
  int cls;        // residue classes of the rows: the dilation, or nr
  int tr;         // output rows of a block, a multiple of its rows per thread
  int tiles;      // blocks per class
  int rows;       // staged rows of a block: tr + hlen - 1
  int back;       // hlen - 1 - s: staged row q holds plane row
                  // rho + cls m0 + (q - back) fmr of the block (rho, m0)
  long long fmr;  // the dilation mod nr
  int fmc;        // the dilation mod nc
  int cback;      // (hlen - 1 - s) fmc mod nc
  int ldw;        // window row stride in samples; 0: direct reads
  int quads;      // 16-byte copies: nc a multiple of 16 bytes of samples
  int nq;         // copies per window row and plane
};

// Banks of at most kSmallTaps x kSmallTaps taps run walks unrolled over
// both tap indices.
constexpr int kSmallTaps = 8;

// The fast form's taps, [k][l][b] (b fastest): kernel parameters, which
// its unrolled walk takes as operands.
template <int kHl>
struct FastTaps {
  float f[4 * kHl * kHl];
};

// K18b's tiles: kStencilTC columns, kR rows per thread, so kThreads /
// kStencilTC * kR rows of one residue class.
constexpr int kStencilTC = 64;
// Dynamic shared memory a block with staged windows may take: two such
// blocks, with the 1 KB the runtime keeps for each, fit in an SM's 228 KB.
constexpr int kStencilBudget = 113 * 1024;
// The fast form (ins_swt2d_fast) takes levels whose dilation mod nc is at
// most kFastFm: levels 1-3 of any plane.
constexpr int kFastFm = 4;

// The fast form's window row stride for hl taps: kStencilTC + (hl - 1)
// kFastFm samples and a shift of up to 3 (16 bytes of floats), a multiple
// of 4 samples.
__host__ __device__ constexpr int fast_ldw(int hl) {
  return (kStencilTC + (hl - 1) * kFastFm + 3 + 3) / 4 * 4;
}

// The fast form's rows a thread: 8, or 4 for banks of 7 or 8 taps, whose
// walk at 8 rows outgrows the registers of two blocks per SM.
__host__ __device__ constexpr int fast_rows(int hl) { return hl <= 6 ? 8 : 4; }

// A block's staging: the row table (src[p rows + q]: plane p's row of
// staged row q, for a, h, v, d), the bank's taps where kTaps (Vec4 per
// (k, l) into s_f, `stride` a row k), then, where ldw > 0, the four
// windows by stage::copy_windows (K9's): window column w holds plane column
// c0 - cback + w (mod nc), from the 16-byte boundary at or below it where
// the copies are 16 bytes. Returns the window's shift: the samples it
// starts before column c0 - cback.
template <class T, bool kTaps, class Bank>
__device__ __forceinline__ int stage_block(
    const T* a, const T* h, const T* v, const T* d, int nr, int nc,
    const Bank& bank, const StencilPlan& sp, int hlen, int stride, int ldw,
    int plane_w, int rho, int m0, int c0, long long pb, T* win,
    Vec4<T>* s_f, const T** src) {
  const int tid = threadIdx.x;
  const int rows = sp.rows;
  if (tid < rows) {
    long long r = rho + static_cast<long long>(sp.cls) * m0 +
                  static_cast<long long>(tid - sp.back) * sp.fmr;
    r %= nr;
    if (r < 0) r += nr;
    const T* const body[4] = {a + pb, h + pb, v + pb, d + pb};
#pragma unroll
    for (int p = 0; p < 4; ++p) src[p * rows + tid] = body[p] + r * nc;
  }
  if constexpr (kTaps) {
    T* f = reinterpret_cast<T*>(s_f);
    for (int i = tid; i < 4 * hlen * hlen; i += kThreads) {
      const int kl = i >> 2;
      f[4 * (kl + kl / hlen * (stride - hlen)) + (i & 3)] = bank.f[i];
    }
  }
  __syncthreads();
  int shift = 0;
  if (ldw) {
    constexpr int kVec = 16 / sizeof(T);
    int first = c0 - sp.cback;
    if (first < 0) first += nc;
    if (sp.quads) {
      shift = first % kVec;
      first -= shift;
    }
    stage::copy_windows<T, 4, false>(src, win, rows, ldw, plane_w, first,
                                     sp.nq, sp.quads, nc, 0);
    __syncthreads();
  }
  return shift;
}

// The generic form, any level and bank. Output p0 + i of a thread (i < kR)
// at tap (k, l) reads staged row p0 + hlen - 1 - u, u = k - i, at window
// column c + (hlen - 1 - l) fmc (kStaged) or plane column col + coff[l]
// (direct, through the read-only cache). The thread walks its staged rows
// once, u ascending (staged rows descending), each row's taps l ascending
// and the planes a, h, v, d, and adds every sample to each output that
// meets it: each output keeps one accumulator and sums k, then l, then a,
// h, v, d, ascending, so that no output depends on the form, the tile or
// the rows a thread takes. The taps: the bank
// (Bank2D, or BankPtr in float64) that the block copies to shared memory as
// Vec4 per (k, l), kH taps a row where kH = kSmallTaps, else hlen. kH =
// kSmallTaps unrolls the walk; kH = kMaxTaps unrolls only the taps l of a
// row. Dynamic shared memory: the windows (kStaged: 4 planes of rows x
// ldw), the taps and the row table (4 x rows pointers).
template <class T, int kH, int kR, bool kStaged, class Bank>
__global__ void __launch_bounds__(kThreads)
ins_swt2d_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ v, const T* __restrict__ d,
                 T* __restrict__ out, int nr, int nc, Bank bank,
                 StencilPlan sp, TapOffsets coff, int hlen, unsigned y0) {
  using V4 = Vec4<T>;
  constexpr bool kUnrolled = kH <= kSmallTaps;
  constexpr int kTC = kStencilTC;
  const int tid = threadIdx.x;
  const unsigned by = y0 + blockIdx.y;  // unsigned: the cheaper division
  const int rho = by / sp.tiles;
  const int m0 = (by - rho * sp.tiles) * sp.tr;
  const int c0 = blockIdx.x * kTC;
  const int rows = sp.rows;
  const int plane_w = kStaged ? rows * sp.ldw : 0;
  const int stride = kUnrolled ? kH : hlen;  // taps of a row k in s_f
  const long long pb = blockIdx.z * (static_cast<long long>(nr) * nc);
  T* win = dynamic_smem<T>();
  V4* s_f = reinterpret_cast<V4*>(win + 4 * plane_w);
  const T** src = reinterpret_cast<const T**>(s_f + hlen * stride);
  const int shift = stage_block<T, true>(a, h, v, d, nr, nc, bank, sp, hlen,
                                         stride, kStaged ? sp.ldw : 0,
                                         plane_w, rho, m0, c0, pb, win, s_f,
                                         src);

  const int c = tid % kTC, p0 = tid / kTC * kR, col = c0 + c;
  if (col >= nc || p0 >= sp.tr) return;
  T acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = T(0);

  // Staged row p0 + hlen - 1 - u into the outputs i that meet it, at tap
  // k = u + i.
  const auto row = [&](int u) {
    const int q = p0 + hlen - 1 - u;
    const T* w = win + q * sp.ldw + shift + c + (hlen - 1) * sp.fmc;
    const T* s[4];
    if constexpr (!kStaged) {
#pragma unroll
      for (int p = 0; p < 4; ++p) s[p] = src[p * rows + q];
    }
#pragma unroll
    for (int l = 0; l < kH; ++l) {
      if (l >= hlen) break;
      T x[4];
      if constexpr (kStaged) {
#pragma unroll
        for (int p = 0; p < 4; ++p) x[p] = w[p * plane_w - l * sp.fmc];
      } else {
        int j = col + coff.k[l];
        if (j >= nc) j -= nc;
#pragma unroll
        for (int p = 0; p < 4; ++p) x[p] = __ldg(s[p] + j);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k = u + i;
        if (k < 0 || k >= hlen) continue;
        const V4 t = s_f[k * stride + l];
        acc[i] = fmadd(x[0], t.x, acc[i]);
        acc[i] = fmadd(x[1], t.y, acc[i]);
        acc[i] = fmadd(x[2], t.z, acc[i]);
        acc[i] = fmadd(x[3], t.w, acc[i]);
      }
    }
  };
  if constexpr (kUnrolled) {
#pragma unroll
    for (int u = 1 - kR; u < kH; ++u) {
      if (u >= hlen) break;
      row(u);
    }
  } else {
#pragma unroll 1
    for (int u = 1 - kR; u < hlen; ++u) row(u);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const long long orow = rho + static_cast<long long>(sp.cls) * (m0 + p0 + i);
    if (orow < nr) out[pb + orow * nc + col] = acc[i];
  }
}

// The fast form, float32: a bank of exactly kHl <= kSmallTaps taps as
// operands, windows staged at the strides fast_ldw (levels whose dilation
// mod nc is at most kFastFm), fast_rows(kHl) rows a thread. The walk is
// the generic form's, with every bound and every offset but the dilation a
// constant: the thread holds one window pointer per tap l, and each sample
// is one shared-memory load at a constant offset from it (the row, the
// plane).
template <int kHl>
__global__ void __launch_bounds__(kThreads, 2)
ins_swt2d_fast(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ v, const float* __restrict__ d,
               float* __restrict__ out, int nr, int nc,
               FastTaps<kHl> taps, StencilPlan sp, TapOffsets, int,
               unsigned y0) {
  constexpr int kTC = kStencilTC, kR = fast_rows(kHl);
  constexpr int kLdw = fast_ldw(kHl);
  constexpr int kPlane = (kThreads / kTC * kR + kHl - 1) * kLdw;
  const int tid = threadIdx.x;
  const unsigned by = y0 + blockIdx.y;
  const int rho = by / sp.tiles;
  const int m0 = (by - rho * sp.tiles) * sp.tr;
  const int c0 = blockIdx.x * kTC;
  const long long pb = blockIdx.z * (static_cast<long long>(nr) * nc);
  float* win = dynamic_smem<float>();
  const float** src = reinterpret_cast<const float**>(win + 4 * kPlane);
  const int shift = stage_block<float, false>(
      a, h, v, d, nr, nc, taps, sp, kHl, kHl, kLdw, kPlane, rho, m0, c0, pb,
      win, nullptr, src);

  const int c = tid % kTC, p0 = tid / kTC * kR, col = c0 + c;
  if (col >= nc || p0 >= sp.tr) return;
  // tap l's window column, at staged row p0 + kHl - 1 (u = 0)
  const float* at[kHl];
#pragma unroll
  for (int l = 0; l < kHl; ++l)
    at[l] = win + (p0 + kHl - 1) * kLdw + shift + c + (kHl - 1 - l) * sp.fmc;
  float acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.f;
#pragma unroll
  for (int u = 1 - kR; u < kHl; ++u) {
#pragma unroll
    for (int l = 0; l < kHl; ++l) {
      float x[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) x[p] = at[l][p * kPlane - u * kLdw];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k = u + i;
        if (k < 0 || k >= kHl) continue;
        const int t = 4 * (k * kHl + l);
        acc[i] = fmadd(x[0], taps.f[t], acc[i]);
        acc[i] = fmadd(x[1], taps.f[t + 1], acc[i]);
        acc[i] = fmadd(x[2], taps.f[t + 2], acc[i]);
        acc[i] = fmadd(x[3], taps.f[t + 3], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const long long orow = rho + static_cast<long long>(sp.cls) * (m0 + p0 + i);
    if (orow < nr) out[pb + orow * nc + col] = acc[i];
  }
}

// The plan of a level of (nr, nc) planes for tiles of `tile` rows, r a
// thread (s the centre), its windows staged where they fit kStencilBudget
// (at the row stride `ldw` where it is given, else the least that holds
// them); *smem the block's dynamic shared memory in bytes, `taps` of them
// the taps', `planes` rows x stride samples a plane where given.
template <class T>
StencilPlan stencil_plan(int nr, int nc, int level, int s, int hlen,
                         int tile, int r, size_t taps, size_t* smem,
                         int ldw_fixed = 0, long long plane_fixed = 0) {
  constexpr int kVec = 16 / sizeof(T);
  StencilPlan p{};
  const bool every_row = level > 31 || (1LL << (level - 1)) >= nr;
  p.cls = every_row ? nr : 1 << (level - 1);
  const int per = (nr + p.cls - 1) / p.cls;  // rows of class 0, the longest
  p.tr = std::min(tile, (per + r - 1) / r * r);
  p.tiles = (per + p.tr - 1) / p.tr;
  p.rows = p.tr + hlen - 1;
  p.back = hlen - 1 - s;
  p.fmr = dilation_mod(level, nr);
  const long long fm = dilation_mod(level, nc);
  p.fmc = static_cast<int>(fm);
  p.cback = static_cast<int>((hlen - 1 - s) * fm % nc);
  const size_t rest = taps + 4 * sizeof(const T*) * p.rows;
  const long long width = kStencilTC + (hlen - 1) * fm;
  const long long least = (width + kVec - 1 + 3) / 4 * 4;
  const long long ldw = ldw_fixed ? ldw_fixed : least;
  const long long plane = plane_fixed ? plane_fixed : p.rows * ldw;
  const long long staged = 4 * sizeof(T) * plane + rest;
  *smem = rest;
  if (least <= ldw && staged <= kStencilBudget) {
    p.ldw = static_cast<int>(ldw);
    p.quads = nc % kVec == 0;
    p.nq = static_cast<int>(p.quads ? ldw / kVec : width);
    *smem = static_cast<size_t>(staged);
  }
  return p;
}

template <class T, class Taps>
using StencilKernel = void (*)(const T*, const T*, const T*, const T*, T*,
                               int, int, Taps, StencilPlan, TapOffsets, int,
                               unsigned);

// One level's instance: the kernel (taking its taps as Taps), its plan and
// dynamic shared memory.
template <class T, class Taps>
struct Stencil {
  StencilKernel<T, Taps> kernel;
  StencilPlan plan;
  size_t smem;
};

// The generic form's instance of a level: 32-row tiles, 8 rows a thread,
// with staged windows; else 16-row tiles, 4 rows a thread, with staged
// windows (deeper levels); else 32-row tiles reading through the read-only
// cache.
template <class T, int kH, class Bank>
Stencil<T, Bank> pick_stencil(int nr, int nc, int level, int centre,
                              int hlen) {
  const size_t taps =
      sizeof(Vec4<T>) * hlen * (kH <= kSmallTaps ? kH : hlen);
  Stencil<T, Bank> st;
  st.plan = stencil_plan<T>(nr, nc, level, centre, hlen, 32, 8, taps,
                            &st.smem);
  if (st.plan.ldw) {
    st.kernel = ins_swt2d_kernel<T, kH, 8, true, Bank>;
    return st;
  }
  size_t smem;
  const StencilPlan small =
      stencil_plan<T>(nr, nc, level, centre, hlen, 16, 4, taps, &smem);
  if (small.ldw) {
    st.plan = small;
    st.smem = smem;
    st.kernel = ins_swt2d_kernel<T, kH, 4, true, Bank>;
    return st;
  }
  st.kernel = ins_swt2d_kernel<T, kH, 8, false, Bank>;
  return st;
}

// The fast form's instance of a level, or none (kernel null) where the
// level's dilation mod nc passes kFastFm.
template <int kHl>
Stencil<float, FastTaps<kHl>> pick_fast(int nr, int nc, int level,
                                        int centre) {
  constexpr int kLdw = fast_ldw(kHl), kTR = 4 * fast_rows(kHl);
  Stencil<float, FastTaps<kHl>> st{};
  st.plan = stencil_plan<float>(nr, nc, level, centre, kHl, kTR,
                                fast_rows(kHl), 0, &st.smem, kLdw,
                                (kTR + kHl - 1LL) * kLdw);
  if (st.plan.ldw && st.plan.fmc <= kFastFm)
    st.kernel = ins_swt2d_fast<kHl>;
  return st;
}

// A level's call: its arguments, and where the caller asks for them in
// place of a launch, the figures of its instance (occupancy: resident
// blocks per SM, dynamic shared memory, tile rows and columns, staged).
template <class T>
struct IswtCall {
  const T *a, *h, *v, *d;
  T* out;
  int batch, nr, nc, level, centre, hlen, device;
  void* stream;
  int* occupancy;   // null: launch
  TapOffsets coff;  // the level's column offsets (plan_level)
};

// K18b's level on the picked instance: launched (blocks: column tiles x
// row tiles x planes, in chunks where a launch cannot hold them all), or
// its occupancy reported.
template <class T, class Taps>
int run_stencil(const Stencil<T, Taps>& st, const Taps& taps,
                const IswtCall<T>& call) {
  const auto kernel = st.kernel;
  cudaError_t err = cudaSetDevice(call.device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(st.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const StencilPlan& sp = st.plan;
  if (int* o = call.occupancy) {
    o[1] = static_cast<int>(st.smem);
    o[2] = sp.tr;
    o[3] = kStencilTC;
    o[4] = sp.ldw > 0;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        o, kernel, kThreads, st.smem));
  }
  const int nr = call.nr, nc = call.nc;
  launch_chunks((nc + kStencilTC - 1) / kStencilTC, sp.cls * sp.tiles,
                call.batch, [&](dim3 grid, int y0, int z0) {
                  const long long p = static_cast<long long>(z0) * nr * nc;
                  kernel<<<grid, kThreads, st.smem,
                           static_cast<cudaStream_t>(call.stream)>>>(
                      call.a + p, call.h + p, call.v + p, call.d + p,
                      call.out + p, nr, nc, taps, sp, call.coff, call.hlen,
                      y0);
                });
  return static_cast<int>(cudaGetLastError());
}

// The call's column offsets, or false if its arguments are out of range.
template <class T>
bool check(IswtCall<T>* call) {
  TapOffsets roff;
  return plan_level(call->batch, call->nr, call->nc, call->level,
                    call->centre, call->hlen, &roff, &call->coff);
}

// The generic form on the bank (Bank2D, or BankPtr in float64).
template <class T, class Bank>
int run_generic(const Bank& bank, const IswtCall<T>& call) {
  const int nr = call.nr, nc = call.nc, level = call.level, hlen = call.hlen;
  return hlen > kSmallTaps
             ? run_stencil(pick_stencil<T, kMaxTaps, Bank>(
                               nr, nc, level, call.centre, hlen),
                           bank, call)
             : run_stencil(pick_stencil<T, kSmallTaps, Bank>(
                               nr, nc, level, call.centre, hlen),
                           bank, call);
}

// fn(std::integral_constant<int, hlen>) for hlen in [kHl, kSmallTaps].
template <int kHl = 1, class Fn>
int with_hlen(int hlen, Fn fn) {
  if (hlen == kHl) return fn(std::integral_constant<int, kHl>{});
  if constexpr (kHl < kSmallTaps) return with_hlen<kHl + 1>(hlen, fn);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K18b in float32: the fast form where it takes the level, else the
// generic one; rec the synthesis filters (null for an occupancy query),
// scaled here by 1/4 (exact in float32: the reference's 1/4 of the
// inverse).
inline int iswt_f32(const float* rec, IswtCall<float> call) {
  if (!check(&call)) return static_cast<int>(cudaErrorInvalidValue);
  const int hlen = call.hlen;
  if (hlen <= kSmallTaps) {
    const int err = with_hlen(hlen, [&](auto hl) {
      constexpr int kHl = decltype(hl)::value;
      const Stencil<float, FastTaps<kHl>> st =
          pick_fast<kHl>(call.nr, call.nc, call.level, call.centre);
      if (!st.kernel) return -1;
      FastTaps<kHl> taps{};
      for (int b = 0; rec && b < 4; ++b)
        for (int i = 0; i < kHl * kHl; ++i)
          taps.f[4 * i + b] = 0.25f * rec[b * kHl * kHl + i];
      return run_stencil(st, taps, call);
    });
    if (err != -1) return err;
  }
  return run_generic(rec ? make_bank(rec, hlen, 0.25f) : Bank2D{}, call);
}

// K18b in float64 on the device bank (BankPtr, x 1/4): the generic form.
inline int iswt_f64(const double* bank, IswtCall<double> call) {
  if (!check(&call)) return static_cast<int>(cudaErrorInvalidValue);
  return run_generic(BankPtr<double>{bank}, call);
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
  return pypwt::iswt_f32(rec, {a, h, v, d, out, batch, nr, nc, level,
                               centre, hlen, device, stream, nullptr});
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
  return pypwt::iswt_f64(bank, {a, h, v, d, out, batch, nr, nc, level,
                                centre, hlen, device, stream, nullptr});
}

// K18b's instance for one level of (nr, nc) planes (f64 1: the float64
// one): resident blocks per SM, dynamic shared memory in bytes, the tile's
// rows and columns, and 1 where its windows are staged in shared memory,
// 0 where it reads through the read-only cache. A figure for reports; no
// bank is read.
extern "C" int pypwt_ins_swt2d_occupancy(int nr, int nc, int level,
                                         int centre, int hlen, int f64,
                                         int device, int* blocks, int* smem,
                                         int* tr, int* tc, int* staged) {
  using namespace pypwt;
  int o[5] = {};
  const int err =
      f64 ? iswt_f64(nullptr, {nullptr, nullptr, nullptr, nullptr, nullptr,
                               1, nr, nc, level, centre, hlen, device,
                               nullptr, o})
          : iswt_f32(nullptr, {nullptr, nullptr, nullptr, nullptr, nullptr,
                               1, nr, nc, level, centre, hlen, device,
                               nullptr, o});
  *blocks = o[0];
  *smem = o[1];
  *tr = o[2];
  *tc = o[3];
  *staged = o[4];
  return err;
}
