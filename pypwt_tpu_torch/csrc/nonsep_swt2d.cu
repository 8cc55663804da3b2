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
// memory (K18a: 4 in, 16 out; K18b: 16 in, 4 out): at hlen 6, 144 FMAs, 18
// us of float32 FMAs at 2048^2 against 25 us of bytes, so device memory
// bounds both kernels at small banks and the FMAs at hlen 8 and up (32 us
// at hlen 8).
//
// Both kernels run one stencil body, the mirror image of each other: K18a
// reads one plane and writes four, K18b reads four and writes one. A block
// owns output rows of one residue class mod the dilation (K9's tiling,
// swt2d.cu), so its taps read only tr + hlen - 1 rows at any level; it
// resolves each staged row's source rows once (a row table) and stages the
// input planes' column windows, tc + (hlen - 1) (f mod Nc) samples wide, in
// shared memory by cp.async (stage::copy_windows of level2d.cuh: 16-byte
// copies from the 16-byte boundary below the window where Nc and the plane
// allow, read shifted; one-sample copies otherwise), or, where the windows
// do not fit kStencilBudget (deep levels, wide banks, float64), reads the
// same rows through the read-only cache. A thread computes several rows of
// one column and walks its staged rows once, loading each sample once for
// every output row it meets: (r + hlen - 1) hlen loads of each input plane
// per r rows, at hlen 6 about 14 a pixel for K18a (4 rows a thread) and 39
// for K18b (8 rows), not the 36 and 144 through L1 of one thread per pixel. Each output keeps one
// accumulator and sums by fmadd in the map's order (k, then l, then, in
// K18b, a, h, v, d), whatever the form or tile, so both kernels give the
// outputs of one thread per pixel bit for bit. Two forms run this walk:
// - the fast form (float32, hlen <= 8, levels whose dilation mod Nc is at
//   most 4, so levels 1-3 of any plane): one instance per hlen, the walk
//   unrolled whole, the taps kernel parameters that the FMAs take as
//   operands, windows at compile-time strides, so each sample is one
//   shared-memory load at a constant offset from one of hlen column
//   pointers; K18b: 32 x 64 tiles of 8 rows a thread (16 x 64, 4 rows, at
//   hlen 7-8, whose walk would spill), two blocks per SM; K18a: 16 x 64
//   tiles of 4 rows a thread (16 accumulators), four blocks per SM (three
//   at hlen 7, which spills at four);
// - the generic form (any level, bank and type): taps copied to shared
//   memory per block as one Vec4 per (k, l), which a warp reads as one
//   broadcast word for its four FMAs; the walk unrolled for hlen <= 8 (else
//   over the taps of a row only); 32 x 64 tiles of 8 rows a thread staged,
//   else 16 x 64 of 4 staged, else 32 x 64 read directly (K18a in float64
//   at hlen <= 8: 16 x 64 of 4 rows staged at two blocks per SM while f mod
//   Nc < 64, else 4 x 64 of 1 read directly at six: GenericRows). Its
//   taps: the float32 bank by value (Bank2D: CUDA 12.1+ on sm_90 takes up
//   to 32,764 bytes of parameters, so a call copies nothing to the
//   device), the float64 one from the device copy that the wrapper
//   uploaded once (BankPtr: 51,200 bytes at hlen 40, past the parameter
//   limit).
// Measured on an H100 (PERF.md): K18b's staging and walk take about 45 and
// 39 us of a 2048^2 level alone and overlap only in part; persistent
// blocks with two window buffers, bulk copies (cp.async.bulk) and 128-
// column tiles did not shorten the level. K18a at level 1 of 2048^2 (hlen
// 6) takes about 52 us in float32 and 122 in float64, where the walk's
// Double4 tap loads (two a four FMAs) hold it.

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "level2d.cuh"

namespace pypwt {
namespace {

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

// -- the stencil body ---------------------------------------------------------
//
// One level's tiling (host): output rows of one residue class, as K9's
// RowPlan (swt2d.cu), and the column windows of its SynPlan.
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

// The planes of one level: kIn in (K18a: x; K18b: a, h, v, d), 4 / kIn out
// (K18a: a, h, v, d; K18b: the synthesis). Tap b of each (k, l) takes input
// plane b % kIn into output b % kOut.
template <class T, int kIn>
struct StencilIo {
  static constexpr int kOut = 4 / kIn;
  const T* in[kIn];
  T* out[kOut];

  // The same planes, p samples on (a chunk of a batch).
  StencilIo plus(long long p) const {
    StencilIo io = *this;
    for (auto& q : io.in) q += p;
    for (auto& q : io.out) q += p;
    return io;
  }
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

// The tiles: kStencilTC columns, kR rows per thread, so kThreads /
// kStencilTC * kR rows of one residue class.
constexpr int kStencilTC = 64;
// Dynamic shared memory a block with staged windows may take: two such
// blocks, with the 1 KB the runtime keeps for each, fit in an SM's 228 KB.
constexpr int kStencilBudget = 113 * 1024;
// The fast form takes levels whose dilation mod nc is at most kFastFm:
// levels 1-3 of any plane.
constexpr int kFastFm = 4;

// The fast form's window row stride for hl taps: kStencilTC + (hl - 1)
// kFastFm samples and a shift of up to 3 (16 bytes of floats), a multiple
// of 4 samples.
__host__ __device__ constexpr int fast_ldw(int hl) {
  return (kStencilTC + (hl - 1) * kFastFm + 3 + 3) / 4 * 4;
}

// The fast form's rows a thread for in planes of hl taps: K18b 8, or 4 at
// 7 or 8 taps, whose walk at 8 rows outgrows the registers of two blocks
// per SM; K18a 4, at four blocks per SM (three at 7 taps, which spill at
// four).
__host__ __device__ constexpr int fast_rows(int in, int hl) {
  return in == 1 ? 4 : hl <= 6 ? 8 : 4;
}

// One tap (k, l) of the four filters, t0..t3, on the samples x of the kIn
// input planes into the kOut accumulators of one output, b ascending.
template <int kIn, class T, int kOut>
__device__ __forceinline__ void add_taps(T (&acc)[kOut], const T (&x)[kIn],
                                         T t0, T t1, T t2, T t3) {
  const T t[4] = {t0, t1, t2, t3};
#pragma unroll
  for (int b = 0; b < 4; ++b)
    acc[b % kOut] = fmadd(x[b % kIn], t[b], acc[b % kOut]);
}

// A block's staging: the row table (src[p rows + q]: input plane p's row of
// staged row q), the bank's taps where kTaps (Vec4 per (k, l) into s_f,
// `stride` a row k), then, where ldw > 0, the input windows by
// stage::copy_windows (K9's): window column w holds plane column c0 -
// cback + w (mod nc), from the 16-byte boundary at or below it where the
// copies are 16 bytes. Returns the window's shift: the samples it starts
// before column c0 - cback.
template <class T, int kIn, bool kTaps, class Bank>
__device__ __forceinline__ int stage_block(
    const T* const (&in)[kIn], int nr, int nc, const Bank& bank,
    const StencilPlan& sp, int hlen, int stride, int ldw, int plane_w,
    int rho, int m0, int c0, long long pb, T* win, Vec4<T>* s_f,
    const T** src) {
  const int tid = threadIdx.x;
  const int rows = sp.rows;
  if (tid < rows) {
    long long r = rho + static_cast<long long>(sp.cls) * m0 +
                  static_cast<long long>(tid - sp.back) * sp.fmr;
    r %= nr;
    if (r < 0) r += nr;
#pragma unroll
    for (int p = 0; p < kIn; ++p) src[p * rows + tid] = in[p] + pb + r * nc;
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
    stage::copy_windows<T, kIn, false>(src, win, rows, ldw, plane_w, first,
                                       sp.nq, sp.quads, nc, 0);
    __syncthreads();
  }
  return shift;
}

// The generic form, any level and bank. Output row p0 + i of a thread (i <
// kR) at tap (k, l) reads staged row p0 + hlen - 1 - u, u = k - i, at
// window column c + (hlen - 1 - l) fmc (kStaged) or plane column col +
// coff[l] (direct, through the read-only cache). The thread walks its
// staged rows once, u ascending (staged rows descending), each row's taps
// l ascending, and adds every sample to each output that meets it. The
// taps: the bank (Bank2D, or BankPtr in float64) that the block copies to
// shared memory as Vec4 per (k, l), kH taps a row where kH = kSmallTaps,
// else hlen. kH = kSmallTaps unrolls the walk; kH = kMaxTaps unrolls only
// the taps l of a row. Dynamic shared memory: the windows (kStaged: kIn
// planes of rows x ldw), the taps and the row table (kIn x rows pointers).
template <class T, int kIn, int kH, int kR, bool kStaged, class Bank>
__device__ __forceinline__ void stencil_generic(
    const StencilIo<T, kIn>& io, int nr, int nc, const Bank& bank,
    const StencilPlan& sp, const TapOffsets& coff, int hlen, unsigned y0) {
  using V4 = Vec4<T>;
  constexpr int kOut = StencilIo<T, kIn>::kOut;
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
  V4* s_f = reinterpret_cast<V4*>(win + kIn * plane_w);
  const T** src = reinterpret_cast<const T**>(s_f + hlen * stride);
  const int shift = stage_block<T, kIn, true>(
      io.in, nr, nc, bank, sp, hlen, stride, kStaged ? sp.ldw : 0, plane_w,
      rho, m0, c0, pb, win, s_f, src);

  const int c = tid % kTC, p0 = tid / kTC * kR, col = c0 + c;
  if (col >= nc || p0 >= sp.tr) return;
  T acc[kR][kOut];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc[i][o] = T(0);

  // Staged row p0 + hlen - 1 - u into the outputs i that meet it, at tap
  // k = u + i.
  const auto row = [&](int u) {
    const int q = p0 + hlen - 1 - u;
    const T* w = win + q * sp.ldw + shift + c + (hlen - 1) * sp.fmc;
    const T* s[kIn];
    if constexpr (!kStaged) {
#pragma unroll
      for (int p = 0; p < kIn; ++p) s[p] = src[p * rows + q];
    }
#pragma unroll
    for (int l = 0; l < kH; ++l) {
      if (l >= hlen) break;
      T x[kIn];
      if constexpr (kStaged) {
#pragma unroll
        for (int p = 0; p < kIn; ++p) x[p] = w[p * plane_w - l * sp.fmc];
      } else {
        int j = col + coff.k[l];
        if (j >= nc) j -= nc;
#pragma unroll
        for (int p = 0; p < kIn; ++p) x[p] = __ldg(s[p] + j);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k = u + i;
        if (k < 0 || k >= hlen) continue;
        const V4 t = s_f[k * stride + l];
        add_taps<kIn>(acc[i], x, t.x, t.y, t.z, t.w);
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
    if (orow < nr) {
#pragma unroll
      for (int o = 0; o < kOut; ++o) io.out[o][pb + orow * nc + col] = acc[i][o];
    }
  }
}

// The fast form, float32: a bank of exactly kHl <= kSmallTaps taps as
// operands, windows staged at the strides fast_ldw (levels whose dilation
// mod nc is at most kFastFm), fast_rows(kIn, kHl) rows a thread. The walk
// is the generic form's, with every bound and every offset but the
// dilation a constant: the thread holds one window pointer per tap l, and
// each sample is one shared-memory load at a constant offset from it (the
// row, the plane).
template <int kIn, int kHl>
__device__ __forceinline__ void stencil_fast(const StencilIo<float, kIn>& io,
                                             int nr, int nc,
                                             const FastTaps<kHl>& taps,
                                             const StencilPlan& sp,
                                             unsigned y0) {
  constexpr int kOut = StencilIo<float, kIn>::kOut;
  constexpr int kTC = kStencilTC, kR = fast_rows(kIn, kHl);
  constexpr int kLdw = fast_ldw(kHl);
  constexpr int kPlane = (kThreads / kTC * kR + kHl - 1) * kLdw;
  const int tid = threadIdx.x;
  const unsigned by = y0 + blockIdx.y;
  const int rho = by / sp.tiles;
  const int m0 = (by - rho * sp.tiles) * sp.tr;
  const int c0 = blockIdx.x * kTC;
  const long long pb = blockIdx.z * (static_cast<long long>(nr) * nc);
  float* win = dynamic_smem<float>();
  const float** src = reinterpret_cast<const float**>(win + kIn * kPlane);
  const int shift = stage_block<float, kIn, false>(
      io.in, nr, nc, taps, sp, kHl, kHl, kLdw, kPlane, rho, m0, c0, pb, win,
      nullptr, src);

  const int c = tid % kTC, p0 = tid / kTC * kR, col = c0 + c;
  if (col >= nc || p0 >= sp.tr) return;
  // tap l's window column, at staged row p0 + kHl - 1 (u = 0)
  const float* at[kHl];
#pragma unroll
  for (int l = 0; l < kHl; ++l)
    at[l] = win + (p0 + kHl - 1) * kLdw + shift + c + (kHl - 1 - l) * sp.fmc;
  float acc[kR][kOut];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc[i][o] = 0.f;
#pragma unroll
  for (int u = 1 - kR; u < kHl; ++u) {
#pragma unroll
    for (int l = 0; l < kHl; ++l) {
      float x[kIn];
#pragma unroll
      for (int p = 0; p < kIn; ++p) x[p] = at[l][p * kPlane - u * kLdw];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k = u + i;
        if (k < 0 || k >= kHl) continue;
        const int t = 4 * (k * kHl + l);
        add_taps<kIn>(acc[i], x, taps.f[t], taps.f[t + 1], taps.f[t + 2],
                      taps.f[t + 3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const long long orow = rho + static_cast<long long>(sp.cls) * (m0 + p0 + i);
    if (orow < nr) {
#pragma unroll
      for (int o = 0; o < kOut; ++o) io.out[o][pb + orow * nc + col] = acc[i][o];
    }
  }
}

// The kernels: K18b's forms (a, h, v, d in, out) and K18a's (x in, a, h,
// v, d out), each the stencil body on its planes. The trailing arguments
// are those of every form, unused by some: the bank or taps, the plan, the
// column offsets (direct reads), hlen, the first row block of the launch.
template <class T, int kH, int kR, bool kStaged, class Bank>
__global__ void __launch_bounds__(kThreads)
ins_swt2d_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ v, const T* __restrict__ d,
                 T* __restrict__ out, int nr, int nc, Bank bank,
                 StencilPlan sp, TapOffsets coff, int hlen, unsigned y0) {
  stencil_generic<T, 4, kH, kR, kStaged>(StencilIo<T, 4>{{a, h, v, d}, {out}},
                                         nr, nc, bank, sp, coff, hlen, y0);
}

template <class T, int kH, int kR, bool kStaged, class Bank>
__global__ void __launch_bounds__(kThreads)
ns_swt2d_stencil(const T* __restrict__ x, T* __restrict__ a,
                 T* __restrict__ h, T* __restrict__ v, T* __restrict__ d,
                 int nr, int nc, Bank bank, StencilPlan sp, TapOffsets coff,
                 int hlen, unsigned y0) {
  stencil_generic<T, 1, kH, kR, kStaged>(StencilIo<T, 1>{{x}, {a, h, v, d}},
                                         nr, nc, bank, sp, coff, hlen, y0);
}

// K18a's float64 generic form for hlen <= 8 (GenericRows<double, 1,
// kSmallTaps>): two blocks per SM at 4 rows a thread (left to itself,
// ptxas holds the walk to fewer registers and runs it slower; at three it
// spills), six at 1 (8 bytes spilled, and still faster than four without).
template <class T, int kH, int kR, bool kStaged, class Bank>
__global__ void __launch_bounds__(kThreads, kR >= 4 ? 2 : 6)
ns_swt2d_stencil_f64(const T* __restrict__ x, T* __restrict__ a,
                     T* __restrict__ h, T* __restrict__ v,
                     T* __restrict__ d, int nr, int nc, Bank bank,
                     StencilPlan sp, TapOffsets coff, int hlen,
                     unsigned y0) {
  stencil_generic<T, 1, kH, kR, kStaged>(StencilIo<T, 1>{{x}, {a, h, v, d}},
                                         nr, nc, bank, sp, coff, hlen, y0);
}

template <int kHl>
__global__ void __launch_bounds__(kThreads, 2)
ins_swt2d_fast(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ v, const float* __restrict__ d,
               float* __restrict__ out, int nr, int nc,
               FastTaps<kHl> taps, StencilPlan sp, TapOffsets, int,
               unsigned y0) {
  stencil_fast<4, kHl>(StencilIo<float, 4>{{a, h, v, d}, {out}}, nr, nc,
                       taps, sp, y0);
}

template <int kHl>
__global__ void __launch_bounds__(kThreads, kHl == 7 ? 3 : 4)
ns_swt2d_fast(const float* __restrict__ x, float* __restrict__ a,
              float* __restrict__ h, float* __restrict__ v,
              float* __restrict__ d, int nr, int nc, FastTaps<kHl> taps,
              StencilPlan sp, TapOffsets, int, unsigned y0) {
  stencil_fast<1, kHl>(StencilIo<float, 1>{{x}, {a, h, v, d}}, nr, nc, taps,
                       sp, y0);
}

// The kernels' type: K18b's or K18a's arguments, taps as Taps.
template <class T, int kIn, class Taps>
using StencilKernel = std::conditional_t<
    kIn == 4,
    void (*)(const T*, const T*, const T*, const T*, T*, int, int, Taps,
             StencilPlan, TapOffsets, int, unsigned),
    void (*)(const T*, T*, T*, T*, T*, int, int, Taps, StencilPlan,
             TapOffsets, int, unsigned)>;

template <class T, int kIn, int kH, int kR, bool kStaged, class Bank>
StencilKernel<T, kIn, Bank> generic_kernel() {
  if constexpr (kIn == 4)
    return ins_swt2d_kernel<T, kH, kR, kStaged, Bank>;
  else if constexpr (std::is_same_v<T, double> && kH == kSmallTaps)
    return ns_swt2d_stencil_f64<T, kH, kR, kStaged, Bank>;
  else
    return ns_swt2d_stencil<T, kH, kR, kStaged, Bank>;
}

template <int kIn, int kHl>
StencilKernel<float, kIn, FastTaps<kHl>> fast_kernel() {
  if constexpr (kIn == 4)
    return ins_swt2d_fast<kHl>;
  else
    return ns_swt2d_fast<kHl>;
}

// The plan of a level of (nr, nc) planes, kIn of them in, for tiles of
// `tile` rows, r a thread (s the centre), its windows staged where they
// fit kStencilBudget (at the row stride `ldw` where it is given, never
// where it is -1, else the least that holds them); *smem the block's
// dynamic shared memory in bytes, `taps` of them the taps', `planes` rows
// x stride samples a plane where given.
template <class T, int kIn>
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
  const size_t rest = taps + kIn * sizeof(const T*) * p.rows;
  const long long width = kStencilTC + (hlen - 1) * fm;
  const long long least = (width + kVec - 1 + 3) / 4 * 4;
  const long long ldw = ldw_fixed ? ldw_fixed : least;
  const long long plane = plane_fixed ? plane_fixed : p.rows * ldw;
  const long long staged = kIn * sizeof(T) * plane + rest;
  *smem = rest;
  if (ldw_fixed >= 0 && least <= ldw && staged <= kStencilBudget) {
    p.ldw = static_cast<int>(ldw);
    p.quads = nc % kVec == 0;
    p.nq = static_cast<int>(p.quads ? ldw / kVec : width);
    *smem = static_cast<size_t>(staged);
  }
  return p;
}

// One level's instance: the kernel (taking its taps as Taps), its plan and
// dynamic shared memory.
template <class T, int kIn, class Taps>
struct Stencil {
  StencilKernel<T, kIn, Taps> kernel;
  StencilPlan plan;
  size_t smem;
};

// The generic form's rows a thread (kIn planes in, T samples, kH taps a
// row): with the larger staged tiles, the smaller staged tiles, and direct
// reads; and the largest dilation mod nc at which it stages windows.
template <class T, int kIn, int kH>
struct GenericRows {
  static constexpr int kLarge = 8, kSmall = 4, kDirect = 8;
  static constexpr long long kStagedFm = 0x3fffffff;
};

// K18a in float64 at hlen <= 8: 4 rows a thread staged, 1 direct; staged
// only while the taps of a row share window columns (f mod nc <
// kStencilTC): a wider window is mostly columns no output reads, and
// direct reads were faster there. (Wider banks keep 8 rows: at 4 their
// walk ran 1.5x slower.)
template <>
struct GenericRows<double, 1, kSmallTaps> {
  static constexpr int kLarge = 4, kSmall = 4, kDirect = 1;
  static constexpr long long kStagedFm = kStencilTC - 1;
};

// The generic form's instance of a level: tiles of GenericRows::kLarge rows
// a thread (4 kLarge rows) with staged windows; else of kSmall rows with
// staged windows (deeper levels); else of kDirect rows reading through the
// read-only cache.
template <class T, int kIn, int kH, class Bank>
Stencil<T, kIn, Bank> pick_stencil(int nr, int nc, int level, int centre,
                                   int hlen) {
  using Rows = GenericRows<T, kIn, kH>;
  constexpr int kTile = kThreads / kStencilTC;  // rows per row a thread
  const size_t taps =
      sizeof(Vec4<T>) * hlen * (kH <= kSmallTaps ? kH : hlen);
  Stencil<T, kIn, Bank> st;
  if (dilation_mod(level, nc) <= Rows::kStagedFm) {
    st.plan = stencil_plan<T, kIn>(nr, nc, level, centre, hlen,
                                   kTile * Rows::kLarge, Rows::kLarge, taps,
                                   &st.smem);
    if (st.plan.ldw) {
      st.kernel = generic_kernel<T, kIn, kH, Rows::kLarge, true, Bank>();
      return st;
    }
    st.plan = stencil_plan<T, kIn>(nr, nc, level, centre, hlen,
                                   kTile * Rows::kSmall, Rows::kSmall, taps,
                                   &st.smem);
    if (st.plan.ldw) {
      st.kernel = generic_kernel<T, kIn, kH, Rows::kSmall, true, Bank>();
      return st;
    }
  }
  st.plan = stencil_plan<T, kIn>(nr, nc, level, centre, hlen,
                                 kTile * Rows::kDirect, Rows::kDirect, taps,
                                 &st.smem, -1);
  st.kernel = generic_kernel<T, kIn, kH, Rows::kDirect, false, Bank>();
  return st;
}

// The fast form's instance of a level, or none (kernel null) where the
// level's dilation mod nc passes kFastFm.
template <int kIn, int kHl>
Stencil<float, kIn, FastTaps<kHl>> pick_fast(int nr, int nc, int level,
                                             int centre) {
  constexpr int kR = fast_rows(kIn, kHl), kTR = kThreads / kStencilTC * kR;
  constexpr int kLdw = fast_ldw(kHl);
  Stencil<float, kIn, FastTaps<kHl>> st{};
  st.plan = stencil_plan<float, kIn>(nr, nc, level, centre, kHl, kTR, kR, 0,
                                     &st.smem, kLdw,
                                     (kTR + kHl - 1LL) * kLdw);
  if (st.plan.ldw && st.plan.fmc <= kFastFm)
    st.kernel = fast_kernel<kIn, kHl>();
  return st;
}

// A level's call: its planes and arguments, and where the caller asks for
// them in place of a launch, the figures of its instance (occupancy:
// resident blocks per SM, dynamic shared memory, tile rows and columns,
// staged).
template <class T, int kIn>
struct StencilCall {
  StencilIo<T, kIn> io;
  int batch, nr, nc, level, centre, hlen, device;
  void* stream;
  int* occupancy;   // null: launch
  TapOffsets coff;  // the level's column offsets (plan_level)
};

// A level on the picked instance: launched (blocks: column tiles x row
// tiles x planes, in chunks where a launch cannot hold them all), or its
// occupancy reported.
template <class T, int kIn, class Taps>
int run_stencil(const Stencil<T, kIn, Taps>& st, const Taps& taps,
                const StencilCall<T, kIn>& call) {
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
  launch_chunks(
      (nc + kStencilTC - 1) / kStencilTC, sp.cls * sp.tiles, call.batch,
      [&](dim3 grid, int y0, int z0) {
        const StencilIo<T, kIn> io =
            call.io.plus(static_cast<long long>(z0) * nr * nc);
        const auto stream = static_cast<cudaStream_t>(call.stream);
        if constexpr (kIn == 4)
          kernel<<<grid, kThreads, st.smem, stream>>>(
              io.in[0], io.in[1], io.in[2], io.in[3], io.out[0], nr, nc, taps,
              sp, call.coff, call.hlen, y0);
        else
          kernel<<<grid, kThreads, st.smem, stream>>>(
              io.in[0], io.out[0], io.out[1], io.out[2], io.out[3], nr, nc,
              taps, sp, call.coff, call.hlen, y0);
      });
  return static_cast<int>(cudaGetLastError());
}

// The call's column offsets, or false if its arguments are out of range.
template <class T, int kIn>
bool check(StencilCall<T, kIn>* call) {
  TapOffsets roff;
  return plan_level(call->batch, call->nr, call->nc, call->level,
                    call->centre, call->hlen, &roff, &call->coff);
}

// The generic form on the bank (Bank2D, or BankPtr in float64).
template <class T, int kIn, class Bank>
int run_generic(const Bank& bank, const StencilCall<T, kIn>& call) {
  const int nr = call.nr, nc = call.nc, level = call.level, hlen = call.hlen;
  return hlen > kSmallTaps
             ? run_stencil(pick_stencil<T, kIn, kMaxTaps, Bank>(
                               nr, nc, level, call.centre, hlen),
                           bank, call)
             : run_stencil(pick_stencil<T, kIn, kSmallTaps, Bank>(
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

// A level in float32: the fast form where it takes the level, else the
// generic one; `filters` the four filters [b][k][l] (null for an occupancy
// query), scaled here by `scale` (K18b's 1/4, exact in float32: the
// reference's 1/4 of the inverse; K18a's 1).
template <int kIn>
int stencil_f32(const float* filters, float scale,
                StencilCall<float, kIn> call) {
  if (!check(&call)) return static_cast<int>(cudaErrorInvalidValue);
  const int hlen = call.hlen;
  if (hlen <= kSmallTaps) {
    const int err = with_hlen(hlen, [&](auto hl) {
      constexpr int kHl = decltype(hl)::value;
      const Stencil<float, kIn, FastTaps<kHl>> st =
          pick_fast<kIn, kHl>(call.nr, call.nc, call.level, call.centre);
      if (!st.kernel) return -1;
      FastTaps<kHl> taps{};
      for (int b = 0; filters && b < 4; ++b)
        for (int i = 0; i < kHl * kHl; ++i)
          taps.f[4 * i + b] = scale * filters[b * kHl * kHl + i];
      return run_stencil(st, taps, call);
    });
    if (err != -1) return err;
  }
  return run_generic(filters ? make_bank(filters, hlen, scale) : Bank2D{},
                     call);
}

// A level in float64 on the device bank (BankPtr, pypwt_ns_bank_f64's
// layout: K18a's 2, K18b's 3, x 1/4): the generic form.
template <int kIn>
int stencil_f64(const double* bank, StencilCall<double, kIn> call) {
  if (!check(&call)) return static_cast<int>(cudaErrorInvalidValue);
  return run_generic(BankPtr<double>{bank}, call);
}

// The figures of a level's instance (pypwt_ns_swt2d_occupancy).
template <int kIn>
int stencil_occupancy(int nr, int nc, int level, int centre, int hlen,
                      int f64, int device, int* blocks, int* smem, int* tr,
                      int* tc, int* staged) {
  int o[5] = {};
  const int err =
      f64 ? stencil_f64<kIn>(nullptr, {{}, 1, nr, nc, level, centre, hlen,
                                       device, nullptr, o})
          : stencil_f32<kIn>(nullptr, 1.f, {{}, 1, nr, nc, level, centre,
                                            hlen, device, nullptr, o});
  *blocks = o[0];
  *smem = o[1];
  *tr = o[2];
  *tc = o[3];
  *staged = o[4];
  return err;
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
  return pypwt::stencil_f32<1>(dec, 1.f, {{{x}, {a, h, v, d}}, batch, nr, nc,
                                          level, centre, hlen, device,
                                          stream, nullptr});
}

extern "C" int pypwt_ins_swt2d(const float* a, const float* h, const float* v,
                               const float* d, float* out, int batch, int nr,
                               int nc, int level, int centre, const float* rec,
                               int hlen, int device, void* stream) {
  return pypwt::stencil_f32<4>(rec, 0.25f, {{{a, h, v, d}, {out}}, batch, nr,
                                            nc, level, centre, hlen, device,
                                            stream, nullptr});
}

// The float64 K18a/K18b: `bank` is the device copy of pypwt_ns_bank_f64's
// layout 2 (K18a) or 3 (K18b, x 1/4).
extern "C" int pypwt_ns_swt2d_f64(const double* x, double* a, double* h,
                                  double* v, double* d, int batch, int nr,
                                  int nc, int level, int centre,
                                  const double* bank, int hlen, int device,
                                  void* stream) {
  return pypwt::stencil_f64<1>(bank, {{{x}, {a, h, v, d}}, batch, nr, nc,
                                      level, centre, hlen, device, stream,
                                      nullptr});
}

extern "C" int pypwt_ins_swt2d_f64(const double* a, const double* h,
                                   const double* v, const double* d,
                                   double* out, int batch, int nr, int nc,
                                   int level, int centre, const double* bank,
                                   int hlen, int device, void* stream) {
  return pypwt::stencil_f64<4>(bank, {{{a, h, v, d}, {out}}, batch, nr, nc,
                                      level, centre, hlen, device, stream,
                                      nullptr});
}

// K18a's (pypwt_ns_swt2d_occupancy) and K18b's (pypwt_ins_swt2d_occupancy)
// instance for one level of (nr, nc) planes (f64 1: the float64 one):
// resident blocks per SM, dynamic shared memory in bytes, the tile's rows
// and columns, and 1 where its windows are staged in shared memory, 0
// where it reads through the read-only cache. A figure for reports; no
// bank is read.
extern "C" int pypwt_ns_swt2d_occupancy(int nr, int nc, int level,
                                        int centre, int hlen, int f64,
                                        int device, int* blocks, int* smem,
                                        int* tr, int* tc, int* staged) {
  return pypwt::stencil_occupancy<1>(nr, nc, level, centre, hlen, f64,
                                     device, blocks, smem, tr, tc, staged);
}

extern "C" int pypwt_ins_swt2d_occupancy(int nr, int nc, int level,
                                         int centre, int hlen, int f64,
                                         int device, int* blocks, int* smem,
                                         int* tr, int* tc, int* staged) {
  return pypwt::stencil_occupancy<4>(nr, nc, level, centre, hlen, f64,
                                     device, blocks, smem, tr, tc, staged);
}
