// K10a / K10b: one periodized batched-1D stationary (a-trous) level and its
// inverse, float32 or float64.
//
// Replace the TPU kernels pypwt_tpu/ops/pallas_dwt.py::swt1d_level_fused
// (_build_swt1d, :2159) and ::iswt1d_level_fused (_build_iswt1d, :2213),
// and compute the maps of the folded long-signal kernels
// ::swt1d_long_fused (_build_swt1d_long, :2576) and ::iswt1d_long_fused
// (_build_iswt1d_long, :2647) on a (1, n) view.
//
// Maps (pypwt_tpu/core/conv.py:183-228), for rows of n samples, any
// hlen <= 40 (odd included), level l >= 1, factor = 2^(l-1):
//   K10a: lo[i] = sum_k dec_lo[k] * x[(i + (s - k) * factor) mod n],
//         hi the same with dec_hi, s = hlen/2;
//   K10b: out[i] = sum_k rec_lo[k]/2 * a[j] + rec_hi[k]/2 * d[j],
//         j = (i + (s - k) * factor) mod n, s = hlen/2 - 1 for even hlen
//         and hlen/2 for odd; the 1/2 is applied once (one axis).
// Tap k is applied at offset (s - k) * factor, not k * factor (the
// reference's order, separable.cu:409-448, tests/oracle.py:68-100).
//
// Bound: per sample K10a reads 4 bytes and writes 8, K10b reads 8 and
// writes 4, with 2 hlen FMAs: hlen/3 flop per byte, under the H100's
// float32 ridge of ~20 flop per byte for every hlen <= 40, so memory-bound.
//
// Design: one flat grid axis of (row, tile) pairs, as in K3; each block
// owns TS outputs of one row. The dilated support spans (hlen-1) * factor
// samples. While the tile plus that span fits in kStageBytes of shared
// memory, and the dilation is at most a tile (beyond it a staged window
// reads more than the taps themselves), the block stages the window once
// with a true periodic wrap and an in-range fast path ("staged"). Otherwise
// every tap reads its contiguous run of the row straight from memory
// through the read-only cache, at an offset reduced mod n on the host, so
// that any level and any wrap wider than the row is covered ("direct").
// Row offsets are 64-bit. The staged window's bytes are sizeof(T) each, so
// a float64 instance (pypwt_swt1d_f64, pypwt_iswt1d_f64) stages half the
// span of a float32 one within the same kStageBytes and reads deeper
// levels direct.

#include <algorithm>

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TS = 1024;                  // outputs per block
constexpr size_t kStageBytes = 48 * 1024;  // no opt-in above 48 KB needed

// Per-tap read offsets: into the staged window (staged) or added to the
// output index and wrapped once (direct).
struct Offsets {
  int k[kMaxTaps];
};

struct Plan {
  bool staged;
  int start;  // staged: window origin relative to the tile's first output
  int win;    // staged: window samples (per array); 0 for direct
  Offsets offs;
};

// The level's read plan; `arrays` is the number of staged inputs of T.
template <class T>
Plan make_plan(int hlen, int s, int level, int n, int arrays) {
  Plan p{};
  // factor mod n, exact at any level
  long long fm = 1 % n;
  for (int l = 1; l < level; ++l) fm = (2 * fm) % n;
  const long long factor = level <= 31 ? (1LL << (level - 1)) : -1;
  const long long span = factor < 0 ? -1 : (hlen - 1) * factor;
  const long long win = std::min(TS, n) + span;
  const size_t fixed = sizeof(T) * 2 * kMaxTaps + sizeof(int) * kMaxTaps;
  p.staged = factor >= 0 && factor <= TS &&
             fixed + sizeof(T) * arrays * win <= kStageBytes;
  if (p.staged) {
    p.start = -(hlen - 1 - s) * static_cast<int>(factor);
    p.win = static_cast<int>(win);
    for (int k = 0; k < hlen; ++k)
      p.offs.k[k] = (hlen - 1 - k) * static_cast<int>(factor);
  } else {
    for (int k = 0; k < hlen; ++k) {
      long long o = ((s - k) * fm) % n;
      p.offs.k[k] = static_cast<int>(o < 0 ? o + n : o);
    }
  }
  return p;
}

template <class T>
inline size_t smem_bytes(const Plan& p, int arrays) {
  return sizeof(T) * 2 * kMaxTaps + sizeof(int) * kMaxTaps +
         (p.staged ? sizeof(T) * arrays * p.win : 0);
}

// Stage samples [i0 + start, i0 + start + w) of a row, wrapped mod n.
template <class T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int n,
                                      int first, int w, T* dst) {
  if (first >= 0 && first + w <= n) {
    for (int q = threadIdx.x; q < w; q += kThreads) dst[q] = src[first + q];
  } else {
    for (int q = threadIdx.x; q < w; q += kThreads)
      dst[q] = src[wrap(first + q, n)];
  }
}

// Sample feeding output i (of the tile starting at i0) through tap offset
// `off`: from the staged window, or from the row with one wrap.
template <bool kStaged, class T>
__device__ __forceinline__ T tap_read(const T* __restrict__ win,
                                      const T* __restrict__ row, int i,
                                      int i0, int off, int n) {
  if constexpr (kStaged) return win[i + off];
  int j = i0 + i + off;
  if (j >= n) j -= n;
  return __ldg(row + j);
}

template <class T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
swt1d_kernel(const T* __restrict__ x, T* __restrict__ lo, T* __restrict__ hi,
             int n, int tiles, int start, int span, TapsT<T> taps,
             Offsets offs, int hlen) {
  T* f_lo = dynamic_smem<T>();  // taps in bank order
  T* f_hi = f_lo + kMaxTaps;
  int* s_off = reinterpret_cast<int*>(f_hi + kMaxTaps);
  T* win = reinterpret_cast<T*>(s_off + kMaxTaps);

  const int tid = threadIdx.x;
  const int row = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - row * tiles) * TS;
  const int cnt = min(TS, n - i0);
  const long long rb = static_cast<long long>(row) * n;
  const T* xr = x + rb;

  if (tid < hlen) {
    f_lo[tid] = taps.lo[tid];
    f_hi[tid] = taps.hi[tid];
    s_off[tid] = offs.k[tid];
  }
  if constexpr (kStaged) stage(xr, n, i0 + start, cnt + span, win);
  __syncthreads();

  for (int i = tid; i < cnt; i += kThreads) {
    T l = 0, h = 0;
    for (int k = 0; k < hlen; ++k) {
      const T v = tap_read<kStaged>(win, xr, i, i0, s_off[k], n);
      l = fmadd(v, f_lo[k], l);
      h = fmadd(v, f_hi[k], h);
    }
    lo[rb + i0 + i] = l;
    hi[rb + i0 + i] = h;
  }
}

template <class T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
iswt1d_kernel(const T* __restrict__ a, const T* __restrict__ d,
              T* __restrict__ out, int n, int tiles, int start, int span,
              TapsT<T> half_taps, Offsets offs, int hlen) {
  T* g_lo = dynamic_smem<T>();  // rec taps / 2, in bank order
  T* g_hi = g_lo + kMaxTaps;
  int* s_off = reinterpret_cast<int*>(g_hi + kMaxTaps);
  T* win_a = reinterpret_cast<T*>(s_off + kMaxTaps);

  const int tid = threadIdx.x;
  const int row = blockIdx.x / tiles;
  const int i0 = (blockIdx.x - row * tiles) * TS;
  const int cnt = min(TS, n - i0);
  const int w = cnt + span;
  T* win_d = win_a + w;
  const long long rb = static_cast<long long>(row) * n;
  const T* ar = a + rb;
  const T* dr = d + rb;

  if (tid < hlen) {
    g_lo[tid] = half_taps.lo[tid];
    g_hi[tid] = half_taps.hi[tid];
    s_off[tid] = offs.k[tid];
  }
  if constexpr (kStaged) {
    stage(ar, n, i0 + start, w, win_a);
    stage(dr, n, i0 + start, w, win_d);
  }
  __syncthreads();

  for (int i = tid; i < cnt; i += kThreads) {
    T s = 0;
    for (int k = 0; k < hlen; ++k) {
      const int off = s_off[k];
      s = fmadd(tap_read<kStaged>(win_a, ar, i, i0, off, n), g_lo[k], s);
      s = fmadd(tap_read<kStaged>(win_d, dr, i, i0, off, n), g_hi[k], s);
    }
    out[rb + i0 + i] = s;
  }
}

inline bool bad_args(int rows, int n, int level, int hlen, int tiles) {
  return hlen < 1 || hlen > kMaxTaps || n < 1 || n > 0x3fffffff ||
         level < 1 || rows < 1 ||
         static_cast<long long>(rows) * tiles > 0x7fffffffLL;
}

template <class T>
int launch_swt(const T* x, T* lo, T* hi, int rows, int n, int level,
               const T* dec_lo, const T* dec_hi, int hlen, int device,
               void* stream) {
  const int tiles = (n + TS - 1) / TS;
  if (bad_args(rows, n, level, hlen, tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan<T>(hlen, hlen / 2, level, n, 1);
  const TapsT<T> taps = make_taps(dec_lo, dec_hi, hlen);
  const size_t smem = smem_bytes<T>(p, 1);
  const int span = p.staged ? p.win - std::min(TS, n) : 0;
  auto* st = static_cast<cudaStream_t>(stream);
  if (p.staged)
    swt1d_kernel<T, true><<<rows * tiles, kThreads, smem, st>>>(
        x, lo, hi, n, tiles, p.start, span, taps, p.offs, hlen);
  else
    swt1d_kernel<T, false><<<rows * tiles, kThreads, smem, st>>>(
        x, lo, hi, n, tiles, 0, 0, taps, p.offs, hlen);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_iswt(const T* a, const T* d, T* out, int rows, int n, int level,
                const T* rec_lo, const T* rec_hi, int hlen, int device,
                void* stream) {
  const int tiles = (n + TS - 1) / TS;
  if (bad_args(rows, n, level, hlen, tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int s = (hlen % 2 == 0) ? hlen / 2 - 1 : hlen / 2;
  const Plan p = make_plan<T>(hlen, s, level, n, 2);
  // rec / 2 is exact: the single 1/2 of the 1D inverse
  T lo2[kMaxTaps], hi2[kMaxTaps];
  for (int k = 0; k < hlen; ++k) {
    lo2[k] = T(0.5) * rec_lo[k];
    hi2[k] = T(0.5) * rec_hi[k];
  }
  const TapsT<T> taps = make_taps<T>(lo2, hi2, hlen);
  const size_t smem = smem_bytes<T>(p, 2);
  const int span = p.staged ? p.win - std::min(TS, n) : 0;
  auto* st = static_cast<cudaStream_t>(stream);
  if (p.staged)
    iswt1d_kernel<T, true><<<rows * tiles, kThreads, smem, st>>>(
        a, d, out, n, tiles, p.start, span, taps, p.offs, hlen);
  else
    iswt1d_kernel<T, false><<<rows * tiles, kThreads, smem, st>>>(
        a, d, out, n, tiles, 0, 0, taps, p.offs, hlen);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pypwt

// All return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. The filters are host arrays of hlen values of the
// data's type.
extern "C" int pypwt_swt1d(const float* x, float* lo, float* hi, int rows,
                           int n, int level, const float* dec_lo,
                           const float* dec_hi, int hlen, int device,
                           void* stream) {
  return pypwt::launch_swt(x, lo, hi, rows, n, level, dec_lo, dec_hi, hlen,
                           device, stream);
}

extern "C" int pypwt_swt1d_f64(const double* x, double* lo, double* hi,
                               int rows, int n, int level,
                               const double* dec_lo, const double* dec_hi,
                               int hlen, int device, void* stream) {
  return pypwt::launch_swt(x, lo, hi, rows, n, level, dec_lo, dec_hi, hlen,
                           device, stream);
}

extern "C" int pypwt_iswt1d(const float* a, const float* d, float* out,
                            int rows, int n, int level, const float* rec_lo,
                            const float* rec_hi, int hlen, int device,
                            void* stream) {
  return pypwt::launch_iswt(a, d, out, rows, n, level, rec_lo, rec_hi, hlen,
                            device, stream);
}

extern "C" int pypwt_iswt1d_f64(const double* a, const double* d,
                                double* out, int rows, int n, int level,
                                const double* rec_lo, const double* rec_hi,
                                int hlen, int device, void* stream) {
  return pypwt::launch_iswt(a, d, out, rows, n, level, rec_lo, rec_hi, hlen,
                            device, stream);
}
