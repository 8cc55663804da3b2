// Shared pieces of the level kernels: the 2D DWT pair and its shifted
// forms (dwt2d.cu, idwt2d.cu), the 1D DWT pair (dwt1d.cu, idwt1d.cu), the
// 1D stationary pair (swt1d.cu), the 2D stationary pair (swt2d.cu), the
// non-separable pairs (nonsep_dwt2d.cu, nonsep_swt2d.cu) and the
// tensor-core forms (tc_*.cu).
//
// The tap-loop kernels are templates on the scalar type T: float, and
// double for the float64 plans (the reference's -DDOUBLEPRECISION build).
// A float64 instance reads its taps at the bank's float64 values, so its
// roundtrip reaches ~1e-15, not float32's ~1e-7.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace pypwt {

// MAX_FILTER_WIDTH of the filter registry (pypwt_tpu_torch/filters).
constexpr int kMaxTaps = 40;
constexpr int kHalfTaps = kMaxTaps / 2;
constexpr int kThreads = 256;

// The scalar type's fused multiply-add (fmaf for float, as before).
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// Dynamic shared memory as an array of T: one untyped declaration serves
// every instance of a template kernel.
template <class T>
__device__ __forceinline__ T* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char pypwt_smem[];
  return reinterpret_cast<T*>(pypwt_smem);
}

// The bank's two filters of one direction, passed to the kernel by value
// (kernel parameter space): no device copy of the taps per call.
template <class T>
struct TapsT {
  T lo[kMaxTaps];
  T hi[kMaxTaps];
};
using Taps = TapsT<float>;

template <class T>
inline TapsT<T> make_taps(const T* lo, const T* hi, int hlen) {
  TapsT<T> t{};
  for (int k = 0; k < hlen; ++k) {
    t.lo[k] = lo[k];
    t.hi[k] = hi[k];
  }
  return t;
}

// The analysis taps of a decimating level. An odd hlen = 2m + 1 gets a zero
// tap in front (hlen + 1 taps): the analysis left pad hlen - 1 - hlen/2 is m
// for both lengths, so the map is the same and the kernels need only handle
// even lengths. Returns the kernel's tap count.
template <class T>
inline int make_analysis_taps(const T* lo, const T* hi, int hlen,
                              TapsT<T>* t) {
  *t = TapsT<T>{};
  const int z = hlen & 1;
  for (int k = 0; k < hlen; ++k) {
    t->lo[k + z] = lo[k];
    t->hi[k + z] = hi[k];
  }
  return hlen + z;
}

// k mod n in [0, n) for any k. A single wrap is not enough: at deep levels
// or on small planes the periodic pad is wider than the plane itself.
__device__ __forceinline__ int wrap(int k, int n) {
  if (static_cast<unsigned>(k) < static_cast<unsigned>(n)) return k;
  k %= n;
  return k < 0 ? k + n : k;
}

// Sample k of an axis of n samples in a decimating level: the reference's
// virtual extension of an odd axis repeats its last sample (conv.py's
// _odd_extend_last, separable.cu:116-121), so the axis has period n + 1 and
// sample n is sample n - 1. For an even axis this is wrap(k, n).
__device__ __forceinline__ int wrap_ext(int k, int n) {
  return min(wrap(k, n + (n & 1)), n - 1);
}

// Per-tap read offsets of one a-trous axis: tap k reads sample
// i + (s - k) * 2^(level-1), here reduced mod n into [0, n) on the host, so
// that the kernel wraps i + k[tap] once (i < n) at any level, and a wrap
// wider than the axis costs nothing more.
struct TapOffsets {
  int k[kMaxTaps];
};

// 2^(level-1) mod n, exact at any level >= 1.
inline long long dilation_mod(int level, int n) {
  long long fm = 1 % n;
  for (int l = 1; l < level; ++l) fm = (2 * fm) % n;
  return fm;
}

inline TapOffsets dilated_offsets(int hlen, int s, int level, int n) {
  TapOffsets t{};
  const long long fm = dilation_mod(level, n);
  for (int k = 0; k < hlen; ++k) {
    const long long o = ((s - k) * fm) % n;
    t.k[k] = static_cast<int>(o < 0 ? o + n : o);
  }
  return t;
}

// Decimating analysis, one axis (conv.analysis_pads / analysis_core):
//   out[i] = sum_{j < hlen} dec[hlen-1-j] * x[(2i + j - lpad) mod N],
//   lpad = hlen - 1 - hlen/2.
__host__ __device__ __forceinline__ int analysis_lpad(int hlen) {
  return hlen - 1 - hlen / 2;
}

// f[j] = dec[hlen-1-j], the analysis taps in window order, into shared
// memory (the caller synchronises before reading them).
template <class T>
__device__ __forceinline__ void load_reversed_taps(const TapsT<T>& taps,
                                                   int hlen, T* f_lo,
                                                   T* f_hi) {
  const int tid = threadIdx.x;
  if (tid < hlen) {
    f_lo[tid] = taps.lo[hlen - 1 - tid];
    f_hi[tid] = taps.hi[hlen - 1 - tid];
  }
}

// Polyphase synthesis, one axis (conv.synthesis_core, the reference's
// separable.cu:252-287): output n = 2m + p of L coefficients is
//   sum_{j < h2} rec_lo[tap(p, j)] * lo[(m + delta(p) + j - c) mod L]
//              + rec_hi[tap(p, j)] * hi[(m + delta(p) + j - c) mod L],
// with h2 = hlen/2, c = h2/2, sigma = (h2 even),
// delta(p) = (p + sigma) >> 1, off(p) = 1 - ((p + sigma) & 1) and
// tap(p, j) = hlen - 1 - 2j - off(p) (an odd hlen never reads tap 0).
struct Polyphase {
  int hlen, h2, c, sigma;
  __host__ __device__ explicit Polyphase(int hlen)
      : hlen(hlen), h2(hlen >> 1), c((hlen >> 1) >> 1),
        sigma(((hlen >> 1) & 1) ? 0 : 1) {}
  __host__ __device__ int delta(int p) const { return (p + sigma) >> 1; }
  __host__ __device__ int tap(int p, int j) const {
    return hlen - 1 - 2 * j - (1 - ((p + sigma) & 1));
  }
};

// g[p * kHalfTaps + j] = rec[tap(p, j)] for both parities, into shared
// memory (the caller synchronises before reading them).
template <class T>
__device__ __forceinline__ void load_polyphase_taps(const TapsT<T>& taps,
                                                    int hlen, T* g_lo,
                                                    T* g_hi) {
  const Polyphase ph(hlen);
  const int tid = threadIdx.x;
  if (tid < 2 * ph.h2) {
    const int p = tid / ph.h2, j = tid - p * ph.h2;
    g_lo[p * kHalfTaps + j] = taps.lo[ph.tap(p, j)];
    g_hi[p * kHalfTaps + j] = taps.hi[ph.tap(p, j)];
  }
}

// Four values of the scalar type in one shared-memory word (the
// non-separable kernels' taps and coefficients): float4, or two 16-byte
// words of double.
template <class T>
struct Vec4Of;
template <>
struct Vec4Of<float> {
  using type = float4;
};
struct alignas(16) Double4 {
  double x, y, z, w;
};
template <>
struct Vec4Of<double> {
  using type = Double4;
};
template <class T>
using Vec4 = typename Vec4Of<T>::type;

// Four hlen x hlen filters of a non-separable bank, interleaved [k][l][b]
// (b fastest). In float32 the kernel takes it by value (kernel parameter
// space, up to 25,600 bytes at hlen 40): no device copy of the bank per
// call. A float64 bank (51,200 bytes) passes CUDA's 32,764-byte parameter
// limit, so the float64 kernels read it from device memory (BankPtr,
// uploaded once per bank by the wrapper); both expose f[i].
template <class T>
struct Bank2DT {
  T f[4 * kMaxTaps * kMaxTaps];
};
using Bank2D = Bank2DT<float>;

template <class T>
struct BankPtr {
  const T* f;
};

// filters: host array of 4 * hlen * hlen values, [b][k][l]; the bank
// interleaves them to [k][l][b], each scaled by `scale`.
template <class T>
inline Bank2DT<T> make_bank(const T* filters, int hlen, T scale) {
  Bank2DT<T> bank{};
  const int n2 = hlen * hlen;
  for (int b = 0; b < 4; ++b)
    for (int i = 0; i < n2; ++i)
      bank.f[4 * i + b] = scale * filters[b * n2 + i];
  return bank;
}

// Where the rows (axis -2) of a 2D level come from. Wrapped: the plane
// itself, wrapped periodically (the unsharded kernels). Halo: one row shard
// of a larger plane (K26-K28, the row-sharded levels of
// pypwt_tpu_torch/parallel/spatial.py): row r of the extended axis
// [-lp, n + rp) is the shard's own row r, row r + lp of the top halo or row
// r - n of the bottom halo, the rows its neighbours exchanged. Past both
// halos there is no row (null): a kernel stages zero there, where only a
// zero tap or an output past the shard meets it. kPlanes planes share the
// rows' geometry (the four coefficient planes of a synthesis), each with
// its own halo pair.
struct Wrapped {
  static constexpr bool kHalo = false;
};

template <class T, int kPlanes>
struct Halo {
  static constexpr bool kHalo = true;
  const T* top[kPlanes];  // (lp, nc) rows above the shard, per plane
  const T* bot[kPlanes];  // (rp, nc) rows below it
  int lp, rp;

  // The same halos moved to plane z of a batch of nc-sample rows.
  __host__ __device__ Halo plane(long long z, int nc) const {
    Halo h = *this;
    for (int p = 0; p < kPlanes; ++p) {
      h.top[p] += z * lp * nc;
      h.bot[p] += z * rp * nc;
    }
    return h;
  }

  // Row r of plane p, whose own n rows of nc samples start at `body`, or
  // null past both halos.
  __device__ __forceinline__ const T* row(int p, const T* body, long long r,
                                          int n, int nc) const {
    if (r >= 0 && r < n) return body + r * nc;
    if (r < 0) return r >= -lp ? top[p] + (r + lp) * nc : nullptr;
    return r - n < rp ? bot[p] + (r - n) * nc : nullptr;
  }
};

// Host-side halo argument of one plane (K26a, K27a, K28's analyses) or of
// four (their syntheses: a, h, v, d in that order).
template <class T>
inline Halo<T, 1> make_halo(const T* top, const T* bot, int lp, int rp) {
  Halo<T, 1> h;
  h.top[0] = top;
  h.bot[0] = bot;
  h.lp = lp;
  h.rp = rp;
  return h;
}

template <class T>
inline Halo<T, 4> make_halo4(const T* const* tops, const T* const* bots,
                             int lp, int rp) {
  Halo<T, 4> h;
  for (int p = 0; p < 4; ++p) {
    h.top[p] = tops[p];
    h.bot[p] = bots[p];
  }
  h.lp = lp;
  h.rp = rp;
  return h;
}

// Where the samples of a 1D level's rows come from (the last axis). Wrapped:
// the row itself, wrapped periodically (K3/K4, K7a/K7b). LaneHalo: one
// segment of longer rows split over a ring of shards (K29a/K29b, K29e/K29f:
// the grid's column passes and the sequence layout of
// pypwt_tpu_torch/parallel/spatial.py): sample c of row `row` on the
// extended axis [-lp, n + rp) is the shard's own sample c, sample c + lp of
// the left halo (rows, lp) or sample c - n of the right halo (rows, rp), the
// samples its neighbours exchanged. Past both halos there is no sample: the
// kernel stages zero there, where only a zero tap or an output past the
// shard meets it (Halo's rule along the other axis). kPlanes planes share
// the geometry (the two coefficient rows of a synthesis), each with its own
// halo pair.
template <class T, int kPlanes>
struct LaneHalo {
  static constexpr bool kHalo = true;
  const T* left[kPlanes];   // (rows, lp) samples before the shard, per plane
  const T* right[kPlanes];  // (rows, rp) samples after it
  int lp, rp;

  // Sample c of row `row` of plane p, whose own n samples start at `body`.
  __device__ __forceinline__ T at(int p, const T* body, long long row, int c,
                                  int n) const {
    if (c >= 0 && c < n) return body[c];
    if (c < 0) return c >= -lp ? left[p][row * lp + c + lp] : T(0);
    return c - n < rp ? right[p][row * rp + c - n] : T(0);
  }
};

// Host-side lane halo argument of kPlanes planes, halos[2 p] the left and
// halos[2 p + 1] the right halo of plane p.
template <class T, int kPlanes>
inline LaneHalo<T, kPlanes> make_lane_halo(const T* const* halos, int lp,
                                           int rp) {
  LaneHalo<T, kPlanes> h;
  for (int p = 0; p < kPlanes; ++p) {
    h.left[p] = halos[2 * p];
    h.right[p] = halos[2 * p + 1];
  }
  h.lp = lp;
  h.rp = rp;
  return h;
}

// The exact halo heights of a row-sharded level (conv.analysis_pads,
// conv.synthesis_pads with n_out = 2L, and their dilation by 2^(level-1)
// in the stationary levels), and the exact halo widths of a one-axis pass
// of the grid and sequence layouts (K29, the same pads along either axis);
// a kernel refuses any other.
inline bool analysis_halos_ok(int hlen, int lp, int rp) {
  return lp == hlen - 1 - hlen / 2 && rp == std::max(hlen / 2 - 1, 0);
}

inline bool synthesis_halos_ok(int hlen, int lp, int rp) {
  const int h2 = hlen / 2, c = h2 / 2, sigma = (h2 & 1) ? 0 : 1;
  return lp == c && rp == std::max(sigma - c + h2 - 1, 0);
}

inline bool stationary_halos_ok(int hlen, int s, int level, int lp, int rp) {
  if (level < 1 || level > 31) return false;
  const long long f = 1LL << (level - 1);
  return lp == (hlen - 1 - s) * f && rp == s * f;
}

// One instance of a tiled level kernel, picked on the host by type, bank
// and level size (idwt2d.cu's pick_pair, dwt2d.cu's pick_ana): the kernel,
// its dynamic shared memory and its tile shape.
template <class Kernel>
struct TileInstance {
  Kernel kernel;
  size_t smem;
  int tr, tc;
};

// Select `device` and read its SM count.
inline cudaError_t device_sms(int device, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

// Let an instance take its dynamic shared memory.
template <class Kernel>
cudaError_t allow_smem(const TileInstance<Kernel>& inst) {
  return cudaFuncSetAttribute(inst.kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(inst.smem));
}

// The occupancy API's resident blocks per SM of an instance, its dynamic
// shared memory in bytes and its tile shape: figures for reports.
template <class Kernel>
int report_occupancy(const TileInstance<Kernel>& inst, int* blocks,
                     int* smem, int* tr, int* tc) {
  const cudaError_t err = allow_smem(inst);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<int>(inst.smem);
  *tr = inst.tr;
  *tc = inst.tc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, inst.kernel, kThreads, inst.smem));
}

// Grid y and z hold at most 65535 blocks. The 2D level kernels put column
// blocks on x, row blocks on y and planes on z; launch_chunks issues a
// level with more row blocks or planes than that as several launches,
// calling launch(grid, y0, z0) with the
// first row block and plane of each, so no grid limit bounds a batch, a
// plane size or a level. One launch in every other case.
constexpr int kMaxGridYZ = 65535;

template <class Launch>
void launch_chunks(int col_blocks, int row_blocks, int planes,
                   Launch launch) {
  for (long long z0 = 0; z0 < planes; z0 += kMaxGridYZ)
    for (long long y0 = 0; y0 < row_blocks; y0 += kMaxGridYZ)
      launch(dim3(col_blocks,
                  static_cast<unsigned>(
                      std::min<long long>(row_blocks - y0, kMaxGridYZ)),
                  static_cast<unsigned>(
                      std::min<long long>(planes - z0, kMaxGridYZ))),
             static_cast<int>(y0), static_cast<int>(z0));
}

}  // namespace pypwt
