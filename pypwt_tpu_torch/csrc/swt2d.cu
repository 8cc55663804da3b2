// K8 / K9: one periodized separable 2D stationary (a-trous) level and its
// inverse, float32 or float64; K27a / K27b: the same levels of one row
// shard of a larger plane, float32 or float64.
//
// Replace the TPU kernels pypwt_tpu/ops/pallas_dwt.py::swt2d_level_fused
// (_build_swt2d, :1912) and ::iswt2d_level_fused (_build_iswt2d, :2004);
// K27a / K27b replace ::build_swt2d_sharded (:1606) and
// ::build_iswt2d_sharded (:1669), the shard_map-local levels of
// pypwt_tpu/parallel/spatial.py's row-sharded path.
//
// Maps (pypwt_tpu/core/swt.py:143-170 on conv.swt_analysis_last and
// swt_synthesis_last), planes of (B?, Nr, Nc), any hlen <= 40 (odd
// included), level l >= 1, factor f = 2^(l-1); on either axis tap k reads
// sample i + (s - k) * f, wrapped mod the axis length, with the centre s
// given by the caller (conv.swt_centre):
//   K8: lo/hi along the last axis (s = hlen/2), then along axis -2:
//       a = lo(lo), h = hi(lo), v = lo(hi), d = hi(hi),
//       so h is the high-pass along axis -2 and the low-pass along the last
//       axis (the names of the JAX fallback, not of the Pallas kernel's
//       internal order);
//   K9: out = syn_-2(syn_-1(a, v), syn_-1(h, d)) with
//       syn(p, q)[i] = sum_k rec_lo[k]/2 * p[j] + rec_hi[k]/2 * q[j],
//       j = i + (s - k) * f, s = hlen/2 - 1 for even hlen and hlen/2 for
//       odd: the fallback's two axis passes in the other order (the map is
//       linear and separable), 1/2 per pass.
//
// Bound: a 2048^2 level of K8 reads 16 MiB and writes 64 MiB (K9 the
// reverse) and does 2 hlen + 4 hlen FMAs per pixel: 6 hlen / 20 flop per
// byte, under the H100's float32 ridge of ~20 for every hlen <= 40, so the
// kernels are bound by device memory.
//
// Design: the dilated support spans (hlen-1) * f samples on both axes, too
// wide at deep levels for a staged 2D window (sym20 at level 6: 1248).
// Along axis -2 a block therefore owns output rows of one residue class
// mod f: rows rho + f*m for TR consecutive m. Their taps then read only
// TR + hlen - 1 rows of the same class, at any level, and rows are separate
// cache lines, so this costs no coalescing. Phase 1 filters those rows along
// the last axis into shared memory: each of TC consecutive output columns
// reads its hlen taps straight from memory through the read-only cache (a
// warp reads 32 consecutive words per tap, at an offset reduced mod Nc on
// the host, so any level and any wrap wider than the plane take one
// conditional subtraction). Phase 2 filters the staged rows along axis -2
// and writes the four subbands (K8) or the image (K9). The row-filtered
// intermediate never leaves the SM. Where the factor reaches Nr, every row
// is its own class. Row blocks run on the grid's y axis and planes on its z
// axis; a level with more of either than a launch holds goes in chunks
// (launch_chunks in common.cuh), so no grid limit bounds a batch, a plane
// or a level. Plane offsets are 64-bit. K27a/K27b take the Halo row source
// (common.cuh): their staged rows lie on the shard's extended axis
// [-lp, nr + rp), the plane's rows plus the exchanged halos, so the row
// plan steps by the dilation itself, not by its residue mod nr, and a row
// is read from the shard or a halo where it lies (no padded copy); the
// columns stay periodic. The float64 instances
// (pypwt_swt2d_f64, pypwt_iswt2d_f64) stage 36 KB of static shared memory.

#include <algorithm>

#include "common.cuh"

namespace pypwt {
namespace {

constexpr int TR = 32;  // output rows per block, of one residue class
constexpr int TC = 32;  // output columns per block
constexpr int kStageRows = TR + kMaxTaps - 1;

// Row tiling of one level: residue classes rho < cls, output rows
// rho + cls * m; `tr` rows per block and `tiles` blocks per class.
struct RowPlan {
  int cls;
  int tr;
  int tiles;
  int back;       // hlen - 1 - s: staged row q serves taps with q - back
  long long fm;   // factor mod nr
};

// halo: the rows of a shard (K27), whose staged rows are rows of the
// extended axis [-lp, nr + rp): fm is then the dilation itself, not reduced
// mod nr (the caller bounds it: level <= 31 and the halos' heights fit an
// int).
RowPlan row_plan(int hlen, int s, int level, int nr, bool halo = false) {
  RowPlan p{};
  const bool every_row = level > 31 || (1LL << (level - 1)) >= nr;
  p.cls = every_row ? nr : (1 << (level - 1));
  const int per = (nr + p.cls - 1) / p.cls;  // rows of class 0, the longest
  p.tr = std::min(TR, per);
  p.tiles = (per + p.tr - 1) / p.tr;
  p.back = hlen - 1 - s;
  p.fm = halo ? 1LL << (level - 1) : dilation_mod(level, nr);
  return p;
}

// Plane row held in staged row q of the block (rho, m0): reduced mod nr, or
// (kHalo) the row of the shard's extended axis.
template <bool kHalo>
__device__ __forceinline__ int staged_row(const RowPlan& p, int rho, int m0,
                                          int q, int nr) {
  long long r = rho + static_cast<long long>(p.cls) * m0 +
                static_cast<long long>(q - p.back) * p.fm;
  if (kHalo) return static_cast<int>(r);
  r %= nr;
  return static_cast<int>(r < 0 ? r + nr : r);
}

// Last-axis sample j = col + off, wrapped once (col < nc, off < nc).
template <class T>
__device__ __forceinline__ T col_tap(const T* __restrict__ row, int col,
                                     int off, int nc) {
  int j = col + off;
  if (j >= nc) j -= nc;
  return __ldg(row + j);
}

// Rows: Wrapped (K8), or the Halo<T, 1> of the shard x (K27a).
template <class T, class Rows>
__global__ void __launch_bounds__(kThreads)
swt2d_kernel(const T* __restrict__ x, T* __restrict__ a, T* __restrict__ h,
             T* __restrict__ v, T* __restrict__ d, int nr, int nc,
             RowPlan rp, TapsT<T> taps, TapOffsets coff, int hlen,
             unsigned y0, Rows halo) {
  __shared__ T s_lo[kStageRows * TC];
  __shared__ T s_hi[kStageRows * TC];
  __shared__ T f_lo[kMaxTaps], f_hi[kMaxTaps];
  __shared__ int s_off[kMaxTaps];
  __shared__ int s_row[kStageRows];

  const int tid = threadIdx.x;
  const unsigned by = y0 + blockIdx.y;  // unsigned: the cheaper division
  const int rho = by / rp.tiles;
  const int m0 = (by - rho * rp.tiles) * rp.tr;
  const int c0 = blockIdx.x * TC;
  const int rows = rp.tr + hlen - 1;
  const long long plane = static_cast<long long>(nr) * nc;
  const T* xb = x + blockIdx.z * plane;

  if (tid < hlen) {
    f_lo[tid] = taps.lo[tid];
    f_hi[tid] = taps.hi[tid];
    s_off[tid] = coff.k[tid];
  }
  if (tid < rows) s_row[tid] = staged_row<Rows::kHalo>(rp, rho, m0, tid, nr);
  __syncthreads();

  // Phase 1, last axis, on the staged rows (zero for a row past a shard's
  // halos).
  for (int i = tid; i < rows * TC; i += kThreads) {
    const int q = i / TC, col = c0 + i - q * TC;
    T lo = 0, hi = 0;
    const T* xr;
    if constexpr (Rows::kHalo) {
      xr = halo.plane(blockIdx.z, nc).row(0, xb, s_row[q], nr, nc);
    } else {
      xr = xb + static_cast<long long>(s_row[q]) * nc;
    }
    if (col < nc && xr) {
      for (int k = 0; k < hlen; ++k) {
        const T val = col_tap(xr, col, s_off[k], nc);
        lo = fmadd(val, f_lo[k], lo);
        hi = fmadd(val, f_hi[k], hi);
      }
    }
    s_lo[i] = lo;
    s_hi[i] = hi;
  }
  __syncthreads();

  // Phase 2, axis -2: output p, tap k reads staged row p + hlen - 1 - k.
  for (int i = tid; i < rp.tr * TC; i += kThreads) {
    const int p = i / TC, c = i - p * TC;
    const long long orow = rho + static_cast<long long>(rp.cls) * (m0 + p);
    const int col = c0 + c;
    if (orow >= nr || col >= nc) continue;
    T sa = 0, sh = 0, sv = 0, sd = 0;
    for (int k = 0; k < hlen; ++k) {
      const int q = (p + hlen - 1 - k) * TC + c;
      const T l = s_lo[q], g = s_hi[q];
      sa = fmadd(l, f_lo[k], sa);
      sh = fmadd(l, f_hi[k], sh);
      sv = fmadd(g, f_lo[k], sv);
      sd = fmadd(g, f_hi[k], sd);
    }
    const long long o = blockIdx.z * plane + orow * nc + col;
    a[o] = sa;
    h[o] = sh;
    v[o] = sv;
    d[o] = sd;
  }
}

// Rows: Wrapped (K9), or the Halo<T, 4> of the shard's planes a, h, v, d
// (K27b).
template <class T, class Rows>
__global__ void __launch_bounds__(kThreads)
iswt2d_kernel(const T* __restrict__ a, const T* __restrict__ h,
              const T* __restrict__ v, const T* __restrict__ d,
              T* __restrict__ out, int nr, int nc, RowPlan rp,
              TapsT<T> half_taps, TapOffsets coff, int hlen, unsigned y0,
              Rows halo) {
  __shared__ T s_p[kStageRows * TC];  // syn_-1(a, v) on staged rows
  __shared__ T s_q[kStageRows * TC];  // syn_-1(h, d)
  __shared__ T g_lo[kMaxTaps], g_hi[kMaxTaps];
  __shared__ int s_off[kMaxTaps];
  __shared__ int s_row[kStageRows];

  const int tid = threadIdx.x;
  const unsigned by = y0 + blockIdx.y;  // unsigned: the cheaper division
  const int rho = by / rp.tiles;
  const int m0 = (by - rho * rp.tiles) * rp.tr;
  const int c0 = blockIdx.x * TC;
  const int rows = rp.tr + hlen - 1;
  const long long plane = static_cast<long long>(nr) * nc;
  const long long pb = blockIdx.z * plane;

  if (tid < hlen) {
    g_lo[tid] = half_taps.lo[tid];
    g_hi[tid] = half_taps.hi[tid];
    s_off[tid] = coff.k[tid];
  }
  if (tid < rows) s_row[tid] = staged_row<Rows::kHalo>(rp, rho, m0, tid, nr);
  __syncthreads();

  for (int i = tid; i < rows * TC; i += kThreads) {
    const int q = i / TC, col = c0 + i - q * TC;
    T sp = 0, sq = 0;
    const T *ar, *hr, *vr, *dr;
    if constexpr (Rows::kHalo) {
      const auto hz = halo.plane(blockIdx.z, nc);
      ar = hz.row(0, a + pb, s_row[q], nr, nc);
      hr = hz.row(1, h + pb, s_row[q], nr, nc);
      vr = hz.row(2, v + pb, s_row[q], nr, nc);
      dr = hz.row(3, d + pb, s_row[q], nr, nc);
    } else {
      const long long rb = pb + static_cast<long long>(s_row[q]) * nc;
      ar = a + rb;
      hr = h + rb;
      vr = v + rb;
      dr = d + rb;
    }
    if (col < nc && ar) {
      for (int k = 0; k < hlen; ++k) {
        const int off = s_off[k];
        sp = fmadd(col_tap(ar, col, off, nc), g_lo[k], sp);
        sp = fmadd(col_tap(vr, col, off, nc), g_hi[k], sp);
        sq = fmadd(col_tap(hr, col, off, nc), g_lo[k], sq);
        sq = fmadd(col_tap(dr, col, off, nc), g_hi[k], sq);
      }
    }
    s_p[i] = sp;
    s_q[i] = sq;
  }
  __syncthreads();

  for (int i = tid; i < rp.tr * TC; i += kThreads) {
    const int p = i / TC, c = i - p * TC;
    const long long orow = rho + static_cast<long long>(rp.cls) * (m0 + p);
    const int col = c0 + c;
    if (orow >= nr || col >= nc) continue;
    T s = 0;
    for (int k = 0; k < hlen; ++k) {
      const int q = (p + hlen - 1 - k) * TC + c;
      s = fmadd(s_p[q], g_lo[k], s);
      s = fmadd(s_q[q], g_hi[k], s);
    }
    out[pb + orow * nc + col] = s;
  }
}

// The level's row tiling and column offsets, or false if the arguments are
// out of range. Its blocks: (nc + TC - 1) / TC columns x rp.cls * rp.tiles
// rows (at most 2 nr) x batch planes.
bool plan_level(int batch, int nr, int nc, int level, int s, int hlen,
                RowPlan* rp, TapOffsets* coff, bool halo = false) {
  if (hlen < 1 || hlen > kMaxTaps || s < 0 || s >= hlen || nr < 1 ||
      nc < 1 || nr > 0x3fffffff || nc > 0x3fffffff || level < 1 || batch < 1)
    return false;
  *rp = row_plan(hlen, s, level, nr, halo);
  *coff = dilated_offsets(hlen, s, level, nc);
  return true;
}

template <class T>
int launch_swt(const T* x, T* a, T* h, T* v, T* d, int batch, int nr, int nc,
               int level, int centre, const T* dec_lo, const T* dec_hi,
               int hlen, int device, void* stream) {
  RowPlan rp;
  TapOffsets coff;
  if (!plan_level(batch, nr, nc, level, centre, hlen, &rp, &coff))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TapsT<T> taps = make_taps(dec_lo, dec_hi, hlen);
  launch_chunks((nc + TC - 1) / TC, rp.cls * rp.tiles, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long p = static_cast<long long>(z0) * nr * nc;
                  swt2d_kernel<T, Wrapped><<<
                      grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                      x + p, a + p, h + p, v + p, d + p, nr, nc, rp, taps,
                      coff, hlen, y0, Wrapped{});
                });
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_iswt(const T* a, const T* h, const T* v, const T* d, T* out,
                int batch, int nr, int nc, int level, int centre,
                const T* rec_lo, const T* rec_hi, int hlen, int device,
                void* stream) {
  RowPlan rp;
  TapOffsets coff;
  if (!plan_level(batch, nr, nc, level, centre, hlen, &rp, &coff))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // rec / 2 is exact: the 1/2 of each axis pass
  T lo2[kMaxTaps], hi2[kMaxTaps];
  for (int k = 0; k < hlen; ++k) {
    lo2[k] = T(0.5) * rec_lo[k];
    hi2[k] = T(0.5) * rec_hi[k];
  }
  const TapsT<T> taps = make_taps<T>(lo2, hi2, hlen);
  launch_chunks((nc + TC - 1) / TC, rp.cls * rp.tiles, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long p = static_cast<long long>(z0) * nr * nc;
                  iswt2d_kernel<T, Wrapped><<<
                      grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                      a + p, h + p, v + p, d + p, out + p, nr, nc, rp, taps,
                      coff, hlen, y0, Wrapped{});
                });
  return static_cast<int>(cudaGetLastError());
}

// K27a: the level of one row shard x of (batch, nr, nc), its rows above and
// below from top (batch, lp, nc) and bot (batch, rp, nc), the exact dilated
// pads of the level.
template <class T>
int launch_swt_sharded(const T* x, const T* top, const T* bot, T* a, T* h,
                       T* v, T* d, int batch, int nr, int nc, int level,
                       int centre, int lp, int rp, const T* dec_lo,
                       const T* dec_hi, int hlen, int device, void* stream) {
  RowPlan rp_;
  TapOffsets coff;
  if (!stationary_halos_ok(hlen, centre, level, lp, rp) ||
      !plan_level(batch, nr, nc, level, centre, hlen, &rp_, &coff, true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TapsT<T> taps = make_taps(dec_lo, dec_hi, hlen);
  const Halo<T, 1> halo = make_halo(top, bot, lp, rp);
  launch_chunks((nc + TC - 1) / TC, rp_.cls * rp_.tiles, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long p = static_cast<long long>(z0) * nr * nc;
                  swt2d_kernel<T, Halo<T, 1>><<<
                      grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                      x + p, a + p, h + p, v + p, d + p, nr, nc, rp_, taps,
                      coff, hlen, y0, halo.plane(z0, nc));
                });
  return static_cast<int>(cudaGetLastError());
}

// K27b: the synthesis of one row shard's planes, each with its halo pair.
template <class T>
int launch_iswt_sharded(const T* const* planes, const T* const* tops,
                        const T* const* bots, T* out, int batch, int nr,
                        int nc, int level, int centre, int lp, int rp,
                        const T* rec_lo, const T* rec_hi, int hlen,
                        int device, void* stream) {
  RowPlan rp_;
  TapOffsets coff;
  if (!stationary_halos_ok(hlen, centre, level, lp, rp) ||
      !plan_level(batch, nr, nc, level, centre, hlen, &rp_, &coff, true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  T lo2[kMaxTaps], hi2[kMaxTaps];
  for (int k = 0; k < hlen; ++k) {
    lo2[k] = T(0.5) * rec_lo[k];
    hi2[k] = T(0.5) * rec_hi[k];
  }
  const TapsT<T> taps = make_taps<T>(lo2, hi2, hlen);
  const Halo<T, 4> halo = make_halo4(tops, bots, lp, rp);
  launch_chunks((nc + TC - 1) / TC, rp_.cls * rp_.tiles, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long p = static_cast<long long>(z0) * nr * nc;
                  iswt2d_kernel<T, Halo<T, 4>><<<
                      grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                      planes[0] + p, planes[1] + p, planes[2] + p,
                      planes[3] + p, out + p, nr, nc, rp_, taps, coff, hlen,
                      y0, halo.plane(z0, nc));
                });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pypwt

// All return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. The filters are host arrays of hlen values of the
// data's type; `centre` is the a-trous centre s of the direction.
extern "C" int pypwt_swt2d(const float* x, float* a, float* h, float* v,
                           float* d, int batch, int nr, int nc, int level,
                           int centre, const float* dec_lo,
                           const float* dec_hi, int hlen, int device,
                           void* stream) {
  return pypwt::launch_swt(x, a, h, v, d, batch, nr, nc, level, centre,
                           dec_lo, dec_hi, hlen, device, stream);
}

extern "C" int pypwt_swt2d_f64(const double* x, double* a, double* h,
                               double* v, double* d, int batch, int nr,
                               int nc, int level, int centre,
                               const double* dec_lo, const double* dec_hi,
                               int hlen, int device, void* stream) {
  return pypwt::launch_swt(x, a, h, v, d, batch, nr, nc, level, centre,
                           dec_lo, dec_hi, hlen, device, stream);
}

extern "C" int pypwt_iswt2d(const float* a, const float* h, const float* v,
                            const float* d, float* out, int batch, int nr,
                            int nc, int level, int centre,
                            const float* rec_lo, const float* rec_hi,
                            int hlen, int device, void* stream) {
  return pypwt::launch_iswt(a, h, v, d, out, batch, nr, nc, level, centre,
                            rec_lo, rec_hi, hlen, device, stream);
}

extern "C" int pypwt_iswt2d_f64(const double* a, const double* h,
                                const double* v, const double* d,
                                double* out, int batch, int nr, int nc,
                                int level, int centre, const double* rec_lo,
                                const double* rec_hi, int hlen, int device,
                                void* stream) {
  return pypwt::launch_iswt(a, h, v, d, out, batch, nr, nc, level, centre,
                            rec_lo, rec_hi, hlen, device, stream);
}

// K27a / K27b: the levels of one row shard (K8's / K9's maps, rows read
// through the halos): top of (batch, lp, nc) and bot of (batch, rp, nc),
// (lp, rp) = ((hlen - 1 - centre), centre) * 2^(level-1). K27b's halos are
// the eight halo tensors in JAX's order (a_top, a_bot, h_top, h_bot, v_top,
// v_bot, d_top, d_bot).
extern "C" int pypwt_swt2d_sharded(const float* x, const float* top,
                                   const float* bot, float* a, float* h,
                                   float* v, float* d, int batch, int nr,
                                   int nc, int level, int centre, int lp,
                                   int rp, const float* dec_lo,
                                   const float* dec_hi, int hlen, int device,
                                   void* stream) {
  return pypwt::launch_swt_sharded(x, top, bot, a, h, v, d, batch, nr, nc,
                                   level, centre, lp, rp, dec_lo, dec_hi,
                                   hlen, device, stream);
}

extern "C" int pypwt_swt2d_sharded_f64(const double* x, const double* top,
                                       const double* bot, double* a,
                                       double* h, double* v, double* d,
                                       int batch, int nr, int nc, int level,
                                       int centre, int lp, int rp,
                                       const double* dec_lo,
                                       const double* dec_hi, int hlen,
                                       int device, void* stream) {
  return pypwt::launch_swt_sharded(x, top, bot, a, h, v, d, batch, nr, nc,
                                   level, centre, lp, rp, dec_lo, dec_hi,
                                   hlen, device, stream);
}

extern "C" int pypwt_iswt2d_sharded(const float* a, const float* h,
                                    const float* v, const float* d,
                                    const float* const* halos, float* out,
                                    int batch, int nr, int nc, int level,
                                    int centre, int lp, int rp,
                                    const float* rec_lo, const float* rec_hi,
                                    int hlen, int device, void* stream) {
  const float* planes[4] = {a, h, v, d};
  const float* tops[4] = {halos[0], halos[2], halos[4], halos[6]};
  const float* bots[4] = {halos[1], halos[3], halos[5], halos[7]};
  return pypwt::launch_iswt_sharded(planes, tops, bots, out, batch, nr, nc,
                                    level, centre, lp, rp, rec_lo, rec_hi,
                                    hlen, device, stream);
}

extern "C" int pypwt_iswt2d_sharded_f64(const double* a, const double* h,
                                        const double* v, const double* d,
                                        const double* const* halos,
                                        double* out, int batch, int nr,
                                        int nc, int level, int centre, int lp,
                                        int rp, const double* rec_lo,
                                        const double* rec_hi, int hlen,
                                        int device, void* stream) {
  const double* planes[4] = {a, h, v, d};
  const double* tops[4] = {halos[0], halos[2], halos[4], halos[6]};
  const double* bots[4] = {halos[1], halos[3], halos[5], halos[7]};
  return pypwt::launch_iswt_sharded(planes, tops, bots, out, batch, nr, nc,
                                    level, centre, lp, rp, rec_lo, rec_hi,
                                    hlen, device, stream);
}
