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
// columns stay periodic. The analysis's float64 instance (pypwt_swt2d_f64)
// stages 36 KB of static shared memory.
//
// The synthesis (K9, K27b) reads four planes per output and is the
// costlier of the two. Its blocks are kSynTR rows of one class by kSynTC
// columns. A table of each staged row's four source rows is built once per
// block (a shard's halos resolved there, not once per sample). Where the
// four column windows, kSynTC + (hlen - 1) * (dilation mod nc) samples
// wide, fit kStageBudget, the block stages them in dynamic shared memory
// by cp.async, every copy of a thread in flight at once and the period
// wrap resolved per copy (16-byte copies from the window's first column
// rounded down to 16 bytes, read shifted, where nc allows; one-sample
// copies otherwise), so phase 1 reads shared memory with no wrap test;
// wider windows (sym20 and deep levels) keep phase 1's reads through the
// read-only cache, from the same table. Phase 2 gives a thread kOutRows
// rows of one column, loading each staged row once. Both phases take
// their taps from the kernel's parameters and keep the tap loop's order
// of accumulation, so the outputs do not depend on the path or the tile.

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

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
// int). tile: the rows of a block at most; tr a multiple of `step`.
RowPlan row_plan(int hlen, int s, int level, int nr, bool halo = false,
                 int tile = TR, int step = 1) {
  RowPlan p{};
  const bool every_row = level > 31 || (1LL << (level - 1)) >= nr;
  p.cls = every_row ? nr : (1 << (level - 1));
  const int per = (nr + p.cls - 1) / p.cls;  // rows of class 0, the longest
  p.tr = std::min(tile, (per + step - 1) / step * step);
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

// The synthesis (K9, K27b) and its tiles: kSynTR output rows of one
// residue class by kSynTC consecutive columns, kOutRows rows of one column
// per thread in phase 2. At db2 level 1 a block stages 45.8 KB and 4 stay
// resident per SM; 16, 20 and 32 rows measured slower on the 2048 x 8192
// shard (PERF.md), and 32 or 128 columns slower than 64.
constexpr int kSynTR = 24;
constexpr int kSynTC = 64;
constexpr int kOutRows = 4;
// Dynamic shared memory a block with staged windows may take: two such
// blocks, with the 1 KB the runtime keeps for each, fit in an SM's 228 KB.
// A level whose windows need more reads its taps from device memory.
constexpr int kStageBudget = 113 * 1024;

// One synthesis level's column windows, from the host. Window column w of
// the block at column c0 holds plane column c0 - back + w (mod nc), so tap
// k of output column c0 + c reads window column c + (hlen - 1 - k) fm.
struct SynPlan {
  int rows;   // staged rows of a block: rp.tr + hlen - 1
  int fm;     // the dilation mod nc
  int back;   // (hlen - 1 - s) fm mod nc
  int ldw;    // window row stride in samples; 0: no windows (direct reads)
  int quads;  // 16-byte copies: nc a multiple of 16 bytes of samples
  int nq;     // copies per window row and plane
};

constexpr int kWarps = kThreads / 32;
// Taps whose loads a thread issues together in the direct phase 1 (device
// memory) and in phase 2 (one staged row per tap); the staged phase 1
// measured faster one tap per trip.
constexpr int kTapChunk = 4;
static_assert(kMaxTaps % kTapChunk == 0, "whole chunks of taps");

// Rows: Wrapped (K9), or the Halo<T, 4> of the shard's planes a, h, v, d
// (K27b). kStaged: the four windows are staged in shared memory (SynPlan
// ldw > 0); else phase 1 reads its taps through the read-only cache.
// Dynamic shared memory: the windows (kStaged: 4 planes of rows x ldw),
// syn_-1(a, v) and syn_-1(h, d) on the staged rows (rows x kSynTC each),
// and the row table (4 x rows pointers).
template <class T, class Rows, bool kStaged>
__global__ void __launch_bounds__(kThreads)
iswt2d_kernel(const T* __restrict__ a, const T* __restrict__ h,
              const T* __restrict__ v, const T* __restrict__ d,
              T* __restrict__ out, int nr, int nc, RowPlan rp, SynPlan sy,
              TapsT<T> half_taps, TapOffsets coff, int hlen, unsigned y0,
              Rows halo) {
  const int tid = threadIdx.x;
  const unsigned by = y0 + blockIdx.y;  // unsigned: the cheaper division
  const int rho = by / rp.tiles;
  const int m0 = (by - rho * rp.tiles) * rp.tr;
  const int c0 = blockIdx.x * kSynTC;
  const int rows = sy.rows;
  const int plane_w = kStaged ? rows * sy.ldw : 0;
  const long long pb = blockIdx.z * (static_cast<long long>(nr) * nc);
  T* win = dynamic_smem<T>();
  T* s_p = win + 4 * plane_w;
  T* s_q = s_p + rows * kSynTC;
  const T** src = reinterpret_cast<const T**>(s_q + rows * kSynTC);

  // The row table, once per staged row: src[p rows + q] is plane p's row
  // of staged row q (a, h, v, d), null past a shard's halos.
  if (tid < rows) {
    const int r = staged_row<Rows::kHalo>(rp, rho, m0, tid, nr);
    const T* const body[4] = {a + pb, h + pb, v + pb, d + pb};
    if constexpr (Rows::kHalo) {
      const auto hz = halo.plane(blockIdx.z, nc);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        src[p * rows + tid] = hz.row(p, body[p], r, nr, nc);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        src[p * rows + tid] = body[p] + static_cast<long long>(r) * nc;
    }
  }
  __syncthreads();

  // The windows, every copy of the thread in flight at once, the period
  // wrap resolved per copy: 16-byte copies from the window's first column
  // rounded down to a multiple of kVec samples (read shifted by the
  // remainder; sample copies from a row that is not 16-byte aligned), or
  // sample copies where nc is not a multiple of kVec; zero for a row past
  // the halos. A warp copies whole rows.
  int shift = 0;
  if constexpr (kStaged) {
    constexpr int kVec = 16 / sizeof(T);
    int first = c0 - sy.back;
    if (first < 0) first += nc;
    if (sy.quads) {
      shift = first % kVec;
      first -= shift;
    }
    const int step = sy.quads ? kVec : 1;
    for (int r = tid >> 5; r < rows; r += kWarps) {
      const T* s[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) s[p] = src[p * rows + r];
      T* dst = win + r * sy.ldw;
      for (int q = tid & 31; q < sy.nq; q += 32) {
        int j = first + step * q;
        if (j >= nc) j %= nc;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          T* t = dst + p * plane_w + step * q;
          if (s[p] == nullptr) {
            for (int e = 0; e < step; ++e) t[e] = T(0);
          } else if (!sy.quads) {
            mma::cp_async_sample(t, s[p] + j);
          } else if ((reinterpret_cast<uintptr_t>(s[p]) & 15) == 0) {
            mma::cp_async16(t, s[p] + j);
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              mma::cp_async_sample(t + e, s[p] + j + e);
          }
        }
      }
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
  }

  // Phase 1, last axis, on the staged rows (zero for a row past a shard's
  // halos and for a column past nc): sp <- a, v and sq <- h, d, tap by tap.
  for (int i = tid; i < rows * kSynTC; i += kThreads) {
    const int q = i / kSynTC, c = i - q * kSynTC, col = c0 + c;
    T sp = 0, sq = 0;
    if (col < nc && src[q] != nullptr) {
      if constexpr (kStaged) {
        // tap k reads window column c + (hlen - 1 - k) fm
        const T* w = win + q * sy.ldw + shift + c + (hlen - 1) * sy.fm;
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          if (k >= hlen) break;
          sp = fmadd(w[0], half_taps.lo[k], sp);
          sp = fmadd(w[2 * plane_w], half_taps.hi[k], sp);
          sq = fmadd(w[plane_w], half_taps.lo[k], sq);
          sq = fmadd(w[3 * plane_w], half_taps.hi[k], sq);
          w -= sy.fm;
        }
      } else {
        // tap k reads plane column col + coff.k[k], wrapped once; the
        // loads of kTapChunk taps go out together (a tap k >= hlen reads
        // column col, never summed)
        const T* ar = src[q];
        const T* hr = src[rows + q];
        const T* vr = src[2 * rows + q];
        const T* dr = src[3 * rows + q];
#pragma unroll
        for (int k0 = 0; k0 < kMaxTaps; k0 += kTapChunk) {
          if (k0 >= hlen) break;
          T va[kTapChunk], vh[kTapChunk], vv[kTapChunk], vd[kTapChunk];
#pragma unroll
          for (int e = 0; e < kTapChunk; ++e) {
            int j = col + coff.k[k0 + e];
            if (j >= nc) j -= nc;
            va[e] = __ldg(ar + j);
            vh[e] = __ldg(hr + j);
            vv[e] = __ldg(vr + j);
            vd[e] = __ldg(dr + j);
          }
#pragma unroll
          for (int e = 0; e < kTapChunk; ++e) {
            const int k = k0 + e;
            if (k < hlen) {
              sp = fmadd(va[e], half_taps.lo[k], sp);
              sp = fmadd(vv[e], half_taps.hi[k], sp);
              sq = fmadd(vh[e], half_taps.lo[k], sq);
              sq = fmadd(vd[e], half_taps.hi[k], sq);
            }
          }
        }
      }
    }
    s_p[i] = sp;
    s_q[i] = sq;
  }
  __syncthreads();

  // Phase 2, axis -2: kOutRows outputs p0 + r of one column per thread; tap
  // k of output p0 + r reads staged row p0 + r + hlen - 1 - k, so the
  // thread loads each staged row once, kTapChunk rows at a time, and slides
  // it through registers.
  constexpr int R = kOutRows;
  for (int i = tid; i < rp.tr / R * kSynTC; i += kThreads) {
    const int g = i / kSynTC, c = i - g * kSynTC, col = c0 + c;
    if (col >= nc) continue;
    const int p0 = g * R;
    const T* bp = s_p + (p0 + hlen - 1) * kSynTC + c;
    const T* bq = s_q + (p0 + hlen - 1) * kSynTC + c;
    T wp[R], wq[R], acc[R];  // wp[r]: staged row p0 + r + hlen - 1 - k
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wp[r] = bp[r * kSynTC];
      wq[r] = bq[r * kSynTC];
      acc[r] = 0;
    }
#pragma unroll
    for (int k0 = 0; k0 < kMaxTaps; k0 += kTapChunk) {
      if (k0 >= hlen) break;
      T np[kTapChunk], nq[kTapChunk];  // the row entering after tap k0 + e
#pragma unroll
      for (int e = 0; e < kTapChunk; ++e) {
        const int o = min(k0 + e + 1, hlen - 1) * kSynTC;
        np[e] = bp[-o];
        nq[e] = bq[-o];
      }
#pragma unroll
      for (int e = 0; e < kTapChunk; ++e) {
        const int k = k0 + e;
        if (k < hlen) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r] = fmadd(wp[r], half_taps.lo[k], acc[r]);
            acc[r] = fmadd(wq[r], half_taps.hi[k], acc[r]);
          }
        }
#pragma unroll
        for (int r = R - 1; r > 0; --r) {
          wp[r] = wp[r - 1];
          wq[r] = wq[r - 1];
        }
        wp[0] = np[e];
        wq[0] = nq[e];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long orow =
          rho + static_cast<long long>(rp.cls) * (m0 + p0 + r);
      if (orow < nr) out[pb + orow * nc + col] = acc[r];
    }
  }
}

// The level's row tiling and column offsets, or false if the arguments are
// out of range. Its blocks: (nc + TC - 1) / TC columns x rp.cls * rp.tiles
// rows (at most 2 nr) x batch planes.
bool plan_level(int batch, int nr, int nc, int level, int s, int hlen,
                RowPlan* rp, TapOffsets* coff, bool halo = false,
                int tile = TR, int step = 1) {
  if (hlen < 1 || hlen > kMaxTaps || s < 0 || s >= hlen || nr < 1 ||
      nc < 1 || nr > 0x3fffffff || nc > 0x3fffffff || level < 1 || batch < 1)
    return false;
  *rp = row_plan(hlen, s, level, nr, halo, tile, step);
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

// The synthesis's windows for the rows of rp at columns nc (s the
// centre): staged where they fit kStageBudget, else none; *smem the
// block's dynamic shared memory in bytes.
template <class T>
SynPlan syn_plan(const RowPlan& rp, int hlen, int s, int level, int nc,
                 size_t* smem) {
  constexpr int kVec = 16 / sizeof(T);
  SynPlan p{};
  p.rows = rp.tr + hlen - 1;
  const long long fm = dilation_mod(level, nc);
  p.fm = static_cast<int>(fm);
  p.back = static_cast<int>((hlen - 1 - s) * fm % nc);
  const size_t rest = (2 * sizeof(T) * kSynTC + 4 * sizeof(const T*)) *
                      static_cast<size_t>(p.rows);
  const long long width = kSynTC + (hlen - 1) * fm;
  const long long ldw = (width + kVec - 1 + 3) / 4 * 4;
  const long long staged = 4 * sizeof(T) * p.rows * ldw + rest;
  *smem = rest;
  if (staged <= kStageBudget) {
    p.ldw = static_cast<int>(ldw);
    p.quads = nc % kVec == 0;
    p.nq = static_cast<int>(p.quads ? ldw / kVec : width);
    *smem = static_cast<size_t>(staged);
  }
  return p;
}

template <class T, class Rows>
using IswtKernel = void (*)(const T*, const T*, const T*, const T*, T*, int,
                            int, RowPlan, SynPlan, TapsT<T>, TapOffsets, int,
                            unsigned, Rows);

// The kernel, plans and dynamic shared memory of one synthesis level, or
// false if the arguments are out of range.
template <class T, class Rows>
bool iswt_level(int batch, int nr, int nc, int level, int centre, int hlen,
                RowPlan* rp, SynPlan* sp, TapOffsets* coff, size_t* smem,
                IswtKernel<T, Rows>* kernel) {
  if (!plan_level(batch, nr, nc, level, centre, hlen, rp, coff, Rows::kHalo,
                  kSynTR, kOutRows))
    return false;
  *sp = syn_plan<T>(*rp, hlen, centre, level, nc, smem);
  *kernel = sp->ldw ? iswt2d_kernel<T, Rows, true>
                    : iswt2d_kernel<T, Rows, false>;
  return true;
}

inline Wrapped at_plane(const Wrapped& rows, long long, int) { return rows; }
template <class T, int kPlanes>
Halo<T, kPlanes> at_plane(const Halo<T, kPlanes>& rows, long long z, int nc) {
  return rows.plane(z, nc);
}

// K9 (Wrapped) and K27b (Halo<T, 4>): one synthesis level of the planes a,
// h, v, d. Blocks: column tiles x row tiles x planes.
template <class T, class Rows>
int launch_iswt(const T* const (&planes)[4], T* out, int batch, int nr,
                int nc, int level, int centre, const T* rec_lo,
                const T* rec_hi, int hlen, int device, void* stream,
                const Rows& rows) {
  RowPlan rp;
  SynPlan sp;
  TapOffsets coff;
  size_t smem;
  IswtKernel<T, Rows> kernel;
  if (!iswt_level<T, Rows>(batch, nr, nc, level, centre, hlen, &rp, &sp,
                           &coff, &smem, &kernel))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // rec / 2 is exact: the 1/2 of each axis pass
  T lo2[kMaxTaps], hi2[kMaxTaps];
  for (int k = 0; k < hlen; ++k) {
    lo2[k] = T(0.5) * rec_lo[k];
    hi2[k] = T(0.5) * rec_hi[k];
  }
  const TapsT<T> taps = make_taps<T>(lo2, hi2, hlen);
  launch_chunks((nc + kSynTC - 1) / kSynTC, rp.cls * rp.tiles, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long p = static_cast<long long>(z0) * nr * nc;
                  kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
                      planes[0] + p, planes[1] + p, planes[2] + p,
                      planes[3] + p, out + p, nr, nc, rp, sp, taps, coff,
                      hlen, y0, at_plane(rows, z0, nc));
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

// K27b: the synthesis of one row shard's planes, each with its halo pair
// (halos in JAX's order: a_top, a_bot, h_top, ..., d_bot).
template <class T>
int launch_iswt_sharded(const T* const (&planes)[4], const T* const* halos,
                        T* out, int batch, int nr, int nc, int level,
                        int centre, int lp, int rp, const T* rec_lo,
                        const T* rec_hi, int hlen, int device, void* stream) {
  if (!stationary_halos_ok(hlen, centre, level, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* tops[4] = {halos[0], halos[2], halos[4], halos[6]};
  const T* bots[4] = {halos[1], halos[3], halos[5], halos[7]};
  return launch_iswt(planes, out, batch, nr, nc, level, centre, rec_lo,
                     rec_hi, hlen, device, stream,
                     make_halo4(tops, bots, lp, rp));
}

// The occupancy API's resident blocks per SM, the dynamic shared memory
// and the phase-1 path (1: staged windows) of the synthesis level that
// launch_iswt runs on (nr, nc) planes.
template <class T, class Rows>
int iswt_occupancy(int nr, int nc, int level, int centre, int hlen,
                   int device, int* blocks, int* smem, int* staged) {
  RowPlan rp;
  SynPlan sp;
  TapOffsets coff;
  size_t bytes;
  IswtKernel<T, Rows> kernel;
  if (!iswt_level<T, Rows>(1, nr, nc, level, centre, hlen, &rp, &sp, &coff,
                           &bytes, &kernel))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<int>(bytes);
  *staged = sp.ldw > 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, bytes));
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
  const float* planes[4] = {a, h, v, d};
  return pypwt::launch_iswt(planes, out, batch, nr, nc, level, centre, rec_lo,
                            rec_hi, hlen, device, stream, pypwt::Wrapped{});
}

extern "C" int pypwt_iswt2d_f64(const double* a, const double* h,
                                const double* v, const double* d,
                                double* out, int batch, int nr, int nc,
                                int level, int centre, const double* rec_lo,
                                const double* rec_hi, int hlen, int device,
                                void* stream) {
  const double* planes[4] = {a, h, v, d};
  return pypwt::launch_iswt(planes, out, batch, nr, nc, level, centre, rec_lo,
                            rec_hi, hlen, device, stream, pypwt::Wrapped{});
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
  return pypwt::launch_iswt_sharded(planes, halos, out, batch, nr, nc, level,
                                    centre, lp, rp, rec_lo, rec_hi, hlen,
                                    device, stream);
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
  return pypwt::launch_iswt_sharded(planes, halos, out, batch, nr, nc, level,
                                    centre, lp, rp, rec_lo, rec_hi, hlen,
                                    device, stream);
}

// K9's / K27b's instance for one level of (nr, nc) planes (f64 1: the
// float64 one; halo 1: K27b's Halo rows): resident blocks per SM, dynamic
// shared memory in bytes, and 1 where phase 1 reads staged windows, 0 where
// it reads through the read-only cache. A figure for reports.
extern "C" int pypwt_iswt2d_occupancy(int nr, int nc, int level, int centre,
                                      int hlen, int f64, int halo,
                                      int device, int* blocks, int* smem,
                                      int* staged) {
  using namespace pypwt;
  if (f64)
    return halo ? iswt_occupancy<double, Halo<double, 4>>(
                      nr, nc, level, centre, hlen, device, blocks, smem,
                      staged)
                : iswt_occupancy<double, Wrapped>(nr, nc, level, centre,
                                                  hlen, device, blocks, smem,
                                                  staged);
  return halo ? iswt_occupancy<float, Halo<float, 4>>(
                    nr, nc, level, centre, hlen, device, blocks, smem, staged)
              : iswt_occupancy<float, Wrapped>(nr, nc, level, centre, hlen,
                                               device, blocks, smem, staged);
}
