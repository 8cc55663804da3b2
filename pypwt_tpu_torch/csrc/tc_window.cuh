// Shared pieces of the 2D tensor-core level kernels whose windows start on
// a coefficient and step by one or by a dilation on both axes: the
// stationary pair K11a / K11b and K28's stationary halves (tc_swt2d.cu),
// and the decimating pair K5 / K6 with K28's DWT halves (tc_dwt2d.cu),
// whose analysis window starts on sample 2 m0 of its first output m0.
//
// A block owns kTile x kTile outputs of one residue class per axis (the
// synthesis: kTile x kTile coefficients). It stages one window per input
// plane in shared memory: a table of source rows, resolved once per window
// row (where a shard's halos are resolved, not once per sample), and the
// axis column of each window column, then asynchronous copies of every
// sample at once (16-byte copies read shifted where the rows allow, 4-byte
// ones elsewhere), the band's fragments built while they fly. The passes run
// groups of output tiles that share each A fragment (band_tiles).
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace pypwt {
namespace {

constexpr int kTile = 32;
constexpr int kWarps = kThreads / 32;

// Tiling of one axis of n samples at a stationary level: residue classes
// rho < cls (the dilation, or n where the dilation reaches it) hold samples
// rho + cls * m; `tiles` tiles of kTile per class (of class 0, the longest).
struct AxisPlan {
  int n;
  int cls;
  int tiles;
  int back;      // hlen - 1 - s: window sample w serves offset w - back
  long long fm;  // dilation mod n (or not: a halo axis)
};

// One axis of the decimating synthesis: one class, window samples a
// coefficient apart, window sample w of the block at m0 holding coefficient
// m0 + w - back (the polyphase centre c); 32-bit index arithmetic.
struct UnitPlan {
  static constexpr int cls = 1;
  int n;
  int back;
};

// One axis of the decimating analysis: one class, window samples a sample
// apart, window sample w of the block at output m0 holding axis sample
// 2 m0 + w - back (analysis_lpad); 32-bit index arithmetic.
struct HalfPlan {
  static constexpr int cls = 1;
  int n;
  int back;
};

// Axis sample held in window sample w of the block (rho, m0): reduced mod
// n, or (kHalo) the row of the shard's extended axis.
template <bool kHalo = false>
__device__ __forceinline__ int window_index(const AxisPlan& p, int rho, int m0,
                                            int w) {
  long long i = rho + static_cast<long long>(p.cls) * m0 +
                static_cast<long long>(w - p.back) * p.fm;
  if (kHalo) return static_cast<int>(i);
  i %= p.n;
  return static_cast<int>(i < 0 ? i + p.n : i);
}

template <bool kHalo = false>
__device__ __forceinline__ int window_index(const UnitPlan& p, int, int m0,
                                            int w) {
  const int i = m0 + w - p.back;
  return kHalo ? i : wrap(i, p.n);
}

template <bool kHalo = false>
__device__ __forceinline__ int window_index(const HalfPlan& p, int, int m0,
                                            int w) {
  const int i = 2 * m0 + w - p.back;
  return kHalo ? i : wrap(i, p.n);
}

// Block coordinates of one level: the residue class and first member of
// its rows and columns.
struct Block {
  int rho_r, m0, rho_c, q0;
  template <class Plan>
  __device__ Block(const Plan& pr, const Plan& pc, int y0) {
    const int bx = blockIdx.x, by = y0 + blockIdx.y;
    rho_c = bx % pc.cls;
    q0 = bx / pc.cls * kTile;
    rho_r = by % pr.cls;
    m0 = by / pr.cls * kTile;
  }
};

// The row source of the block's plane (blockIdx.z): a shard's halos move
// with the plane, Wrapped has nothing to move.
__device__ __forceinline__ Wrapped plane_rows(Wrapped w, int) { return w; }

template <int kPlanes>
__device__ __forceinline__ Halo<float, kPlanes> plane_rows(
    const Halo<float, kPlanes>& h, int nc) {
  return h.plane(blockIdx.z, nc);
}

// The windows' sources, resolved once per window row, not once per sample:
// src[p kWin + r] is plane p's row of window row r, null past the window's
// extent `ext` or (Halo) past both halos; col[c] the axis column of window
// column c, -1 past the extent. Planes: the block's plane of each of
// kPlanes inputs (x; or a, h, v, d); rows: Wrapped or the Halo<float,
// kPlanes> moved to that plane; Plan: AxisPlan or UnitPlan.
template <class G, int kPlanes, class Plan, class Rows>
__device__ __forceinline__ void window_sources(
    const float* const (&planes)[kPlanes], const float** src, int* col,
    const Plan& pr, const Plan& pc, const Block& blk, int ext,
    const Rows& rows) {
  for (int r = threadIdx.x; r < G::kWin; r += kThreads) {
    const int row = window_index<Rows::kHalo>(pr, blk.rho_r, blk.m0, r);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const float* s = nullptr;
      if (r < ext) {
        if constexpr (Rows::kHalo)
          s = rows.row(p, planes[p], row, pr.n, pc.n);
        else
          s = planes[p] + static_cast<long long>(row) * pc.n;
      }
      src[p * G::kWin + r] = s;
    }
  }
  for (int c = threadIdx.x; c < G::kWinC; c += kThreads)
    col[c] = c < ext ? window_index(pc, blk.rho_c, blk.q0, c) : -1;
}

// Issue the asynchronous copies of the kPlanes windows into `in` (zero
// where the source row is missing); the caller commits, waits and
// synchronises. Every sample of the thread is in flight at once.
// base >= 0 (one class of columns stepping by 1, rows of a multiple of 4
// samples): window column c holds axis column (base + c) mod n, base the
// window's first column rounded down to a multiple of 4 (the caller reads
// the window shifted by the remainder), in 16-byte copies, or 4-byte ones
// from a row that is not 16-byte aligned; columns past the window's extent
// hold samples that only zero taps meet. base < 0 (any other columns, a
// stationary level's gather strided by the dilation among them): a warp
// takes whole window rows, a lane the same columns col[c] of each, zero
// past the extent.
template <class G, int kPlanes>
__device__ __forceinline__ void issue_windows(float* in,
                                              const float* const* src,
                                              const int* col, int base,
                                              int n) {
  constexpr int kPlane = G::kWin * G::kLdW;
  if (base >= 0) {
    constexpr int kQuads = (G::kWinC + 3 + 3) / 4;  // kWinC shifted by <= 3
    static_assert(4 * kQuads <= G::kLdW, "a shifted window row must fit");
    for (int i = threadIdx.x; i < G::kWin * kQuads; i += kThreads) {
      const int r = i / kQuads, q = i - r * kQuads;
      const int j = (base + 4 * q) % n;
      float* dst = in + r * G::kLdW + 4 * q;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const float* s = src[p * G::kWin + r];
        float* d = dst + p * kPlane;
        if (s == nullptr) {
          d[0] = d[1] = d[2] = d[3] = 0.f;
        } else if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
          mma::cp_async16(d, s + j);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) mma::cp_async4(d + e, s + j + e);
        }
      }
    }
    return;
  }
  constexpr int kLanes = (G::kWinC + 31) / 32;
  const int lane = threadIdx.x & 31;
  int j[kLanes];
#pragma unroll
  for (int q = 0; q < kLanes; ++q)
    j[q] = lane + 32 * q < G::kWinC ? col[lane + 32 * q] : -1;
  for (int r = threadIdx.x >> 5; r < G::kWin; r += kWarps) {
    const float* s[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) s[p] = src[p * G::kWin + r];
    float* dst = in + r * G::kLdW + lane;
#pragma unroll
    for (int q = 0; q < kLanes; ++q) {
      if (lane + 32 * q >= G::kWinC) continue;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        float* d = dst + p * kPlane + 32 * q;
        if (s[p] != nullptr && j[q] >= 0)
          mma::cp_async4(d, s[p] + j[q]);
        else
          *d = 0.f;
      }
    }
  }
}

// Stage the windows of kPlanes planes (window rows and columns of extent
// `ext`): their sources, the taps (load_taps()), the asynchronous copies,
// and the band's fragments (make_band(), returned), built while the copies
// fly; on return the windows are in shared memory, visible to the block,
// to be read shifted by `shift` columns (issue_windows).
template <class G, int kPlanes, class Plan, class Rows, class LoadTaps,
          class MakeBand>
__device__ __forceinline__ auto stage_windows(
    const float* const (&planes)[kPlanes], float* in, const float** src,
    int* col, const Plan& pr, const Plan& pc, const Block& blk,
    int ext, const Rows& rows, int& shift, LoadTaps load_taps,
    MakeBand make_band) {
  window_sources<G>(planes, src, col, pr, pc, blk, ext, rows);
  load_taps();
  __syncthreads();
  const int first = window_index(pc, blk.rho_c, blk.q0, 0);
  const bool quads = pc.cls == 1 && pc.n % 4 == 0;
  shift = quads ? first % 4 : 0;
  issue_windows<G, kPlanes>(in, src, col, quads ? first - shift : -1, pc.n);
  mma::cp_async_commit();
  const auto b = make_band();
  mma::cp_async_wait<0>();
  __syncthreads();
  return b;
}

// kR output tiles of a synthesis pass whose windows start kK samples
// apart: c[r] += the products of mma::band_product_pair for tile r, in its
// order. The A fragment of window block f serves tile r at k-step f - r,
// so each fragment is loaded (and, in "highest", split) once for up to kR
// tiles.
template <class P, int kSteps, int kR, class Elem0, class Elem1>
__device__ __forceinline__ void band_tiles(float (&c)[kR][4], Elem0 elem0,
                                           Elem1 elem1,
                                           const typename P::B (&b0)[kSteps],
                                           const typename P::B (&b1)[kSteps]) {
#pragma unroll
  for (int f = 0; f < kSteps + kR - 1; ++f) {
    const auto a0 =
        P::load_a([&](int m, int k) { return elem0(f * P::kK + k, m); });
    const auto a1 =
        P::load_a([&](int m, int k) { return elem1(f * P::kK + k, m); });
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int s = f - r;
      if (s >= 0 && s < kSteps) {
        P::mma(c[r], a0, b0[s]);
        P::mma(c[r], a1, b1[s]);
      }
    }
  }
}

// The first output of group g of a pass's output tiles of 8: a group is kR
// tiles whose windows start one k-step apart, kEvery tiles (8 kEvery
// outputs) apart, and kEvery such groups interleave.
template <int kEvery, int kR>
__device__ __forceinline__ int group_first(int g) {
  return (g / kEvery * kR * kEvery + g % kEvery) * 8;
}

// The occupancy API's resident blocks per SM of an instance, and its
// dynamic shared memory in bytes: a figure for reports.
template <class Kernel>
int occupancy(const mma::Instance<Kernel>& inst, int device, int* blocks,
              int* smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<int>(inst.smem);
  err = cudaFuncSetAttribute(inst.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, inst.kernel, kThreads, inst.smem));
}

}  // namespace
}  // namespace pypwt
