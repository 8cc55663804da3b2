// The persistent tile walk of the grid's row passes (axis -2 of one shard):
// K29g / K29h (tc_dwt2d.cu, on the tensor cores) and K29d (axis_rows.cu,
// a tap loop).
//
// The grid is what the SMs hold at once (the occupancy API). A block walks
// tiles of tr rows (output rows, or coefficient rows) by kCols columns,
// t = blockIdx.x, + gridDim.x, ...; while its threads compute one tile, the
// windows of its next tile are in flight in the other of two slots, staged
// by cp.async from a table of that tile's source rows (the shard's rows and
// halo rows resolved once per window row, in 32-bit arithmetic, so that no
// copy tests a halo or divides). A window row holds the tile's own columns
// (the row passes read no column halo), 16-byte copies where nc is a whole
// number of 16-byte runs and the row is 16-byte aligned, sample copies
// otherwise, zero past nc and where the table has no row (past both
// halos).
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace pypwt {
namespace row_walk {

// The tiles of one launch, row tile t / col_tiles and column tile t %
// col_tiles; block b takes tiles b + j gridDim.x.
struct Plan {
  long long tiles;
  int col_tiles;
};

// The two slots of a block's windows: kPlanes windows of `win` rows `ld`
// samples apart a slot, `plane` samples from one plane to the next and
// `slot` from one slot to the next; and their source rows, kPlanes x win a
// slot (plane p's row r at src[p win + r]), `table` pointers apart.
template <class T>
struct Slots {
  T* in;
  const T** src;
  int win, ld, plane, slot, table;
};

// 16 bytes of zero: four floats or two doubles.
template <class T>
__device__ __forceinline__ void zero16(T* d);
template <>
__device__ __forceinline__ void zero16(float* d) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
}
template <>
__device__ __forceinline__ void zero16(double* d) {
  d[0] = d[1] = 0.0;
}

// Issue the asynchronous copies of the kPlanes windows of one slot into
// `in`: window row r of plane p holds columns c0 .. c0 + kCols - 1 of row
// src[p win + r], zero where that row is missing and past nc. Rows of a
// whole number of 16-byte runs go in 16-byte copies (c0 is a multiple of
// kCols) where the row is 16-byte aligned, every other row in sample
// copies.
template <class T, int kCols, int kPlanes>
__device__ __forceinline__ void issue_rows(T* in, const T* const* src,
                                           int win, int ld, int plane,
                                           int c0, int nc) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kQ = kCols / kVec;
  const bool quads = nc % kVec == 0;
  for (int i = threadIdx.x; i < win * kQ; i += kThreads) {
    const int r = i / kQ, q = i - r * kQ;
    const int c = c0 + kVec * q;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const T* s = src[p * win + r];
      T* d = in + p * plane + r * ld + kVec * q;
      if (s == nullptr || c >= nc) {
        zero16(d);
      } else if (quads && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
        mma::cp_async16(d, s + c);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if (c + e < nc)
            mma::cp_async_sample(d + e, s + c + e);
          else
            d[e] = T(0);
        }
      }
    }
  }
}

// Walk the block's tiles t = b, b + gridDim.x, ..., the tile at rows r0 ..
// r0 + tr - 1 and columns c0 ..: table(r0, src) fills a slot's source rows
// (kPlanes x win), issue_rows its copies, one commit group per tile;
// product(r0, c0, in, band) computes the tile from its slot's windows once
// they have landed, while the next tile's fly. The band (make_band(): the
// tensor-core forms' fragments; anything for a tap loop) is built while
// the first tile's copies fly. Two barriers a tile: the next table visible
// (and the slot it fills read by the tile before), the tile's windows
// visible. Blocks of kThreads threads.
template <class T, int kCols, int kPlanes, class Table, class MakeBand,
          class Product>
__device__ __forceinline__ void walk_tiles(const Slots<T>& sm,
                                           const Plan& plan, int tr, int nc,
                                           Table table, MakeBand make_band,
                                           Product product) {
  const auto r0 = [&](long long t) {
    return static_cast<int>(t / plan.col_tiles) * tr;
  };
  const auto c0 = [&](long long t) {
    return static_cast<int>(t % plan.col_tiles) * kCols;
  };
  long long t = blockIdx.x;
  if (t < plan.tiles) table(r0(t), sm.src);
  __syncthreads();
  if (t < plan.tiles)
    issue_rows<T, kCols, kPlanes>(sm.in, sm.src, sm.win, sm.ld, sm.plane,
                                  c0(t), nc);
  mma::cp_async_commit();
  const auto band = make_band();
  for (int slot = 0; t < plan.tiles; t += gridDim.x, slot ^= 1) {
    const long long next = t + gridDim.x;
    const T** src = sm.src + (slot ^ 1) * sm.table;
    if (next < plan.tiles) table(r0(next), src);
    __syncthreads();
    if (next < plan.tiles)
      issue_rows<T, kCols, kPlanes>(sm.in + (slot ^ 1) * sm.slot, src,
                                    sm.win, sm.ld, sm.plane, c0(next), nc);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    product(r0(t), c0(t), static_cast<const T*>(sm.in + slot * sm.slot),
            band);
  }
}

// The launch of a persistent instance (kThreads a block) over the tiles of
// `rows` rows of nc samples: the plan, and a grid of what the SMs hold at
// once (the occupancy API), at most a block a tile.
template <class Kernel>
cudaError_t plan_tiles(const TileInstance<Kernel>& inst, int rows, int nc,
                       int device, Plan* plan, unsigned* grid) {
  if (inst.kernel == nullptr) return cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = device_sms(device, &sms);
  if (err == cudaSuccess) err = allow_smem(inst);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inst.kernel,
                                                        kThreads, inst.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  plan->col_tiles = (nc + inst.tc - 1) / inst.tc;
  plan->tiles =
      static_cast<long long>((rows + inst.tr - 1) / inst.tr) * plan->col_tiles;
  *grid = static_cast<unsigned>(std::min<long long>(
      static_cast<long long>(per_sm) * sms, plan->tiles));
  return cudaSuccess;
}

}  // namespace row_walk
}  // namespace pypwt
