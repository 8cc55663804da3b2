// K11a / K11b: one periodized separable 2D stationary (a-trous) level and
// its inverse, float32, as banded products on the tensor cores; and the SWT
// half of K28, the same levels of one row shard.
//
// K11a replaces the TPU kernel pypwt_tpu/ops/mxu_swt.py::
// swt2d_level_fused_mxu (_build_swt2d_mxu, call :315), K11b
// ::iswt2d_level_fused_mxu (_build_iswt2d_mxu, :410): banded (or, at deep
// levels, polyphase) MXU dots D @ x on each axis. K28's
// pypwt_tc_swt2d_sharded / pypwt_tc_iswt2d_sharded replace
// ::build_swt2d_sharded_mxu (:656) and ::build_iswt2d_sharded_mxu (:737):
// the same kernels with the Halo row source (common.cuh). Their row windows
// lie on the shard's extended axis [-lp, nr + rp), so the rows' plan steps
// by the dilation itself, not its residue mod nr; a row is read from the
// shard or a halo where it lies (no padded copy); the columns stay periodic.
//
// Maps (the port's plain versions in ops/mxu_swt.py), planes (B?, Nr, Nc),
// any hlen <= 40, level l >= 1, dilation t = 2^(l-1); on either axis tap k
// reads sample i + (s - k) t, wrapped mod the axis length, with the centre s
// given by the caller (conv.swt_centre):
//   K11a: lo/hi along axis -2 (lo_r, hi_r), then along the last axis:
//         a = lo(lo_r), v = hi(lo_r), h = lo(hi_r), d = hi(hi_r) (K8's
//         subbands, in JAX's pass order);
//   K11b: along axis -2 t1 = syn(a, h), t2 = syn(v, d), then along the last
//         axis out = syn(t1, t2), syn(p, q)[i] = sum_k rec_lo[k]/2 p[j] +
//         rec_hi[k]/2 q[j], j = i + (s - k) t (1/2 per pass).
// The router gives them only levels whose dilated support fits in the
// plane (JAX's coverage); the index arithmetic here wraps at any level.
//
// Bound: the bytes of K8/K9, 20 per pixel (16 MiB in, 64 MiB out at 2048^2
// for K11a, the reverse for K11b: 25 us at 3.35 TB/s). A tile of 8 outputs
// spans kSteps k-steps of 8 or 16 samples (hlen + 7 of them non-zero), 3
// products each in "highest": at sym8 and 2048^2 about 2.4 GFLOP of TF32,
// 5 us at 495 TFLOP/s, so the kernels stay memory-bound.
//
// Design: along each axis a block owns outputs of one residue class mod t:
// rows rho_r + t m for kTile consecutive m and columns rho_c + t q for kTile
// consecutive q, as K8 does for its rows. Their taps then read samples of
// the same class only, kTile + hlen - 1 of them per axis at any level, so
// one compact (level-1) band serves every level: out[n] = sum_j f[j] w[n + j]
// with f[j] = tap[hlen-1-j] on the staged window w. The block stages that
// window in shared memory once (zero past its extent, where the band's zero
// entries meet it), runs pass 1 along axis -2 as the window read transposed
// times the band, keeps the result in shared memory, and runs pass 2 along
// the last axis as that result times the band; the band's fragments are
// built once per thread, in registers, and serve both passes. Blocks of
// neighbouring column classes are neighbours on the grid, so the sectors of
// a strided gather or store meet in L2. Column blocks run on the grid's x
// axis, row blocks on y, planes on z, in chunks past a grid's limits.
//
// Both directions stage their windows the same way: by cp.async, all of a
// thread's copies in flight at once, from a table of source rows built once
// per window row (where a shard's halos are resolved, not once per sample),
// in 16-byte copies at level 1 (from the window's first column rounded down
// to a multiple of 4, read shifted; 4-byte copies from a row that is not
// 16-byte aligned) and a warp per window row in the strided gathers of
// deeper levels; the band's fragments are built while the copies fly. The
// passes run groups of output tiles that share each A fragment, so a window
// sample is loaded (and, in "highest", split) once per group, not once per
// tile; a group's accumulators take the products in band_product's order,
// so the outputs do not depend on the grouping.
//
// The analysis (K11a, K28's) reads one plane and writes four: 16 of its 20
// bytes per pixel are stores. Its pass 2 puts the C fragments into an
// output tile in shared memory (the window's and lo_r/hi_r's space, free by
// then), and the block then writes whole tile rows, consecutive lanes on
// consecutive outputs: at level 1 a row of a plane is 128 contiguous bytes,
// written in 16-byte stores where the planes' rows are 16-byte aligned
// (scalar ones where not), instead of fragments that fill half of each
// 32-byte sector; at deeper levels the row's outputs lie a dilation apart,
// and only the neighbouring column classes' blocks fill the rest of their
// sectors. Its registers, not its shared memory, bound its resident
// blocks; the sym8 "highest" instance is promised four (swt_min_blocks).
// The synthesis (K11b, K28's) stages four windows per tile, 2.4 samples per
// output, and spends many instructions per sample.

#include "tc_window.cuh"

namespace pypwt {
namespace {

using mma::band;
using mma::Instance;
using mma::round16;

// The plan of one axis at a level (tc_window.cuh). halo: the rows of a
// shard (K28), whose window samples are rows of the extended axis
// [-lp, n + rp): fm is then the dilation itself, not reduced mod n (the
// caller bounds it: level <= 31, halos of int heights).
AxisPlan axis_plan(int hlen, int s, int level, int n, bool halo = false) {
  AxisPlan p{};
  p.n = n;
  const bool every = level > 31 || (1LL << (level - 1)) >= n;
  p.cls = every ? n : (1 << (level - 1));
  const int per = (n + p.cls - 1) / p.cls;
  p.tiles = (per + kTile - 1) / kTile;
  p.back = hlen - 1 - s;
  p.fm = halo ? 1LL << (level - 1) : dilation_mod(level, n);
  return p;
}

// Shared-memory geometry: kSteps k-steps of kK samples cover the hlen + 7
// window samples of an 8-output tile.
template <class P, int kSteps>
struct SwtGeom {
  static constexpr int kSpan = kSteps * P::kK;
  static constexpr int kWin = kTile - 8 + kSpan;  // window rows read
  static constexpr int kWinC = round16(kWin);     // window columns
  static constexpr int kLdW = mma::lead_dim<P>(kWinC, true);
  static constexpr int kLdT = mma::lead_dim<P>(kWinC, false);
};

// The synthesis taps rec / 2 (exact in float32: the 1/2 of each axis pass).
inline Taps half_taps(const float* rec_lo, const float* rec_hi, int hlen) {
  float lo2[kMaxTaps], hi2[kMaxTaps];
  for (int k = 0; k < hlen; ++k) {
    lo2[k] = 0.5f * rec_lo[k];
    hi2[k] = 0.5f * rec_hi[k];
  }
  return make_taps(lo2, hi2, hlen);
}

// The compact band of both filters, B[k][n] = f[k - n].
template <class P, int kSteps>
struct Band {
  typename P::B lo[kSteps], hi[kSteps];
  __device__ __forceinline__ Band(const float* f_lo, const float* f_hi,
                                  int hlen) {
    mma::band_fragments<P>(
        lo, [&](int k, int n) { return band(f_lo, k - n, hlen); });
    mma::band_fragments<P>(
        hi, [&](int k, int n) { return band(f_hi, k - n, hlen); });
  }
};

// Output (row, column) of product row m and column n of a pass-2 tile, or
// false past the plane.
struct Store {
  long long row, col;
  __device__ bool at(const AxisPlan& pr, const AxisPlan& pc, const Block& blk,
                     int m, int n) {
    row = blk.rho_r + static_cast<long long>(pr.cls) * (blk.m0 + m);
    col = blk.rho_c + static_cast<long long>(pc.cls) * (blk.q0 + n);
    return row < pr.n && col < pc.n;
  }
};

// Shared memory of the analysis: the window ([kWin][kLdW]) and lo_r/hi_r
// ([2 kTile][kLdT]), whose space the output tile takes after pass 2 (a, h,
// v, d; [kTile][kLdO] each: rows 8 floats apart mod 32, so that the C
// fragments' 8-byte stores meet each bank once per half-warp), the taps in
// window order, the source row of each window row and the axis column of
// each window column.
template <class G>
struct SwtSmem {
  static constexpr int kPlane = G::kWin * G::kLdW;
  static constexpr int kT = kTile * G::kLdT;
  static constexpr int kLdO = kTile + 8;
  static constexpr int kO = kTile * kLdO;
  static constexpr int kWork =
      kPlane + 2 * kT > 4 * kO ? kPlane + 2 * kT : 4 * kO;
  static constexpr int kFloats = kWork + 2 * kMaxTaps;
  static_assert(kFloats % 2 == 0, "the row table must be 8-byte aligned");
  static constexpr size_t kBytes = sizeof(float) * kFloats +
                                   sizeof(const float*) * G::kWin +
                                   sizeof(int) * G::kWinC;
  float *in, *t, *out, *f_lo, *f_hi;
  const float** src;
  int* col;
  __device__ explicit SwtSmem(float* base)
      : in(base),
        t(in + kPlane),
        out(base),
        f_lo(base + kWork),
        f_hi(f_lo + kMaxTaps),
        src(reinterpret_cast<const float**>(f_hi + kMaxTaps)),
        col(reinterpret_cast<int*>(src + G::kWin)) {}
};

// Shared memory of the synthesis: the four windows (a, h, v, d; [kWin][kLdW]
// each), t1/t2 ([kTile][kLdT] each), the taps in window order, the source
// row of each plane and window row and the axis column of each window
// column.
template <class G>
struct IswtSmem {
  static constexpr int kPlane = G::kWin * G::kLdW;
  static constexpr int kT = kTile * G::kLdT;
  static constexpr int kFloats = 4 * kPlane + 2 * kT + 2 * kMaxTaps;
  static_assert(kFloats % 2 == 0, "the row table must be 8-byte aligned");
  static constexpr size_t kBytes = sizeof(float) * kFloats +
                                   sizeof(const float*) * 4 * G::kWin +
                                   sizeof(int) * G::kWinC;
  float *in, *t, *f_lo, *f_hi;
  const float** src;
  int* col;
  __device__ explicit IswtSmem(float* base)
      : in(base),
        t(in + 4 * kPlane),
        f_lo(t + 2 * kT),
        f_hi(f_lo + kMaxTaps),
        src(reinterpret_cast<const float**>(f_hi + kMaxTaps)),
        col(reinterpret_cast<int*>(src + 4 * G::kWin)) {}
};

// Stage the windows of kPlanes planes (tc_window.cuh) with the taps in
// window order and the compact band, whose fragments are returned.
template <class P, int kSteps, int kPlanes, class Rows>
__device__ __forceinline__ Band<P, kSteps> stage_windows(
    const float* const (&planes)[kPlanes], float* in, const float** src,
    int* col, float* f_lo, float* f_hi, const AxisPlan& pr,
    const AxisPlan& pc, const Block& blk, const Taps& taps, int hlen,
    const Rows& rows, int& shift) {
  return pypwt::stage_windows<SwtGeom<P, kSteps>>(
      planes, in, src, col, pr, pc, blk, kTile + hlen - 1, rows, shift,
      [&] { load_reversed_taps(taps, hlen, f_lo, f_hi); },
      [&] { return Band<P, kSteps>(f_lo, f_hi, hlen); });
}

// kR output tiles of an analysis pass, kK samples apart: lo[r] and hi[r]
// get the products of mma::band_product for the tile at r kK, in its order
// (k-step 0 first, both bands from one A fragment). The A fragment of
// window block f serves tile r at k-step f - r.
template <class P, int kSteps, int kR, class Elem>
__device__ __forceinline__ void band_tiles_lohi(
    float (&lo)[kR][4], float (&hi)[kR][4], Elem elem,
    const typename P::B (&b_lo)[kSteps], const typename P::B (&b_hi)[kSteps]) {
#pragma unroll
  for (int f = 0; f < kSteps + kR - 1; ++f) {
    const auto a =
        P::load_a([&](int m, int k) { return elem(f * P::kK + k, m); });
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int s = f - r;
      if (s >= 0 && s < kSteps) {
        P::mma(lo[r], a, b_lo[s]);
        P::mma(hi[r], a, b_hi[s]);
      }
    }
  }
}

// Write the block's output tile (a, h, v, d; [kTile][kLdO] each in `tile`)
// to the planes outs[p]: whole tile rows, consecutive lanes on consecutive
// outputs, the same tile position of each plane in turn. vec (level 1,
// rows of a multiple of 4 samples, every plane 16-byte aligned): 16-byte
// stores, 8 threads a row; else one sample a lane, a warp a row, the row's
// outputs a dilation apart.
template <int kLdO>
__device__ __forceinline__ void store_tile(float* const (&outs)[4],
                                           const float* tile,
                                           const AxisPlan& pr,
                                           const AxisPlan& pc,
                                           const Block& blk, bool vec) {
  constexpr int kO = kTile * kLdO;
  if (vec) {
    constexpr int kQ = kTile / 4;
    static_assert(kTile * kQ == kThreads, "a quad of each plane a thread");
    const int q = threadIdx.x % kQ, m = threadIdx.x / kQ;
    const long long row =
        blk.rho_r + static_cast<long long>(pr.cls) * (blk.m0 + m);
    const int c = blk.q0 + 4 * q;
    if (row < pr.n && c < pc.n) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        *reinterpret_cast<float4*>(outs[p] + row * pc.n + c) =
            *reinterpret_cast<const float4*>(tile + p * kO + m * kLdO +
                                             4 * q);
    }
    return;
  }
  const int n = threadIdx.x % kTile;
  const long long c =
      blk.rho_c + static_cast<long long>(pc.cls) * (blk.q0 + n);
  if (c >= pc.n) return;
#pragma unroll
  for (int j = 0; j < kTile / kWarps; ++j) {
    const int m = threadIdx.x / kTile + kWarps * j;
    const long long row =
        blk.rho_r + static_cast<long long>(pr.cls) * (blk.m0 + m);
    if (row < pr.n) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        outs[p][row * pc.n + c] = tile[p * kO + m * kLdO + n];
    }
  }
}

// The analysis level of one block. Rows: Wrapped (K11a), or the
// Halo<float, 1> of the shard x (K28's stationary analysis). The window
// arrives by cp.async from a table of source rows while the band's
// fragments are built (stage_windows); the passes run tiles in groups that
// share A fragments (band_tiles_lohi), two a task; pass 2's C fragments go
// through an output tile in shared memory to whole-row stores
// (store_tile).
template <class P, int kSteps, class Rows>
__device__ __forceinline__ void swt_level(const float* __restrict__ x,
                                          float* __restrict__ a,
                                          float* __restrict__ h,
                                          float* __restrict__ v,
                                          float* __restrict__ d,
                                          const AxisPlan& pr,
                                          const AxisPlan& pc,
                                          const Taps& taps, int hlen, int y0,
                                          const Rows& rows) {
  using G = SwtGeom<P, kSteps>;
  using S = SwtSmem<G>;
  extern __shared__ float smem[];
  const S sm(smem);

  const int warp = threadIdx.x >> 5;
  const Block blk(pr, pc, y0);
  const long long plane = static_cast<long long>(pr.n) * pc.n;
  const long long pb = blockIdx.z * plane;
  const float* const in[1] = {x + pb};
  int shift;
  const Band<P, kSteps> b = stage_windows<P, kSteps>(
      in, sm.in, sm.src, sm.col, sm.f_lo, sm.f_hi, pr, pc, blk, taps, hlen,
      plane_rows(rows, pc.n), shift);

  // Pass 1, axis -2: (window columns x window rows) x band, in groups of
  // two tiles (one where a tile's band has a single TF32 k-step: the 8
  // warps then have a task each).
  constexpr int kM1 = G::kWinC / 16, kN = kTile / 8;
  constexpr int kR1 = P::kK == 8 && kSteps == 1 ? 1 : 2, kG1 = kN / kR1;
  for (int task = warp; task < kM1 * kG1; task += kWarps) {
    const int m0 = task / kG1 * 16, n0 = group_first<P::kK / 8, kR1>(task % kG1);
    const float* w = sm.in + n0 * G::kLdW + m0 + shift;
    float clo[kR1][4] = {}, chi[kR1][4] = {};
    band_tiles_lohi<P, kSteps, kR1>(
        clo, chi, [&](int k, int m) { return w[k * G::kLdW + m]; }, b.lo,
        b.hi);
#pragma unroll
    for (int r = 0; r < kR1; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = (n0 + r * P::kK + mma::c_col(i)) * G::kLdT + m0 +
                      mma::c_row(i);
        sm.t[t] = clo[r][i];
        sm.t[S::kT + t] = chi[r][i];
      }
  }
  __syncthreads();

  // Pass 2, last axis: (lo_r and hi_r rows x window columns) x band; one
  // task a warp: 16 rows and two tiles of columns.
  constexpr int kR2 = 2, kG2 = kN / kR2;
  static_assert(2 * kTile / 16 * kG2 == kWarps, "one pass-2 task a warp");
  const int m0 = warp / kG2 * 16, n0 = group_first<P::kK / 8, kR2>(warp % kG2);
  const float* t = sm.t + m0 * G::kLdT + n0;
  float clo[kR2][4] = {}, chi[kR2][4] = {};
  band_tiles_lohi<P, kSteps, kR2>(
      clo, chi, [&](int k, int m) { return t[m * G::kLdT + k]; }, b.lo, b.hi);
  __syncthreads();  // the window and lo_r/hi_r are read: the tile's space

  // lo_r rows: a = lo, v = hi; hi_r rows: h = lo, d = hi (tile planes a,
  // h, v, d), two C elements of a row in one 8-byte store.
  const bool low = m0 < kTile;
  float* t_lo = sm.out + (low ? 0 : 1) * S::kO;
  float* t_hi = sm.out + (low ? 2 : 3) * S::kO;
  const int mb = low ? m0 : m0 - kTile;
#pragma unroll
  for (int r = 0; r < kR2; ++r)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int o = (mb + mma::c_row(i)) * S::kLdO + n0 + r * P::kK +
                    mma::c_col(i);
      *reinterpret_cast<float2*>(t_lo + o) = make_float2(clo[r][i],
                                                         clo[r][i + 1]);
      *reinterpret_cast<float2*>(t_hi + o) = make_float2(chi[r][i],
                                                         chi[r][i + 1]);
    }
  __syncthreads();
  float* const outs[4] = {a + pb, h + pb, v + pb, d + pb};
  const bool vec =
      pc.cls == 1 && pc.n % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(outs[0]) |
        reinterpret_cast<uintptr_t>(outs[1]) |
        reinterpret_cast<uintptr_t>(outs[2]) |
        reinterpret_cast<uintptr_t>(outs[3])) & 15) == 0;
  store_tile<S::kLdO>(outs, sm.out, pr, pc, blk, vec);
}

// Resident blocks per SM promised to ptxas (__launch_bounds__) by the
// instances that run faster with more blocks than their registers leave:
// 4 for TF32 with 3 k-steps (sym8 "highest": 64 registers and a spill of
// 12-20 bytes, where left to itself ptxas takes 72-80 and 3 blocks fit;
// the spilling build measured faster). 0: no promise (a promise on every
// instance took the bf16 ones from 5 blocks to 4, and spilled hundreds of
// bytes in TF32 with 4-6 k-steps).
template <class P, int kSteps>
__host__ __device__ constexpr int swt_min_blocks() {
  return P::kK == 8 && kSteps == 3 ? 4 : 0;
}

template <class P, int kSteps, class Rows>
__global__ void __launch_bounds__(kThreads)
tc_swt2d_kernel(const float* __restrict__ x, float* __restrict__ a,
                float* __restrict__ h, float* __restrict__ v,
                float* __restrict__ d, AxisPlan pr, AxisPlan pc, Taps taps,
                int hlen, int y0, Rows rows) {
  swt_level<P, kSteps>(x, a, h, v, d, pr, pc, taps, hlen, y0, rows);
}

// The same with kMinBlocks blocks per SM promised (swt_min_blocks).
template <class P, int kSteps, class Rows, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tc_swt2d_kernel_bounded(const float* __restrict__ x, float* __restrict__ a,
                        float* __restrict__ h, float* __restrict__ v,
                        float* __restrict__ d, AxisPlan pr, AxisPlan pc,
                        Taps taps, int hlen, int y0, Rows rows) {
  swt_level<P, kSteps>(x, a, h, v, d, pr, pc, taps, hlen, y0, rows);
}

// Rows: Wrapped (K11b), or the Halo<float, 4> of the shard's planes a, h,
// v, d (K28's stationary synthesis). The windows arrive by cp.async from a
// table of source rows while the band's fragments are built
// (stage_windows); the passes run tiles in groups that share A
// fragments (band_tiles): pass 1 the kTile / 8 tiles of a window column
// block that one fragment sequence reaches, pass 2 two.
template <class P, int kSteps, class Rows>
__global__ void __launch_bounds__(kThreads)
tc_iswt2d_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ v, const float* __restrict__ d,
                 float* __restrict__ out, AxisPlan pr, AxisPlan pc,
                 Taps half_taps, int hlen, int y0, Rows rows) {
  using G = SwtGeom<P, kSteps>;
  using S = IswtSmem<G>;
  extern __shared__ float smem[];
  const S sm(smem);

  const int warp = threadIdx.x >> 5;
  const Block blk(pr, pc, y0);
  const long long plane = static_cast<long long>(pr.n) * pc.n;
  const long long pb = blockIdx.z * plane;
  const float* const in[4] = {a + pb, h + pb, v + pb, d + pb};
  int shift;
  const Band<P, kSteps> b = stage_windows<P, kSteps>(
      in, sm.in, sm.src, sm.col, sm.f_lo, sm.f_hi, pr, pc, blk, half_taps,
      hlen, plane_rows(rows, pc.n), shift);

  // Pass 1, axis -2: t1 = syn(a, h), t2 = syn(v, d), on window columns.
  constexpr int kM1 = G::kWinC / 16, kN = kTile / 8;
  // (two tiles a task where the band has 2 k-steps or fewer: with all
  // four, ptxas spills there)
  constexpr int kR1 = kSteps <= 2 ? 2 : kN * 8 / P::kK, kG1 = kN / kR1;
  for (int task = warp; task < 2 * kM1 * kG1; task += kWarps) {
    const int pair = task / (kM1 * kG1), rest = task - pair * kM1 * kG1;
    const int m0 = rest / kG1 * 16, n0 = group_first<P::kK / 8, kR1>(rest % kG1);
    const float* lo =
        sm.in + (2 * pair) * S::kPlane + n0 * G::kLdW + m0 + shift;
    const float* hi = lo + S::kPlane;
    float c[kR1][4] = {};
    band_tiles<P, kSteps, kR1>(
        c, [&](int k, int m) { return lo[k * G::kLdW + m]; },
        [&](int k, int m) { return hi[k * G::kLdW + m]; }, b.lo, b.hi);
    float* t = sm.t + pair * S::kT;
#pragma unroll
    for (int r = 0; r < kR1; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t[(n0 + r * P::kK + mma::c_col(i)) * G::kLdT + m0 + mma::c_row(i)] =
            c[r][i];
  }
  __syncthreads();

  // Pass 2, last axis: out = syn(t1, t2).
  constexpr int kR2 = 2, kG2 = kN / kR2;
  for (int task = warp; task < kTile / 16 * kG2; task += kWarps) {
    const int m0 = task / kG2 * 16, n0 = group_first<P::kK / 8, kR2>(task % kG2);
    const float* t1 = sm.t + m0 * G::kLdT + n0;
    const float* t2 = t1 + S::kT;
    float c[kR2][4] = {};
    band_tiles<P, kSteps, kR2>(
        c, [&](int k, int m) { return t1[m * G::kLdT + k]; },
        [&](int k, int m) { return t2[m * G::kLdT + k]; }, b.lo, b.hi);
#pragma unroll
    for (int r = 0; r < kR2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Store st;
        if (st.at(pr, pc, blk, m0 + mma::c_row(i),
                  n0 + r * P::kK + mma::c_col(i)))
          out[pb + st.row * pc.n + st.col] = c[r][i];
      }
  }
}

template <class Rows>
using SwtKernel = void (*)(const float*, float*, float*, float*, float*,
                           AxisPlan, AxisPlan, Taps, int, int, Rows);
template <class Rows>
using IswtKernel = void (*)(const float*, const float*, const float*,
                            const float*, float*, AxisPlan, AxisPlan, Taps,
                            int, int, Rows);

template <class P, int S, class Rows>
Instance<SwtKernel<Rows>> swt_instance() {
  constexpr int kMin = swt_min_blocks<P, S>();
  SwtKernel<Rows> kernel;
  if constexpr (kMin > 0)
    kernel = tc_swt2d_kernel_bounded<P, S, Rows, kMin>;
  else
    kernel = tc_swt2d_kernel<P, S, Rows>;
  return {kernel, SwtSmem<SwtGeom<P, S>>::kBytes};
}

template <class P, int S, class Rows>
Instance<IswtKernel<Rows>> iswt_instance() {
  return {tc_iswt2d_kernel<P, S, Rows>,
          IswtSmem<SwtGeom<P, S>>::kBytes};
}

// kSteps = ceil((hlen + 7) / kK): 1..6 (TF32), 1..3 (BF16) for hlen 1..40.
template <class Rows>
Instance<SwtKernel<Rows>> pick_swt(bool bf16, int hlen) {
  if (bf16) {
    switch ((hlen + 7 + 15) / 16) {
      case 1: return swt_instance<mma::Bf16, 1, Rows>();
      case 2: return swt_instance<mma::Bf16, 2, Rows>();
      case 3: return swt_instance<mma::Bf16, 3, Rows>();
    }
  } else {
    switch ((hlen + 7 + 7) / 8) {
      case 1: return swt_instance<mma::Tf32, 1, Rows>();
      case 2: return swt_instance<mma::Tf32, 2, Rows>();
      case 3: return swt_instance<mma::Tf32, 3, Rows>();
      case 4: return swt_instance<mma::Tf32, 4, Rows>();
      case 5: return swt_instance<mma::Tf32, 5, Rows>();
      case 6: return swt_instance<mma::Tf32, 6, Rows>();
    }
  }
  return {nullptr, 0};
}

template <class Rows>
Instance<IswtKernel<Rows>> pick_iswt(bool bf16, int hlen) {
  if (bf16) {
    switch ((hlen + 7 + 15) / 16) {
      case 1: return iswt_instance<mma::Bf16, 1, Rows>();
      case 2: return iswt_instance<mma::Bf16, 2, Rows>();
      case 3: return iswt_instance<mma::Bf16, 3, Rows>();
    }
  } else {
    switch ((hlen + 7 + 7) / 8) {
      case 1: return iswt_instance<mma::Tf32, 1, Rows>();
      case 2: return iswt_instance<mma::Tf32, 2, Rows>();
      case 3: return iswt_instance<mma::Tf32, 3, Rows>();
      case 4: return iswt_instance<mma::Tf32, 4, Rows>();
      case 5: return iswt_instance<mma::Tf32, 5, Rows>();
      case 6: return iswt_instance<mma::Tf32, 6, Rows>();
    }
  }
  return {nullptr, 0};
}

// Launch one level: the plans of both axes (the rows' on a shard's extended
// axis where halo), the kernel's attribute, and column blocks (classes
// fastest) x row blocks x planes; call(grid, z0, pr, pc, y0) launches one
// chunk from plane z0.
template <class Kernel, class Call>
int launch_level(const Instance<Kernel>& inst, int batch, int nr, int nc,
                 int level, int centre, int hlen, int device, Call call,
                 bool halo = false) {
  if (hlen < 1 || hlen > kMaxTaps || centre < 0 || centre >= hlen ||
      nr < 1 || nc < 1 || nr > 0x3fffffff || nc > 0x3fffffff || level < 1 ||
      batch < 1 || inst.kernel == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(inst.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(inst.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const AxisPlan pr = axis_plan(hlen, centre, level, nr, halo);
  const AxisPlan pc = axis_plan(hlen, centre, level, nc);
  launch_chunks(pc.cls * pc.tiles, pr.cls * pr.tiles, batch,
                [&](dim3 grid, int y0, int z0) { call(grid, z0, pr, pc, y0); });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pypwt

// Both return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. The filters are host arrays of hlen floats,
// `centre` the a-trous centre s of the direction, bf16 1 for the "bf16"
// precision and 0 for "highest" (3xTF32).
// K11a: a, h, v, d of the input's shape (batch, nr, nc).
extern "C" int pypwt_tc_swt2d(const float* x, float* a, float* h, float* v,
                              float* d, int batch, int nr, int nc, int level,
                              int centre, const float* dec_lo,
                              const float* dec_hi, int hlen, int bf16,
                              int device, void* stream) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto inst = pick_swt<Wrapped>(bf16 != 0, hlen);
  const Taps taps = make_taps(dec_lo, dec_hi, hlen);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_level(
      inst, batch, nr, nc, level, centre, hlen, device,
      [&](dim3 grid, int z0, AxisPlan pr, AxisPlan pc, int y0) {
        const long long p = static_cast<long long>(z0) * nr * nc;
        inst.kernel<<<grid, kThreads, inst.smem, st>>>(
            x + p, a + p, h + p, v + p, d + p, pr, pc, taps, hlen, y0,
            Wrapped{});
      });
}

// K11b: out of the coefficients' shape.
extern "C" int pypwt_tc_iswt2d(const float* a, const float* h, const float* v,
                               const float* d, float* out, int batch, int nr,
                               int nc, int level, int centre,
                               const float* rec_lo, const float* rec_hi,
                               int hlen, int bf16, int device, void* stream) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto inst = pick_iswt<Wrapped>(bf16 != 0, hlen);
  const Taps taps = half_taps(rec_lo, rec_hi, hlen);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_level(
      inst, batch, nr, nc, level, centre, hlen, device,
      [&](dim3 grid, int z0, AxisPlan pr, AxisPlan pc, int y0) {
        const long long p = static_cast<long long>(z0) * nr * nc;
        inst.kernel<<<grid, kThreads, inst.smem, st>>>(
            a + p, h + p, v + p, d + p, out + p, pr, pc, taps, hlen, y0,
            Wrapped{});
      });
}

// K28's stationary analysis: K11a's level of one row shard x of (batch, nr,
// nc), its rows above and below from top (batch, lp, nc) and bot (batch,
// rp, nc), (lp, rp) = (hlen - 1 - centre, centre) * 2^(level-1).
extern "C" int pypwt_tc_swt2d_sharded(const float* x, const float* top,
                                      const float* bot, float* a, float* h,
                                      float* v, float* d, int batch, int nr,
                                      int nc, int level, int centre, int lp,
                                      int rp, const float* dec_lo,
                                      const float* dec_hi, int hlen, int bf16,
                                      int device, void* stream) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps ||
      !stationary_halos_ok(hlen, centre, level, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  using Rows = Halo<float, 1>;
  const auto inst = pick_swt<Rows>(bf16 != 0, hlen);
  const Taps taps = make_taps(dec_lo, dec_hi, hlen);
  const Rows halo = make_halo(top, bot, lp, rp);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_level(
      inst, batch, nr, nc, level, centre, hlen, device,
      [&](dim3 grid, int z0, AxisPlan pr, AxisPlan pc, int y0) {
        const long long p = static_cast<long long>(z0) * nr * nc;
        inst.kernel<<<grid, kThreads, inst.smem, st>>>(
            x + p, a + p, h + p, v + p, d + p, pr, pc, taps, hlen, y0,
            halo.plane(z0, nc));
      },
      true);
}

// K28's stationary synthesis: K11b's level of one row shard's planes, halos
// their eight halo tensors in JAX's order (a_top, a_bot, h_top, ...).
extern "C" int pypwt_tc_iswt2d_sharded(const float* a, const float* h,
                                       const float* v, const float* d,
                                       const float* const* halos, float* out,
                                       int batch, int nr, int nc, int level,
                                       int centre, int lp, int rp,
                                       const float* rec_lo,
                                       const float* rec_hi, int hlen, int bf16,
                                       int device, void* stream) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps ||
      !stationary_halos_ok(hlen, centre, level, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  using Rows = Halo<float, 4>;
  const auto inst = pick_iswt<Rows>(bf16 != 0, hlen);
  const Taps taps = half_taps(rec_lo, rec_hi, hlen);
  const float* tops[4] = {halos[0], halos[2], halos[4], halos[6]};
  const float* bots[4] = {halos[1], halos[3], halos[5], halos[7]};
  const Rows halo = make_halo4(tops, bots, lp, rp);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_level(
      inst, batch, nr, nc, level, centre, hlen, device,
      [&](dim3 grid, int z0, AxisPlan pr, AxisPlan pc, int y0) {
        const long long p = static_cast<long long>(z0) * nr * nc;
        inst.kernel<<<grid, kThreads, inst.smem, st>>>(
            a + p, h + p, v + p, d + p, out + p, pr, pc, taps, hlen, y0,
            halo.plane(z0, nc));
      },
      true);
}

// The occupancy API's resident blocks per SM, and the dynamic shared memory
// in bytes, of the analysis (pypwt_tc_swt2d_occupancy) or synthesis
// (pypwt_tc_iswt2d_occupancy) instance for hlen taps (bf16 as above; halo 1
// for K28's Halo rows, 0 for K11a's / K11b's): a figure for reports.
extern "C" int pypwt_tc_swt2d_occupancy(int hlen, int bf16, int halo,
                                        int device, int* blocks, int* smem) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  return halo ? occupancy(pick_swt<Halo<float, 1>>(bf16 != 0, hlen), device,
                          blocks, smem)
              : occupancy(pick_swt<Wrapped>(bf16 != 0, hlen), device, blocks,
                          smem);
}

extern "C" int pypwt_tc_iswt2d_occupancy(int hlen, int bf16, int halo,
                                         int device, int* blocks,
                                         int* smem) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  return halo ? occupancy(pick_iswt<Halo<float, 4>>(bf16 != 0, hlen), device,
                          blocks, smem)
              : occupancy(pick_iswt<Wrapped>(bf16 != 0, hlen), device,
                          blocks, smem);
}
