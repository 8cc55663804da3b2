// K5 / K6: one periodized separable 2D DWT level, analysis (K5) and
// polyphase synthesis (K6), float32, as banded products on the tensor cores;
// the DWT half of K28, the same levels of one row shard; and K29g / K29h,
// their axis -2 pass taken alone on one shard of a grid.
//
// K5 replaces the TPU kernel pypwt_tpu/ops/mxu_dwt.py::dwt2d_fused_mxu
// (_build_dwt2d_mxu, call :251), K6 ::idwt2d_fused_mxu (_build_idwt2d_mxu,
// :347): both run each separable pass as banded MXU dots D @ x. K28's
// pypwt_tc_dwt2d_sharded / pypwt_tc_idwt2d_sharded replace
// ::build_dwt2d_sharded_mxu (:571) and ::build_idwt2d_sharded_mxu (:651):
// the same kernels with the Halo row source (common.cuh), the window rows
// above and below the shard read from its neighbours' exchanged rows where
// they lie (no padded copy), the columns periodic as before. K29g
// (pypwt_tc_ana_rows) replaces ::build_ana_padded_rows_mxu (:763) and K29h
// (pypwt_tc_syn_rows) ::build_syn_padded_rows_mxu (:873), the row passes of
// the grid layout of pypwt_tpu/parallel/spatial.py in mode "mxu": pass 1 of
// K5 / K6 alone, on the Halo rows, its result stored straight to device
// memory: K29g lo, hi of (nr/2, nc) from a shard (nr, nc); K29h (2L, nc)
// from a, d of (L, nc) (conv.analysis_core / synthesis_core along axis -2
// on the halo-extended rows; the bytes of K29c / K29d).
//
// Maps (the port's plain versions in ops/mxu_dwt.py), for planes
// (B?, Nr, Nc) with Nr and Nc even and an even hlen of 4..40 (JAX's
// coverage; the router sends every other level to K1/K2):
//   K5: the decimating analysis lo[i] = sum_j f[j] x[(2i + j - lpad) mod N],
//       f[j] = dec[hlen-1-j], lpad = hlen - 1 - hlen/2, first along axis -2
//       (lo_r, hi_r), then along the last axis: a = lo(lo_r), v = hi(lo_r),
//       h = lo(hi_r), d = hi(hi_r) (the subbands of K1, in JAX's pass
//       order, which "bf16" rounding makes visible);
//   K6: along axis -2 t1 = syn(a, h), t2 = syn(v, d), then along the last
//       axis out = syn(t1, t2), with the polyphase synthesis of
//       common.cuh's Polyphase: y[2m + p] = sum_{j < h2} g_p_lo[j]
//       lo[(m + delta_p + j - c) mod L] + g_p_hi[j] hi[...].
//
// Bound: the bytes of K1/K2, 8 per input pixel (16 MiB in and 16 MiB out at
// 2048^2: 10 us at 3.35 TB/s). The products cost more flops than the taps
// (a tile of 8 outputs spans kSteps k-steps of 8 or 16 window samples,
// 14 + hlen of them non-zero), 3x in "highest": at sym8 and 2048^2 about
// 1.2 GFLOP of TF32, 2.5 us at 495 TFLOP/s, so the tensor cores leave the
// kernel memory-bound; "bf16" is one pass at twice the rate.
//
// Design: each block owns a tile of kTile x kTile outputs (of each subband
// for K5; of coefficients, so 2kTile x 2kTile pixels, for K6). It stages
// the window in shared memory once, zero past the window's rows, where the
// band's zero entries meet them (its columns below). Pass 1 runs
// along axis -2 as the window read transposed (A: columns x rows) times the
// band B (rows x outputs) and leaves its result in shared memory; pass 2
// runs along the last axis as that result (rows x columns) times the band.
// Nothing else goes to device memory. The band of a decimating filter is
// the same for every 8-output tile when the tile's k-range starts at window
// sample 2 n0 (K6: coefficient n0 / 2): B[k][n] = f[k - 2n] (K6: the
// polyphase taps of output parity n & 1 at k - n/2 - delta). So each thread
// builds its B fragments once, in registers, for both filters and every
// k-step, and both passes reuse them. Row tiles run on the grid's y axis,
// planes on z, in chunks past a grid's limits (launch_chunks).
//
// Both stage their windows as the stationary kernels of tc_swt2d.cu do
// (tc_window.cuh): a table of source rows built once per block in 32-bit
// index arithmetic (K5's HalfPlan: window sample w of the block at output
// m0 holds sample 2 m0 + w - lpad; K6's UnitPlan: coefficient m0 + w - c; a
// shard's halos resolved there, not once per sample), every sample in
// flight at once by cp.async (16-byte copies read shifted where the rows
// are 16-byte aligned and the row length % 4 == 0; the columns past the
// extent then hold samples that only zero taps meet), the band's fragments
// built while they fly. Their rows in shared memory take the shortest
// conflict-free lead dimension (sym8 in TF32: K5 88 floats for 80 staged
// columns, not 104; K6 56 for 48, not 72), so that K5's sym8 instances fit
// three blocks per SM in "highest" and four in "bf16", K6's three. In K6,
// tiles 2 kK outputs apart read windows one k-step apart: a task runs all
// such tiles of a pass (four in TF32, two in bf16), each A fragment loaded
// and, in "highest", split once for the group (band_tiles). Each
// accumulator takes band_product_pair's products in its order, so the
// grouping leaves every output bit as it was. K5's tiles run one per task
// (band_product): groups of its tiles, 16 window samples apart, took its
// TF32 instances to two blocks per SM and gained nothing in "bf16". Pass 2
// of both stores a row's two C elements in one 8-byte store (K5: where
// its subbands' rows start 8-byte aligned, else one float at a time).
//
// K29g / K29h are one pass, bound by their bytes alone (the column pass's
// 4096 x 2048 output of a 4096^2 grid block and its two halves: 64 MiB,
// 20 us at 3.35 TB/s). Their blocks are persistent and walk tiles of 32
// output rows (K29h: coefficient rows) by 64 columns on row_walk.cuh's
// walk, which the tap-loop K29d (axis_rows.cu) shares: the grid is what
// the SMs hold at once, by the occupancy API, and while a block's warps
// compute one tile, the window of its next tile is in flight in the other
// of two slots, staged by cp.async from a table of that tile's source rows
// (the shard's rows and halo rows resolved once per window row, in 32-bit
// arithmetic; 16-byte copies where nc % 4 == 0 and the row is 16-byte
// aligned; zero past nc and past both halos). The band's fragments are
// built once per block, while the first tile's copies fly. K29h's tiles
// 2 kK outputs apart run in groups that share A fragments (band_tiles), as
// many as fit 32 registers beside the band. The C fragments go straight to
// device memory: a warp's store covers four rows of 32 bytes, whole
// sectors. A staged output tile with 16-byte stores, tiles of 64 rows or
// 128 columns and the band's fragments in shared memory (a block per SM
// more) all measured slower (PERF.md §6).

#include "row_walk.cuh"
#include "tc_window.cuh"

namespace pypwt {
namespace {

using mma::band;
using mma::Instance;
using mma::round16;

// The shortest leading dimension (in floats) of at least `cols` columns
// whose fragments are read without bank conflicts: mma::lead_dim's residue
// w (4 or 8) asks only for ld / w odd (the lanes that read one fragment
// register then still meet distinct banks), so ld = w mod 2w serves, not
// only ld = w mod 32.
template <class P>
__host__ __device__ constexpr int short_lead_dim(int cols, bool transposed) {
  const int want = (P::kK == 8) != transposed ? 4 : 8;
  return cols + ((want - cols) % (2 * want) + 2 * want) % (2 * want);
}

// K5's geometry: kSteps k-steps of kK samples cover the 14 + hlen window
// samples of an 8-output tile. The window's rows hold kWinC columns read
// shifted by up to 3 (the staging's 16-byte copies), lo_r/hi_r's kWinC, in
// the shortest rows whose fragments are read without bank conflicts.
template <class P, int kSteps>
struct AnaGeom {
  static constexpr int kSpan = kSteps * P::kK;
  static constexpr int kWin = 2 * kTile - 16 + kSpan;  // window rows read
  static constexpr int kWinC = round16(kWin);          // window columns
  static constexpr int kLdW = short_lead_dim<P>(kWinC + 4, true);
  static constexpr int kLdT = short_lead_dim<P>(kWinC, false);
};

// Shared memory of K5: the window ([kWin][kLdW]), lo_r and hi_r ([kTile]
// [kLdT] each), the taps in window order, the source row of each window row
// and the column of each window column.
template <class G>
struct DwtSmem {
  static constexpr int kPlane = G::kWin * G::kLdW;
  static constexpr int kT = kTile * G::kLdT;
  static constexpr int kFloats = kPlane + 2 * kT + 2 * kMaxTaps;
  static_assert(kFloats % 2 == 0, "the row table must be 8-byte aligned");
  static constexpr size_t kBytes = sizeof(float) * kFloats +
                                   sizeof(const float*) * G::kWin +
                                   sizeof(int) * G::kWinC;
  float *in, *t, *f_lo, *f_hi;
  const float** src;
  int* col;
  __device__ explicit DwtSmem(float* base)
      : in(base),
        t(in + kPlane),
        f_lo(t + 2 * kT),
        f_hi(f_lo + kMaxTaps),
        src(reinterpret_cast<const float**>(f_hi + kMaxTaps)),
        col(reinterpret_cast<int*>(src + G::kWin)) {}
};

// The decimating band of both filters: output n of an 8-output tile reads
// window samples 2 n + j with tap f[j].
template <class P, int kSteps>
struct AnaBand {
  typename P::B lo[kSteps], hi[kSteps];
  __device__ __forceinline__ AnaBand(const float* f_lo, const float* f_hi,
                                     int hlen) {
    mma::band_fragments<P>(
        lo, [&](int k, int n) { return band(f_lo, k - 2 * n, hlen); });
    mma::band_fragments<P>(
        hi, [&](int k, int n) { return band(f_hi, k - 2 * n, hlen); });
  }
};

// Rows: Wrapped (K5), or the Halo<float, 1> of the shard x (K28's analysis).
// Window sample w of the block at output (m0, q0) holds sample 2 m0 + w -
// lpad of the rows and 2 q0 + w - lpad of the columns: it arrives by
// cp.async from a table of source rows while the band's fragments are built
// (stage_windows, tc_window.cuh).
template <class P, int kSteps, class Rows>
__global__ void __launch_bounds__(kThreads)
tc_dwt2d_kernel(const float* __restrict__ x, float* __restrict__ a,
                float* __restrict__ h, float* __restrict__ v,
                float* __restrict__ d, int nr, int nc, Taps taps, int hlen,
                int y0, Rows rows) {
  using G = AnaGeom<P, kSteps>;
  using S = DwtSmem<G>;
  extern __shared__ float smem[];
  const S sm(smem);

  const int warp = threadIdx.x >> 5;
  const int lr = nr >> 1, lc = nc >> 1;
  const HalfPlan pr{nr, analysis_lpad(hlen)}, pc{nc, analysis_lpad(hlen)};
  const Block blk(pr, pc, y0);
  const int ext = 2 * kTile + hlen - 2;  // the window's extent
  const float* const in[1] = {x + blockIdx.z * static_cast<long long>(nr) *
                                      nc};
  int shift;
  const AnaBand<P, kSteps> b = stage_windows<G>(
      in, sm.in, sm.src, sm.col, pr, pc, blk, ext, plane_rows(rows, nc),
      shift, [&] { load_reversed_taps(taps, hlen, sm.f_lo, sm.f_hi); },
      [&] { return AnaBand<P, kSteps>(sm.f_lo, sm.f_hi, hlen); });

  // Pass 1, axis -2: (window columns x window rows) x band -> lo_r, hi_r.
  constexpr int kN = kTile / 8;
  for (int task = warp; task < G::kWinC / 16 * kN; task += kWarps) {
    const int m0 = task / kN * 16, n0 = task % kN * 8;
    float clo[4] = {0.f, 0.f, 0.f, 0.f}, chi[4] = {0.f, 0.f, 0.f, 0.f};
    const float* w = sm.in + 2 * n0 * G::kLdW + m0 + shift;
    mma::band_product<P>(
        clo, chi, [&](int k, int m) { return w[k * G::kLdW + m]; }, b.lo,
        b.hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = (n0 + mma::c_col(i)) * G::kLdT + m0 + mma::c_row(i);
      sm.t[t] = clo[i];
      sm.t[S::kT + t] = chi[i];
    }
  }
  __syncthreads();

  // Pass 2, last axis: (lo_r and hi_r rows x window columns) x band. A
  // row's two C elements (an even column) go in one 8-byte store where the
  // subbands' rows start 8-byte aligned (lc even, planes aligned), else one
  // float at a time.
  const long long ob = blockIdx.z * static_cast<long long>(lr) * lc;
  const bool pairs =
      lc % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(h) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(d)) &
       7) == 0;
  const int r0 = blk.m0, c0 = blk.q0;
  for (int task = warp; task < 2 * kTile / 16 * kN; task += kWarps) {
    const int m0 = task / kN * 16, n0 = task % kN * 8;
    float clo[4] = {0.f, 0.f, 0.f, 0.f}, chi[4] = {0.f, 0.f, 0.f, 0.f};
    const float* t = sm.t + m0 * G::kLdT + 2 * n0;
    mma::band_product<P>(
        clo, chi, [&](int k, int m) { return t[m * G::kLdT + k]; }, b.lo,
        b.hi);
    const bool low = m0 < kTile;  // a 16-row tile lies in one half
    float* out_lo = (low ? a : h) + ob;
    float* out_hi = (low ? v : d) + ob;
    const int rbase = r0 + (low ? m0 : m0 - kTile);
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int orow = rbase + mma::c_row(i), ocol = c0 + n0 + mma::c_col(i);
      if (orow >= lr || ocol >= lc) continue;
      const long long o = static_cast<long long>(orow) * lc + ocol;
      if (pairs) {
        *reinterpret_cast<float2*>(out_lo + o) =
            make_float2(clo[i], clo[i + 1]);
        *reinterpret_cast<float2*>(out_hi + o) =
            make_float2(chi[i], chi[i + 1]);
      } else {
        out_lo[o] = clo[i];
        out_hi[o] = chi[i];
        if (ocol + 1 < lc) {
          out_lo[o + 1] = clo[i + 1];
          out_hi[o + 1] = chi[i + 1];
        }
      }
    }
  }
}

// K6's geometry: an 8-output tile reads 4 coefficients and the h2 taps of
// their phases, h2 + 4 samples, in kSteps k-steps. The windows' rows hold
// kWinC columns read shifted by up to 3 (issue_windows), t1/t2's kWinC, in
// the shortest rows whose fragments are read without bank conflicts.
template <class P, int kSteps>
struct SynGeom {
  static constexpr int kSpan = kSteps * P::kK;
  static constexpr int kWin = kTile - 4 + kSpan;  // coefficient rows read
  static constexpr int kWinC = round16(kWin);     // coefficient columns
  static constexpr int kLdW = short_lead_dim<P>(kWinC + 4, true);
  static constexpr int kLdT = short_lead_dim<P>(kWinC, false);
};

// Shared memory of K6: the four windows (a, h, v, d; [kWin][kLdW] each),
// t1/t2 ([2 kTile][kLdT] each), the taps of each output parity, the source
// row of each plane and window row and the column of each window column.
template <class G>
struct IdwtSmem {
  static constexpr int kPlane = G::kWin * G::kLdW;
  static constexpr int kT = 2 * kTile * G::kLdT;
  static constexpr int kFloats = 4 * kPlane + 2 * kT + 4 * kHalfTaps;
  static_assert(kFloats % 2 == 0, "the row table must be 8-byte aligned");
  static constexpr size_t kBytes = sizeof(float) * kFloats +
                                   sizeof(const float*) * 4 * G::kWin +
                                   sizeof(int) * G::kWinC;
  float *in, *t, *g_lo, *g_hi;
  const float** src;
  int* col;
  __device__ explicit IdwtSmem(float* base)
      : in(base),
        t(in + 4 * kPlane),
        g_lo(t + 2 * kT),
        g_hi(g_lo + 2 * kHalfTaps),
        src(reinterpret_cast<const float**>(g_hi + 2 * kHalfTaps)),
        col(reinterpret_cast<int*>(src + 4 * G::kWin)) {}
};

// The polyphase band of both filters: output n of an 8-output tile is
// coefficient n / 2 of the tile, phase n & 1, which reads window sample
// n / 2 + delta + j with tap g_p[j].
template <class P, int kSteps>
struct PolyBand {
  typename P::B lo[kSteps], hi[kSteps];
  __device__ __forceinline__ PolyBand(const float* g_lo, const float* g_hi,
                                      const Polyphase& ph) {
    mma::band_fragments<P>(lo, [&](int k, int n) {
      return band(g_lo + (n & 1) * kHalfTaps, k - (n >> 1) - ph.delta(n & 1),
                  ph.h2);
    });
    mma::band_fragments<P>(hi, [&](int k, int n) {
      return band(g_hi + (n & 1) * kHalfTaps, k - (n >> 1) - ph.delta(n & 1),
                  ph.h2);
    });
  }
};

// Rows: Wrapped (K6), or the Halo<float, 4> of the shard's planes a, h, v,
// d (K28's synthesis). The window starts at coefficient (q0r - c, q0c - c)
// and steps by 1 on both axes, as a level-1 stationary window does: it
// arrives by cp.async from a table of source rows while the band's
// fragments are built (stage_windows, tc_window.cuh), and the passes run
// groups of tiles that share A fragments (band_tiles).
template <class P, int kSteps, class Rows>
__global__ void __launch_bounds__(kThreads)
tc_idwt2d_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ v, const float* __restrict__ d,
                 float* __restrict__ out, int lr, int lc, Taps taps, int hlen,
                 int y0, Rows rows) {
  using G = SynGeom<P, kSteps>;
  using S = IdwtSmem<G>;
  extern __shared__ float smem[];
  const S sm(smem);

  const Polyphase ph(hlen);
  const int warp = threadIdx.x >> 5;
  const int nr = 2 * lr, nc = 2 * lc;
  // window sample w holds coefficient q0 - c + w on both axes
  const UnitPlan pr{lr, ph.c}, pc{lc, ph.c};
  const Block blk(pr, pc, y0);
  const long long ib = blockIdx.z * static_cast<long long>(lr) * lc;
  const float* const in[4] = {a + ib, h + ib, v + ib, d + ib};
  int shift;
  const PolyBand<P, kSteps> b = stage_windows<G>(
      in, sm.in, sm.src, sm.col, pr, pc, blk, kTile + ph.h2,
      plane_rows(rows, lc), shift,
      [&] { load_polyphase_taps(taps, hlen, sm.g_lo, sm.g_hi); },
      [&] { return PolyBand<P, kSteps>(sm.g_lo, sm.g_hi, ph); });

  // Pass 1, axis -2: t1 = syn(a, h), t2 = syn(v, d), on window columns.
  // Tiles of 8 outputs kEvery tiles (2 kK outputs) apart read windows one
  // k-step apart: a task runs all kR such tiles of a pass.
  constexpr int kM1 = G::kWinC / 16, kN = 2 * kTile / 8;
  constexpr int kEvery = P::kK / 4, kR = kN / kEvery, kG = kN / kR;
  for (int task = warp; task < 2 * kM1 * kG; task += kWarps) {
    const int pair = task / (kM1 * kG), rest = task - pair * kM1 * kG;
    const int m0 = rest / kG * 16, n0 = group_first<kEvery, kR>(rest % kG);
    const float* lo =
        sm.in + (2 * pair) * S::kPlane + (n0 >> 1) * G::kLdW + m0 + shift;
    const float* hi = lo + S::kPlane;
    float c[kR][4] = {};
    band_tiles<P, kSteps, kR>(
        c, [&](int k, int m) { return lo[k * G::kLdW + m]; },
        [&](int k, int m) { return hi[k * G::kLdW + m]; }, b.lo, b.hi);
    float* t = sm.t + pair * S::kT;
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t[(n0 + 2 * r * P::kK + mma::c_col(i)) * G::kLdT + m0 +
          mma::c_row(i)] = c[r][i];
  }
  __syncthreads();

  // Pass 2, last axis: out = syn(t1, t2), on the 2 kTile output rows; the
  // two C elements of a row (an even column of an even row length: both in
  // the plane, 8-byte aligned) in one store.
  const long long ob = blockIdx.z * static_cast<long long>(nr) * nc;
  const int R0 = 2 * blk.m0, C0 = 2 * blk.q0;
  for (int task = warp; task < 2 * kTile / 16 * kG; task += kWarps) {
    const int m0 = task / kG * 16, n0 = group_first<kEvery, kR>(task % kG);
    const float* t1 = sm.t + m0 * G::kLdT + (n0 >> 1);
    const float* t2 = t1 + S::kT;
    float c[kR][4] = {};
    band_tiles<P, kSteps, kR>(
        c, [&](int k, int m) { return t1[m * G::kLdT + k]; },
        [&](int k, int m) { return t2[m * G::kLdT + k]; }, b.lo, b.hi);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int orow = R0 + m0 + mma::c_row(i);
        const int ocol = C0 + n0 + 2 * r * P::kK + mma::c_col(i);
        if (orow < nr && ocol < nc)
          *reinterpret_cast<float2*>(out + ob +
                                     static_cast<long long>(orow) * nc +
                                     ocol) = make_float2(c[r][i], c[r][i + 1]);
      }
  }
}

// K29g / K29h's tile: kRows output rows (K29h: coefficient rows, so
// 2 kRows output rows) by kCols columns of a shard, the columns the A
// fragments' rows. Window row r holds columns c0 .. c0 + kCols - 1 of a
// shard or halo row, zero past nc (the columns are not periodic), in rows
// of kLdW floats (the shortest whose fragments are read without bank
// conflicts).
constexpr int kRows = 32, kCols = 64;

// K29g's geometry: kSteps k-steps of kK window rows cover an 8-output
// tile; one input plane.
template <class P, int kStepsT>
struct AnaRowsGeom {
  using Prec = P;
  static constexpr int kSteps = kStepsT;
  static constexpr int kWin = 2 * kRows - 16 + kSteps * P::kK;  // rows read
  static constexpr int kPlanes = 1;
  static constexpr int kLdW = short_lead_dim<P>(kCols, true);
};

// K29h's geometry: an 8-output tile reads 4 coefficient rows and the h2
// taps of their phases, h2 + 4 rows, in kSteps k-steps; two coefficient
// planes. A task runs kGroup tiles 2 kK outputs apart, whose windows start
// a k-step apart (band_tiles).
template <class P, int kStepsT, int kGroupT>
struct SynRowsGeom {
  using Prec = P;
  static constexpr int kSteps = kStepsT;
  static constexpr int kWin = kRows - 4 + kSteps * P::kK;  // rows read
  static constexpr int kPlanes = 2;
  static constexpr int kGroup = kGroupT;
  static constexpr int kLdW = short_lead_dim<P>(kCols, true);
};

// Shared memory of K29g / K29h: two slots of windows ([kWin][kLdW] a
// plane), the taps (K29g in window order, K29h per output parity) and two
// slots of the source row of each plane and window row; slots() is their
// form for the walk (row_walk.cuh).
template <class G>
struct RowsSmem {
  static constexpr int kPlane = G::kWin * G::kLdW;
  static constexpr int kSlot = G::kPlanes * kPlane;
  static constexpr int kTable = G::kPlanes * G::kWin;
  static constexpr int kFloats = 2 * kSlot + 2 * kMaxTaps;
  static_assert(kFloats % 2 == 0, "the row table must be 8-byte aligned");
  static constexpr size_t kBytes =
      sizeof(float) * kFloats + sizeof(const float*) * 2 * kTable;
  float *in, *f_lo, *f_hi;
  const float** src;
  __device__ explicit RowsSmem(float* base)
      : in(base),
        f_lo(base + 2 * kSlot),
        f_hi(f_lo + kMaxTaps),
        src(reinterpret_cast<const float**>(f_hi + kMaxTaps)) {}
  __device__ row_walk::Slots<float> slots() const {
    return {in, src, G::kWin, G::kLdW, kPlane, kSlot, kTable};
  }
};

// K29g: window row r of the tile at output rows r0 .. holds shard row
// 2 r0 - lpad + r (a halo row past the shard, zero past both halos and
// past the window's extent). Each task's products are mma::band_product's,
// in its order (both bands from one A fragment).
template <class G>
__global__ void __launch_bounds__(kThreads)
tc_ana_rows_kernel(const float* __restrict__ x, float* __restrict__ lo,
                   float* __restrict__ hi, int nr, int nc, Taps taps,
                   int hlen, row_walk::Plan plan, Halo<float, 1> rows) {
  using P = typename G::Prec;
  extern __shared__ float smem[];
  const RowsSmem<G> sm(smem);
  const int warp = threadIdx.x >> 5;
  const int len = nr >> 1;
  const int ext = 2 * kRows + hlen - 2;  // the window's extent
  const int lpad = analysis_lpad(hlen);
  load_reversed_taps(taps, hlen, sm.f_lo, sm.f_hi);
  row_walk::walk_tiles<float, kCols, G::kPlanes>(
      sm.slots(), plan, kRows, nc,
      [&](int r0, const float** src) {
        for (int r = threadIdx.x; r < G::kWin; r += kThreads)
          src[r] = r < ext ? rows.row(0, x, 2 * r0 - lpad + r, nr, nc)
                           : nullptr;
      },
      [&] { return AnaBand<P, G::kSteps>(sm.f_lo, sm.f_hi, hlen); },
      [&](int r0, int c0, const float* in, const AnaBand<P, G::kSteps>& b) {
        // (columns x window rows) x band: output rows n0.. of columns m0..
        constexpr int kN = kRows / 8;
        for (int task = warp; task < kCols / 16 * kN; task += kWarps) {
          const int m0 = task / kN * 16, n0 = task % kN * 8;
          float clo[4] = {0.f, 0.f, 0.f, 0.f}, chi[4] = {0.f, 0.f, 0.f, 0.f};
          const float* w = in + 2 * n0 * G::kLdW + m0;
          mma::band_product<P>(
              clo, chi, [&](int k, int m) { return w[k * G::kLdW + m]; },
              b.lo, b.hi);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int orow = r0 + n0 + mma::c_col(i);
            const int ocol = c0 + m0 + mma::c_row(i);
            if (orow < len && ocol < nc) {
              const long long o = static_cast<long long>(orow) * nc + ocol;
              lo[o] = clo[i];
              hi[o] = chi[i];
            }
          }
        }
      });
}

// K29h: window row r of the tile at coefficient rows q0 .. holds
// coefficient row q0 - c + r of a and d (the polyphase centre c; a halo
// row past the shard, zero past both halos and past the window's extent).
// Each accumulator takes mma::band_product_pair's products in its order
// (band_tiles).
template <class G>
__global__ void __launch_bounds__(kThreads)
tc_syn_rows_kernel(const float* __restrict__ a, const float* __restrict__ d,
                   float* __restrict__ out, int len, int nc, Taps taps,
                   int hlen, row_walk::Plan plan, Halo<float, 2> rows) {
  using P = typename G::Prec;
  extern __shared__ float smem[];
  const RowsSmem<G> sm(smem);
  const Polyphase ph(hlen);
  const int warp = threadIdx.x >> 5;
  const int ext = kRows + ph.h2;  // the window's extent
  const float* const planes[2] = {a, d};
  load_polyphase_taps(taps, hlen, sm.f_lo, sm.f_hi);
  row_walk::walk_tiles<float, kCols, G::kPlanes>(
      sm.slots(), plan, kRows, nc,
      [&](int q0, const float** src) {
        for (int r = threadIdx.x; r < G::kWin; r += kThreads) {
#pragma unroll
          for (int p = 0; p < 2; ++p)
            src[p * G::kWin + r] =
                r < ext ? rows.row(p, planes[p], q0 - ph.c + r, len, nc)
                        : nullptr;
        }
      },
      [&] { return PolyBand<P, G::kSteps>(sm.f_lo, sm.f_hi, ph); },
      [&](int q0, int c0, const float* in, const PolyBand<P, G::kSteps>& b) {
        // (columns x window rows) x band: output rows n0.. of columns
        // m0..; a task runs kR tiles 2 kK outputs apart
        constexpr int kN = 2 * kRows / 8, kR = G::kGroup;
        constexpr int kEvery = P::kK / 4, kG = kN / kR;
        static_assert(kR == 1 || kN % (kR * kEvery) == 0, "whole groups");
        for (int task = warp; task < kCols / 16 * kG; task += kWarps) {
          const int m0 = task / kG * 16;
          const int n0 = group_first<kEvery, kR>(task % kG);
          const float* lo = in + (n0 >> 1) * G::kLdW + m0;
          const float* hi = lo + RowsSmem<G>::kPlane;
          float c[kR][4] = {};
          band_tiles<P, G::kSteps, kR>(
              c, [&](int k, int m) { return lo[k * G::kLdW + m]; },
              [&](int k, int m) { return hi[k * G::kLdW + m]; }, b.lo, b.hi);
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int orow = 2 * q0 + n0 + 2 * r * P::kK + mma::c_col(i);
              const int ocol = c0 + m0 + mma::c_row(i);
              if (orow < 2 * len && ocol < nc)
                out[static_cast<long long>(orow) * nc + ocol] = c[r][i];
            }
        }
      });
}

using AnaRowsKernel = void (*)(const float*, float*, float*, int, int, Taps,
                               int, row_walk::Plan, Halo<float, 1>);
using SynRowsKernel = void (*)(const float*, const float*, float*, int, int,
                               Taps, int, row_walk::Plan, Halo<float, 2>);

template <class P, int S>
TileInstance<AnaRowsKernel> ana_rows_instance() {
  using G = AnaRowsGeom<P, S>;
  return {tc_ana_rows_kernel<G>, RowsSmem<G>::kBytes, kRows, kCols};
}

template <class P, int S>
TileInstance<SynRowsKernel> syn_rows_instance() {
  // K29h's tile groups where a tile spans more than one k-step: as many
  // tiles as share a fragment, within 32 registers of accumulators (4 a
  // tile) and band (8 a k-step in TF32, 4 in bf16)
  constexpr int kMax = 2 * kRows / 8 / (P::kK / 4);
  constexpr int kFit = (32 - S * (P::kK == 8 ? 8 : 4)) / 4;
  constexpr int kGroup = S == 1 ? 1 : kMax < kFit ? kMax : kFit;
  using G = SynRowsGeom<P, S, kGroup>;
  return {tc_syn_rows_kernel<G>, RowsSmem<G>::kBytes, kRows, kCols};
}

// kSteps as pick_dwt / pick_idwt below.
TileInstance<AnaRowsKernel> pick_ana_rows(bool bf16, int hlen) {
  if (bf16) {
    switch ((14 + hlen + 15) / 16) {
      case 2: return ana_rows_instance<mma::Bf16, 2>();
      case 3: return ana_rows_instance<mma::Bf16, 3>();
      case 4: return ana_rows_instance<mma::Bf16, 4>();
    }
  } else {
    switch ((14 + hlen + 7) / 8) {
      case 3: return ana_rows_instance<mma::Tf32, 3>();
      case 4: return ana_rows_instance<mma::Tf32, 4>();
      case 5: return ana_rows_instance<mma::Tf32, 5>();
      case 6: return ana_rows_instance<mma::Tf32, 6>();
      case 7: return ana_rows_instance<mma::Tf32, 7>();
    }
  }
  return {nullptr, 0, 0, 0};
}

TileInstance<SynRowsKernel> pick_syn_rows(bool bf16, int hlen) {
  if (bf16) {
    switch ((hlen / 2 + 4 + 15) / 16) {
      case 1: return syn_rows_instance<mma::Bf16, 1>();
      case 2: return syn_rows_instance<mma::Bf16, 2>();
    }
  } else {
    switch ((hlen / 2 + 4 + 7) / 8) {
      case 1: return syn_rows_instance<mma::Tf32, 1>();
      case 2: return syn_rows_instance<mma::Tf32, 2>();
      case 3: return syn_rows_instance<mma::Tf32, 3>();
    }
  }
  return {nullptr, 0, 0, 0};
}

template <class Rows>
using DwtKernel = void (*)(const float*, float*, float*, float*, float*, int,
                           int, Taps, int, int, Rows);
template <class Rows>
using IdwtKernel = void (*)(const float*, const float*, const float*,
                            const float*, float*, int, int, Taps, int, int,
                            Rows);

template <class P, int S, class Rows>
Instance<DwtKernel<Rows>> dwt_instance() {
  return {tc_dwt2d_kernel<P, S, Rows>, DwtSmem<AnaGeom<P, S>>::kBytes};
}

template <class P, int S, class Rows>
Instance<IdwtKernel<Rows>> idwt_instance() {
  return {tc_idwt2d_kernel<P, S, Rows>, IdwtSmem<SynGeom<P, S>>::kBytes};
}

// kSteps = ceil((14 + hlen) / kK): 3..7 (TF32), 2..4 (BF16) for hlen 4..40.
template <class Rows>
Instance<DwtKernel<Rows>> pick_dwt(bool bf16, int hlen) {
  if (bf16) {
    switch ((14 + hlen + 15) / 16) {
      case 2: return dwt_instance<mma::Bf16, 2, Rows>();
      case 3: return dwt_instance<mma::Bf16, 3, Rows>();
      case 4: return dwt_instance<mma::Bf16, 4, Rows>();
    }
  } else {
    switch ((14 + hlen + 7) / 8) {
      case 3: return dwt_instance<mma::Tf32, 3, Rows>();
      case 4: return dwt_instance<mma::Tf32, 4, Rows>();
      case 5: return dwt_instance<mma::Tf32, 5, Rows>();
      case 6: return dwt_instance<mma::Tf32, 6, Rows>();
      case 7: return dwt_instance<mma::Tf32, 7, Rows>();
    }
  }
  return {nullptr, 0};
}

// kSteps = ceil((hlen/2 + 4) / kK): 1..3 (TF32), 1..2 (BF16).
template <class Rows>
Instance<IdwtKernel<Rows>> pick_idwt(bool bf16, int hlen) {
  if (bf16) {
    switch ((hlen / 2 + 4 + 15) / 16) {
      case 1: return idwt_instance<mma::Bf16, 1, Rows>();
      case 2: return idwt_instance<mma::Bf16, 2, Rows>();
    }
  } else {
    switch ((hlen / 2 + 4 + 7) / 8) {
      case 1: return idwt_instance<mma::Tf32, 1, Rows>();
      case 2: return idwt_instance<mma::Tf32, 2, Rows>();
      case 3: return idwt_instance<mma::Tf32, 3, Rows>();
    }
  }
  return {nullptr, 0};
}

bool level_ok(int batch, int nr, int nc, int hlen) {
  return hlen >= 4 && hlen <= kMaxTaps && hlen % 2 == 0 && batch >= 1 &&
         nr >= 2 && nc >= 2 && nr % 2 == 0 && nc % 2 == 0 &&
         nr <= 0x3fffffff && nc <= 0x3fffffff;
}

// K6's output takes 8-byte stores.
bool pair_aligned(const float* out) {
  return (reinterpret_cast<uintptr_t>(out) & 7) == 0;
}

template <class Kernel>
cudaError_t prepare(const Instance<Kernel>& inst, int device) {
  if (inst.kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(inst.kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(inst.smem));
}

}  // namespace
}  // namespace pypwt

// Both return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. The filters are host arrays of hlen floats; bf16 is
// 1 for the "bf16" precision, 0 for "highest" (3xTF32).
// K5: a, h, v, d of (batch, nr/2, nc/2).
extern "C" int pypwt_tc_dwt2d(const float* x, float* a, float* h, float* v,
                              float* d, int batch, int nr, int nc,
                              const float* dec_lo, const float* dec_hi,
                              int hlen, int bf16, int device, void* stream) {
  using namespace pypwt;
  if (!level_ok(batch, nr, nc, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto inst = pick_dwt<Wrapped>(bf16 != 0, hlen);
  cudaError_t err = prepare(inst, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps taps = make_taps(dec_lo, dec_hi, hlen);
  const int lr = nr / 2, lc = nc / 2;
  launch_chunks((lc + kTile - 1) / kTile, (lr + kTile - 1) / kTile, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long pi = static_cast<long long>(z0) * nr * nc;
                  const long long po = static_cast<long long>(z0) * lr * lc;
                  inst.kernel<<<grid, kThreads, inst.smem,
                                static_cast<cudaStream_t>(stream)>>>(
                      x + pi, a + po, h + po, v + po, d + po, nr, nc, taps,
                      hlen, y0, Wrapped{});
                });
  return static_cast<int>(cudaGetLastError());
}

// K6: out of (batch, 2 lr, 2 lc) from coefficients of (batch, lr, lc); out
// 8-byte aligned (the kernel stores pairs of outputs).
extern "C" int pypwt_tc_idwt2d(const float* a, const float* h, const float* v,
                               const float* d, float* out, int batch, int lr,
                               int lc, const float* rec_lo,
                               const float* rec_hi, int hlen, int bf16,
                               int device, void* stream) {
  using namespace pypwt;
  if (lr > 0x1fffffff || lc > 0x1fffffff ||
      !level_ok(batch, 2 * lr, 2 * lc, hlen) || !pair_aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto inst = pick_idwt<Wrapped>(bf16 != 0, hlen);
  cudaError_t err = prepare(inst, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps taps = make_taps(rec_lo, rec_hi, hlen);
  launch_chunks((lc + kTile - 1) / kTile, (lr + kTile - 1) / kTile, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long pi = static_cast<long long>(z0) * lr * lc;
                  const long long po = 4 * pi;
                  inst.kernel<<<grid, kThreads, inst.smem,
                                static_cast<cudaStream_t>(stream)>>>(
                      a + pi, h + pi, v + pi, d + pi, out + po, lr, lc, taps,
                      hlen, y0, Wrapped{});
                });
  return static_cast<int>(cudaGetLastError());
}

// K28's analysis: K5's level of one row shard x of (batch, nr, nc), its
// rows above and below from top (batch, lp, nc) and bot (batch, rp, nc), lp
// and rp the analysis pads of hlen.
extern "C" int pypwt_tc_dwt2d_sharded(const float* x, const float* top,
                                      const float* bot, float* a, float* h,
                                      float* v, float* d, int batch, int nr,
                                      int nc, int lp, int rp,
                                      const float* dec_lo,
                                      const float* dec_hi, int hlen, int bf16,
                                      int device, void* stream) {
  using namespace pypwt;
  if (!level_ok(batch, nr, nc, hlen) || !analysis_halos_ok(hlen, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  using Rows = Halo<float, 1>;
  const auto inst = pick_dwt<Rows>(bf16 != 0, hlen);
  cudaError_t err = prepare(inst, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps taps = make_taps(dec_lo, dec_hi, hlen);
  const Rows halo = make_halo(top, bot, lp, rp);
  const int lr = nr / 2, lc = nc / 2;
  launch_chunks((lc + kTile - 1) / kTile, (lr + kTile - 1) / kTile, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long pi = static_cast<long long>(z0) * nr * nc;
                  const long long po = static_cast<long long>(z0) * lr * lc;
                  inst.kernel<<<grid, kThreads, inst.smem,
                                static_cast<cudaStream_t>(stream)>>>(
                      x + pi, a + po, h + po, v + po, d + po, nr, nc, taps,
                      hlen, y0, halo.plane(z0, nc));
                });
  return static_cast<int>(cudaGetLastError());
}

// K28's synthesis: K6's level of one row shard's planes a, h, v, d of
// (batch, lr, lc), halos their eight halo tensors in JAX's order (a_top,
// a_bot, h_top, ...), tops of (batch, lp, lc) and bottoms of (batch, rp,
// lc), lp and rp the synthesis pads of hlen; out of (batch, 2 lr, 2 lc),
// 8-byte aligned.
extern "C" int pypwt_tc_idwt2d_sharded(const float* a, const float* h,
                                       const float* v, const float* d,
                                       const float* const* halos, float* out,
                                       int batch, int lr, int lc, int lp,
                                       int rp, const float* rec_lo,
                                       const float* rec_hi, int hlen, int bf16,
                                       int device, void* stream) {
  using namespace pypwt;
  if (lr > 0x1fffffff || lc > 0x1fffffff ||
      !level_ok(batch, 2 * lr, 2 * lc, hlen) ||
      !synthesis_halos_ok(hlen, lp, rp) || !pair_aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  using Rows = Halo<float, 4>;
  const auto inst = pick_idwt<Rows>(bf16 != 0, hlen);
  cudaError_t err = prepare(inst, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps taps = make_taps(rec_lo, rec_hi, hlen);
  const float* tops[4] = {halos[0], halos[2], halos[4], halos[6]};
  const float* bots[4] = {halos[1], halos[3], halos[5], halos[7]};
  const Rows halo = make_halo4(tops, bots, lp, rp);
  launch_chunks((lc + kTile - 1) / kTile, (lr + kTile - 1) / kTile, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long pi = static_cast<long long>(z0) * lr * lc;
                  const long long po = 4 * pi;
                  inst.kernel<<<grid, kThreads, inst.smem,
                                static_cast<cudaStream_t>(stream)>>>(
                      a + pi, h + pi, v + pi, d + pi, out + po, lr, lc, taps,
                      hlen, y0, halo.plane(z0, lc));
                });
  return static_cast<int>(cudaGetLastError());
}

// K29g: lo, hi of (nr/2, nc) from the shard x of (nr, nc), nr even, its
// rows above from top (lp, nc) and below from bot (rp, nc), lp and rp the
// analysis pads of hlen.
extern "C" int pypwt_tc_ana_rows(const float* x, const float* top,
                                 const float* bot, float* lo, float* hi,
                                 int nr, int nc, int lp, int rp,
                                 const float* dec_lo, const float* dec_hi,
                                 int hlen, int bf16, int device,
                                 void* stream) {
  using namespace pypwt;
  if (!level_ok(1, nr, 2, hlen) || nc < 1 || nc > 0x3fffffff ||
      !analysis_halos_ok(hlen, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto inst = pick_ana_rows(bf16 != 0, hlen);
  row_walk::Plan plan;
  unsigned grid = 0;
  const cudaError_t err =
      row_walk::plan_tiles(inst, nr / 2, nc, device, &plan, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps taps = make_taps(dec_lo, dec_hi, hlen);
  const Halo<float, 1> halo = make_halo(top, bot, lp, rp);
  inst.kernel<<<grid, kThreads, inst.smem, static_cast<cudaStream_t>(stream)>>>(
      x, lo, hi, nr, nc, taps, hlen, plan, halo);
  return static_cast<int>(cudaGetLastError());
}

// K29h: out of (2 len, nc) from a, d of (len, nc), halos their four halo
// tensors (a_top, a_bot, d_top, d_bot), tops of (lp, nc) and bottoms of
// (rp, nc), lp and rp the synthesis pads of hlen.
extern "C" int pypwt_tc_syn_rows(const float* a, const float* d,
                                 const float* const* halos, float* out,
                                 int len, int nc, int lp, int rp,
                                 const float* rec_lo, const float* rec_hi,
                                 int hlen, int bf16, int device,
                                 void* stream) {
  using namespace pypwt;
  if (len > 0x1fffffff || !level_ok(1, 2 * len, 2, hlen) || nc < 1 ||
      nc > 0x3fffffff || !synthesis_halos_ok(hlen, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto inst = pick_syn_rows(bf16 != 0, hlen);
  row_walk::Plan plan;
  unsigned grid = 0;
  const cudaError_t err =
      row_walk::plan_tiles(inst, len, nc, device, &plan, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps taps = make_taps(rec_lo, rec_hi, hlen);
  const float* tops[2] = {halos[0], halos[2]};
  const float* bots[2] = {halos[1], halos[3]};
  Halo<float, 2> halo;
  for (int p = 0; p < 2; ++p) {
    halo.top[p] = tops[p];
    halo.bot[p] = bots[p];
  }
  halo.lp = lp;
  halo.rp = rp;
  inst.kernel<<<grid, kThreads, inst.smem, static_cast<cudaStream_t>(stream)>>>(
      a, d, out, len, nc, taps, hlen, plan, halo);
  return static_cast<int>(cudaGetLastError());
}

// The occupancy API's resident blocks per SM, and the dynamic shared memory
// in bytes, of K5's instance for hlen taps (halo 0) or K28's analysis (halo
// 1), bf16 as above: a figure for reports.
extern "C" int pypwt_tc_dwt2d_occupancy(int hlen, int bf16, int halo,
                                        int device, int* blocks, int* smem) {
  using namespace pypwt;
  if (!level_ok(1, 2, 2, hlen)) return static_cast<int>(cudaErrorInvalidValue);
  return halo ? occupancy(pick_dwt<Halo<float, 1>>(bf16 != 0, hlen), device,
                          blocks, smem)
              : occupancy(pick_dwt<Wrapped>(bf16 != 0, hlen), device, blocks,
                          smem);
}

// The same figure of K6's instance for hlen taps (halo 0) or K28's
// synthesis (halo 1).
extern "C" int pypwt_tc_idwt2d_occupancy(int hlen, int bf16, int halo,
                                         int device, int* blocks,
                                         int* smem) {
  using namespace pypwt;
  if (!level_ok(1, 2, 2, hlen)) return static_cast<int>(cudaErrorInvalidValue);
  return halo ? occupancy(pick_idwt<Halo<float, 4>>(bf16 != 0, hlen), device,
                          blocks, smem)
              : occupancy(pick_idwt<Wrapped>(bf16 != 0, hlen), device,
                          blocks, smem);
}

// The occupancy API's resident blocks per SM, the dynamic shared memory in
// bytes and the tile shape (rows and columns: K29g's of outputs, K29h's of
// coefficients) of K29g's instance (synthesis 0) or K29h's (synthesis 1)
// for hlen taps, bf16 as above: figures for reports.
extern "C" int pypwt_tc_rows_occupancy(int synthesis, int hlen, int bf16,
                                       int device, int* blocks, int* smem,
                                       int* tile_rows, int* tile_cols) {
  using namespace pypwt;
  if (!level_ok(1, 2, 2, hlen)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return synthesis ? report_occupancy(pick_syn_rows(bf16 != 0, hlen), blocks,
                                      smem, tile_rows, tile_cols)
                   : report_occupancy(pick_ana_rows(bf16 != 0, hlen), blocks,
                                      smem, tile_rows, tile_cols);
}
