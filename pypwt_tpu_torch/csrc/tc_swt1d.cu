// K12a / K12b: one periodized batched-1D stationary (a-trous) level and its
// inverse, float32, as banded products on the tensor cores.
//
// K12a replaces the TPU kernel pypwt_tpu/ops/mxu_swt.py::
// swt1d_level_fused_mxu (_build_swt1d_mxu, call :494), K12b
// ::iswt1d_level_fused_mxu (_build_iswt1d_mxu, :560): banded MXU dots on
// the last axis. One signal is a (1, n) row, which also computes the map of
// the folded long-signal kernels ::swt1d_long_fused_mxu /
// ::iswt1d_long_fused_mxu (K15, :806 and :875).
//
// Maps (the port's plain versions in ops/mxu_swt.py), rows (R, n), any hlen
// <= 40, level l >= 1, dilation t = 2^(l-1); tap k reads sample
// i + (s - k) t, wrapped mod n, with the centre s given by the caller
// (conv.swt_centre):
//   K12a: lo[i] = sum_k dec_lo[k] x[i + (s - k) t], hi with dec_hi;
//   K12b: out[i] = sum_k rec_lo[k]/2 lo[j] + rec_hi[k]/2 hi[j],
//         j = i + (s - k) t (one 1/2).
// The router gives them only levels whose dilated support fits in the row
// (JAX's coverage); the index arithmetic here wraps at any level.
//
// Bound: the bytes of K10, 12 per sample (16 MiB in, 32 MiB out for 2048
// rows of 2048 in K12a, the reverse in K12b: 15.0 us at 3.35 TB/s). A chunk
// of 8 outputs spans kSteps k-steps of 8 or 16 samples (hlen + 7 of them
// non-zero), 3 products each in "highest": at sym8 about 1.2 GFLOP of TF32
// per level of 2048 x 2048, 2.4 us at 495 TFLOP/s: memory-bound.
//
// Design: the outputs of one residue class mod t, rho + t q, read samples
// of the same class only, so one compact (level-1) band serves every level:
// out[q] = sum_j f[j] w[q + j], f[j] = tap[hlen-1-j], on the class's window
// w[u] = x[rho + t (q0 - back + u)], back = hlen - 1 - s. The work item is
// C consecutive classes (C = min(t, 32)) of one row and 8 cpl consecutive
// positions of each (1024 outputs in all; several whole short rows where a
// row has fewer): one line per class, with its own periodic halo, which at
// deep levels reaches across several segments and around the row. Its 128
// chunks (8 consecutive positions of one class) are one 16-chunk tile per
// warp. Blocks are persistent: the grid is what the SMs hold at once (the
// occupancy API), and block b walks items b + j gridDim.x (row block,
// class group and position tile advanced with a carry, no division per
// item); the taps and both bands' B fragments are built once per block,
// while its first windows are in flight. The windows go through a ring of
// kRing slots in shared memory, each with its item beside it: while the
// warps compute item j, the windows of the next kRing - 1 items are in
// flight, one cp.async commit group per item, no register holding a
// sample. Zero is written past a line's extent (and for a line past the
// rows or classes), where the band's zero entries meet it, so a NaN outside
// an output's support cannot reach it.
//   Level 1 (t = 1, or a row of one sample): a line is one run of its row.
// It is copied in 16-byte cp.async from its first sample rounded down to a
// 16-byte address and read shifted by the remainder (samples that wrap
// around the row are copied 4 bytes at a time from where they lie), and a
// lane's two consecutive outputs of a fragment row go out as one 8-byte
// store where the row offset is even: no shared output tile.
//   Levels >= 2: consecutive threads copy consecutive classes of one
// position, 4 bytes each (where C = t, a warp's copies are one run of the
// row), into the de-interleaved windows, each copy's sample kept mod n as
// the walk goes (no multiply or divide a copy); the products go to a
// shared output tile, written back class-fastest in vectors across classes
// where the classes, the row and the outputs allow (two floats at C = 2,
// four at C >= 4), one barrier between the products and the write-back.
// Copying the classes' span whole and de-interleaving it in shared memory
// measured slower, and so did two output tiles (the write-back of one item
// beside the products of the next) and a promise of 3 or 4 blocks per SM
// to every instance; one instance gets one where it would spill
// (kMinBlocks).
// TF32 windows keep 4 floats after every 8 samples, so that the 8 chunks a
// fragment reads start in distinct banks (a read that the level-1 shift
// moves across a pad still meets 32 banks); bf16 ones none. A tile's
// products are those of mma::band_product (K12b: band_product_pair) in
// their order, on the same window samples and band entries, so the outputs
// are bit-identical to those of the first version (a block per item,
// windows staged through registers).

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace pypwt {
namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kRing = 3;      // window slots: kRing - 1 items in flight
constexpr int kChunks = 128;  // 8-output chunks per item
constexpr int kMaxClasses = 32;
static_assert(kChunks == 16 * kWarps, "one 16-chunk tile per warp and item");

using mma::band;

// The residue-class lines of one level: an item holds `packs` rows x C
// classes (group grp of the row's classes) x 8 cpl positions (tile of the
// class); line l = p C + c.
struct ClassLines {
  long long rows;
  long long items;       // row blocks x groups x tiles
  int per_block, extra;  // items of block b: per_block + (b < extra)
  int step_a;            // a block's step gridDim.x = (step_a groups +
  int step_grp, step_tile;  // step_grp) tiles + step_tile items
  int n;
  int cls;       // residue classes: the dilation, or n where it reaches n
  int log_cls;   // log2(cls) where cls is a power of two, else -1 (cls = n:
                 // one position per class)
  long long fm;  // the dilation mod n
  int back;      // hlen - 1 - s: window sample u holds position q0 - back + u
  int C;         // classes per item, a power of two
  int log_c;     // log2 C
  int groups;    // class groups per row
  int cpl;       // 8-position chunks per line
  int tiles;     // position tiles per class
  int packs;     // rows per item
  int ldl;       // shared floats per staged line
  int ldo;       // shared floats per output line
  int nq;        // level 1: quads of slots a line; kThreads = q_dl nq + q_dq
  int q_dl, q_dq;
  // levels >= 2: a thread takes one class of each group of C and a
  // (pack, index) pair of every kThreads / C, advanced with a carry by
  // these uniform steps: the copies over lines of win window samples, each
  // pair's sample mod n moved by cp_dk on a step and by cp_dkc on a carry;
  // the write-back over lines of 8 cpl positions, vec classes a store
  int win;
  int cp_dp, cp_du, cp_dk, cp_dkc;
  int vec, log_wb;  // log_wb = log2(C / vec)
  int wb_dp, wb_dq;
};

ClassLines plan_classes(long long rows, int n, int level, int hlen, int s) {
  ClassLines p{};
  p.rows = rows;
  p.n = n;
  const bool every = level > 31 || (1LL << (level - 1)) >= n;
  p.cls = every ? n : (1 << (level - 1));
  p.log_cls = -1;
  for (int b = 0; b < 31; ++b)
    if (p.cls == 1 << b) p.log_cls = b;
  p.fm = dilation_mod(level, n);
  p.back = hlen - 1 - s;
  while ((2 << p.log_c) <= std::min(p.cls, kMaxClasses)) ++p.log_c;
  p.C = 1 << p.log_c;  // where cls is not a power of two, the last group
                       // holds fewer
  p.groups = (p.cls + p.C - 1) / p.C;
  const int per = (n + p.cls - 1) / p.cls;  // positions of class 0
  const int chunks = (per + 7) / 8;
  p.cpl = std::min(kChunks / p.C, chunks);
  p.tiles = (chunks + p.cpl - 1) / p.cpl;
  p.packs = p.groups == 1 && p.tiles == 1
                ? static_cast<int>(std::min<long long>(
                      std::max(1, kChunks / (p.C * p.cpl)), rows))
                : 1;
  p.items = (rows + p.packs - 1) / p.packs * p.groups * p.tiles;
  p.ldo = 8 * p.cpl + 1;  // odd: the class-fastest write-back is
                          // conflict-free
  return p;
}

// Positions of class rho of the row.
__device__ __forceinline__ int positions(const ClassLines& p, int rho) {
  return p.log_cls >= 0 ? (p.n - rho + p.cls - 1) >> p.log_cls : 1;
}

// Positions q0 .. q0 + cnt - 1 of class rho in an item (0: no class rho).
__device__ __forceinline__ int line_count(const ClassLines& p, int rho,
                                          int q0) {
  return rho < p.cls ? max(0, min(8 * p.cpl, positions(p, rho) - q0)) : 0;
}

// One item: rows row0 .. row0 + packs - 1 (those before rows), classes
// rho0 .. rho0 + C - 1 (those before cls), positions q0 .. of each.
struct Item {
  long long row0;
  int rho0, q0;
  __device__ int lines(const ClassLines& p) const {
    return static_cast<int>(min(static_cast<long long>(p.packs),
                                p.rows - row0));
  }
};
static_assert(sizeof(Item) == 16, "items keep the slots 16-byte aligned");

// A block's items blockIdx.x + j gridDim.x, item = (a groups + grp) tiles +
// tile: the divisions once per block, then the host's step and a carry.
class Walk {
 public:
  __device__ explicit Walk(const ClassLines& p) {
    const long long per_row = static_cast<long long>(p.groups) * p.tiles;
    a_ = static_cast<int>(blockIdx.x / per_row);
    const int rest = static_cast<int>(blockIdx.x - a_ * per_row);
    grp_ = rest / p.tiles;
    tile_ = rest - grp_ * p.tiles;
  }
  __device__ Item item(const ClassLines& p) const {
    return {static_cast<long long>(a_) * p.packs, grp_ * p.C,
            tile_ * 8 * p.cpl};
  }
  __device__ void next(const ClassLines& p) {
    tile_ += p.step_tile;
    int carry = tile_ >= p.tiles;
    if (carry) tile_ -= p.tiles;
    grp_ += p.step_grp + carry;
    carry = grp_ >= p.groups;
    if (carry) grp_ -= p.groups;
    a_ += p.step_a + carry;
  }

 private:
  int a_, grp_, tile_;
};

// Shared memory of a block: the taps, the item of each slot, kRing slots of
// `buf` floats, then the output tile of the levels >= 2 (`tile` floats).
struct Ring {
  static constexpr int kTapFloats = 2 * kMaxTaps;
  static constexpr int kItemFloats = kRing * sizeof(Item) / sizeof(float);
  float* taps;
  Item* items;
  float* first;
  int buf;
  __device__ explicit Ring(int buf) : taps(dynamic_smem<float>()), buf(buf) {
    items = reinterpret_cast<Item*>(taps + kTapFloats);
    first = taps + kTapFloats + kItemFloats;
  }
  // slot i (of kRing) and the output tile
  __device__ float* at(int i) const { return first + i * buf; }
  __device__ float* tile() const { return first + kRing * buf; }
  static size_t bytes(int buf, int tile) {
    return sizeof(float) * (kTapFloats + kItemFloats +
                            static_cast<size_t>(kRing) * buf + tile);
  }
};

// A block's pipeline over its items: each is fetched kRing - 1 items
// before it is computed, into the next slot of the ring, its Item kept
// beside the slot; one commit group per item (empty past the block's
// last), one __syncthreads per item before its products.
class Pipe {
 public:
  __device__ Pipe(const ClassLines& p, const Ring& ring)
      : p_(p),
        ring_(ring),
        fetch_(p),
        count_(p.per_block + (static_cast<int>(blockIdx.x) < p.extra)) {}
  // Issue the first kRing - 1 items; the caller synchronises.
  template <class Issue>
  __device__ __forceinline__ void start(Issue issue) {
    for (int j = 0; j < kRing - 1; ++j) fill(j, j, issue);
  }
  // Each item in turn: wait for its slot, refill the one before it (every
  // warp is done with it), compute(slot, item).
  template <class Issue, class Compute>
  __device__ __forceinline__ void run(Issue issue, Compute compute) {
    int i = 0;
    for (int j = 0; j < count_; ++j, i = i + 1 == kRing ? 0 : i + 1) {
      mma::cp_async_wait<kRing - 2>();
      __syncthreads();
      const Item it = ring_.items[i];
      fill(j + kRing - 1, i == 0 ? kRing - 1 : i - 1, issue);
      compute(ring_.at(i), it);
    }
  }

 private:
  // Item j of the block into slot i.
  template <class Issue>
  __device__ __forceinline__ void fill(int j, int i, Issue issue) {
    if (j < count_) {
      const Item it = fetch_.item(p_);
      if (threadIdx.x == 0) ring_.items[i] = it;
      issue(ring_.at(i), it);
      fetch_.next(p_);
    }
    mma::cp_async_commit();
  }
  const ClassLines& p_;
  const Ring& ring_;
  Walk fetch_;
  int count_;
};

// The window's geometry: chunk m reads class samples 8 m + k, k < kSpan;
// TF32 windows keep 4 floats after every 8 samples (rows 12 floats apart
// hit distinct banks), bf16 ones none (rows 8 apart meet each bank twice,
// the least for a fragment's 64 words). Level 1 (kRun): a line holds
// quads(cpl) quads of slots, the window shifted by up to 3.
template <class P, int kSteps, bool kRun, int kInputs, int kOutputs>
struct Geom {
  static constexpr int kSpan = kSteps * P::kK;
  static constexpr int kPad = P::kK == 8 ? 4 : 0;
  __host__ __device__ static int window(int cpl) {
    return 8 * (cpl - 1) + kSpan;
  }
  __host__ __device__ static int quads(int cpl) { return window(cpl) / 4 + 1; }
  __host__ __device__ static int phys(int u) { return u + kPad * (u >> 3); }
  static int ldl(int cpl) {
    return phys(kRun ? 4 * quads(cpl) - 1 : window(cpl) - 1) + 1;
  }
  static size_t smem(const ClassLines& p) {
    const int lpb = p.C * p.packs;
    return Ring::bytes(kInputs * lpb * p.ldl,
                       kRun ? 0 : kOutputs * lpb * p.ldo);
  }
};

// Thread tid's (line, quad) pairs of an item's level-1 windows, lines of nq
// quads: the first decoded once per block, then the host's step and a
// carry.
class QuadWalk {
 public:
  __device__ explicit QuadWalk(const ClassLines& p) {
    l0_ = threadIdx.x / static_cast<unsigned>(p.nq);
    q0_ = threadIdx.x - l0_ * p.nq;
  }
  template <class F>
  __device__ __forceinline__ void each(const ClassLines& p, int lines,
                                       F f) const {
    int l = l0_, q = q0_;
    while (l < lines) {
      f(l, q);
      l += p.q_dl;
      q += p.q_dq;
      if (q >= p.nq) {
        q -= p.nq;
        ++l;
      }
    }
  }

 private:
  int l0_, q0_;
};

// Thread tid's first pair of a levels->=2 walk: class c = tid mod 2^log
// (of a group of 2^log, which divides kThreads) and (pack, index) pair r =
// tid / 2^log = pk span + u; the walk adds kThreads / 2^log to r by the
// plan's steps, so that consecutive threads take consecutive classes of
// one index and no pair costs a division.
struct WalkStart {
  int c, pk, u;
  __device__ WalkStart(int log, int span) {
    c = threadIdx.x & ((1 << log) - 1);
    const int r = threadIdx.x >> log;
    pk = r < span ? 0 : r / span;
    u = r - pk * span;
  }
};

// Floats from the 16-byte boundary below sample `start` of the row at body
// to it: slot v of a level-1 window holds sample start - shift + v, so
// slots 4q .. 4q + 3 are one aligned 16-byte copy.
__device__ __forceinline__ int slot_shift(const float* body, int start) {
  return static_cast<int>(((reinterpret_cast<uintptr_t>(body) >> 2) + start) &
                          3);
}

// Sample k of a row of n, wrapped: one period off is the rule (a window is
// shorter than its row but at the deepest levels); wrap() divides only for
// a wrap wider than the row.
__device__ __forceinline__ int wrapped(int k, int n) {
  const int j = k < 0 ? k + n : k >= n ? k - n : k;
  return static_cast<unsigned>(j) < static_cast<unsigned>(n) ? j : wrap(k, n);
}

// Issue the copies of slots 4q .. 4q + 3 of a level-1 window into dst:
// slot 4q holds sample `first` + 4q and window index 4q - shift; zero from
// window index ext on. One 16-byte copy where the four samples are the
// row's own and inside the extent, else one 4-byte copy per slot from where
// its sample lies.
__device__ __forceinline__ void copy_quad(float* dst, const float* body,
                                          int first, int shift, int q,
                                          int ext, int n) {
  const int k0 = first + 4 * q, u0 = 4 * q - shift;
  if (k0 >= 0 && k0 <= n - 4 && u0 + 3 < ext) {
    mma::cp_async16_ca(dst, body + k0);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (u0 + e < ext)
      mma::cp_async4(dst + e, body + wrapped(k0 + e, n));
    else
      dst[e] = 0.f;
  }
}

// Issue the cp.async copies of an item's level-1 windows into buf (plane j
// of kInputs at buf + j lpb ldl): window index u of line l is sample q0 -
// back + u of its row, zero from cnt + hlen - 1 on.
template <class G, int kInputs>
__device__ __forceinline__ void issue_run(float* buf, const Item& it,
                                          const ClassLines& p,
                                          const float* const (&src)[kInputs],
                                          int hlen, const QuadWalk& qw) {
  const int start = it.q0 - p.back;
  const int ext = min(8 * p.cpl, p.n - it.q0) + hlen - 1;
  qw.each(p, it.lines(p), [&](int l, int q) {
    const long long row = (it.row0 + l) * p.n;
#pragma unroll
    for (int j = 0; j < kInputs; ++j) {
      const float* body = src[j] + row;
      const int shift = slot_shift(body, start);
      copy_quad(buf + (j * p.packs + l) * p.ldl + G::phys(4 * q), body,
                start - shift, shift, q, ext, p.n);
    }
  });
}

// Issue the cp.async copies of an item's class windows into buf (plane j
// at buf + j lpb ldl): window sample u of line l = pk C + c is x[(rho + cls
// q0 + (u - back) fm) mod n] of its row, zero from cnt + hlen - 1 on and
// for a line past the rows or classes. Each pair's sample is kept mod n as
// the walk goes (k_start: the thread's first pair's (u fm - back fm) mod
// n), so that no copy multiplies or divides.
template <class G, int kInputs>
__device__ __forceinline__ void issue_classes(
    float* buf, const Item& it, const ClassLines& p,
    const float* const (&src)[kInputs], int hlen, int k_start) {
  const int lpb = p.C * p.packs;
  const WalkStart w(p.log_c, p.win);
  const int rho = it.rho0 + w.c;
  const int cnt = line_count(p, rho, it.q0);
  const int ext = cnt > 0 ? cnt + hlen - 1 : 0;
  const int lines = it.lines(p);
  long long k0 = rho + static_cast<long long>(p.cls) * it.q0 + k_start;
  while (k0 >= p.n) k0 -= p.n;  // of [0, 3 n + C)
  int pk = w.pk, u = w.u, k = static_cast<int>(k0);
  while (pk < p.packs) {
    float* d = buf + (pk * p.C + w.c) * p.ldl + G::phys(u);
    if (pk < lines && u < ext) {
      const long long o = (it.row0 + pk) * p.n + k;
#pragma unroll
      for (int j = 0; j < kInputs; ++j)
        mma::cp_async4(d + j * lpb * p.ldl, src[j] + o);
    } else {
#pragma unroll
      for (int j = 0; j < kInputs; ++j) d[j * lpb * p.ldl] = 0.f;
    }
    pk += p.cp_dp;
    u += p.cp_du;
    k += p.cp_dk;
    if (k >= p.n) k -= p.n;
    if (u >= p.win) {
      u -= p.win;
      ++pk;
      k += p.cp_dkc;
      if (k >= p.n) k -= p.n;
    }
  }
}

// Store a lane's two outputs of one fragment row (columns 2t, 2t + 1) at
// out + at: one 8-byte store where both are inside lim and at is even.
__device__ __forceinline__ void store_pair(float* out, long long at, int lim,
                                           bool vec, float v0, float v1) {
  const int col = 2 * (mma::lane_id() & 3);
  if (vec && col + 1 < lim && (at & 1) == 0) {
    *reinterpret_cast<float2*>(out + at + col) = make_float2(v0, v1);
    return;
  }
  if (col < lim) out[at + col] = v0;
  if (col + 1 < lim) out[at + col + 1] = v1;
}

// kVec consecutive floats of one store.
template <int kVec>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void put(float* d, const float (&v)[1]) { *d = v[0]; }
};
template <>
struct Vec<2> {
  __device__ static void put(float* d, const float (&v)[2]) {
    *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void put(float* d, const float (&v)[4]) {
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Write kOutputs shared output tiles back, class-fastest, kVec classes a
// store: position q of line l goes to sample rho + cls (q0 + q) of its row.
// The host sets kVec (ClassLines::vec) only where every aligned group of
// kVec classes is whole, has the same positions and lands on a kVec-float
// boundary.
template <int kOutputs, int kVec>
__device__ __forceinline__ void write_back(float* const (&dst)[kOutputs],
                                           const float* s_o,
                                           const ClassLines& p,
                                           const Item& it) {
  const int lpb = p.C * p.packs, span = 8 * p.cpl;
  const WalkStart w(p.log_wb, span);
  const int c = kVec * w.c, rho = it.rho0 + c;
  const int cnt = line_count(p, rho, it.q0);
  const int lines = it.lines(p);
  int pk = w.pk, q = w.u;
  while (pk < lines) {
    if (q < cnt) {
      const int l = pk * p.C + c;
      const long long o = (it.row0 + pk) * p.n + rho +
                          static_cast<long long>(p.cls) * (it.q0 + q);
#pragma unroll
      for (int j = 0; j < kOutputs; ++j) {
        float v[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          v[e] = s_o[(j * lpb + l + e) * p.ldo + q];
        Vec<kVec>::put(dst[j] + o, v);
      }
    }
    pk += p.wb_dp;
    q += p.wb_dq;
    if (q >= span) {
      q -= span;
      ++pk;
    }
  }
}

// The rows of the warp's tile (chunks t0 + g and t0 + g + 8, t0 = 16
// warp): line and chunk of the line, and whether the chunk is the item's,
// decoded once per block.
struct TileRows {
  int t0, line[2], chunk[2];
  bool ok[2];
  __device__ explicit TileRows(const ClassLines& p)
      : t0(16 * (threadIdx.x >> 5)) {
    const int g = mma::lane_id() >> 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = t0 + g + 8 * r;
      line[r] = q / p.cpl;
      chunk[r] = q - line[r] * p.cpl;
      ok[r] = q < p.C * p.packs * p.cpl;
    }
  }
};

// A tile's A fragments read from its window: lane element i of k-step s
// (fragment row r = i & 1, column group h = i >> 1, in mma.cuh's layouts)
// at cur[at[r][h] + kStride s], at[r][h] the offset of its k-step-0 sample
// with the chunk's base, the level-1 shift and the TF32 pads resolved once
// per item, so that each load is a shared load at a constant offset.
template <class P>
struct Frag;

template <>
struct Frag<mma::Tf32> {
  static constexpr int kStride = 12;  // 8 samples and their pad
  // window sample of element group h at k-step 0, and its slot
  __device__ static int column(int h) { return (mma::lane_id() & 3) + 4 * h; }
  __device__ static int phys(int v) { return v + 4 * (v >> 3); }
  __device__ static mma::Tf32::A load(const float* cur, const int (&at)[2][2],
                                      int s) {
    mma::Tf32::A a;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mma::split_tf32(cur[at[i & 1][i >> 1] + kStride * s], a.big[i],
                      a.small[i]);
    return a;
  }
};

template <>
struct Frag<mma::Bf16> {
  static constexpr int kStride = 16;
  __device__ static int column(int h) {
    return 2 * (mma::lane_id() & 3) + 8 * h;
  }
  __device__ static int phys(int v) { return v; }
  __device__ static mma::Bf16::A load(const float* cur, const int (&at)[2][2],
                                      int s) {
    mma::Bf16::A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* q = cur + at[i & 1][i >> 1] + kStride * s;
      a.v[i] = mma::pack_bf16(q[0], q[1]);
    }
    return a;
  }
};

// c0 += A B0 and c1 += A B1 over the k-steps, in mma::band_product's order.
template <class P, int kSteps>
__device__ __forceinline__ void product(float (&c0)[4], float (&c1)[4],
                                        const float* cur,
                                        const int (&at)[2][2],
                                        const typename P::B (&b0)[kSteps],
                                        const typename P::B (&b1)[kSteps]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const auto a = Frag<P>::load(cur, at, s);
    P::mma(c0, a, b0[s]);
    P::mma(c1, a, b1[s]);
  }
}

// c += A0 B0 + A1 B1 over the k-steps, in mma::band_product_pair's order.
template <class P, int kSteps>
__device__ __forceinline__ void product_pair(
    float (&c)[4], const float* cur, const int (&at0)[2][2],
    const int (&at1)[2][2], const typename P::B (&b0)[kSteps],
    const typename P::B (&b1)[kSteps]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const auto a0 = Frag<P>::load(cur, at0, s);
    P::mma(c, a0, b0[s]);
    const auto a1 = Frag<P>::load(cur, at1, s);
    P::mma(c, a1, b1[s]);
  }
}

// One level of K12a (kSyn false: src = {x}, dst = {lo, hi}) or K12b (kSyn
// true: src = {lo, hi}, dst = {out}), at level 1 (kRun) or a level >= 2.
template <class P, int kSteps, bool kRun, bool kSyn>
__device__ __forceinline__ void class_level(
    const float* const (&src)[kSyn ? 2 : 1], float* const (&dst)[kSyn ? 1 : 2],
    const ClassLines& p, const Taps& taps, int hlen) {
  constexpr int kIn = kSyn ? 2 : 1, kOut = kSyn ? 1 : 2;
  using G = Geom<P, kSteps, kRun, kIn, kOut>;
  const int lpb = p.C * p.packs;
  const Ring ring(kIn * lpb * p.ldl);
  float* f_lo = ring.taps;
  float* f_hi = f_lo + kMaxTaps;  // taps in window order
  Pipe pipe(p, ring);
  const QuadWalk qw(p);
  // levels >= 2: the thread's first copy's (u fm - back fm) mod n
  const int k_start =
      kRun ? 0
           : static_cast<int>(
                 (WalkStart(p.log_c, p.win).u * p.fm % p.n + p.n -
                  p.back * p.fm % p.n) %
                 p.n);
  const auto issue = [&](float* buf, const Item& it) {
    if constexpr (kRun)
      issue_run<G>(buf, it, p, src, hlen, qw);
    else
      issue_classes<G>(buf, it, p, src, hlen, k_start);
  };
  pipe.start(issue);
  load_reversed_taps(taps, hlen, f_lo, f_hi);
  __syncthreads();

  typename P::B b_lo[kSteps], b_hi[kSteps];
  mma::band_fragments<P>(
      b_lo, [&](int k, int n) { return band(f_lo, k - n, hlen); });
  mma::band_fragments<P>(
      b_hi, [&](int k, int n) { return band(f_hi, k - n, hlen); });
  const TileRows tr(p);
  const int col = 2 * (mma::lane_id() & 3);
  const int plane = lpb * p.ldl;
  float* s_o = ring.tile();
  bool vec = true;  // level 1: 8-byte stores
#pragma unroll
  for (int j = 0; j < kOut; ++j)
    vec = vec && (reinterpret_cast<uintptr_t>(dst[j]) & 7) == 0;

  pipe.run(issue, [&](const float* cur, const Item& it) {
    // fragment row r reads window sample k of its chunk at slot k +
    // shift of line line[r] (plane j: + j plane); level 1 shifts by the
    // row's alignment, each plane's own
    int at[kIn][2][2], lim[2];
    long long out[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int shift[kIn] = {};
      lim[r] = 0;
      out[r] = 0;
      if constexpr (kRun) {
        const long long row = it.row0 + tr.line[r];
        if (tr.ok[r] && row < p.rows) {
          lim[r] = min(8 * p.cpl, p.n - it.q0) - 8 * tr.chunk[r];
          out[r] = row * p.n + it.q0 + 8 * tr.chunk[r];
#pragma unroll
          for (int j = 0; j < kIn; ++j)
            shift[j] = slot_shift(src[j] + row * p.n, it.q0 - p.back);
        }
      }
      const int base =
          tr.ok[r] ? tr.line[r] * p.ldl + (8 + G::kPad) * tr.chunk[r] : 0;
#pragma unroll
      for (int j = 0; j < kIn; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          at[j][r][h] = j * plane + base +
                        Frag<P>::phys(Frag<P>::column(h) + shift[j]);
    }
    if (tr.t0 < lpb * p.cpl) {
      if constexpr (kSyn) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        product_pair<P>(c, cur, at[0], at[kIn - 1], b_lo, b_hi);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if constexpr (kRun) {
            store_pair(dst[0], out[r], lim[r], vec, c[2 * r], c[2 * r + 1]);
          } else if (tr.ok[r]) {
            const int o = tr.line[r] * p.ldo + 8 * tr.chunk[r] + col;
            s_o[o] = c[2 * r];
            s_o[o + 1] = c[2 * r + 1];
          }
        }
      } else {
        float clo[4] = {0.f, 0.f, 0.f, 0.f}, chi[4] = {0.f, 0.f, 0.f, 0.f};
        product<P>(clo, chi, cur, at[0], b_lo, b_hi);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if constexpr (kRun) {
            store_pair(dst[0], out[r], lim[r], vec, clo[2 * r],
                       clo[2 * r + 1]);
            store_pair(dst[kOut - 1], out[r], lim[r], vec, chi[2 * r],
                       chi[2 * r + 1]);
          } else if (tr.ok[r]) {
            const int o = tr.line[r] * p.ldo + 8 * tr.chunk[r] + col;
            s_o[o] = clo[2 * r];
            s_o[o + 1] = clo[2 * r + 1];
            s_o[lpb * p.ldo + o] = chi[2 * r];
            s_o[lpb * p.ldo + o + 1] = chi[2 * r + 1];
          }
        }
      }
    }
    if constexpr (!kRun) {
      __syncthreads();  // the tile complete; the next item's barrier
                        // guards its reuse
      if (p.vec == 4)
        write_back<kOut, 4>(dst, s_o, p, it);
      else if (p.vec == 2)
        write_back<kOut, 2>(dst, s_o, p, it);
      else
        write_back<kOut, 1>(dst, s_o, p, it);
    }
  });
}

template <class P, int kSteps, bool kRun>
__global__ void __launch_bounds__(kThreads)
tc_swt1d_kernel(const float* __restrict__ x, float* __restrict__ lo,
                float* __restrict__ hi, ClassLines p, Taps taps, int hlen) {
  const float* const src[1] = {x};
  float* const dst[2] = {lo, hi};
  class_level<P, kSteps, kRun, false>(src, dst, p, taps, hlen);
}

// Resident blocks per SM promised to ptxas: 3 (80 registers) for K12a's
// level-1 bf16 instance of 3 k-steps, which, left to itself, it fits in 64
// registers and spills; 0 elsewhere: no promise (an explicit minimum lets
// it spend the budget, which measured slower where it does not spill).
template <class P, int kSteps, bool kRun>
constexpr int kMinBlocks = P::kK == 16 && kSteps == 3 && kRun ? 3 : 0;

// K12a with kMinBlocks blocks per SM promised.
template <class P, int kSteps, bool kRun, int kMin>
__global__ void __launch_bounds__(kThreads, kMin)
tc_swt1d_kernel_bounded(const float* __restrict__ x, float* __restrict__ lo,
                        float* __restrict__ hi, ClassLines p, Taps taps,
                        int hlen) {
  const float* const src[1] = {x};
  float* const dst[2] = {lo, hi};
  class_level<P, kSteps, kRun, false>(src, dst, p, taps, hlen);
}

template <class P, int kSteps, bool kRun>
__global__ void __launch_bounds__(kThreads)
tc_iswt1d_kernel(const float* __restrict__ a, const float* __restrict__ d,
                 float* __restrict__ out, ClassLines p, Taps half_taps,
                 int hlen) {
  const float* const src[2] = {a, d};
  float* const dst[1] = {out};
  class_level<P, kSteps, kRun, true>(src, dst, p, half_taps, hlen);
}

using SwtKernel = void (*)(const float*, float*, float*, ClassLines, Taps,
                           int);
using IswtKernel = void (*)(const float*, const float*, float*, ClassLines,
                            Taps, int);

// A kernel instance, its per-line shared floats, its quads of slots per
// level-1 line and its shared memory.
template <class Kernel>
struct Picked {
  Kernel kernel;
  int (*ldl)(int);
  int (*quads)(int);
  int (*window)(int);
  size_t (*smem)(const ClassLines&);
};

template <class P, int S, bool kRun>
struct MakeSwt {
  static Picked<SwtKernel> get() {
    using G = Geom<P, S, kRun, 1, 2>;
    constexpr int kMin = kMinBlocks<P, S, kRun>;
    SwtKernel kernel;
    if constexpr (kMin > 0)
      kernel = tc_swt1d_kernel_bounded<P, S, kRun, kMin>;
    else
      kernel = tc_swt1d_kernel<P, S, kRun>;
    return {kernel, G::ldl, G::quads, G::window, G::smem};
  }
};

template <class P, int S, bool kRun>
struct MakeIswt {
  static Picked<IswtKernel> get() {
    using G = Geom<P, S, kRun, 2, 1>;
    return {tc_iswt1d_kernel<P, S, kRun>, G::ldl, G::quads, G::window,
            G::smem};
  }
};

// kSteps = ceil((hlen + 7) / kK): 1..6 (TF32), 1..3 (BF16) for hlen 1..40.
template <template <class, int, bool> class Make, bool kRun, class Kernel>
Picked<Kernel> pick_steps(bool bf16, int hlen) {
  if (bf16) {
    switch ((hlen + 7 + 15) / 16) {
      case 1: return Make<mma::Bf16, 1, kRun>::get();
      case 2: return Make<mma::Bf16, 2, kRun>::get();
      case 3: return Make<mma::Bf16, 3, kRun>::get();
    }
  } else {
    switch ((hlen + 7 + 7) / 8) {
      case 1: return Make<mma::Tf32, 1, kRun>::get();
      case 2: return Make<mma::Tf32, 2, kRun>::get();
      case 3: return Make<mma::Tf32, 3, kRun>::get();
      case 4: return Make<mma::Tf32, 4, kRun>::get();
      case 5: return Make<mma::Tf32, 5, kRun>::get();
      case 6: return Make<mma::Tf32, 6, kRun>::get();
    }
  }
  return {nullptr, nullptr, nullptr, nullptr, nullptr};
}

// The level-1 instance where a line is one run of its row (one class).
template <template <class, int, bool> class Make, class Kernel>
Picked<Kernel> pick(bool bf16, int hlen, bool run) {
  return run ? pick_steps<Make, true, Kernel>(bf16, hlen)
             : pick_steps<Make, false, Kernel>(bf16, hlen);
}

bool level_args_ok(int rows, int n, int level, int centre, int hlen) {
  return hlen >= 1 && hlen <= kMaxTaps && centre >= 0 && centre < hlen &&
         rows >= 1 && n >= 1 && n <= 0x3fffffff && level >= 1;
}

// Whether level `level` of rows of n has one residue class.
bool one_class(int n, int level) {
  return n == 1 || level == 1;
}

// The floats per store of the levels-2+ write-back: 4 (2) where C >= 4
// (2), n and cls are multiples and every output is 16- (8-) byte aligned,
// else 1 (and 1 for a report, outs 0).
int write_vector(const ClassLines& p, const float* const* dst, int outs) {
  for (int v = 4; v >= 2 && outs > 0; v /= 2) {
    bool ok = p.C >= v && p.n % v == 0 && p.cls % v == 0;
    for (int j = 0; j < outs; ++j)
      ok = ok && reinterpret_cast<uintptr_t>(dst[j]) % (4 * v) == 0;
    if (ok) return v;
  }
  return 1;
}

// The levels-2+ walks' uniform steps (ClassLines), the windows of win
// samples and the write-back vec classes a store.
void plan_walks(ClassLines& p, int win, int vec) {
  p.win = win;
  int step = kThreads >> p.log_c;
  p.cp_dp = step / win;
  p.cp_du = step - p.cp_dp * win;
  p.cp_dk = static_cast<int>(p.cp_du * p.fm % p.n);
  p.cp_dkc = static_cast<int>((p.n - win * p.fm % p.n) % p.n);
  p.vec = vec;
  p.log_wb = p.log_c - (vec == 4 ? 2 : vec == 2 ? 1 : 0);
  step = kThreads >> p.log_wb;
  p.wb_dp = step / (8 * p.cpl);
  p.wb_dq = step - p.wb_dp * 8 * p.cpl;
}

// One level's launch: its lines, shared memory, resident blocks per SM and
// grid (the blocks the SMs hold at once, at most the items).
struct Launch {
  ClassLines p;
  size_t smem;
  int per_sm;
  unsigned grid;
};

// Plan the level and the grid for outputs dst[0 .. outs - 1] (none: a
// report), and opt the kernel into its shared memory.
template <class Kernel>
cudaError_t plan_launch(const Picked<Kernel>& inst, int rows, int n,
                        int level, int centre, int hlen, int device,
                        const float* const* dst, int outs, Launch* lc) {
  if (inst.kernel == nullptr || !level_args_ok(rows, n, level, centre, hlen))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = device_sms(device, &sms);
  if (err != cudaSuccess) return err;
  ClassLines& p = lc->p;
  p = plan_classes(rows, n, level, hlen, centre);
  p.ldl = inst.ldl(p.cpl);
  p.nq = inst.quads(p.cpl);
  p.q_dl = kThreads / p.nq;
  p.q_dq = kThreads - p.q_dl * p.nq;
  plan_walks(p, inst.window(p.cpl), write_vector(p, dst, outs));
  lc->smem = inst.smem(p);
  err = cudaFuncSetAttribute(inst.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(lc->smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &lc->per_sm, inst.kernel, kThreads, lc->smem);
  if (err != cudaSuccess) return err;
  if (lc->per_sm < 1) return cudaErrorInvalidConfiguration;
  lc->grid = static_cast<unsigned>(std::min<long long>(
      static_cast<long long>(lc->per_sm) * sms, p.items));
  p.step_tile = static_cast<int>(lc->grid % p.tiles);
  const long long groups_step = lc->grid / p.tiles;
  p.step_grp = static_cast<int>(groups_step % p.groups);
  p.step_a = static_cast<int>(groups_step / p.groups);
  if (p.items / lc->grid > 0x7fffffff) return cudaErrorInvalidValue;
  p.per_block = static_cast<int>(p.items / lc->grid);
  p.extra = static_cast<int>(p.items % lc->grid);
  return cudaSuccess;
}

}  // namespace
}  // namespace pypwt

// Both return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. The filters are host arrays of hlen floats,
// `centre` the a-trous centre s of the direction, bf16 1 for the "bf16"
// precision and 0 for "highest" (3xTF32).
// K12a: lo, hi of the input's shape (rows, n).
extern "C" int pypwt_tc_swt1d(const float* x, float* lo, float* hi, int rows,
                              int n, int level, int centre,
                              const float* dec_lo, const float* dec_hi,
                              int hlen, int bf16, int device, void* stream) {
  using namespace pypwt;
  if (!level_args_ok(rows, n, level, centre, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto inst =
      pick<MakeSwt, SwtKernel>(bf16 != 0, hlen, one_class(n, level));
  const float* const dst[2] = {lo, hi};
  Launch lc;
  const cudaError_t err =
      plan_launch(inst, rows, n, level, centre, hlen, device, dst, 2, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  inst.kernel<<<lc.grid, kThreads, lc.smem,
                static_cast<cudaStream_t>(stream)>>>(
      x, lo, hi, lc.p, make_taps(dec_lo, dec_hi, hlen), hlen);
  return static_cast<int>(cudaGetLastError());
}

// K12b: out of the coefficients' shape.
extern "C" int pypwt_tc_iswt1d(const float* a, const float* d, float* out,
                               int rows, int n, int level, int centre,
                               const float* rec_lo, const float* rec_hi,
                               int hlen, int bf16, int device, void* stream) {
  using namespace pypwt;
  if (!level_args_ok(rows, n, level, centre, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  // rec / 2 is exact in float32: the single 1/2 of the 1D inverse
  float lo2[kMaxTaps], hi2[kMaxTaps];
  for (int k = 0; k < hlen; ++k) {
    lo2[k] = 0.5f * rec_lo[k];
    hi2[k] = 0.5f * rec_hi[k];
  }
  const auto inst =
      pick<MakeIswt, IswtKernel>(bf16 != 0, hlen, one_class(n, level));
  const float* const dst[1] = {out};
  Launch lc;
  const cudaError_t err =
      plan_launch(inst, rows, n, level, centre, hlen, device, dst, 1, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  inst.kernel<<<lc.grid, kThreads, lc.smem,
                static_cast<cudaStream_t>(stream)>>>(
      a, d, out, lc.p, make_taps<float>(lo2, hi2, hlen), hlen);
  return static_cast<int>(cudaGetLastError());
}

// The launch that K12a (synthesis 0) or K12b (synthesis 1) would make at
// `level` on rows of n samples with hlen taps (bf16 as above; the centre
// of the direction): resident blocks per SM (the occupancy API), dynamic
// shared memory in bytes and the grid; a figure for reports.
extern "C" int pypwt_tc_swt1d_occupancy(int synthesis, int rows, int n,
                                        int level, int hlen, int bf16,
                                        int device, int* blocks, int* smem,
                                        int* grid) {
  using namespace pypwt;
  const int centre = synthesis && hlen % 2 == 0 ? hlen / 2 - 1 : hlen / 2;
  if (!level_args_ok(rows, n, level, centre, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool run = one_class(n, level);
  Launch lc;
  const cudaError_t err =
      synthesis
          ? plan_launch(pick<MakeIswt, IswtKernel>(bf16 != 0, hlen, run),
                        rows, n, level, centre, hlen, device, nullptr, 0, &lc)
          : plan_launch(pick<MakeSwt, SwtKernel>(bf16 != 0, hlen, run), rows,
                        n, level, centre, hlen, device, nullptr, 0, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = lc.per_sm;
  *smem = static_cast<int>(lc.smem);
  *grid = static_cast<int>(lc.grid);
  return 0;
}
