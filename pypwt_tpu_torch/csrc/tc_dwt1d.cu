// K7a / K7b: one periodized batched-1D DWT level, analysis (K7a) and
// polyphase synthesis (K7b), float32, as banded products on the tensor cores;
// and K29e / K29f, the same levels of one segment of longer rows.
//
// K7a replaces the TPU kernel pypwt_tpu/ops/mxu_dwt.py::dwt1d_fused_mxu
// (_build_dwt1d_mxu, call :421), K7b ::idwt1d_fused_mxu (_build_idwt1d_mxu,
// :477): both run the last-axis pass as banded MXU dots D @ x. One signal is
// a (1, n) row, which also computes the map of the folded long-signal
// kernels ::dwt1d_long_fused_mxu / ::idwt1d_long_fused_mxu (K15, :929 and
// :993), whose fold only fixed the TPU's lane layout. K29e
// (pypwt_tc_ana_lanes) replaces ::build_ana_padded_lanes_mxu (:713) and
// K29f (pypwt_tc_syn_lanes) ::build_syn_padded_lanes_mxu (:821), the
// lane-axis passes of the grid and sequence layouts of
// pypwt_tpu/parallel/spatial.py in mode "mxu": the same kernels with the
// LaneHalo sample source (common.cuh), the samples before and after the
// shard read from the exchanged halos where they lie (window samples past
// both halos stage as zero, as past the window's extent).
//
// Maps (the port's plain versions in ops/mxu_dwt.py), rows (R, n) with n
// even and an even hlen of 4..40 (JAX's coverage; the router sends every
// other level to K3/K4):
//   K7a: lo[i] = sum_j f[j] x[(2i + j - lpad) mod n], f[j] = dec[hlen-1-j],
//        lpad = hlen - 1 - hlen/2, and hi the same with dec_hi; n/2 each;
//   K7b: the polyphase synthesis of common.cuh's Polyphase, y[2m + p] =
//        sum_{j < h2} g_p_lo[j] lo[(m + delta_p + j - c) mod L] + g_p_hi[j]
//        hi[...], 2L outputs from L coefficients.
//
// Bound: the bytes of K3/K4, 8 per input sample (16 MiB in and 16 MiB out
// for 2048 rows of 2048: 10.0 us at 3.35 TB/s). An 8-output chunk spans
// kSteps k-steps of 8 or 16 window samples (14 + hlen of them non-zero in
// K7a, h2 + 4 in K7b), 3 products each in "highest": at sym8 and 2048 x
// 2048 about 0.6 GFLOP of TF32 for K7a, 1.2 us at 495 TFLOP/s, so the
// kernels are memory-bound; "bf16" is one product at twice the rate. A
// line's few KB of window take a trip to memory that one tile per warp
// cannot cover, so a block has to keep the next windows in flight while
// it computes; past that, "highest" is bound by its instructions (the A
// fragments' loads and TF32 splits), not by bytes.
//
// Design: a product's 16 rows are 16 chunks of 8 consecutive outputs, not
// 16 rows of the input, so a single signal fills a tile as a sinogram does.
// The work item is a line: a segment of at most 1024 outputs of one row
// with its own periodic halo (a row of 2048 samples is one line; a 4 Mi
// signal is 2048 lines), or several whole short rows (the deep levels of a
// sinogram), so every item holds up to 128 chunks, one 16-chunk tile per
// warp. Blocks are persistent: the grid is what the SMs hold at once (the
// occupancy API), and block b walks items b + j
// gridDim.x, as many as the host counted for it (row and segment advanced
// with a carry, no division per item); the taps and both bands' B
// fragments are built once per block. The windows go through a ring of
// kRing buffers in shared memory, each with its item beside it: while the
// warps compute item j, the windows of the next kRing - 1 items are in
// flight, one cp.async commit group per item, no register holding a
// sample, one __syncthreads per item. A window is one run of one row: it
// is copied in 16-byte cp.async (cached in L1 too: faster than L2-only in
// "bf16") from its first sample rounded down to a 16-byte address and read
// shifted by the remainder, so an unaligned row or plane costs no narrower
// copies; samples that wrap (Wrapped) or lie in a halo (LaneHalo) are
// copied 4 bytes at a time from where they lie, and zero is written past
// the window's extent, where the band's zero entries meet it, so a NaN
// outside an output's support cannot reach it. Chunk m of a line reads
// window samples 16 m + k (K7b: coefficients 4 m + k), so the A tile is a
// strided view of the window; K7a stores the window with kPad floats after
// every 16 slots so that the 8 chunks a fragment reads start in distinct
// banks (a TF32 read that the shift moves across a pad still meets 32
// banks). The band is the same for every chunk: B[k][n] = f[k - 2n] (K7b:
// the polyphase taps of output parity n & 1 at k - n/2 - delta). A tile's
// products are those of mma::band_product (K7b: band_product_pair) in their
// order, so the outputs are bit-identical to the first version's. A lane's
// two consecutive outputs go out as one 8-byte store where the row offset
// is even: one store instruction writes 64 consecutive floats. No instance
// spills: where ptxas, left to itself, would fit 64 registers and spill,
// the kernel promises it fewer resident blocks (kMinBlocks).

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace pypwt {
namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kRing = 3;  // window buffers: kRing - 1 items in flight
constexpr int kChunks = 128;  // 8-output chunks per item
static_assert(kChunks == 16 * kWarps, "one 16-chunk tile per warp and item");

using mma::band;

// The items of one level: per_row lines of cpl chunks in each row; an item
// is one line, or lpb whole rows where a row is one line.
struct Lines {
  long long rows;
  long long items;
  long long step_a;  // a block's step gridDim.x = step_a per_row + step_seg
  int step_seg;
  int per_block, extra;  // items of block b: per_block + (b < extra)
  int per_row;
  int row_shift;  // log2(per_row) where per_row is a power of two, else -1
  int cpl;
  int lpb;
  int outs;  // outputs per row
  int n;     // input samples (K7a) or coefficients (K7b) per row
  int ldl;   // shared floats per staged line
  int nq;    // quads of slots per staged line; kThreads = q_dl nq + q_dq
  int q_dl, q_dq;
};

Lines plan_lines(long long rows, int outs, int n) {
  Lines ln{};
  const int chunks = (outs + 7) / 8;
  ln.cpl = std::min(kChunks, chunks);
  ln.per_row = (chunks + ln.cpl - 1) / ln.cpl;
  ln.row_shift = -1;
  for (int s = 0; s < 31; ++s)
    if (ln.per_row == 1 << s) ln.row_shift = s;
  ln.lpb = 1;  // several rows per item only where a row is one line
  if (ln.per_row == 1)
    ln.lpb = static_cast<int>(std::min<long long>(kChunks / ln.cpl, rows));
  ln.rows = rows;
  ln.items = (rows + ln.lpb - 1) / ln.lpb * ln.per_row;
  ln.outs = outs;
  ln.n = n;
  return ln;
}

// One item: rows r0 .. r0 + lines - 1, outputs o0 .. o0 + cnt - 1 of
// each.
struct Item {
  long long r0;
  int o0, cnt, lines;
  __device__ int chunks(int cpl) const {
    return (lines - 1) * cpl + (cnt + 7) / 8;
  }
};

// A block's items blockIdx.x + j gridDim.x, item = a per_row + seg: one
// 32-bit division per block (a shift where per_row is a power of two; the
// step is the host's), then a carry.
class Walk {
 public:
  __device__ explicit Walk(const Lines& ln) {
    const unsigned a = ln.row_shift >= 0
                           ? blockIdx.x >> ln.row_shift
                           : blockIdx.x / static_cast<unsigned>(ln.per_row);
    a_ = a;
    seg_ = static_cast<int>(blockIdx.x - a * ln.per_row);
  }
  __device__ Item item(const Lines& ln) const {
    Item it;
    it.r0 = a_ * ln.lpb;
    it.o0 = seg_ * 8 * ln.cpl;
    it.cnt = min(8 * ln.cpl, ln.outs - it.o0);
    it.lines = static_cast<int>(
        min(static_cast<long long>(ln.lpb), ln.rows - it.r0));
    return it;
  }
  __device__ void next(const Lines& ln) {
    a_ += ln.step_a;
    seg_ += ln.step_seg;
    if (seg_ >= ln.per_row) {
      seg_ -= ln.per_row;
      ++a_;
    }
  }

 private:
  long long a_;
  int seg_;
};

// Thread tid's (line, quad) pairs of an item's windows, lines of nq quads:
// the first decoded once per block, then the host's step and a carry.
class QuadWalk {
 public:
  __device__ explicit QuadWalk(const Lines& ln) {
    // one line per item: a thread past its quads has nothing to copy
    l0_ = ln.lpb == 1 ? threadIdx.x >= ln.nq
                      : threadIdx.x / static_cast<unsigned>(ln.nq);
    q0_ = threadIdx.x - l0_ * ln.nq;
  }
  template <class F>
  __device__ __forceinline__ void each(const Lines& ln, int lines,
                                       F f) const {
    int l = l0_, q = q0_;
    while (l < lines) {
      f(l, q);
      l += ln.q_dl;
      q += ln.q_dq;
      if (q >= ln.nq) {
        q -= ln.nq;
        ++l;
      }
    }
  }

 private:
  int l0_, q0_;
};

// Where sample k of row `row` lies, its own n samples at `body` (plane p):
// Wrapped, the row itself mod n; LaneHalo, the shard's samples or its
// halos, null past both halos.
__device__ __forceinline__ const float* sample_src(const Wrapped&, int,
                                                  const float* body,
                                                  long long, int k, int n) {
  // one period off is the rule (a window is shorter than its row but at
  // the deepest levels); wrap() divides only for a wrap wider than the row
  const int j = k < 0 ? k + n : k >= n ? k - n : k;
  return body + (static_cast<unsigned>(j) < static_cast<unsigned>(n)
                     ? j
                     : wrap(k, n));
}

template <int kPlanes>
__device__ __forceinline__ const float* sample_src(
    const LaneHalo<float, kPlanes>& h, int p, const float* body,
    long long row, int k, int n) {
  if (static_cast<unsigned>(k) < static_cast<unsigned>(n)) return body + k;
  if (k < 0) return k >= -h.lp ? h.left[p] + row * h.lp + k + h.lp : nullptr;
  return k - n < h.rp ? h.right[p] + row * h.rp + k - n : nullptr;
}

// Floats from the 16-byte boundary below sample `start` of the row at body
// to it: slot v of the window's buffer holds sample start - shift + v, so
// slots 4q .. 4q + 3 are one aligned 16-byte copy.
__device__ __forceinline__ int slot_shift(const float* body, int start) {
  return static_cast<int>(((reinterpret_cast<uintptr_t>(body) >> 2) + start) &
                          3);
}

// Issue the copies of slots 4q .. 4q + 3 of a window into dst: slot 4q
// holds sample `first` + 4q and window index 4q - shift; zero from window
// index ext on. One 16-byte copy where the four samples are the row's own
// and inside the extent, else one 4-byte copy per slot from where its
// sample lies (zero past both halos).
template <class Lanes>
__device__ __forceinline__ void copy_quad(float* dst, const float* body,
                                          long long row, int p, int first,
                                          int shift, int q, int ext, int n,
                                          const Lanes& lanes) {
  const int k0 = first + 4 * q, u0 = 4 * q - shift;
  if (k0 >= 0 && k0 <= n - 4 && u0 + 3 < ext) {
    mma::cp_async16_ca(dst, body + k0);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float* s =
        u0 + e < ext ? sample_src(lanes, p, body, row, k0 + e, n) : nullptr;
    if (s != nullptr)
      mma::cp_async4(dst + e, s);
    else
      dst[e] = 0.f;
  }
}

// Shared memory of a block: the taps, the item of each buffer, then kRing
// buffers of `buf` floats.
template <int kTapFloats>
struct Ring {
  static constexpr int kItemFloats =
      (kRing * sizeof(Item) / sizeof(float) + 3) / 4 * 4;
  float* taps;
  Item* items;
  float* first;
  int buf;
  __device__ explicit Ring(int buf) : taps(dynamic_smem<float>()), buf(buf) {
    items = reinterpret_cast<Item*>(taps + kTapFloats);
    first = taps + kTapFloats + kItemFloats;
  }
  // buffer i (of kRing) and its item
  __device__ float* at(int i) const { return first + i * buf; }
  static size_t bytes(int buf) {
    return sizeof(float) *
           (kTapFloats + kItemFloats + static_cast<size_t>(kRing) * buf);
  }
};

// A block's pipeline over its items: each is fetched kRing - 1 items
// before it is computed, into the next buffer of the ring, its Item kept
// beside the buffer; one commit group per item (empty past the block's
// last), one __syncthreads per item.
template <class R>
class Pipe {
 public:
  __device__ Pipe(const Lines& ln, const R& ring)
      : ln_(ln),
        ring_(ring),
        fetch_(ln),
        count_(ln.per_block + (static_cast<int>(blockIdx.x) < ln.extra)) {}
  // Issue the first kRing - 1 items; the caller synchronises.
  template <class Issue>
  __device__ __forceinline__ void start(Issue issue) {
    for (int j = 0; j < kRing - 1; ++j) fill(j, j, issue);
  }
  // Each item in turn: wait for its buffer, refill the one before it (every
  // warp is done with it), compute(buffer, item).
  template <class Issue, class Compute>
  __device__ __forceinline__ void run(Issue issue, Compute compute) {
    for (int j = 0, i = 0; j < count_; ++j, i = i + 1 == kRing ? 0 : i + 1) {
      mma::cp_async_wait<kRing - 2>();
      __syncthreads();
      const Item it = ring_.items[i];
      fill(j + kRing - 1, i == 0 ? kRing - 1 : i - 1, issue);
      compute(ring_.at(i), it);
    }
  }

 private:
  // Item j of the block into buffer i.
  template <class Issue>
  __device__ __forceinline__ void fill(int j, int i, Issue issue) {
    if (j < count_) {
      const Item it = fetch_.item(ln_);
      if (threadIdx.x == 0) ring_.items[i] = it;
      issue(ring_.at(i), it);
      fetch_.next(ln_);
    }
    mma::cp_async_commit();
  }
  const Lines& ln_;
  const R& ring_;
  Walk fetch_;
  int count_;
};

// The rows of the warp's tile (chunks t0 + g and t0 + g + 8, t0 = 16
// warp): line and chunk of the line, decoded once per block.
struct TileRows {
  int t0, g, line[2], chunk[2];
  __device__ explicit TileRows(const Lines& ln)
      : t0(16 * (threadIdx.x >> 5)), g(mma::lane_id() >> 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = t0 + g + 8 * r;
      line[r] = ln.lpb == 1 ? 0 : q / ln.cpl;
      chunk[r] = q - line[r] * ln.cpl;
    }
  }
};

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

// K7a's window geometry: chunk m reads samples 16 m + k, k < kSpan, at slot
// 16 m + k + shift; slots are stored with kPad floats after every 16 (TF32
// fragments read 4 consecutive k per row: rows 20 floats apart hit
// distinct banks; bf16 fragments read 8: rows 24 apart meet each bank
// twice, the least for 64 words); a line holds quads(cpl) quads of slots,
// the window shifted by up to 3.
template <class P, int kSteps>
struct AnaGeom {
  static constexpr int kSpan = kSteps * P::kK;
  static constexpr int kPad = P::kK == 8 ? 4 : 8;
  // 3 blocks per SM promised to ptxas (80 registers) where, left to itself,
  // it fits 64 and spills (bf16, 4 k-steps); 0: no promise (a promise of 1
  // lets it spend up to 255 and costs the others a resident block)
  static constexpr int kMinBlocks = P::kK == 16 && kSteps == 4 ? 3 : 0;
  using R = Ring<2 * kMaxTaps>;
  __host__ __device__ static int window(int cpl) {
    return 16 * (cpl - 1) + kSpan;
  }
  __host__ __device__ static int quads(int cpl) { return window(cpl) / 4 + 1; }
  __host__ __device__ static int phys(int v) { return v + kPad * (v >> 4); }
  static int ldl(int cpl) { return phys(4 * quads(cpl) - 1) + 1; }
  static size_t smem(const Lines& ln) { return R::bytes(ln.lpb * ln.ldl); }
};

// Issue the cp.async copies of an item's analysis windows into buf.
template <class G, class Lanes>
__device__ __forceinline__ void issue_ana(float* buf, const Item& it,
                                          const Lines& ln, const float* x,
                                          int lpad, int hlen,
                                          const QuadWalk& qw,
                                          const Lanes& lanes) {
  // window index u of line l is sample 2 o0 - lpad + u of its row (K29e:
  // of the extended axis), zero from 2 cnt + hlen - 2 on
  const int start = 2 * it.o0 - lpad, ext = 2 * it.cnt + hlen - 2;
  qw.each(ln, it.lines, [&](int l, int q) {
    const long long row = it.r0 + l;
    const float* body = x + row * ln.n;
    const int shift = slot_shift(body, start);
    copy_quad(buf + l * ln.ldl + G::phys(4 * q), body, row, 0, start - shift,
              shift, q, ext, ln.n, lanes);
  });
}

// K7a's level. Lanes: Wrapped (K7a), or the LaneHalo<float, 1> of the
// rows x (K29e).
template <class P, int kSteps, class Lanes>
__device__ __forceinline__ void ana_level(const float* __restrict__ x,
                                          float* __restrict__ lo,
                                          float* __restrict__ hi,
                                          const Lines& ln, const Taps& taps,
                                          int hlen, const Lanes& lanes) {
  using G = AnaGeom<P, kSteps>;
  const typename G::R ring(ln.lpb * ln.ldl);
  float* f_lo = ring.taps;
  float* f_hi = f_lo + kMaxTaps;  // taps in window order
  const int lpad = analysis_lpad(hlen);
  const QuadWalk qw(ln);
  Pipe<typename G::R> pipe(ln, ring);
  const auto issue = [&](float* buf, const Item& it) {
    issue_ana<G>(buf, it, ln, x, lpad, hlen, qw, lanes);
  };
  pipe.start(issue);
  load_reversed_taps(taps, hlen, f_lo, f_hi);
  __syncthreads();

  typename P::B b_lo[kSteps], b_hi[kSteps];
  mma::band_fragments<P>(
      b_lo, [&](int k, int n) { return band(f_lo, k - 2 * n, hlen); });
  mma::band_fragments<P>(
      b_hi, [&](int k, int n) { return band(f_hi, k - 2 * n, hlen); });
  const TileRows tr(ln);
  const bool vec = ((reinterpret_cast<uintptr_t>(lo) |
                     reinterpret_cast<uintptr_t>(hi)) & 7) == 0;

  pipe.run(issue, [&](const float* cur, const Item& it) {
    const int chunks = it.chunks(ln.cpl);
    if (tr.t0 >= chunks) return;
    const int start = 2 * it.o0 - lpad;
    int base[2], lim[2], shift[2];
    long long out[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = tr.t0 + tr.g + 8 * r < chunks;
      const int line = tr.line[r], chunk = tr.chunk[r];
      const long long row = it.r0 + line;
      shift[r] = ok ? slot_shift(x + row * ln.n, start) : 0;
      base[r] = ok ? line * ln.ldl + (16 + G::kPad) * chunk : 0;
      lim[r] = ok ? it.cnt - 8 * chunk : 0;
      out[r] = ok ? row * ln.outs + it.o0 + 8 * chunk : 0;
    }
    float clo[4] = {0.f, 0.f, 0.f, 0.f}, chi[4] = {0.f, 0.f, 0.f, 0.f};
    mma::band_product<P>(
        clo, chi,
        [&](int k, int m) {
          const int r = m < 8 ? 0 : 1, v = k + shift[r];
          return cur[base[r] + v + G::kPad * (v >> 4)];
        },
        b_lo, b_hi);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      store_pair(lo, out[r], lim[r], vec, clo[2 * r], clo[2 * r + 1]);
      store_pair(hi, out[r], lim[r], vec, chi[2 * r], chi[2 * r + 1]);
    }
  });
}

template <class P, int kSteps, class Lanes>
__global__ void __launch_bounds__(kThreads)
tc_dwt1d_kernel(const float* __restrict__ x, float* __restrict__ lo,
                float* __restrict__ hi, Lines ln, Taps taps, int hlen,
                Lanes lanes) {
  ana_level<P, kSteps>(x, lo, hi, ln, taps, hlen, lanes);
}

// The same with kMinBlocks blocks per SM promised (AnaGeom::kMinBlocks).
template <class P, int kSteps, class Lanes, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tc_dwt1d_kernel_bounded(const float* __restrict__ x, float* __restrict__ lo,
                        float* __restrict__ hi, Lines ln, Taps taps, int hlen,
                        Lanes lanes) {
  ana_level<P, kSteps>(x, lo, hi, ln, taps, hlen, lanes);
}

// K7b's geometry: chunk m (8 outputs, 4 coefficients) reads coefficients
// 4 m + k, k < kSpan, of each of the two windows, at slot 4 m + k + shift;
// rows 4 floats apart meet the banks as few times as a fragment allows, so
// no padding.
template <class P, int kSteps>
struct SynGeom {
  static constexpr int kSpan = kSteps * P::kK;
  // as AnaGeom::kMinBlocks: 2 for TF32 with 3 k-steps (at 80 registers
  // the Wrapped instance still spills), else 0
  static constexpr int kMinBlocks = P::kK == 8 && kSteps == 3 ? 2 : 0;
  using R = Ring<4 * kHalfTaps>;
  __host__ __device__ static int window(int cpl) {
    return 4 * (cpl - 1) + kSpan;
  }
  __host__ __device__ static int quads(int cpl) { return window(cpl) / 4 + 1; }
  static int ldl(int cpl) { return 4 * quads(cpl); }
  static size_t smem(const Lines& ln) {
    return R::bytes(2 * ln.lpb * ln.ldl);
  }
};

// Issue the cp.async copies of an item's two coefficient windows into buf
// (a's lines, then d's).
template <class G, class Lanes>
__device__ __forceinline__ void issue_syn(float* buf, const Item& it,
                                          const Lines& ln, const float* a,
                                          const float* d, const Polyphase& ph,
                                          const QuadWalk& qw,
                                          const Lanes& lanes) {
  // window index u of line l is coefficient o0 / 2 - c + u of its row
  // (K29f: of the extended axis), zero from cnt / 2 + h2 on
  const int start = it.o0 / 2 - ph.c, ext = it.cnt / 2 + ph.h2;
  float* buf_d = buf + ln.lpb * ln.ldl;
  qw.each(ln, it.lines, [&](int l, int q) {
    const long long row = it.r0 + l;
    const float* body_a = a + row * ln.n;
    const float* body_d = d + row * ln.n;
    const int sa = slot_shift(body_a, start), sd = slot_shift(body_d, start);
    copy_quad(buf + l * ln.ldl + 4 * q, body_a, row, 0, start - sa, sa, q,
              ext, ln.n, lanes);
    copy_quad(buf_d + l * ln.ldl + 4 * q, body_d, row, 1, start - sd, sd, q,
              ext, ln.n, lanes);
  });
}

// K7b's level. Lanes: Wrapped (K7b), or the LaneHalo<float, 2> of the
// rows a, d (K29f).
template <class P, int kSteps, class Lanes>
__device__ __forceinline__ void syn_level(const float* __restrict__ a,
                                          const float* __restrict__ d,
                                          float* __restrict__ out,
                                          const Lines& ln, const Taps& taps,
                                          int hlen, const Lanes& lanes) {
  using G = SynGeom<P, kSteps>;
  const typename G::R ring(2 * ln.lpb * ln.ldl);
  float* g_lo = ring.taps;
  float* g_hi = g_lo + 2 * kHalfTaps;  // [2][kHalfTaps] taps per parity
  const Polyphase ph(hlen);
  const QuadWalk qw(ln);
  Pipe<typename G::R> pipe(ln, ring);
  const auto issue = [&](float* buf, const Item& it) {
    issue_syn<G>(buf, it, ln, a, d, ph, qw, lanes);
  };
  pipe.start(issue);
  load_polyphase_taps(taps, hlen, g_lo, g_hi);
  __syncthreads();

  // Output n of a chunk: coefficient n / 2 of the chunk, phase n & 1, which
  // reads window sample n / 2 + delta + j with tap g_p[j].
  typename P::B b_lo[kSteps], b_hi[kSteps];
  mma::band_fragments<P>(b_lo, [&](int k, int n) {
    return band(g_lo + (n & 1) * kHalfTaps, k - (n >> 1) - ph.delta(n & 1),
                ph.h2);
  });
  mma::band_fragments<P>(b_hi, [&](int k, int n) {
    return band(g_hi + (n & 1) * kHalfTaps, k - (n >> 1) - ph.delta(n & 1),
                ph.h2);
  });
  const TileRows tr(ln);
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const int sd_off = ln.lpb * ln.ldl;

  pipe.run(issue, [&](const float* cur, const Item& it) {
    const int chunks = it.chunks(ln.cpl);
    if (tr.t0 >= chunks) return;
    const int start = it.o0 / 2 - ph.c;
    int base_a[2], base_d[2], lim[2];
    long long dst[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = tr.t0 + tr.g + 8 * r < chunks;
      const int line = tr.line[r], chunk = tr.chunk[r];
      const long long row = it.r0 + line;
      const int base = line * ln.ldl + 4 * chunk;
      base_a[r] = ok ? base + slot_shift(a + row * ln.n, start) : 0;
      base_d[r] =
          ok ? sd_off + base + slot_shift(d + row * ln.n, start) : sd_off;
      lim[r] = ok ? it.cnt - 8 * chunk : 0;
      dst[r] = ok ? row * ln.outs + it.o0 + 8 * chunk : 0;
    }
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma::band_product_pair<P>(
        c,
        [&](int k, int m) { return cur[(m < 8 ? base_a[0] : base_a[1]) + k]; },
        [&](int k, int m) { return cur[(m < 8 ? base_d[0] : base_d[1]) + k]; },
        b_lo, b_hi);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      store_pair(out, dst[r], lim[r], vec, c[2 * r], c[2 * r + 1]);
  });
}

template <class P, int kSteps, class Lanes>
__global__ void __launch_bounds__(kThreads)
tc_idwt1d_kernel(const float* __restrict__ a, const float* __restrict__ d,
                 float* __restrict__ out, Lines ln, Taps taps, int hlen,
                 Lanes lanes) {
  syn_level<P, kSteps>(a, d, out, ln, taps, hlen, lanes);
}

// The same with kMinBlocks blocks per SM promised (SynGeom::kMinBlocks).
template <class P, int kSteps, class Lanes, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tc_idwt1d_kernel_bounded(const float* __restrict__ a,
                         const float* __restrict__ d, float* __restrict__ out,
                         Lines ln, Taps taps, int hlen, Lanes lanes) {
  syn_level<P, kSteps>(a, d, out, ln, taps, hlen, lanes);
}

template <class Lanes>
using DwtKernel = void (*)(const float*, float*, float*, Lines, Taps, int,
                           Lanes);
template <class Lanes>
using IdwtKernel = void (*)(const float*, const float*, float*, Lines, Taps,
                            int, Lanes);

// A kernel instance, its per-line shared floats and its shared memory.
template <class Kernel>
struct Picked {
  Kernel kernel;
  int (*ldl)(int);
  int (*quads)(int);
  size_t (*smem)(const Lines&);
};

template <class P, int S, class Lanes>
Picked<DwtKernel<Lanes>> dwt_instance() {
  using G = AnaGeom<P, S>;
  DwtKernel<Lanes> kernel;
  if constexpr (G::kMinBlocks > 0)
    kernel = tc_dwt1d_kernel_bounded<P, S, Lanes, G::kMinBlocks>;
  else
    kernel = tc_dwt1d_kernel<P, S, Lanes>;
  return {kernel, G::ldl, G::quads, G::smem};
}

template <class P, int S, class Lanes>
Picked<IdwtKernel<Lanes>> idwt_instance() {
  using G = SynGeom<P, S>;
  IdwtKernel<Lanes> kernel;
  if constexpr (G::kMinBlocks > 0)
    kernel = tc_idwt1d_kernel_bounded<P, S, Lanes, G::kMinBlocks>;
  else
    kernel = tc_idwt1d_kernel<P, S, Lanes>;
  return {kernel, G::ldl, G::quads, G::smem};
}

// kSteps = ceil((14 + hlen) / kK): 3..7 (TF32), 2..4 (BF16) for hlen 4..40.
template <class Lanes>
Picked<DwtKernel<Lanes>> pick_dwt(bool bf16, int hlen) {
  if (bf16) {
    switch ((14 + hlen + 15) / 16) {
      case 2: return dwt_instance<mma::Bf16, 2, Lanes>();
      case 3: return dwt_instance<mma::Bf16, 3, Lanes>();
      case 4: return dwt_instance<mma::Bf16, 4, Lanes>();
    }
  } else {
    switch ((14 + hlen + 7) / 8) {
      case 3: return dwt_instance<mma::Tf32, 3, Lanes>();
      case 4: return dwt_instance<mma::Tf32, 4, Lanes>();
      case 5: return dwt_instance<mma::Tf32, 5, Lanes>();
      case 6: return dwt_instance<mma::Tf32, 6, Lanes>();
      case 7: return dwt_instance<mma::Tf32, 7, Lanes>();
    }
  }
  return {nullptr, nullptr, nullptr, nullptr};
}

// kSteps = ceil((hlen/2 + 4) / kK): 1..3 (TF32), 1..2 (BF16).
template <class Lanes>
Picked<IdwtKernel<Lanes>> pick_idwt(bool bf16, int hlen) {
  if (bf16) {
    switch ((hlen / 2 + 4 + 15) / 16) {
      case 1: return idwt_instance<mma::Bf16, 1, Lanes>();
      case 2: return idwt_instance<mma::Bf16, 2, Lanes>();
    }
  } else {
    switch ((hlen / 2 + 4 + 7) / 8) {
      case 1: return idwt_instance<mma::Tf32, 1, Lanes>();
      case 2: return idwt_instance<mma::Tf32, 2, Lanes>();
      case 3: return idwt_instance<mma::Tf32, 3, Lanes>();
    }
  }
  return {nullptr, nullptr, nullptr, nullptr};
}

// One level's launch: its lines, shared memory, resident blocks per SM and
// grid (the blocks the SMs hold at once, at most the items).
struct Launch {
  Lines ln;
  size_t smem;
  int per_sm;
  unsigned grid;
};

// Plan the lines and the grid, and opt the kernel into its shared memory.
template <class Kernel>
cudaError_t plan_launch(const Picked<Kernel>& inst, long long rows, int outs,
                        int n, int device, Launch* lc) {
  if (inst.kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  lc->ln = plan_lines(rows, outs, n);
  lc->ln.ldl = inst.ldl(lc->ln.cpl);
  lc->ln.nq = inst.quads(lc->ln.cpl);
  lc->ln.q_dl = kThreads / lc->ln.nq;
  lc->ln.q_dq = kThreads - lc->ln.q_dl * lc->ln.nq;
  lc->smem = inst.smem(lc->ln);
  err = cudaFuncSetAttribute(inst.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(lc->smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &lc->per_sm, inst.kernel, kThreads, lc->smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (lc->per_sm < 1) return cudaErrorInvalidConfiguration;
  lc->grid = static_cast<unsigned>(std::min<long long>(
      static_cast<long long>(lc->per_sm) * sms, lc->ln.items));
  lc->ln.step_a = lc->grid / lc->ln.per_row;
  lc->ln.step_seg = static_cast<int>(lc->grid % lc->ln.per_row);
  lc->ln.per_block = static_cast<int>(lc->ln.items / lc->grid);
  lc->ln.extra = static_cast<int>(lc->ln.items % lc->grid);
  return cudaSuccess;
}

bool dwt_args_ok(int rows, int n, int hlen) {
  return hlen >= 4 && hlen <= kMaxTaps && hlen % 2 == 0 && rows >= 1 &&
         n >= 2 && n % 2 == 0 && n <= 0x3fffffff;
}

bool idwt_args_ok(int rows, int len, int hlen) {
  return hlen >= 4 && hlen <= kMaxTaps && hlen % 2 == 0 && rows >= 1 &&
         len >= 1 && len <= 0x1fffffff;
}

// K7a / K29e: lo, hi of (rows, n/2) from x of (rows, n), n even.
template <class Lanes>
int launch_dwt(const float* x, float* lo, float* hi, int rows, int n,
               const float* dec_lo, const float* dec_hi, int hlen, int bf16,
               int device, void* stream, Lanes lanes) {
  if (!dwt_args_ok(rows, n, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Lanes::kHalo) {
    if (!analysis_halos_ok(hlen, lanes.lp, lanes.rp))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto inst = pick_dwt<Lanes>(bf16 != 0, hlen);
  Launch lc;
  const cudaError_t err = plan_launch(inst, rows, n / 2, n, device, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  inst.kernel<<<lc.grid, kThreads, lc.smem,
                static_cast<cudaStream_t>(stream)>>>(
      x, lo, hi, lc.ln, make_taps(dec_lo, dec_hi, hlen), hlen, lanes);
  return static_cast<int>(cudaGetLastError());
}

// K7b / K29f: out of (rows, 2 len) from lo, hi of (rows, len).
template <class Lanes>
int launch_idwt(const float* a, const float* d, float* out, int rows,
                int len, const float* rec_lo, const float* rec_hi, int hlen,
                int bf16, int device, void* stream, Lanes lanes) {
  if (!idwt_args_ok(rows, len, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Lanes::kHalo) {
    if (!synthesis_halos_ok(hlen, lanes.lp, lanes.rp))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto inst = pick_idwt<Lanes>(bf16 != 0, hlen);
  Launch lc;
  const cudaError_t err = plan_launch(inst, rows, 2 * len, len, device, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  inst.kernel<<<lc.grid, kThreads, lc.smem,
                static_cast<cudaStream_t>(stream)>>>(
      a, d, out, lc.ln, make_taps(rec_lo, rec_hi, hlen), hlen, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pypwt

// All return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. The filters are host arrays of hlen floats; bf16 is
// 1 for the "bf16" precision, 0 for "highest" (3xTF32).
// K7a: lo, hi of (rows, n/2) from x of (rows, n), n even.
extern "C" int pypwt_tc_dwt1d(const float* x, float* lo, float* hi, int rows,
                              int n, const float* dec_lo, const float* dec_hi,
                              int hlen, int bf16, int device, void* stream) {
  return pypwt::launch_dwt(x, lo, hi, rows, n, dec_lo, dec_hi, hlen, bf16,
                           device, stream, pypwt::Wrapped{});
}

// K7b: out of (rows, 2 len) from lo, hi of (rows, len).
extern "C" int pypwt_tc_idwt1d(const float* a, const float* d, float* out,
                               int rows, int len, const float* rec_lo,
                               const float* rec_hi, int hlen, int bf16,
                               int device, void* stream) {
  return pypwt::launch_idwt(a, d, out, rows, len, rec_lo, rec_hi, hlen, bf16,
                            device, stream, pypwt::Wrapped{});
}

// K29e: K7a's level of rows x of (rows, n), their samples before and after
// from left (rows, lp) and right (rows, rp), lp and rp the analysis pads.
extern "C" int pypwt_tc_ana_lanes(const float* x, const float* left,
                                  const float* right, float* lo, float* hi,
                                  int rows, int n, int lp, int rp,
                                  const float* dec_lo, const float* dec_hi,
                                  int hlen, int bf16, int device,
                                  void* stream) {
  const float* halos[2] = {left, right};
  return pypwt::launch_dwt(x, lo, hi, rows, n, dec_lo, dec_hi, hlen, bf16,
                           device, stream,
                           pypwt::make_lane_halo<float, 1>(halos, lp, rp));
}

// K29f: K7b's level of the rows a, d of (rows, len), halos their four halo
// rows (a_left, a_right, d_left, d_right) of widths lp and rp, the synthesis
// pads; out of (rows, 2 len).
extern "C" int pypwt_tc_syn_lanes(const float* a, const float* d,
                                  const float* const* halos, float* out,
                                  int rows, int len, int lp, int rp,
                                  const float* rec_lo, const float* rec_hi,
                                  int hlen, int bf16, int device,
                                  void* stream) {
  return pypwt::launch_idwt(a, d, out, rows, len, rec_lo, rec_hi, hlen, bf16,
                            device, stream,
                            pypwt::make_lane_halo<float, 2>(halos, lp, rp));
}

// The launch that K7a (synthesis 0) or K7b (synthesis 1) would make on rows
// of n samples (K7b: n coefficients) with hlen taps (bf16 as above; halo 1
// for the LaneHalo instance of K29e / K29f): resident blocks per SM (the
// occupancy API), dynamic shared memory in bytes and the grid; a figure
// for reports.
extern "C" int pypwt_tc_dwt1d_occupancy(int synthesis, int rows, int n,
                                        int hlen, int bf16, int halo,
                                        int device, int* blocks, int* smem,
                                        int* grid) {
  using namespace pypwt;
  if (synthesis ? !idwt_args_ok(rows, n, hlen) : !dwt_args_ok(rows, n, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch lc;
  cudaError_t err;
  if (synthesis) {
    const long long outs = 2LL * n;
    err = halo ? plan_launch(pick_idwt<LaneHalo<float, 2>>(bf16 != 0, hlen),
                             rows, static_cast<int>(outs), n, device, &lc)
               : plan_launch(pick_idwt<Wrapped>(bf16 != 0, hlen), rows,
                             static_cast<int>(outs), n, device, &lc);
  } else {
    err = halo ? plan_launch(pick_dwt<LaneHalo<float, 1>>(bf16 != 0, hlen),
                             rows, n / 2, n, device, &lc)
               : plan_launch(pick_dwt<Wrapped>(bf16 != 0, hlen), rows, n / 2,
                             n, device, &lc);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = lc.per_sm;
  *smem = static_cast<int>(lc.smem);
  *grid = static_cast<int>(lc.grid);
  return 0;
}
