// The tile bodies of one separable 2D DWT level, analysis and synthesis,
// and the kernels that run them:
//   ana::tile       K24 (pyramid2d.cu) alone;
//   ana_pair::tile  K1, K26a and K19 (dwt2d.cu; K19 with its roll and
//                   threshold);
//   syn::tile       K25 (pyramid2d.cu) alone;
//   pair::tile      K2, K26b and K20 (idwt2d.cu; K20 with its unshift).
// K24/K25 run theirs for every level of a pyramid in one launch. The row
// source (common.cuh: Wrapped, or the Halo of a row shard; here, Roll) is a
// template parameter: K26a/K26b are K1/K2's bodies with the shard's edge
// rows read from its neighbours' exchanged rows, K19 is K1's with the plane
// read rolled. ana_pair:: and pair:: stage their windows through stage:: (a
// row table, then cp.async copies).
//
// A tile is one block's share of a level: it stages its input window into
// the block's dynamic shared memory, runs both separable passes there, with
// a barrier after the staging and after the first pass, and stores its
// outputs. An ana:: or syn:: block may run one tile after another (the
// pyramid kernels' grid-stride loops) with no barrier between them: a
// tile's staging writes only the window buffers, which the tile before
// stopped reading at its second barrier, and its first pass, which
// overwrites the pass buffers, waits at its own first barrier for every
// thread to leave the tile before. An ana_pair:: or pair:: block runs one
// tile.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace pypwt {

enum Thresh { kNone = 0, kSoft = 1, kHard = 2 };

// K19's row source and epilogue (a Rows of ana_pair::tile): the plane read
// rolled by (sr, sc) in [0, nr) x [0, nc), x_s[i, j] = x[(i - sr) mod nr,
// (j - sc) mod nc], before an odd axis's extension, and h, v and d
// thresholded by beta at the store (mode: Thresh).
struct Roll {
  static constexpr bool kHalo = false;
  int sr, sc, mode;
  float beta;
};

// A load from device memory: plain, or (kCoherent) cached in L2 only
// (ld.global.cg), for data that an earlier level of the same launch wrote
// (the pyramid kernels' intermediate approximations), which the
// non-coherent read-only path could serve stale.
template <bool kCoherent, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kCoherent) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// Two adjacent samples as one 8-byte (float) or 16-byte (double) store.
template <class T>
__device__ __forceinline__ void store_pair(T* o, T x, T y);
template <>
__device__ __forceinline__ void store_pair(float* o, float x, float y) {
  *reinterpret_cast<float2*>(o) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store_pair(double* o, double x, double y) {
  *reinterpret_cast<double2*>(o) = make_double2(x, y);
}

// -- staging shared by the tap-loop bodies pair:: and ana_pair:: -----------
//
// A block stages its windows in two steps. It resolves the source row of
// each window row once, into a table in shared memory (row_table: the
// plane's rows wrapped, or a shard's own rows and its halos' rows, null past
// both halos), so no copy tests a halo, wraps a row or divides. Then its
// warps copy whole window rows by cp.async, every copy of a thread in
// flight before one wait (copy_windows).
namespace stage {

// src[p wr + r], r < wr <= kThreads: plane p's row of window row r, the
// axis row first + r of n rows of nc samples: wrapped, or (kExt) extended
// by its last row where n is odd (wrap_ext); Rows: Wrapped, the Halo of a
// shard (null past both halos), or a Roll (that row of the rolled plane,
// the extension resolved before the roll). The caller synchronises.
template <class T, int kPlanes, bool kExt, class Rows>
__device__ __forceinline__ void row_table(const T* const (&planes)[kPlanes],
                                          const T** src, int first, int wr,
                                          int n, int nc, const Rows& rows) {
  const int tid = threadIdx.x;
  if (tid < wr) {
    const int r = first + tid;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      if constexpr (Rows::kHalo) {
        src[p * wr + tid] = rows.row(p, planes[p], r, n, nc);
      } else {
        int i = kExt ? wrap_ext(r, n) : wrap(r, n);
        if constexpr (std::is_same_v<Rows, Roll>) {
          i -= rows.sr;
          if (i < 0) i += n;
        }
        src[p * wr + tid] = planes[p] + static_cast<long long>(i) * nc;
      }
    }
  }
}

// Window row r of plane p (ldw samples apart, planes `plane` samples apart)
// from the row src[p wr + r]: copy q of nq is the axis sample j = first +
// step q reduced mod `period` (and, kExt, clamped to `last`, the sample
// that extends an odd axis; and, kRoll, then rolled by `roll` in [0, last
// + 1)), resolved once per copy. quads: 16-byte copies (step = 16 bytes of
// samples; first and period multiples of it, roll 0), sample copies from a
// row that is not 16-byte aligned; else one sample per copy (step 1). Zero
// for a missing row. Waits for its own copies; the caller synchronises.
template <class T, int kPlanes, bool kExt, bool kRoll = false>
__device__ __forceinline__ void copy_windows(const T* const* src, T* win,
                                             int wr, int ldw, int plane,
                                             int first, int nq, bool quads,
                                             int period, int last,
                                             int roll = 0) {
  constexpr int kVec = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int step = quads ? kVec : 1;
  for (int r = tid >> 5; r < wr; r += kThreads / 32) {
    const T* s[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) s[p] = src[p * wr + r];
    T* dst = win + r * ldw;
    for (int q = tid & 31; q < nq; q += 32) {
      int j = first + step * q;
      if (j >= period) j %= period;
      if (kExt) j = min(j, last);
      if constexpr (kRoll) {
        j -= roll;
        if (j < 0) j += last + 1;
      }
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        T* t = dst + p * plane + step * q;
        if (s[p] == nullptr) {
          for (int e = 0; e < step; ++e) t[e] = T(0);
        } else if (!quads) {
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
}

}  // namespace stage

// -- analysis: K24's level (map: dwt2d.cu) ---------------------------------
//
// A TR x TC = 32 x 32 output tile: its (2TR + hlen - 2) x (2TC + hlen - 2)
// window staged by a gather, one sample per thread and step, split into
// even and odd columns so that the decimating taps read consecutive words;
// the taps from shared memory; one output per thread and item in each
// pass. K24 instantiates it with kOdd and kShift false and kMode kNone: a
// shifted, extended or thresholded level runs ana_pair::tile (K19).
namespace ana {

constexpr int TR = 32;  // output rows per tile
constexpr int TC = 32;  // output columns per tile

__host__ __device__ inline int win_rows(int hlen) { return 2 * TR + hlen - 2; }
// window columns of one parity: (2TC + hlen - 2) / 2
__host__ __device__ inline int win_half_cols(int hlen) {
  return TC + hlen / 2 - 1;
}

template <class T>
inline size_t smem_bytes(int hlen) {
  const size_t wr = win_rows(hlen), wc2 = win_half_cols(hlen);
  return sizeof(T) * (2 * wr * wc2 + 2 * wr * TC + 2 * kMaxTaps);
}

// The reversed taps f_lo (f_hi = f_lo + kMaxTaps) behind the tile's
// buffers; the kernel loads them once (load_reversed_taps).
template <class T>
__device__ __forceinline__ T* taps(T* smem, int hlen) {
  const int wr = win_rows(hlen), wc2 = win_half_cols(hlen);
  return smem + 2 * wr * wc2 + 2 * wr * TC;
}

// Source index of window sample k of an axis of n samples, for a plane
// rolled by s in [0, n) (kShift) and extended by its last sample where n
// is odd (kOdd).
template <bool kOdd, bool kShift>
__device__ __forceinline__ int source(int k, int n, int s) {
  if (!kShift) return kOdd ? wrap_ext(k, n) : wrap(k, n);
  if (!kOdd) return wrap(k - s, n);
  const int i = wrap_ext(k, n) - s;
  return i < 0 ? i + n : i;
}

// The epilogue of K19: soft or hard thresholding of a detail coefficient.
template <int kMode>
__device__ __forceinline__ float threshold(float x, float beta) {
  if (kMode == kSoft) return copysignf(fmaxf(fabsf(x) - beta, 0.f), x);
  if (kMode == kHard) return fabsf(x) > beta ? x : 0.f;
  return x;
}

// ... with the mode a runtime value, kSoft or kHard.
__device__ __forceinline__ float threshold(float x, int mode, float beta) {
  return mode == kSoft ? threshold<kSoft>(x, beta) : threshold<kHard>(x, beta);
}

// The TR x TC output tile at (r0, c0) of the level of plane x (nr x nc)
// into planes a, h, v, d (ceil(nr/2) x ceil(nc/2)).
template <class T, bool kOdd, bool kShift, int kMode, bool kCoherent>
__device__ __forceinline__ void tile(const T* x, T* a, T* h, T* v, T* d,
                                     int nr, int nc, int hlen, int r0,
                                     int c0, int sr, int sc, float beta,
                                     T* smem) {
  const int wr = win_rows(hlen), wc2 = win_half_cols(hlen), wc = 2 * wc2;
  T* s_ev = smem;                  // [wr][wc2] even window columns
  T* s_od = s_ev + wr * wc2;       // [wr][wc2] odd window columns
  T* s_lo = s_od + wr * wc2;       // [wr][TC] last-axis low-pass
  T* s_hi = s_lo + wr * TC;        // [wr][TC] last-axis high-pass
  const T* f_lo = s_hi + wr * TC;  // reversed taps: f[j] = dec[hlen-1-j]
  const T* f_hi = f_lo + kMaxTaps;

  const int tid = threadIdx.x;
  const int lr = (nr + 1) >> 1, lc = (nc + 1) >> 1;
  const int lpad = analysis_lpad(hlen);
  const int row0 = 2 * r0 - lpad, col0 = 2 * c0 - lpad;
  for (int i = tid; i < wr * wc; i += kThreads) {
    const int r = i / wc, c = i - r * wc;
    const int col = source<kOdd, kShift>(col0 + c, nc, sc);
    const T val = load<kCoherent>(
        x + static_cast<long long>(source<kOdd, kShift>(row0 + r, nr, sr)) *
                nc +
        col);
    (c & 1 ? s_od : s_ev)[r * wc2 + (c >> 1)] = val;
  }
  __syncthreads();

  // Last axis: window column 2c + j feeds output column c.
  for (int i = tid; i < wr * TC; i += kThreads) {
    const int r = i / TC, c = i - r * TC;
    const T* ev = s_ev + r * wc2 + c;
    const T* od = s_od + r * wc2 + c;
    T lo = 0, hi = 0;
    for (int j = 0; j < hlen; j += 2) {
      const T e = ev[j >> 1], o = od[j >> 1];
      lo = fmadd(e, f_lo[j], lo);
      hi = fmadd(e, f_hi[j], hi);
      lo = fmadd(o, f_lo[j + 1], lo);
      hi = fmadd(o, f_hi[j + 1], hi);
    }
    s_lo[i] = lo;
    s_hi[i] = hi;
  }
  __syncthreads();

  // Axis -2: window row 2r + j feeds output row r.
  for (int i = tid; i < TR * TC; i += kThreads) {
    const int r = i / TC, c = i - r * TC;
    const int orow = r0 + r, ocol = c0 + c;
    if (orow >= lr || ocol >= lc) continue;
    const T* lo = s_lo + 2 * r * TC + c;
    const T* hi = s_hi + 2 * r * TC + c;
    T sa = 0, sh = 0, sv = 0, sd = 0;
    for (int j = 0; j < hlen; ++j) {
      const T l = lo[j * TC], g = hi[j * TC];
      sa = fmadd(l, f_lo[j], sa);
      sh = fmadd(l, f_hi[j], sh);
      sv = fmadd(g, f_lo[j], sv);
      sd = fmadd(g, f_hi[j], sd);
    }
    const long long o = static_cast<long long>(orow) * lc + ocol;
    a[o] = sa;
    h[o] = threshold<kMode>(sh, beta);
    v[o] = threshold<kMode>(sv, beta);
    d[o] = threshold<kMode>(sd, beta);
  }
}

}  // namespace ana

// -- analysis in pairs: K1's, K26a's and K19's level (map and design:
// dwt2d.cu) ------------------------------------------------------------------
//
// The map and the order of every sum are ana::tile's; only the work is
// grouped otherwise. A tile is kTR x kTC outputs, a shape the host picks by
// type, hlen and level size (dwt2d.cu's pick_ana). The block stages its
// input window (2 kTR + hlen - 2 rows) by stage::: the row table, then
// cp.async copies of whole rows, window column q holding axis column 2 c0 -
// lpad - kShift + q, where kShift = (-lpad) mod 16 bytes of samples puts the
// window's first column on a 16-byte boundary of the axis (2 c0 is a
// multiple of 16 bytes of samples, so every block of a launch has the same
// shift, a template parameter). The last-axis pass gives each thread a
// 16-byte aligned run of its window row, read as 16-byte words as the tap
// loop reaches them (consecutive threads on consecutive words: no bank
// conflict), from which it computes lo and hi of kP = 16 / (2 sizeof(T))
// adjacent output columns; the axis -2 pass gives each thread two adjacent
// columns of kR output rows, read as pairs, whose a, h, v, d it stores as
// one 8-byte (float) or 16-byte (double) pair where lc is even and the
// planes aligned. The taps are kernel parameters (Taps), so the unrolled
// tap loops take them as operands; a loop runs over an output's own taps
// only (j < hlen), so no zero product is summed.
//
// K19 (Rows: Roll) reads the plane rolled by (sr, sc). Window row r holds
// rolled row 2 r0 - lpad + r, resolved once in the row table (extended,
// then rolled). Window column q holds rolled column 2 c0 - lpad - kShift +
// q, that is source column (2 c0 - lpad - kShift + q - sc) mod nc on an
// even axis, so kShift = (-lpad - sc) mod 16 bytes of samples puts the
// window's first source column on a 16-byte boundary where nc is a
// multiple of 16 bytes of samples (16-byte copies); otherwise sample
// copies roll each column after the odd extension's clamp. h, v and d are
// thresholded at the store, by a runtime mode.
namespace ana_pair {

// f[j] = dec[hlen - 1 - j], the taps in window order (hlen even:
// make_analysis_taps).
template <class T>
struct Taps {
  T lo[kMaxTaps], hi[kMaxTaps];
};

// taps: the padded bank of make_analysis_taps, hlen its (even) length.
template <class T>
inline Taps<T> make_taps(const TapsT<T>& taps, int hlen) {
  Taps<T> f{};
  for (int j = 0; j < hlen; ++j) {
    f.lo[j] = taps.lo[hlen - 1 - j];
    f.hi[j] = taps.hi[hlen - 1 - j];
  }
  return f;
}

// The samples by which a window starts before its first output's first
// sample: (-lpad) mod 16 bytes of samples.
template <class T>
__host__ __device__ constexpr int shift_of(int hlen) {
  return (16 / static_cast<int>(sizeof(T)) -
          analysis_lpad(hlen) % (16 / static_cast<int>(sizeof(T)))) %
         (16 / static_cast<int>(sizeof(T)));
}

// K19's, for a plane rolled by sc in [0, nc) columns: (-lpad - sc) mod 16
// bytes of samples.
template <class T>
inline int shift_of(int hlen, int sc) {
  constexpr int kVec = 16 / sizeof(T);
  return (kVec - (analysis_lpad(hlen) + sc) % kVec) % kVec;
}

// The staged extent of a tile of tr x tc outputs: wr window rows of ldw
// samples (the shift and 2 tc + hlen - 2 columns, rounded up to 16 bytes);
// the shift shift_of<T>(hlen), or K19's.
template <class T>
struct Geometry {
  static constexpr int kVec = 16 / sizeof(T);
  int wr, ww, ldw, tc;
  __host__ __device__ Geometry(int tr, int tc, int hlen)
      : Geometry(tr, tc, hlen, shift_of<T>(hlen)) {}
  __host__ __device__ Geometry(int tr, int tc, int hlen, int shift)
      : wr(2 * tr + hlen - 2),
        ww(shift + 2 * tc + hlen - 2),
        ldw((ww + kVec - 1) / kVec * kVec),
        tc(tc) {}
  // Dynamic shared memory: the window [wr][ldw], the last-axis pass's lo
  // and hi [wr][tc], and the row table (wr pointers).
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(T) * (wr * ldw + 2 * wr * tc) + sizeof(const T*) * wr;
  }
};

// 16 bytes of samples, and two samples, of shared memory.
template <class T>
struct Words;
template <>
struct Words<float> {
  using Run = float4;
  using Pair = float2;
  __device__ static void unpack(const float4& w, float* x) {
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  }
};
template <>
struct Words<double> {
  using Run = double2;
  using Pair = double2;
  __device__ static void unpack(const double2& w, double* x) {
    x[0] = w.x;
    x[1] = w.y;
  }
};

// The kTR x kTC output tile at (r0, c0) of the level of plane x (nr x nc)
// into planes a, h, v, d (ceil(nr/2) x ceil(nc/2)), odd axes extended by
// their last sample (wrap_ext: on an even axis, the plain wrap); kShift:
// shift_of<T>(hlen). Rows: Wrapped, the Halo<T, 1> of the shard x moved
// to this plane (K26a: nr even), or K19's Roll (float; kShift:
// shift_of<T>(hlen, sc)).
template <class T, int kTR, int kTC, int kShift, class Rows>
__device__ __forceinline__ void tile(const T* x, T* a, T* h, T* v, T* d,
                                     int nr, int nc, int hlen,
                                     const Taps<T>& f, int r0, int c0,
                                     T* smem, const Rows& rows) {
  using W = Words<T>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kP = kVec / 2;  // last-axis outputs per thread
  constexpr int kR = kTR * kTC >= 4 * kThreads ? 2 : 1;  // axis -2 rows
  static_assert(kTC % (2 * kP) == 0 && kTR % kR == 0, "tile shape");
  constexpr bool kRoll = std::is_same_v<Rows, Roll>;
  const Geometry<T> geo =
      kRoll ? Geometry<T>(kTR, kTC, hlen, kShift) : Geometry<T>(kTR, kTC, hlen);
  const int wr = geo.wr, ldw = geo.ldw;
  T* win = smem;                 // [wr][ldw] input window
  T* s_lo = win + wr * ldw;      // [wr][kTC] last-axis low-pass
  T* s_hi = s_lo + wr * kTC;     // [wr][kTC] last-axis high-pass
  const T** src = reinterpret_cast<const T**>(s_hi + wr * kTC);
  const int tid = threadIdx.x;
  const int lr = (nr + 1) >> 1, lc = (nc + 1) >> 1;
  const int lpad = analysis_lpad(hlen);

  // Window row r holds axis row 2 r0 - lpad + r.
  const T* const planes[1] = {x};
  stage::row_table<T, 1, true>(planes, src, 2 * r0 - lpad, wr, nr, nc,
                               rows);
  __syncthreads();
  // Window column q holds axis column 2 c0 - lpad - kShift + q, a 16-byte
  // boundary where nc is a multiple of 16 bytes of samples (16-byte copies).
  // K19: of the rolled plane; the roll moves the first column of 16-byte
  // copies, and sample copies roll each column after the extension.
  const int period = nc + (nc & 1);
  const bool quads = nc % kVec == 0;
  int first = wrap(2 * c0 - lpad - kShift, period), roll = 0;
  if constexpr (kRoll) {
    if (quads)
      first = wrap(first - rows.sc, period);
    else
      roll = rows.sc;
  }
  stage::copy_windows<T, 1, true, kRoll>(src, win, wr, ldw, 0, first,
                                         quads ? ldw / kVec : geo.ww, quads,
                                         period, nc - 1, roll);
  __syncthreads();

  // Last axis: output column kP u + p of window row r meets window columns
  // 2 (kP u + p) + kShift + j, that is sample 2p + kShift + j of the
  // thread's run, which starts at column kVec u; per output, j ascending.
  {
    constexpr int kU = kTC / kP;  // threads per window row
    constexpr int kRun = kMaxTaps + 2 * kVec;  // samples a run may hold
    for (int i = tid; i < wr * kU; i += kThreads) {
      const int r = i / kU, u = i - r * kU;
      const typename W::Run* run = reinterpret_cast<const typename W::Run*>(
          win + r * ldw + kVec * u);
      T xs[kRun];
      T lo[kP], hi[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) lo[p] = hi[p] = T(0);
#pragma unroll
      for (int j = 0; j < kMaxTaps; ++j) {
        if (j >= hlen) break;
        // the word holding the last sample tap j meets, read as it is
        // reached
        constexpr int kFirst = 2 * (kP - 1) + kShift;
        if (j == 0) {
#pragma unroll
          for (int q = 0; q <= kFirst / kVec; ++q)
            W::unpack(run[q], xs + q * kVec);
        } else if ((kFirst + j) % kVec == 0) {
          W::unpack(run[(kFirst + j) / kVec], xs + kFirst + j);
        }
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          lo[p] = fmadd(xs[2 * p + kShift + j], f.lo[j], lo[p]);
          hi[p] = fmadd(xs[2 * p + kShift + j], f.hi[j], hi[p]);
        }
      }
      T* ol = s_lo + r * kTC + kP * u;
      T* oh = s_hi + r * kTC + kP * u;
      if constexpr (kP == 2) {
        store_pair(ol, lo[0], lo[1]);
        store_pair(oh, hi[0], hi[1]);
      } else {
        *ol = lo[0];
        *oh = hi[0];
      }
    }
  }
  __syncthreads();

  // Axis -2: output row kR g + s of columns 2u, 2u + 1 meets pass-1 rows
  // 2 kR g + 2s + j; per output, j ascending: a and h from lo, v and d from
  // hi.
  const bool pairs =
      (lc & 1) == 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(h) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(d)) &
       (2 * sizeof(T) - 1)) == 0;
  constexpr int kG = kTC / 2;  // threads per output row group
  const int span = hlen + 2 * kR - 2;  // pass-1 rows a thread meets
  for (int i = tid; i < (kTR / kR) * kG; i += kThreads) {
    const int g = i / kG, u = i - g * kG;
    const T* lo = s_lo + 2 * kR * g * kTC + 2 * u;
    const T* hi = s_hi + 2 * kR * g * kTC + 2 * u;
    T sa[kR][2], sh[kR][2], sv[kR][2], sd[kR][2];
#pragma unroll
    for (int s = 0; s < kR; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c) sa[s][c] = sh[s][c] = sv[s][c] = sd[s][c] = 0;
#pragma unroll
    for (int k = 0; k < kMaxTaps + 2 * kR - 2; ++k) {
      if (k >= span) break;
      const typename W::Pair l =
          *reinterpret_cast<const typename W::Pair*>(lo + k * kTC);
      const typename W::Pair m =
          *reinterpret_cast<const typename W::Pair*>(hi + k * kTC);
      const T lx[2] = {l.x, l.y}, mx[2] = {m.x, m.y};
#pragma unroll
      for (int s = 0; s < kR; ++s) {
        const int j = k - 2 * s;
        if (j < 0 || j >= hlen) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sa[s][c] = fmadd(lx[c], f.lo[j], sa[s][c]);
          sh[s][c] = fmadd(lx[c], f.hi[j], sh[s][c]);
          sv[s][c] = fmadd(mx[c], f.lo[j], sv[s][c]);
          sd[s][c] = fmadd(mx[c], f.hi[j], sd[s][c]);
        }
      }
    }
    const int ocol = c0 + 2 * u;
    if (ocol >= lc) continue;
    if constexpr (kRoll) {  // K19's epilogue
      if (rows.mode != kNone) {
#pragma unroll
        for (int s = 0; s < kR; ++s)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            sh[s][c] = ana::threshold(sh[s][c], rows.mode, rows.beta);
            sv[s][c] = ana::threshold(sv[s][c], rows.mode, rows.beta);
            sd[s][c] = ana::threshold(sd[s][c], rows.mode, rows.beta);
          }
      }
    }
#pragma unroll
    for (int s = 0; s < kR; ++s) {
      const int orow = r0 + kR * g + s;
      if (orow >= lr) break;
      const long long o = static_cast<long long>(orow) * lc + ocol;
      if (pairs) {
        store_pair(a + o, sa[s][0], sa[s][1]);
        store_pair(h + o, sh[s][0], sh[s][1]);
        store_pair(v + o, sv[s][0], sv[s][1]);
        store_pair(d + o, sd[s][0], sd[s][1]);
      } else {
        a[o] = sa[s][0];
        h[o] = sh[s][0];
        v[o] = sv[s][0];
        d[o] = sd[s][0];
        if (ocol + 1 < lc) {
          a[o + 1] = sa[s][1];
          h[o + 1] = sh[s][1];
          v[o + 1] = sv[s][1];
          d[o + 1] = sd[s][1];
        }
      }
    }
  }
}

}  // namespace ana_pair

// -- synthesis: K25's level (map: idwt2d.cu) --------------------------------
namespace syn {

constexpr int TR = 32;  // coefficient rows per tile (2TR output rows)
constexpr int TC = 32;  // coefficient columns per tile (2TC output columns)

template <class T>
inline size_t smem_bytes(int hlen) {
  const size_t h2 = hlen / 2;
  const size_t wr = TR + h2, ww = TC + h2;
  return sizeof(T) * (4 * wr * ww + 2 * (2 * TR) * ww + 4 * kHalfTaps);
}

// The polyphase taps g_lo (g_hi = g_lo + 2 kHalfTaps) behind the tile's
// buffers; the kernel loads them once (load_polyphase_taps).
template <class T>
__device__ __forceinline__ T* taps(T* smem, int hlen) {
  const int h2 = hlen / 2, wr = TR + h2, ww = TC + h2;
  return smem + 4 * wr * ww + 2 * (2 * TR) * ww;
}

// The 2TR x 2TC output tile at (R0, C0) of the level of planes a, h, v, d
// (lr x lc) into plane out (nr x nc).
template <class T, bool kCoherent>
__device__ __forceinline__ void tile(const T* a, const T* h, const T* v,
                                     const T* d, T* out, int lr, int lc,
                                     int nr, int nc, int hlen, int R0,
                                     int C0, T* smem) {
  const Polyphase ph(hlen);
  const int h2 = ph.h2, c = ph.c;
  const int wr = TR + h2, ww = TC + h2;
  T* s_a = smem;               // [wr][ww] coefficient windows
  T* s_h = s_a + wr * ww;
  T* s_v = s_h + wr * ww;
  T* s_d = s_v + wr * ww;
  T* t1 = s_d + wr * ww;       // [2TR][ww] axis -2 synthesis of (a, h)
  T* t2 = t1 + 2 * TR * ww;    // ... of (v, d)
  const T* g_lo = t2 + 2 * TR * ww;  // [2][kHalfTaps] taps per parity
  const T* g_hi = g_lo + 2 * kHalfTaps;

  const int tid = threadIdx.x;
  const int m0 = R0 >> 1, n0 = C0 >> 1;  // first coefficient row, column

  // window origin: coefficient (m0 - c, n0 - c)
  for (int i = tid; i < wr * ww; i += kThreads) {
    const int r = i / ww, q = i - r * ww;
    const int col = wrap(n0 - c + q, lc);
    const long long o =
        static_cast<long long>(wrap(m0 - c + r, lr)) * lc + col;
    s_a[i] = load<kCoherent>(a + o);
    s_h[i] = load<kCoherent>(h + o);
    s_v[i] = load<kCoherent>(v + o);
    s_d[i] = load<kCoherent>(d + o);
  }
  __syncthreads();

  // Axis -2: y row 2(m0 + m) + p reads window rows m + delta_p + j.
  for (int i = tid; i < 2 * TR * ww; i += kThreads) {
    const int q = i / ww, w = i - q * ww;
    const int p = q & 1;
    const int base = ((q >> 1) + ph.delta(p)) * ww + w;
    const T* gl = g_lo + p * kHalfTaps;
    const T* gh = g_hi + p * kHalfTaps;
    T x1 = 0, x2 = 0;
    for (int j = 0; j < h2; ++j) {
      const int k = base + j * ww;
      x1 = fmadd(s_a[k], gl[j], x1);
      x1 = fmadd(s_h[k], gh[j], x1);
      x2 = fmadd(s_v[k], gl[j], x2);
      x2 = fmadd(s_d[k], gh[j], x2);
    }
    t1[i] = x1;
    t2[i] = x2;
  }
  __syncthreads();

  // Last axis: output column C0 + n = 2m + p reads window columns
  // m - n0 + delta_p + j.
  for (int i = tid; i < 4 * TR * TC; i += kThreads) {
    const int q = i / (2 * TC), n = i - q * (2 * TC);
    const int orow = R0 + q, ocol = C0 + n;
    if (orow >= nr || ocol >= nc) continue;
    const int p = n & 1;
    const int base = q * ww + (n >> 1) + ph.delta(p);
    const T* gl = g_lo + p * kHalfTaps;
    const T* gh = g_hi + p * kHalfTaps;
    T s = 0;
    for (int j = 0; j < h2; ++j) {
      s = fmadd(t1[base + j], gl[j], s);
      s = fmadd(t2[base + j], gh[j], s);
    }
    out[static_cast<long long>(orow) * nc + ocol] = s;
  }
}

}  // namespace syn

// -- synthesis in pairs: K2's, K26b's and K20's level (map: idwt2d.cu) -----
//
// The map and the order of every sum are syn::tile's; only the work is
// grouped otherwise. A tile is kTR x kTC coefficients (2 kTR x 2 kTC
// outputs), a shape the host picks by type and level size (idwt2d.cu's
// pick_pair). The block resolves the source rows of its windows
// once, into a table in shared memory (the plane's rows wrapped, or a
// shard's rows and halos, null past them), then stages the four windows by
// cp.async, every copy of a thread in flight before one wait. Output 2m + p
// of an axis meets window samples m + k for delta(p) <= k < delta(p) + h2
// (Polyphase), so the two parities share all but one of their h2 + sigma
// samples: in the axis -2 pass a thread computes both parities of one
// coefficient row and window column, in the last-axis pass both of one
// coefficient column, stored as one 8-byte (float) or 16-byte (double)
// pair where the output rows allow. The taps are kernel parameters,
// indexed by k (Taps), so the unrolled tap loops take them as operands.
//
// K20 (kUnshift) stores scale * (y[(i + sr) mod nr, (j + sc) mod nc] [+
// acc[i, j]]) where y has period 2L along each shifted axis. Along an axis
// shifted by s = 2q + e, output 2m + p is y's 2(m + q) + p + e: y parity
// (p + e) & 1 of coefficient m + q + ((p + e) >> 1). So the window's origin
// moves by q coefficients, and an odd s (kOddR, kOddC) gives output parity
// 0 y's parity-1 taps on window samples [sigma, sigma + h2) and output
// parity 1 y's parity-0 taps on [1, h2 + 1): a span of h2 + 1, both
// parities of a thread still on shared samples and still one stored pair.
// The accumulator is read as a pair where the store is one, before the
// sums; each output adds it, then scales, as syn::tile did.
namespace pair {

// g[p][k]: the tap of output parity p that meets window sample m + k, zero
// where no term is summed: the polyphase tap g_p[k - delta(p)], or, along
// an axis shifted by an odd s, y's tap of parity 1 - p one sample on for p
// = 1 (make_taps).
template <class T>
struct Taps {
  T lo[2][kHalfTaps + 1];
  T hi[2][kHalfTaps + 1];
};

template <class T>
inline Taps<T> make_taps(const T* rec_lo, const T* rec_hi, int hlen,
                         bool odd = false) {
  const Polyphase ph(hlen);
  Taps<T> g{};
  for (int p = 0; p < 2; ++p) {
    const int e = p + (odd ? 1 : 0), yp = e & 1;  // y's parity
    const int k0 = ph.delta(yp) + (e >> 1);
    for (int j = 0; j < ph.h2; ++j) {
      g.lo[p][j + k0] = rec_lo[ph.tap(yp, j)];
      g.hi[p][j + k0] = rec_hi[ph.tap(yp, j)];
    }
  }
  return g;
}

// The window samples a coefficient of an axis meets: h2 + sigma, or h2 + 1
// along an axis shifted by an odd s.
__host__ __device__ inline int span_of(int hlen, bool odd) {
  return (hlen >> 1) + (odd ? 1 : Polyphase(hlen).sigma);
}

// Whether window sample k (< the axis's span) meets output parity 0 of an
// axis: k < h2, or sigma <= k < sigma + h2 shifted by an odd s.
template <bool kOdd>
__device__ __forceinline__ bool meets_even(int k, int h2, int sigma) {
  if constexpr (kOdd) {
    return k >= sigma && k < sigma + h2;
  } else {
    return k < h2;
  }
}

// ... output parity 1: k >= sigma, or k >= 1 shifted by an odd s.
template <bool kOdd>
__device__ __forceinline__ bool meets_odd(int k, int sigma) {
  if constexpr (kOdd) {
    return k >= 1;
  } else {
    return k >= sigma;
  }
}

// The staged extent of a tile of tr x tc coefficients: span_r and span_c
// window samples per coefficient along axis -2 and the last axis (span_of),
// wr rows and ww columns per window, rows ldw samples apart (a whole number
// of 16-byte copies, room for a window copied from the 16-byte boundary
// below its first sample).
template <class T>
struct Geometry {
  static constexpr int kVec = 16 / sizeof(T);  // samples per 16-byte copy
  int span_r, span_c, wr, ww, ldw, tr;
  __host__ __device__ Geometry(int tr, int tc, int hlen, bool odd_r = false,
                               bool odd_c = false)
      : span_r(span_of(hlen, odd_r)),
        span_c(span_of(hlen, odd_c)),
        wr(tr + span_r - 1),
        ww(tc + span_c - 1),
        ldw((ww + 2 * kVec - 2) / kVec * kVec),
        tr(tr) {}
  // Dynamic shared memory: the four windows [wr][ldw], the axis -2 pass's
  // t1 and t2 [2 tr][ldw], and the row table (4 wr pointers).
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(T) * (4 * wr * ldw + 2 * 2 * tr * ldw) +
           sizeof(const T*) * 4 * wr;
  }
};

// K20's unshift of a tile: the window's origin moved by qr coefficient
// rows and qc columns (sr >> 1, sc >> 1), and the store's accumulator (of
// out's shape, or null) and scale.
template <class T>
struct Unshift {
  int qr, qc;
  const T* acc;
  float scale;
};

// Two adjacent samples of one 8-byte (float) or 16-byte (double) load:
// K20's accumulator (float32 only), K29d's window reads (axis_rows.cu).
template <class T>
__device__ __forceinline__ void load_pair(const T* p, T& x, T& y);
template <>
__device__ __forceinline__ void load_pair(const float* p, float& x,
                                          float& y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x = v.x;
  y = v.y;
}
template <>
__device__ __forceinline__ void load_pair(const double* p, double& x,
                                          double& y) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x = v.x;
  y = v.y;
}

// The outputs of coefficient rows m0.. and columns n0.. of planes a, h, v,
// d (lr x lc) into plane out (nr x nc: 2lr x 2lc, or one less on an odd
// axis, cropped), with taps gr along axis -2 and gc along the last axis
// (the same Taps but in K20). Rows: Wrapped, or the Halo<T, 4> of the
// shard's planes moved to this plane (K26b: nr = 2 lr, nc = 2 lc).
// kUnshift: K20's store, with u's origin, accumulator and scale, and an odd
// shift along axis -2 (kOddR) or the last axis (kOddC).
template <class T, int kTR, int kTC, class Rows, bool kOddR = false,
          bool kOddC = false, bool kUnshift = false>
__device__ __forceinline__ void tile(const T* a, const T* h, const T* v,
                                     const T* d, T* out, int lr, int lc,
                                     int nr, int nc, int hlen,
                                     const Taps<T>& gr, const Taps<T>& gc,
                                     int m0, int n0, T* smem,
                                     const Rows& rows,
                                     const Unshift<T>& u = Unshift<T>{}) {
  constexpr int kVec = Geometry<T>::kVec;
  const Geometry<T> geo(kTR, kTC, hlen, kOddR, kOddC);
  const int h2 = hlen >> 1, sigma = Polyphase(hlen).sigma;
  const int span_r = geo.span_r, span_c = geo.span_c, c = h2 >> 1;
  const int wr = geo.wr, ww = geo.ww, ldw = geo.ldw, plane = wr * ldw;
  T* win = smem;                   // [4][wr][ldw] windows of a, h, v, d
  T* t1 = win + 4 * plane;         // [2 kTR][ldw] axis -2 synthesis of (a, h)
  T* t2 = t1 + 2 * kTR * ldw;      // ... of (v, d)
  const T** src = reinterpret_cast<const T**>(t2 + 2 * kTR * ldw);
  const int tid = threadIdx.x;
  // the window's first coefficient row and column, before the halo of c
  int wm0 = m0, wn0 = n0;
  if constexpr (kUnshift) {
    wm0 += u.qr;
    wn0 += u.qc;
  }

  // The row table: src[p wr + r] is plane p's row of window row r, the
  // coefficient row wm0 - c + r (wrapped; or a shard's row or halo row,
  // null past both halos).
  const T* const planes[4] = {a, h, v, d};
  stage::row_table<T, 4, false>(planes, src, wm0 - c, wr, lr, lc, rows);
  __syncthreads();

  // The windows: window column q holds coefficient column wn0 - c + q (mod
  // lc). Where lc is a multiple of 16 bytes of samples, 16-byte copies from
  // the window's first column rounded down to 16 bytes (read shifted by the
  // remainder); otherwise sample copies.
  const bool quads = lc % kVec == 0;
  int first = wrap(wn0 - c, lc), shift = 0;
  if (quads) {
    shift = first % kVec;
    first -= shift;
  }
  const int nq = quads ? (shift + ww + kVec - 1) / kVec : ww;
  stage::copy_windows<T, 4, false>(src, win, wr, ldw, plane, first, nq,
                                   quads, lc, lc - 1);
  __syncthreads();

  // Axis -2: output rows 2(m0 + m) + p of window column w; parity p meets
  // window rows m + k with tap gr[p][k]. Per parity and j: a then h into
  // t1, v then d into t2. The items run over whole rows of ldw columns, so
  // a warp reads consecutive words (no bank conflict where it crosses a
  // row); columns w >= ww are computed and never read.
  for (int i = tid; i < kTR * ldw; i += kThreads) {
    const int m = i / ldw, w = i - m * ldw;
    const T* s = win + i + shift;
    T x1e = 0, x1o = 0, x2e = 0, x2o = 0;
#pragma unroll
    for (int k = 0; k <= kHalfTaps; ++k) {
      if (k >= span_r) break;
      const T va = s[k * ldw], vh = s[plane + k * ldw];
      const T vv = s[2 * plane + k * ldw], vd = s[3 * plane + k * ldw];
      if (meets_even<kOddR>(k, h2, sigma)) {
        x1e = fmadd(va, gr.lo[0][k], x1e);
        x1e = fmadd(vh, gr.hi[0][k], x1e);
        x2e = fmadd(vv, gr.lo[0][k], x2e);
        x2e = fmadd(vd, gr.hi[0][k], x2e);
      }
      if (meets_odd<kOddR>(k, sigma)) {
        x1o = fmadd(va, gr.lo[1][k], x1o);
        x1o = fmadd(vh, gr.hi[1][k], x1o);
        x2o = fmadd(vv, gr.lo[1][k], x2o);
        x2o = fmadd(vd, gr.hi[1][k], x2o);
      }
    }
    T* o1 = t1 + 2 * m * ldw + w;
    T* o2 = t2 + 2 * m * ldw + w;
    o1[0] = x1e;
    o1[ldw] = x1o;
    o2[0] = x2e;
    o2[ldw] = x2o;
  }
  __syncthreads();

  // Last axis: output columns 2(n0 + m) + p of output row 2 m0 + q read t
  // columns m + k with tap gc[p][k], t1 then t2 per j; one pair store where
  // nc is even and the plane's rows start 2-sample aligned, else one
  // store per column within the crop. K20's accumulator: a pair load where
  // the store is one and the accumulator is aligned as out, else one load
  // per column within the crop.
  const bool pairs = (nc & 1) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(T) - 1)) == 0;
  bool acc_pairs = false;
  if constexpr (kUnshift)
    acc_pairs = pairs &&
        (reinterpret_cast<uintptr_t>(u.acc) & (2 * sizeof(T) - 1)) == 0;
  for (int i = tid; i < 2 * kTR * kTC; i += kThreads) {
    const int q = i / kTC, m = i - q * kTC;
    const int orow = 2 * m0 + q, ocol = 2 * (n0 + m);
    if (orow >= nr || ocol >= nc) continue;
    T ae = 0, ao = 0;
    if constexpr (kUnshift) {
      if (u.acc) {
        const T* pa = u.acc + static_cast<long long>(orow) * nc + ocol;
        if (acc_pairs) {
          load_pair(pa, ae, ao);
        } else {
          ae = pa[0];
          if (ocol + 1 < nc) ao = pa[1];
        }
      }
    }
    const T* r1 = t1 + q * ldw + m;
    const T* r2 = t2 + q * ldw + m;
    T se = 0, so = 0;
#pragma unroll
    for (int k = 0; k <= kHalfTaps; ++k) {
      if (k >= span_c) break;
      const T z1 = r1[k], z2 = r2[k];
      if (meets_even<kOddC>(k, h2, sigma)) {
        se = fmadd(z1, gc.lo[0][k], se);
        se = fmadd(z2, gc.hi[0][k], se);
      }
      if (meets_odd<kOddC>(k, sigma)) {
        so = fmadd(z1, gc.lo[1][k], so);
        so = fmadd(z2, gc.hi[1][k], so);
      }
    }
    if constexpr (kUnshift) {
      if (u.acc) {
        se += ae;
        so += ao;
      }
      se *= u.scale;
      so *= u.scale;
    }
    T* o = out + static_cast<long long>(orow) * nc + ocol;
    if (pairs) {
      store_pair(o, se, so);
    } else {
      o[0] = se;
      if (ocol + 1 < nc) o[1] = so;
    }
  }
}

}  // namespace pair
}  // namespace pypwt
