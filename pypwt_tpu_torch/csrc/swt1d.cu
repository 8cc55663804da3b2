// K10a / K10b: one periodized batched-1D stationary (a-trous) level and its
// inverse, float32 or float64.
//
// Replace the TPU kernels pypwt_tpu/ops/pallas_dwt.py::swt1d_level_fused
// (_build_swt1d, :2159) and ::iswt1d_level_fused (_build_iswt1d, :2213),
// and compute the maps of the folded long-signal kernels
// ::swt1d_long_fused (_build_swt1d_long, :2576) and ::iswt1d_long_fused
// (_build_iswt1d_long, :2647) on a (1, n) view.
//
// Maps (pypwt_tpu/core/conv.py:183-228), for rows of n samples, any
// hlen <= 40 (odd included), level l >= 1, dilation t = 2^(l-1):
//   K10a: lo[i] = sum_k dec_lo[k] * x[(i + (s - k) * t) mod n],
//         hi the same with dec_hi, s = hlen/2;
//   K10b: out[i] = sum_k rec_lo[k]/2 * a[j] + rec_hi[k]/2 * d[j],
//         j = (i + (s - k) * t) mod n, s = hlen/2 - 1 for even hlen
//         and hlen/2 for odd; the 1/2 is applied once (one axis).
// Tap k is applied at offset (s - k) * t, not k * t (the reference's
// order, separable.cu:409-448, tests/oracle.py:68-100). Every output sums
// from zero, k ascending, one fused multiply-add per tap and output (K10b:
// the a term, then the d term), so the outputs are bit-identical to those
// of the first version of these kernels.
//
// Bound: per sample K10a reads 4 bytes and writes 8, K10b reads 8 and
// writes 4 (12 bytes either way; 15.0 us for 2048 rows of 2048 at
// 3.35 TB/s), with 2 hlen FMAs: hlen/3 flop per byte, under the H100's
// float32 ridge of ~20 flop per byte for every hlen <= 40, so memory-bound.
//
// Design. Outputs i = c + t q of one residue class c read samples of that
// class only: the row is a matrix of positions q by classes c (element
// (q, c) is sample (c + t q) mod n), and a level is a stencil down its
// columns with unit step. A thread takes kR = 5 consecutive positions of
// one class and reads each of its kR + K - 1 window samples of each input
// once, adding it to every output it meets, with the tap as the FMA's
// operand from the kernel's parameter bank: K, the taps a thread unrolls,
// is a template parameter (20 instances a kernel and type: an even K runs
// hlen K and K - 1, an odd hlen with the window one row earlier and the
// first row's product skipped, so no product of a zero tap enters a sum).
// Threads of a warp take consecutive classes, then groups of kR positions:
// kR odd makes a warp's window reads, single samples at any shift, meet 32
// distinct banks at every C. Blocks are persistent (the grid is what the
// SMs hold at once, the occupancy API) and walk items blockIdx.x + j
// gridDim.x over a ring of three window slots: while the warps compute one
// item, the cp.async copies of the next two items' windows (a and d in
// K10b) are in flight. Zero is written past a window's extent.
//   Run mode, C = t (levels 1-6 of a row of 32 or more samples): the rows'
// groups of kR positions, row after row, are cut into items of 256 / C groups
// (fewer for short rows, as the shared memory allows), so every thread of an
// item works and the items are as many as the work needs (tiles cut within
// rows idled threads and left the blocks' last round ragged: the 2048 x 2048
// sinogram ran 16 % slower than a signal of the same size on an H100,
// PERF.md). An item holds one window segment a row it touches, copied in
// 16-byte cp.async from the 16-byte boundary below its first sample and read
// shifted by the remainder (each row and input its own shift: n odd or not a
// multiple of 4 gives each row another), with the samples that wrap around
// the row, and a window wider than the row, copied one at a time from where
// they lie. Its outputs are one run of memory: K10a's two go through a shared
// tile each (the same conflict-free pattern), placed at the run's 16-byte
// phase, and leave in 16-byte stores, one sample at a time only at the run's
// ends (stored from the registers they took twice as long); K10b's one is
// stored from the registers, one sample at a time, which measured faster than
// its tile and than pair stores.
//   Row mode (C = 32 of more classes, or a class a sample where the
// dilation passes n): an item is pt positions of 32 classes of one row (or
// of several rows short enough); each window row is a run of 32 classes,
// copied in 16 bytes where it is aligned and does not cross the row's end
// (the class wraps where t does not divide n), else sample by sample; a
// warp's stores are 32 consecutive classes, one sample each.
// Row offsets are 64-bit. A float64 window holds half the samples per
// byte; its 16-byte copies and stores carry two. The first version's
// "direct" form (no window) is gone: every shape it took stages here.

#include <array>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "common.cuh"
#include "mma.cuh"

namespace pypwt {
namespace {

constexpr int kR = 5;         // consecutive positions a thread (odd)
constexpr int kSlots = 3;     // window slots: two items in flight
constexpr int kMaxClasses = 32;
constexpr size_t kItemBytes = 96 * 1024;  // shared memory of short rows

template <class T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The level's geometry (host-planned). Run mode (C = t): the rows' groups
// of kR positions, row after row, G to an item. Row mode: tiles of pt
// positions of C classes of `packs` rows.
struct Plan {
  long long rows, items;
  int n;
  int t;      // matrix row stride: the dilation, or n where it reaches n
  int fm;     // the dilation mod n: the sample step between window rows
  int cls;    // residue classes: min(dilation, n)
  int C, log_c;  // classes an item, a power of two
  int npos;      // positions of class 0
  int back;      // window row r holds position q0 - back + r
  int run;       // 1: C = t, a window is one run of its row
  int full;      // 1: hlen = K; 0: hlen = K - 1 (the first row unused)
  int slot;      // samples a window slot holds of each input
  int tile;      // samples the output tile holds of each output (K10a)
  // run mode
  int gpr;       // groups a row
  int G;         // groups an item
  int fgroups;   // rows x gpr
  int ldwf;      // window samples of a whole row's segment
  // row mode
  int groups;    // class groups a row
  int tiles;     // position tiles a row
  int pt;        // positions a tile, a multiple of kR
  int gr;        // thread groups of kR positions a (row, class)
  int packs;     // rows an item
  int ldw;       // samples from one pack's window to the next
};

// Window samples of a run-mode segment of ng groups at K taps, with room
// for its 16-byte phase.
template <class T>
__host__ __device__ int seg_ldw(int C, int ng, int K) {
  return ((ng * kR + K - 1) * C + 2 * kVec<T> - 2) / kVec<T> * kVec<T>;
}

// A run-mode item: groups f0 .. f1 - 1, of rows r0 .. r0 + nseg - 1, a
// window segment each (segment s: groups first(s) .. end(s) - 1 of its row,
// at win_at(s); the first segment sized by its own groups, the others by a
// whole row's). Its outputs are one run of memory (rows lie end to end):
// elements e0 .. e0 + len - 1.
struct Run {
  int f0, f1, r0, g00, nseg;
  __device__ Run(const Plan& p, int it) {
    f0 = it * p.G;
    f1 = min(f0 + p.G, p.fgroups);
    r0 = f0 / p.gpr;
    g00 = f0 - r0 * p.gpr;
    nseg = (f1 - 1) / p.gpr - r0 + 1;
  }
  __device__ int first(int s) const { return s == 0 ? g00 : 0; }
  __device__ int end(const Plan& p, int s) const {
    return min(p.gpr, f1 - (r0 + s) * p.gpr);
  }
  template <class T, int K>
  __device__ int win_at(const Plan& p, int s) const {
    return s == 0 ? 0
                  : seg_ldw<T>(p.C, end(p, 0) - g00, K) + (s - 1) * p.ldwf;
  }
  // all segments' samples, and the segment of quad q
  template <class T, int K>
  __device__ int win_all(const Plan& p) const {
    return win_at<T, K>(p, nseg - 1) +
           seg_ldw<T>(p.C, end(p, nseg - 1) - first(nseg - 1), K);
  }
  __device__ long long e0(const Plan& p) const {
    return static_cast<long long>(r0) * p.n +
           static_cast<long long>(g00) * kR * p.t;
  }
  __device__ int len(const Plan& p) const {
    const int last = (f1 - 1) / p.gpr;
    const long long end = static_cast<long long>(last) * p.n +
                          min(static_cast<long long>(f1 - last * p.gpr) *
                                  kR * p.t,
                              static_cast<long long>(p.n));
    return static_cast<int>(end - e0(p));
  }
  template <class T, int K>
  __device__ int seg_of(const Plan& p, int q) const {
    const int q0 = seg_ldw<T>(p.C, end(p, 0) - g00, K) / kVec<T>;
    if (q < q0) return 0;
    if (nseg == 2) return 1;  // rows of an item or longer: no division
    return 1 + (q - q0) / (p.ldwf / kVec<T>);
  }
};

// A row-mode item: rows row0 .. row0 + packs - 1 (those before rows),
// classes c0 .., positions q0 .. q0 + cnt - 1.
struct Item {
  long long row0;
  int c0, q0, cnt, lines;
  __device__ Item(const Plan& p, int it) {
    const int rest = it / p.tiles;
    const int tile = it - rest * p.tiles;
    const int a = rest / p.groups;
    c0 = (rest - a * p.groups) * p.C;
    row0 = static_cast<long long>(a) * p.packs;
    q0 = tile * p.pt;
    cnt = min(p.pt, p.npos - q0);
    lines = static_cast<int>(min(static_cast<long long>(p.packs),
                                 p.rows - row0));
  }
};

// Sample k of a row of n, wrapped: one period off is the rule; wrap()
// divides only for a wrap wider than the row.
__device__ __forceinline__ int wrapped(long long k, int n) {
  if (k >= 0 && k < n) return static_cast<int>(k);
  if (k < 0 && k >= -static_cast<long long>(n)) return static_cast<int>(k + n);
  if (k >= n && k < 2LL * n) return static_cast<int>(k - n);
  const long long r = k % n;
  return static_cast<int>(r < 0 ? r + n : r);
}

// Samples from the 16-byte boundary below sample k of the row at body to
// it (a C = t window: slot v holds sample a0 - shift + v).
template <class T>
__device__ __forceinline__ int phase(const T* body, long long k) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(body) / sizeof(T) +
                           static_cast<uintptr_t>(k)) &
                          (kVec<T> - 1));
}

// 16 bytes into shared memory, cached in L1 too (it measured faster than
// through L2 only in K10b).
template <class T>
__device__ __forceinline__ void copy16_async(T* d, const T* s) {
  mma::cp_async16_ca(reinterpret_cast<float*>(d),
                     reinterpret_cast<const float*>(s));
}

// 16 bytes from shared memory to device memory.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// Issue the copies of samples a0 .. a0 + ext - 1 of the row at body (a C =
// t window, wrapped mod n) for quad q of the window at d0: slot v holds
// sample a0 - shift + v; zero from window index ext on.
template <class T>
__device__ __forceinline__ void copy_quad(T* d0, const T* body, long long a0,
                                          long long ext, int q, int n) {
  const int shift = phase(body, a0);
  const long long k0 = a0 - shift + kVec<T> * q;
  const long long u0 = kVec<T> * q - shift;
  T* d = d0 + kVec<T> * q;
  if (k0 >= 0 && k0 + kVec<T> <= n && u0 + kVec<T> <= ext) {
    copy16_async(d, body + k0);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec<T>; ++e) {
    if (u0 + e < ext)
      mma::cp_async_sample(d + e, body + wrapped(k0 + e, n));
    else
      d[e] = T(0);
  }
}

// Issue a run-mode item's copies into slot `win` (input j's at win + j
// slot): segment s's window starts at sample (first(s) kR - back) t of its
// row.
template <class T, int K, int kIn>
__device__ __forceinline__ void issue_run(const Plan& p, const Run& ru,
                                           const T* const* src, T* win) {
  const int nq = ru.win_all<T, K>(p) / kVec<T>;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int s = ru.nseg == 1 ? 0 : ru.seg_of<T, K>(p, q);
    const int at = ru.win_at<T, K>(p, s);
    const int g0 = ru.first(s), ng = ru.end(p, s) - g0;
    const long long a0 = static_cast<long long>(g0 * kR - p.back) * p.t;
    const long long ext = static_cast<long long>(ng * kR + K - 1) * p.t;
    const long long row = static_cast<long long>(ru.r0 + s) * p.n;
#pragma unroll
    for (int j = 0; j < kIn; ++j)
      copy_quad(win + j * p.slot + at, src[j] + row, a0, ext,
                q - at / kVec<T>, p.n);
  }
}

// Issue a row-mode item's copies into slot `win` (input j's windows at win
// + j slot, pack l's at + l ldw): window row r of pack l holds classes c0
// .. c0 + C - 1 at position q0 - back + r, samples (c0 + c + (q0 - back +
// r) fm) mod n; zero past cnt + K - 1 rows and past the classes.
template <class T, int K, int kIn>
__device__ __forceinline__ void issue_rows(const Plan& p, const Item& it,
                                           const T* const* src, T* win) {
  const int span = it.cnt + K - 1;
  const int rows = p.pt + K - 1;
  const int qpr = (p.C + kVec<T> - 1) / kVec<T>;  // copies a window row
  for (int i = threadIdx.x; i < it.lines * rows * qpr; i += kThreads) {
    const int lr = i / qpr, q = i - lr * qpr;
    const int l = lr / rows, r = lr - l * rows;
    long long b = (static_cast<long long>(it.q0 - p.back + r) * p.fm +
                   it.c0) % p.n;
    if (b < 0) b += p.n;
    const int c = kVec<T> * q;
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      const T* body = src[j] + (it.row0 + l) * p.n;
      T* d = win + j * p.slot + l * p.ldw + r * p.C + c;
      if (r < span && p.C % kVec<T> == 0 && b + c + kVec<T> <= p.n &&
          it.c0 + c + kVec<T> <= p.cls &&
          (reinterpret_cast<uintptr_t>(body + b + c) & 15) == 0) {
        copy16_async(d, body + b + c);
        continue;
      }
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e) {
        if (c + e >= p.C) break;
        if (r < span && it.c0 + c + e < p.cls)
          mma::cp_async_sample(d + e, body + wrapped(b + c + e, p.n));
        else
          d[e] = T(0);
      }
    }
  }
}

// Write a run-mode item's output tiles back (K10a): its outputs are one
// run of memory, tile slot shift + w holding element e0 + w at the run's
// 16-byte phase shift.
template <class T, int kOut>
__device__ __forceinline__ void write_back(const Plan& p, const Run& ru,
                                           T* const* dst, const T* tile) {
  const long long e0 = ru.e0(p);
  const int len = ru.len(p);
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    T* o = dst[j] + e0;
    const int shift = phase(o, 0);
    const int nq = (shift + len + kVec<T> - 1) / kVec<T>;
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const int w0 = kVec<T> * q - shift;
      const T* from = tile + j * p.tile + kVec<T> * q;
      if (w0 >= 0 && w0 + kVec<T> <= len) {
        copy16(o + w0, from);
        continue;
      }
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e)
        if (w0 + e >= 0 && w0 + e < len) o[w0 + e] = from[e];
    }
  }
}

// acc[j][m] = the kR outputs of this thread from its window samples w[j][v
// C], v < kR + K - 1: window row v meets output m through tap K - 1 - (v -
// m); rows in descending order give every output its taps in ascending
// order.
template <class T, int K, bool kSyn, int kIn, int kOut>
__device__ __forceinline__ void accumulate(const T* const (&w)[kIn], int C,
                                           bool full, const TapsT<T>& taps,
                                           T (&acc)[kOut][kR]) {
#pragma unroll
  for (int j = 0; j < kOut; ++j)
#pragma unroll
    for (int m = 0; m < kR; ++m) acc[j][m] = T(0);
#pragma unroll
  for (int v = kR + K - 2; v >= 0; --v) {
    T x[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j) x[j] = w[j][v * C];
#pragma unroll
    for (int m = 0; m < kR; ++m) {
      const int k = K - 1 - (v - m);
      if (k < 0 || k >= K) continue;
      if (k == K - 1 && !full) continue;
      if constexpr (kSyn) {
        acc[0][m] = fmadd(x[0], taps.lo[k], acc[0][m]);
        acc[0][m] = fmadd(x[kIn - 1], taps.hi[k], acc[0][m]);
      } else {
        acc[0][m] = fmadd(x[0], taps.lo[k], acc[0][m]);
        acc[kOut - 1][m] = fmadd(x[0], taps.hi[k], acc[kOut - 1][m]);
      }
    }
  }
}

// One level of K10a (kSyn false: in = {x}, out = {lo, hi}, taps = dec) or
// K10b (kSyn true: in = {a, d}, out = {out}, taps = rec / 2), K = the taps
// unrolled (hlen K, or K - 1 where p.full is 0).
template <class T, int K, bool kSyn>
__device__ __forceinline__ void level(const T* __restrict__ in0,
                                      const T* __restrict__ in1,
                                      T* __restrict__ out0,
                                      T* __restrict__ out1, const Plan& p,
                                      const TapsT<T>& taps) {
  constexpr int kIn = kSyn ? 2 : 1, kOut = kSyn ? 1 : 2;
  const T* src[kIn];
  T* dst[kOut];
  src[0] = in0;
  dst[0] = out0;
  if constexpr (kSyn) {
    src[kIn - 1] = in1;
  } else {
    dst[kOut - 1] = out1;
  }
  T* smem = dynamic_smem<T>();
  const int slot = kIn * p.slot;
  T* tile = smem + kSlots * slot;

  // this thread's class c and group (row mode: pack l, group g)
  const int c = threadIdx.x & (p.C - 1);
  const int grp = threadIdx.x >> p.log_c;
  const int l = p.run ? 0 : grp / p.gr;
  const int g = p.run ? grp : grp - l * p.gr;

  const auto issue = [&](long long it, T* win) {
    if (p.run)
      issue_run<T, K, kIn>(p, Run(p, static_cast<int>(it)), src, win);
    else
      issue_rows<T, K, kIn>(p, Item(p, static_cast<int>(it)), src, win);
  };
  // a ring of kSlots window slots: items j + 1 .. j + kSlots - 1 in
  // flight while item j computes, one commit group an item (empty past
  // the block's last)
  const long long step = gridDim.x;
  long long it = blockIdx.x;
#pragma unroll
  for (int j = 0; j < kSlots - 1; ++j) {
    if (it + j * step < p.items) issue(it + j * step, smem + j * slot);
    mma::cp_async_commit();
  }
  for (int s = 0; it < p.items;
       it += step, s = s + 1 == kSlots ? 0 : s + 1) {
    mma::cp_async_wait<kSlots - 2>();
    __syncthreads();  // this item's windows landed; the last one is done
    const long long ahead = it + (kSlots - 1) * step;
    if (ahead < p.items)
      issue(ahead, smem + (s == 0 ? kSlots - 1 : s - 1) * slot);
    mma::cp_async_commit();
    const T* win = smem + s * slot;
    T acc[kOut][kR];
    if (p.run) {
      // C = t: segment sg of this thread's row, positions q0 .. q0 + kR - 1
      // there
      const Run ru(p, static_cast<int>(it));
      if (g < ru.f1 - ru.f0) {
        const int f = ru.f0 + g;
        const int row = f / p.gpr;
        const int sg = row - ru.r0;
        const int q0 = (f - row * p.gpr) * kR;
        const long long a0 =
            static_cast<long long>(ru.first(sg) * kR - p.back) * p.t;
        const int at = (q0 - ru.first(sg) * kR) * p.C + c;
        const T* w[kIn];
#pragma unroll
        for (int j = 0; j < kIn; ++j)
          w[j] = win + j * p.slot + ru.win_at<T, K>(p, sg) +
                 phase(src[j] + static_cast<long long>(row) * p.n, a0) + at;
        accumulate<T, K, kSyn>(w, p.C, p.full, taps, acc);
        // output m is element row n + (q0 + m) t + c, where it exists
        const long long e = static_cast<long long>(row) * p.n + c;
        if constexpr (kSyn) {
          // one output: stored from here (it measured faster than a tile)
#pragma unroll
          for (int m = 0; m < kR; ++m) {
            const int i = (q0 + m) * p.t;
            if (q0 + m < p.npos && i + c < p.n) dst[0][e + i] = acc[0][m];
          }
        } else {
          // two: into the tiles, at the item run's 16-byte phase
          const long long e0 = ru.e0(p);
#pragma unroll
          for (int j = 0; j < kOut; ++j) {
            T* to = tile + j * p.tile + phase(dst[j], e0) + (e - e0);
#pragma unroll
            for (int m = 0; m < kR; ++m) {
              const int i = (q0 + m) * p.t;
              if (q0 + m < p.npos && i + c < p.n) to[i] = acc[j][m];
            }
          }
        }
      }
      if constexpr (!kSyn) {
        __syncthreads();  // the tiles complete; the next item's barrier
                          // guards their reuse
        write_back<T, kOut>(p, ru, dst, tile);
      }
      continue;
    }
    const Item cur(p, static_cast<int>(it));
    if (l < cur.lines) {
      const T* w[kIn];
#pragma unroll
      for (int j = 0; j < kIn; ++j)
        w[j] = win + j * p.slot + l * p.ldw + g * kR * p.C + c;
      accumulate<T, K, kSyn>(w, p.C, p.full, taps, acc);
      const int cl = cur.c0 + c;
#pragma unroll
      for (int m = 0; m < kR; ++m) {
        const int q = cur.q0 + g * kR + m;
        const long long i = cl + static_cast<long long>(q) * p.t;
        if (cl < p.cls && q - cur.q0 < cur.cnt && i < p.n) {
#pragma unroll
          for (int j = 0; j < kOut; ++j)
            dst[j][(cur.row0 + l) * p.n + i] = acc[j][m];
        }
      }
    }
  }
}

template <class T, int K, bool kSyn>
__global__ void __launch_bounds__(kThreads)
swt1d_kernel(const T* __restrict__ in0, const T* __restrict__ in1,
             T* __restrict__ out0, T* __restrict__ out1, Plan p,
             TapsT<T> taps) {
  level<T, K, kSyn>(in0, in1, out0, out1, p, taps);
}

// The float64 instances, promised 4 blocks per SM (64 registers): left to
// itself ptxas held K10a's K = 6 and 8 (db3, db4) at 48 registers with a
// 4-byte spill; their windows allow 4 blocks per SM at those banks anyway.
template <int K, bool kSyn>
__global__ void __launch_bounds__(kThreads, 4)
swt1d_kernel_f64(const double* __restrict__ in0,
                 const double* __restrict__ in1, double* __restrict__ out0,
                 double* __restrict__ out1, Plan p, TapsT<double> taps) {
  level<double, K, kSyn>(in0, in1, out0, out1, p, taps);
}

template <class T>
using Kernel = void (*)(const T*, const T*, T*, T*, Plan, TapsT<T>);

template <class T, int K, bool kSyn>
Kernel<T> instance() {
  if constexpr (std::is_same_v<T, double>) {
    return swt1d_kernel_f64<K, kSyn>;
  } else {
    return swt1d_kernel<T, K, kSyn>;
  }
}

template <class T, bool kSyn, int... kI>
std::array<Kernel<T>, sizeof...(kI)> instances(
    std::integer_sequence<int, kI...>) {
  return {instance<T, 2 * (kI + 1), kSyn>()...};
}

// The instance of K = hlen rounded up to even (2 .. 40).
template <class T, bool kSyn>
Kernel<T> pick(int hlen) {
  static const auto kInstances =
      instances<T, kSyn>(std::make_integer_sequence<int, kHalfTaps>{});
  return kInstances[(hlen + 1) / 2 - 1];
}

inline bool bad_args(long long rows, int n, int level, int hlen) {
  return hlen < 1 || hlen > kMaxTaps || n < 1 || n > 0x3fffffff ||
         level < 1 || rows < 1;
}

// The level's plan for rows of n samples, hlen taps at centre s, K10a
// (syn false: one input, two outputs through the tile in run mode) or K10b
// (two inputs, one output): the geometry and the dynamic shared memory (0
// where no item fits it).
template <class T>
Plan make_plan(long long rows, int n, int level, int hlen, int s, bool syn,
               size_t* smem) {
  constexpr int vec = kVec<T>;
  const int ins = syn ? 2 : 1, outs = syn ? 0 : 2;
  const int K = (hlen + 1) / 2 * 2;  // the instance's taps
  Plan p{};
  p.rows = rows;
  p.n = n;
  const long long dil = level <= 31 ? 1LL << (level - 1) : -1;
  const bool every = dil < 0 || dil >= n;
  p.cls = every ? n : static_cast<int>(dil);
  p.t = p.cls;
  p.fm = static_cast<int>(dilation_mod(level, n));
  p.run = dil > 0 && dil <= n && dil <= kMaxClasses;
  int c = 1;
  while (c < std::min(p.cls, kMaxClasses)) c *= 2;
  p.C = p.run ? p.t : c;
  while ((1 << p.log_c) < p.C) ++p.log_c;
  p.npos = every ? 1 : (n + p.t - 1) / p.t;
  p.full = hlen == K;
  p.back = K - 1 - s;
  *smem = 0;
  if (p.run) {
    p.gpr = (p.npos + kR - 1) / kR;
    if (rows * p.gpr > INT_MAX - kThreads) return p;
    p.fgroups = static_cast<int>(rows * p.gpr);
    p.ldwf = seg_ldw<T>(p.C, p.gpr, K);
    // G groups an item touch at most segs rows; halve G while its windows
    // and tiles pass kItemBytes (short rows)
    for (p.G = kThreads / p.C;; p.G /= 2) {
      const int segs = (p.G + p.gpr - 2) / p.gpr + 1;
      p.slot = (p.G * kR * p.C + segs * ((K - 1) * p.C + 2 * vec) + vec -
                1) / vec * vec;
      p.tile = (p.G * kR * p.C + 2 * vec - 2) / vec * vec;
      *smem = sizeof(T) * (kSlots * ins * static_cast<size_t>(p.slot) +
                           outs * static_cast<size_t>(p.tile));
      if (*smem <= kItemBytes || p.G == 1) break;
    }
    p.items = (p.fgroups + p.G - 1) / p.G;
    return p;
  }
  p.groups = (p.cls + p.C - 1) / p.C;
  const int kmax = kR * (kThreads / p.C);  // positions a tile at most
  p.tiles = (p.npos + kmax - 1) / kmax;
  p.pt = ((p.npos + p.tiles - 1) / p.tiles + kR - 1) / kR * kR;
  p.gr = p.pt / kR;
  p.ldw = ((p.pt + K - 1) * p.C + vec - 1) / vec * vec;
  const size_t per_pack = sizeof(T) * kSlots * ins * p.ldw;
  p.packs = 1;
  if (p.tiles == 1 && p.groups == 1) {
    const long long fit = std::max<long long>(
        1, std::min<long long>(kThreads / (p.gr * p.C),
                               static_cast<long long>(kItemBytes / per_pack)));
    p.packs = static_cast<int>(std::min(fit, rows));
  }
  p.slot = p.packs * p.ldw;
  p.items = (rows + p.packs - 1) / p.packs * p.groups * p.tiles;
  *smem = per_pack * p.packs;
  return p;
}

// Resident blocks per SM of an instance at smem bytes (the occupancy API),
// asked once per device, kernel and size; the kernel is first allowed the
// most dynamic shared memory a block may opt into.
template <class K>
cudaError_t resident(K kernel, int device, size_t smem, int* per_sm) {
  struct Seen {
    const void* kernel;
    int device;
    size_t smem;
    int per_sm;
  };
  static Seen seen[256];
  static int count = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < count; ++i) {
    if (seen[i].kernel == key && seen[i].device == device &&
        seen[i].smem == smem) {
      *per_sm = seen[i].per_sm;
      return cudaSuccess;
    }
  }
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (count < 256) seen[count++] = {key, device, smem, *per_sm};
  return cudaSuccess;
}

// One level's launch: plan, instance, shared memory, resident blocks per
// SM and grid (the blocks the SMs hold at once, at most the items).
template <class T>
struct Launch {
  Plan p;
  Kernel<T> kernel;
  size_t smem;
  int per_sm;
  unsigned grid;
};

template <class T, bool kSyn>
cudaError_t plan_launch(long long rows, int n, int level, int hlen,
                        int device, Launch<T>* lc) {
  if (bad_args(rows, n, level, hlen)) return cudaErrorInvalidValue;
  const int s = kSyn && hlen % 2 == 0 ? hlen / 2 - 1 : hlen / 2;
  lc->p = make_plan<T>(rows, n, level, hlen, s, kSyn, &lc->smem);
  if (lc->smem == 0 || lc->p.items > 0x7fffffff)
    return cudaErrorInvalidValue;
  lc->kernel = pick<T, kSyn>(hlen);
  int sms = 0;
  cudaError_t err = device_sms(device, &sms);
  if (err == cudaSuccess)
    err = resident(lc->kernel, device, lc->smem, &lc->per_sm);
  if (err != cudaSuccess) return err;
  lc->grid = static_cast<unsigned>(std::min<long long>(
      static_cast<long long>(lc->per_sm) * sms, lc->p.items));
  return cudaSuccess;
}

template <class T>
int launch_swt(const T* x, T* lo, T* hi, int rows, int n, int level,
               const T* dec_lo, const T* dec_hi, int hlen, int device,
               void* stream) {
  Launch<T> lc;
  const cudaError_t err =
      plan_launch<T, false>(rows, n, level, hlen, device, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  lc.kernel<<<lc.grid, kThreads, lc.smem,
              static_cast<cudaStream_t>(stream)>>>(
      x, nullptr, lo, hi, lc.p, make_taps(dec_lo, dec_hi, hlen));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_iswt(const T* a, const T* d, T* out, int rows, int n, int level,
                const T* rec_lo, const T* rec_hi, int hlen, int device,
                void* stream) {
  Launch<T> lc;
  const cudaError_t err =
      plan_launch<T, true>(rows, n, level, hlen, device, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  // rec / 2 is exact: the single 1/2 of the 1D inverse
  T lo2[kMaxTaps], hi2[kMaxTaps];
  for (int k = 0; k < hlen; ++k) {
    lo2[k] = T(0.5) * rec_lo[k];
    hi2[k] = T(0.5) * rec_hi[k];
  }
  lc.kernel<<<lc.grid, kThreads, lc.smem,
              static_cast<cudaStream_t>(stream)>>>(
      a, d, out, nullptr, lc.p, make_taps<T>(lo2, hi2, hlen));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int report(int synthesis, int rows, int n, int level, int hlen, int device,
           int* blocks, int* smem, int* grid) {
  Launch<T> lc;
  const cudaError_t err =
      synthesis ? plan_launch<T, true>(rows, n, level, hlen, device, &lc)
                : plan_launch<T, false>(rows, n, level, hlen, device, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = lc.per_sm;
  *smem = static_cast<int>(lc.smem);
  *grid = static_cast<int>(lc.grid);
  return 0;
}

}  // namespace
}  // namespace pypwt

// All return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. The filters are host arrays of hlen values of the
// data's type.
extern "C" int pypwt_swt1d(const float* x, float* lo, float* hi, int rows,
                           int n, int level, const float* dec_lo,
                           const float* dec_hi, int hlen, int device,
                           void* stream) {
  return pypwt::launch_swt(x, lo, hi, rows, n, level, dec_lo, dec_hi, hlen,
                           device, stream);
}

extern "C" int pypwt_swt1d_f64(const double* x, double* lo, double* hi,
                               int rows, int n, int level,
                               const double* dec_lo, const double* dec_hi,
                               int hlen, int device, void* stream) {
  return pypwt::launch_swt(x, lo, hi, rows, n, level, dec_lo, dec_hi, hlen,
                           device, stream);
}

extern "C" int pypwt_iswt1d(const float* a, const float* d, float* out,
                            int rows, int n, int level, const float* rec_lo,
                            const float* rec_hi, int hlen, int device,
                            void* stream) {
  return pypwt::launch_iswt(a, d, out, rows, n, level, rec_lo, rec_hi, hlen,
                            device, stream);
}

extern "C" int pypwt_iswt1d_f64(const double* a, const double* d,
                                double* out, int rows, int n, int level,
                                const double* rec_lo, const double* rec_hi,
                                int hlen, int device, void* stream) {
  return pypwt::launch_iswt(a, d, out, rows, n, level, rec_lo, rec_hi, hlen,
                            device, stream);
}

// The launch that K10a (synthesis 0) or K10b (synthesis 1) would make at
// `level` on rows of n samples with hlen taps, float64 where f64 is 1:
// resident blocks per SM (the occupancy API), dynamic shared memory in
// bytes and the grid; a figure for reports.
extern "C" int pypwt_swt1d_occupancy(int synthesis, int rows, int n,
                                     int level, int hlen, int f64,
                                     int device, int* blocks, int* smem,
                                     int* grid) {
  return f64 ? pypwt::report<double>(synthesis, rows, n, level, hlen, device,
                                     blocks, smem, grid)
             : pypwt::report<float>(synthesis, rows, n, level, hlen, device,
                                    blocks, smem, grid);
}
