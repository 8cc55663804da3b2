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
// w[u] = x[rho + t (q0 - back + u)], back = hlen - 1 - s. A block takes C
// consecutive classes (C = min(t, 32)) of one row and 8 cpl consecutive
// positions of each (1024 outputs in all; several whole short rows where a
// row has fewer), so that its reads and writes are runs of C consecutive
// samples (all of a segment where t <= 32): one line per class, with its
// own periodic halo, which at deep levels reaches across several segments
// and around the row. The block stages each line's window once (a thread
// keeps one class and walks its samples without a division per element;
// TF32 windows with 4 floats after every 8 samples, so that the 8
// chunks a fragment reads start in distinct banks) and zero past its
// extent, where the band's zero entries meet it. Warps take 16-chunk tiles
// (a chunk: 8 consecutive positions of one class) in turn; the products go
// to a shared output tile, which the block writes back class-fastest. The
// band's fragments are built once per thread, in registers. Blocks past a
// grid's 2^31 - 1 go in further launches; offsets are 64-bit.

#include "common.cuh"
#include "mma.cuh"

namespace pypwt {
namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 128;  // 8-output chunks per block
constexpr int kMaxClasses = 32;

using mma::band;

// The residue-class lines of one level: a block holds `packs` rows x C
// classes (group grp of the row's classes) x 8 cpl positions (tile of the
// class); line l = p C + c.
struct ClassLines {
  long long rows;
  int n;
  int cls;       // residue classes: the dilation, or n where it reaches n
  long long fm;  // the dilation mod n
  int back;      // hlen - 1 - s: window sample u holds position q0 - back + u
  int C;         // classes per block, a power of two
  int log_c;     // log2 C
  int groups;    // class groups per row
  int cpl;       // 8-position chunks per line
  int tiles;     // position tiles per class
  int packs;     // rows per block
  int ldl;       // shared floats per staged line
  int ldo;       // shared floats per output line
};

ClassLines plan_classes(long long rows, int n, int level, int hlen, int s) {
  ClassLines p{};
  p.rows = rows;
  p.n = n;
  const bool every = level > 31 || (1LL << (level - 1)) >= n;
  p.cls = every ? n : (1 << (level - 1));
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
  p.ldo = 8 * p.cpl + 1;  // odd: the class-fastest write-back is
                          // conflict-free
  return p;
}

// Each line's row offset, class and positions (0: no line), decoded once
// per block into shared memory.
struct LineInfo {
  long long* row;  // [lpb] row * n
  int* rho;        // [lpb] residue class
  int* cnt;        // [lpb] positions of the line
};

__host__ __device__ inline size_t line_info_bytes(int lpb) {
  return static_cast<size_t>(lpb) * (sizeof(long long) + 2 * sizeof(int));
}

__device__ __forceinline__ LineInfo line_info(void* smem, int lpb) {
  LineInfo li;
  li.row = static_cast<long long*>(smem);
  li.rho = reinterpret_cast<int*>(li.row + lpb);
  li.cnt = li.rho + lpb;
  return li;
}

// The block's first row, class and position.
struct BlockPos {
  long long row0;
  int rho0, q0;
  __device__ BlockPos(const ClassLines& p, long long b) {
    const long long per_rows = static_cast<long long>(p.groups) * p.tiles;
    const long long rb = b / per_rows;
    const int rest = static_cast<int>(b - rb * per_rows);
    const int grp = rest / p.tiles;
    row0 = rb * p.packs;
    rho0 = grp * p.C;
    q0 = (rest - grp * p.tiles) * 8 * p.cpl;
  }
};

__device__ __forceinline__ void decode_lines(const ClassLines& p, LineInfo li,
                                             const BlockPos& bp) {
  const int l = threadIdx.x;
  if (l >= p.C * p.packs) return;
  const int pk = l / p.C, c = l - pk * p.C;
  const long long row = bp.row0 + pk;
  const int rho = bp.rho0 + c;
  int cnt = 0;
  if (row < p.rows && rho < p.cls) {
    const int positions = (p.n - rho + p.cls - 1) / p.cls;
    cnt = max(0, min(8 * p.cpl, positions - bp.q0));
  }
  li.row[l] = row < p.rows ? row * p.n : 0;
  li.rho[l] = rho;
  li.cnt[l] = cnt;
}

// The window's geometry: chunk m reads class samples 8 m + k, k < kSpan;
// TF32 windows keep 4 floats after every 8 samples (rows 12 floats apart
// hit distinct banks), bf16 ones none (rows 8 apart meet each bank twice,
// the least for a fragment's 64 words).
template <class P, int kSteps, int kInputs, int kOutputs>
struct Geom {
  static constexpr int kSpan = kSteps * P::kK;
  static constexpr int kPad = P::kK == 8 ? 4 : 0;
  __host__ __device__ static int window(int cpl) {
    return 8 * (cpl - 1) + kSpan;
  }
  __host__ __device__ static int phys(int u) { return u + kPad * (u >> 3); }
  static int ldl(int cpl) { return phys(window(cpl) - 1) + 1; }
  static size_t smem(const ClassLines& p) {
    const int lpb = p.C * p.packs;
    return line_info_bytes(lpb) + sizeof(float) * 2 * kMaxTaps +
           sizeof(float) * lpb * (kInputs * p.ldl + kOutputs * p.ldo);
  }
};

// Thread tid takes class c = tid mod C of the block (C a power of two, so
// that it divides kThreads) and the rows r = tid / C + j kThreads / C of
// (pack, index) pairs, r = pk n + u, advanced with a carry: consecutive
// threads take consecutive classes, and no element costs a division.
// kBatch loads are in flight before their stores.
template <int kBatch, class Load, class Store>
__device__ __forceinline__ void walk_classes(const ClassLines& p, int n,
                                             Load load, Store store) {
  const int c = threadIdx.x & (p.C - 1), step = kThreads >> p.log_c;
  const int dp = step / n, du = step - dp * n;
  const int r = threadIdx.x >> p.log_c;
  int pk = r / n, u = r - pk * n;
  while (pk < p.packs) {
    decltype(load(0, 0)) v[kBatch];
    int ls[kBatch], us[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      ls[j] = pk < p.packs ? pk * p.C + c : -1;
      us[j] = u;
      if (ls[j] >= 0) v[j] = load(ls[j], u);
      pk += dp;
      u += du;
      if (u >= n) {
        u -= n;
        ++pk;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (ls[j] >= 0) store(ls[j], us[j], v[j]);
  }
}

// One window sample of each staged plane.
template <int kInputs>
struct Samples {
  float v[kInputs];
};

// Stage the windows of kInputs planes: window sample u of line l is
// x[(rho + cls q0 + (u - back) fm) mod n], zero from the extent
// cnt + hlen - 1 on.
template <int kInputs, class G>
__device__ __forceinline__ void stage(const float* const (&planes)[kInputs],
                                      float* s_in, const ClassLines& p,
                                      const LineInfo& li, const BlockPos& bp,
                                      int hlen) {
  const long long q0 = static_cast<long long>(p.cls) * bp.q0;
  const int lines = p.C * p.packs;
  walk_classes<8 / kInputs>(
      p, G::window(p.cpl),
      [&](int l, int u) {
        Samples<kInputs> v{};
        if (li.cnt[l] > 0 && u < li.cnt[l] + hlen - 1) {
          long long k = li.rho[l] + q0 + (u - p.back) * p.fm;
          if (static_cast<unsigned long long>(k) >=
              static_cast<unsigned long long>(p.n)) {
            k %= p.n;
            if (k < 0) k += p.n;
          }
#pragma unroll
          for (int j = 0; j < kInputs; ++j)
            v.v[j] = __ldg(planes[j] + li.row[l] + k);
        }
        return v;
      },
      [&](int l, int u, const Samples<kInputs>& v) {
        const int o = l * p.ldl + G::phys(u);
#pragma unroll
        for (int j = 0; j < kInputs; ++j) s_in[j * lines * p.ldl + o] = v.v[j];
      });
}

// Write kOutputs shared output tiles back, class-fastest: position q of
// line l goes to sample rho + cls (q0 + q) of its row.
template <int kOutputs>
__device__ __forceinline__ void write_back(float* const (&dst)[kOutputs],
                                           const float* s_out,
                                           const ClassLines& p,
                                           const LineInfo& li,
                                           const BlockPos& bp) {
  const int lpb = p.C * p.packs;
  walk_classes<4>(
      p, 8 * p.cpl,
      [&](int l, int q) {
        Samples<kOutputs> v;
#pragma unroll
        for (int j = 0; j < kOutputs; ++j)
          v.v[j] = s_out[(j * lpb + l) * p.ldo + q];
        return v;
      },
      [&](int l, int q, const Samples<kOutputs>& v) {
        if (q >= li.cnt[l]) return;
        const long long o = li.row[l] + li.rho[l] +
                            static_cast<long long>(p.cls) * (bp.q0 + q);
#pragma unroll
        for (int j = 0; j < kOutputs; ++j) dst[j][o] = v.v[j];
      });
}

// The base of chunk q's window and of its outputs, for the lane's two
// fragment rows.
template <class G>
struct TileRows {
  int in[2], out[2];
  __device__ TileRows(const ClassLines& p, int t0) {
    const int g = mma::lane_id() >> 2;
    const int chunks = p.C * p.packs * p.cpl;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = t0 + g + 8 * r;
      const int l = q / p.cpl, ch = q - l * p.cpl;
      const bool ok = q < chunks;
      in[r] = ok ? l * p.ldl + G::phys(8 * ch) : 0;
      out[r] = ok ? l * p.ldo + 8 * ch : -1;
    }
  }
};

template <class P, int kSteps>
__global__ void __launch_bounds__(kThreads)
tc_swt1d_kernel(const float* __restrict__ x, float* __restrict__ lo,
                float* __restrict__ hi, ClassLines p, Taps taps, int hlen,
                long long block0) {
  using G = Geom<P, kSteps, 1, 2>;
  const int lpb = p.C * p.packs;
  unsigned char* smem = dynamic_smem<unsigned char>();
  const LineInfo li = line_info(smem, lpb);
  float* f_lo = reinterpret_cast<float*>(smem + line_info_bytes(lpb));
  float* f_hi = f_lo + kMaxTaps;      // taps in window order
  float* s_w = f_hi + kMaxTaps;       // [lpb][ldl] class windows
  float* s_o = s_w + lpb * p.ldl;     // [2][lpb][ldo] lo, hi

  const BlockPos bp(p, block0 + blockIdx.x);
  decode_lines(p, li, bp);
  load_reversed_taps(taps, hlen, f_lo, f_hi);
  __syncthreads();
  const float* const in[1] = {x};
  stage<1, G>(in, s_w, p, li, bp, hlen);
  __syncthreads();

  typename P::B b_lo[kSteps], b_hi[kSteps];
  mma::band_fragments<P>(
      b_lo, [&](int k, int n) { return band(f_lo, k - n, hlen); });
  mma::band_fragments<P>(
      b_hi, [&](int k, int n) { return band(f_hi, k - n, hlen); });

  const int warp = threadIdx.x >> 5, col = 2 * (mma::lane_id() & 3);
  const int chunks = lpb * p.cpl;
  for (int t0 = 16 * warp; t0 < chunks; t0 += 16 * kWarps) {
    const TileRows<G> tr(p, t0);
    float clo[4] = {0.f, 0.f, 0.f, 0.f}, chi[4] = {0.f, 0.f, 0.f, 0.f};
    mma::band_product<P>(
        clo, chi,
        [&](int k, int m) {
          return s_w[(m < 8 ? tr.in[0] : tr.in[1]) + k + G::kPad * (k >> 3)];
        },
        b_lo, b_hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      if (tr.out[r] < 0) continue;
      const int o = tr.out[r] + col + (i & 1);
      s_o[o] = clo[i];
      s_o[lpb * p.ldo + o] = chi[i];
    }
  }
  __syncthreads();
  float* const out[2] = {lo, hi};
  write_back<2>(out, s_o, p, li, bp);
}

template <class P, int kSteps>
__global__ void __launch_bounds__(kThreads)
tc_iswt1d_kernel(const float* __restrict__ a, const float* __restrict__ d,
                 float* __restrict__ out, ClassLines p, Taps half_taps,
                 int hlen, long long block0) {
  using G = Geom<P, kSteps, 2, 1>;
  const int lpb = p.C * p.packs;
  unsigned char* smem = dynamic_smem<unsigned char>();
  const LineInfo li = line_info(smem, lpb);
  float* f_lo = reinterpret_cast<float*>(smem + line_info_bytes(lpb));
  float* f_hi = f_lo + kMaxTaps;      // rec / 2 in window order
  float* s_in = f_hi + kMaxTaps;      // [2][lpb][ldl] lo, hi windows
  float* s_o = s_in + 2 * lpb * p.ldl;  // [lpb][ldo]

  const BlockPos bp(p, block0 + blockIdx.x);
  decode_lines(p, li, bp);
  load_reversed_taps(half_taps, hlen, f_lo, f_hi);
  __syncthreads();
  const float* const in[2] = {a, d};
  stage<2, G>(in, s_in, p, li, bp, hlen);
  __syncthreads();

  typename P::B b_lo[kSteps], b_hi[kSteps];
  mma::band_fragments<P>(
      b_lo, [&](int k, int n) { return band(f_lo, k - n, hlen); });
  mma::band_fragments<P>(
      b_hi, [&](int k, int n) { return band(f_hi, k - n, hlen); });

  const float* s_d = s_in + lpb * p.ldl;
  const int warp = threadIdx.x >> 5, col = 2 * (mma::lane_id() & 3);
  const int chunks = lpb * p.cpl;
  for (int t0 = 16 * warp; t0 < chunks; t0 += 16 * kWarps) {
    const TileRows<G> tr(p, t0);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma::band_product_pair<P>(
        c,
        [&](int k, int m) {
          return s_in[(m < 8 ? tr.in[0] : tr.in[1]) + k + G::kPad * (k >> 3)];
        },
        [&](int k, int m) {
          return s_d[(m < 8 ? tr.in[0] : tr.in[1]) + k + G::kPad * (k >> 3)];
        },
        b_lo, b_hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      if (tr.out[r] >= 0) s_o[tr.out[r] + col + (i & 1)] = c[i];
    }
  }
  __syncthreads();
  float* const dst[1] = {out};
  write_back<1>(dst, s_o, p, li, bp);
}

using SwtKernel = void (*)(const float*, float*, float*, ClassLines, Taps,
                           int, long long);
using IswtKernel = void (*)(const float*, const float*, float*, ClassLines,
                            Taps, int, long long);

// A kernel instance, its per-line shared floats and its shared memory.
template <class Kernel>
struct Picked {
  Kernel kernel;
  int (*ldl)(int);
  size_t (*smem)(const ClassLines&);
};

template <class P, int S>
Picked<SwtKernel> swt_instance() {
  using G = Geom<P, S, 1, 2>;
  return {tc_swt1d_kernel<P, S>, G::ldl, G::smem};
}

template <class P, int S>
Picked<IswtKernel> iswt_instance() {
  using G = Geom<P, S, 2, 1>;
  return {tc_iswt1d_kernel<P, S>, G::ldl, G::smem};
}

// kSteps = ceil((hlen + 7) / kK): 1..6 (TF32), 1..3 (BF16) for hlen 1..40.
template <template <class, int> class Make, class Kernel>
Picked<Kernel> pick(bool bf16, int hlen) {
  if (bf16) {
    switch ((hlen + 7 + 15) / 16) {
      case 1: return Make<mma::Bf16, 1>::get();
      case 2: return Make<mma::Bf16, 2>::get();
      case 3: return Make<mma::Bf16, 3>::get();
    }
  } else {
    switch ((hlen + 7 + 7) / 8) {
      case 1: return Make<mma::Tf32, 1>::get();
      case 2: return Make<mma::Tf32, 2>::get();
      case 3: return Make<mma::Tf32, 3>::get();
      case 4: return Make<mma::Tf32, 4>::get();
      case 5: return Make<mma::Tf32, 5>::get();
      case 6: return Make<mma::Tf32, 6>::get();
    }
  }
  return {nullptr, nullptr, nullptr};
}

template <class P, int S>
struct MakeSwt {
  static Picked<SwtKernel> get() { return swt_instance<P, S>(); }
};

template <class P, int S>
struct MakeIswt {
  static Picked<IswtKernel> get() { return iswt_instance<P, S>(); }
};

// Plan the level, opt the kernel into its shared memory and launch its
// blocks, in launches of at most 2^31 - 1.
template <class Kernel, class Call>
int launch_level(const Picked<Kernel>& inst, int rows, int n, int level,
                 int centre, int hlen, int device, Call call) {
  if (inst.kernel == nullptr || hlen < 1 || hlen > kMaxTaps || centre < 0 ||
      centre >= hlen || rows < 1 || n < 1 || n > 0x3fffffff || level < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ClassLines p = plan_classes(rows, n, level, hlen, centre);
  p.ldl = inst.ldl(p.cpl);
  const size_t smem = inst.smem(p);
  err = cudaFuncSetAttribute(inst.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (p.rows + p.packs - 1) / p.packs *
                           static_cast<long long>(p.groups) * p.tiles;
  for (long long b0 = 0; b0 < blocks; b0 += 0x7fffffffLL)
    call(static_cast<unsigned>(std::min(blocks - b0, 0x7fffffffLL)), smem, p,
         b0);
  return static_cast<int>(cudaGetLastError());
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
  if (hlen < 1 || hlen > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  const Taps taps = make_taps(dec_lo, dec_hi, hlen);
  const auto inst = pick<MakeSwt, SwtKernel>(bf16 != 0, hlen);
  return launch_level(inst, rows, n, level, centre, hlen, device,
                      [&](unsigned grid, size_t smem, const ClassLines& p,
                          long long b0) {
                        inst.kernel<<<grid, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
                            x, lo, hi, p, taps, hlen, b0);
                      });
}

// K12b: out of the coefficients' shape.
extern "C" int pypwt_tc_iswt1d(const float* a, const float* d, float* out,
                               int rows, int n, int level, int centre,
                               const float* rec_lo, const float* rec_hi,
                               int hlen, int bf16, int device, void* stream) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  // rec / 2 is exact in float32: the single 1/2 of the 1D inverse
  float lo2[kMaxTaps], hi2[kMaxTaps];
  for (int k = 0; k < hlen; ++k) {
    lo2[k] = 0.5f * rec_lo[k];
    hi2[k] = 0.5f * rec_hi[k];
  }
  const Taps taps = make_taps<float>(lo2, hi2, hlen);
  const auto inst = pick<MakeIswt, IswtKernel>(bf16 != 0, hlen);
  return launch_level(inst, rows, n, level, centre, hlen, device,
                      [&](unsigned grid, size_t smem, const ClassLines& p,
                          long long b0) {
                        inst.kernel<<<grid, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
                            a, d, out, p, taps, hlen, b0);
                      });
}
