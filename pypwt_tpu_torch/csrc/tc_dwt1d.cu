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
// kernels are memory-bound; "bf16" is one product at twice the rate.
//
// Design: a product's 16 rows are 16 chunks of 8 consecutive outputs, not
// 16 rows of the input, so a single signal fills a tile as a sinogram does.
// The work item is a line: a segment of at most 1024 outputs of one row
// with its own periodic halo (a row of 2048 samples is one line; a 4 Mi
// signal is 2048 lines), and a block takes one line, or several whole
// short rows (the deep levels of a sinogram), so every block holds up to
// 128 chunks. The block stages each line's window in shared memory once
// (batched loads, indices advanced without a division per sample, a true
// periodic wrap at any halo width) and zero past the
// window's extent, where the band's zero entries meet it, so a NaN outside
// an output's support cannot reach it. Chunk m of a line reads window
// samples 16 m + k (K7b: coefficients 4 m + k), so the A tile is a strided
// view of the window; K7a stores the window with kPad floats after every
// 16 samples so that the 8 chunks a fragment reads start in distinct banks.
// The band is the same for every chunk: B[k][n] = f[k - 2n] (K7b: the
// polyphase taps of output parity n & 1 at k - n/2 - delta), built once per
// thread in registers for both filters. Warps take 16-chunk tiles in turn
// and store their fragments straight to device memory: a fragment's 4
// lanes of one chunk hold its 8 consecutive outputs, and its 8 chunks are
// consecutive, so each store is 64 consecutive floats. Blocks past a grid's
// 2^31 - 1 go in further launches; offsets are 64-bit.

#include "common.cuh"
#include "mma.cuh"

namespace pypwt {
namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 128;  // 8-output chunks per block

using mma::band;

// The lines of one level: per_row lines of cpl chunks in each row, lpb
// lines per block (several rows only where a row is one line).
struct Lines {
  long long count;  // lines in all
  int per_row;
  int cpl;
  int lpb;
  int outs;  // outputs per row
  int n;     // input samples (K7a) or coefficients (K7b) per row
  int ldl;   // shared floats per staged line
};

Lines plan_lines(long long rows, int outs, int n) {
  Lines ln{};
  const int chunks = (outs + 7) / 8;
  ln.cpl = std::min(kChunks, chunks);
  ln.per_row = (chunks + ln.cpl - 1) / ln.cpl;
  ln.lpb = 1;  // several rows per block only where a row is one line
  if (ln.per_row == 1)
    ln.lpb = static_cast<int>(std::min<long long>(kChunks / ln.cpl, rows));
  ln.count = rows * ln.per_row;
  ln.outs = outs;
  ln.n = n;
  return ln;
}

// Each line's row offsets, first output and output count (0: no line),
// decoded once per block into shared memory.
struct LineInfo {
  long long* in;   // [lpb] row * n
  long long* out;  // [lpb] row * outs + first output
  int* o0;         // [lpb] first output in its row
  int* cnt;        // [lpb] outputs of the line
};

__device__ __forceinline__ LineInfo line_info(void* smem, int lpb) {
  LineInfo li;
  li.in = static_cast<long long*>(smem);
  li.out = li.in + lpb;
  li.o0 = reinterpret_cast<int*>(li.out + lpb);
  li.cnt = li.o0 + lpb;
  return li;
}

__host__ __device__ inline size_t line_info_bytes(int lpb) {
  return static_cast<size_t>(lpb) * (2 * sizeof(long long) + 2 * sizeof(int));
}

__device__ __forceinline__ void decode_lines(const Lines& ln, LineInfo li,
                                             long long first) {
  const int l = threadIdx.x;
  if (l >= ln.lpb) return;
  const long long line = first + l;
  if (line >= ln.count) {
    li.in[l] = li.out[l] = 0;
    li.o0[l] = li.cnt[l] = 0;
    return;
  }
  const long long row = line / ln.per_row;
  const int o0 = static_cast<int>(line - row * ln.per_row) * 8 * ln.cpl;
  li.in[l] = row * ln.n;
  li.out[l] = row * ln.outs + o0;
  li.o0[l] = o0;
  li.cnt[l] = min(8 * ln.cpl, ln.outs - o0);
}

// Stage `lines` windows of wl samples each: thread tid takes elements
// i = tid + j kThreads, i = l wl + u, decoded once and advanced with a
// carry (no division per element), kBatch loads in flight before their
// stores.
template <int kBatch, class Load, class Store>
__device__ __forceinline__ void stage_lines(int lines, int wl, Load load,
                                            Store store) {
  const int dl = kThreads / wl, du = kThreads - dl * wl;
  int l = threadIdx.x / wl, u = threadIdx.x - l * wl;
  while (l < lines) {
    decltype(load(0, 0)) v[kBatch];
    int ls[kBatch], us[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      ls[j] = l;
      us[j] = u;
      if (l < lines) v[j] = load(l, u);
      l += dl;
      u += du;
      if (u >= wl) {
        u -= wl;
        ++l;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (ls[j] < lines) store(ls[j], us[j], v[j]);
  }
}

// K7a's window geometry: chunk m reads samples 16 m + k, k < kSpan; the
// window is stored with kPad floats after every 16 samples (TF32 fragments
// read 4 consecutive k per row: rows 20 floats apart hit distinct banks;
// bf16 fragments read 8: rows 24 apart meet each bank twice, the least for
// 64 words).
template <class P, int kSteps>
struct AnaGeom {
  static constexpr int kSpan = kSteps * P::kK;
  static constexpr int kPad = P::kK == 8 ? 4 : 8;
  __host__ __device__ static int window(int cpl) {
    return 16 * (cpl - 1) + kSpan;
  }
  __host__ __device__ static int phys(int u) { return u + kPad * (u >> 4); }
  static int ldl(int cpl) { return phys(window(cpl) - 1) + 1; }
  static size_t smem(const Lines& ln) {
    return line_info_bytes(ln.lpb) + sizeof(float) * 2 * kMaxTaps +
           sizeof(float) * ln.lpb * ln.ldl;
  }
};

// Lanes: Wrapped (K7a), or the LaneHalo<float, 1> of the rows x (K29e).
template <class P, int kSteps, class Lanes>
__global__ void __launch_bounds__(kThreads)
tc_dwt1d_kernel(const float* __restrict__ x, float* __restrict__ lo,
                float* __restrict__ hi, Lines ln, Taps taps, int hlen,
                long long block0, Lanes lanes) {
  using G = AnaGeom<P, kSteps>;
  unsigned char* smem = dynamic_smem<unsigned char>();
  const LineInfo li = line_info(smem, ln.lpb);
  float* f_lo = reinterpret_cast<float*>(smem + line_info_bytes(ln.lpb));
  float* f_hi = f_lo + kMaxTaps;  // taps in window order
  float* s_w = f_hi + kMaxTaps;   // [lpb][ldl] windows

  const int warp = threadIdx.x >> 5;
  decode_lines(ln, li, (block0 + blockIdx.x) * ln.lpb);
  load_reversed_taps(taps, hlen, f_lo, f_hi);
  __syncthreads();

  // Window sample u of line l is x[(2 o0 - lpad + u) mod n] (K29e: sample
  // 2 o0 - lpad + u of the extended axis), zero from the window's extent
  // 2 cnt + hlen - 2 on.
  const int wl = G::window(ln.cpl);
  const int lpad = analysis_lpad(hlen);
  stage_lines<8>(
      ln.lpb, wl,
      [&](int l, int u) {
        if (li.cnt[l] <= 0 || u >= 2 * li.cnt[l] + hlen - 2) return 0.f;
        const int k = 2 * li.o0[l] - lpad + u;
        if constexpr (Lanes::kHalo) {
          if (static_cast<unsigned>(k) < static_cast<unsigned>(ln.n))
            return __ldg(x + li.in[l] + k);
          return lanes.at(0, x + li.in[l], li.in[l] / ln.n, k, ln.n);
        } else {
          return __ldg(x + li.in[l] + wrap(k, ln.n));
        }
      },
      [&](int l, int u, float v) { s_w[l * ln.ldl + G::phys(u)] = v; });
  __syncthreads();

  typename P::B b_lo[kSteps], b_hi[kSteps];
  mma::band_fragments<P>(
      b_lo, [&](int k, int n) { return band(f_lo, k - 2 * n, hlen); });
  mma::band_fragments<P>(
      b_hi, [&](int k, int n) { return band(f_hi, k - 2 * n, hlen); });

  // 16-chunk tiles: a lane's fragment rows are chunks g and g + 8.
  const int chunks = ln.lpb * ln.cpl;
  const int g = mma::lane_id() >> 2, col = 2 * (mma::lane_id() & 3);
  for (int t0 = 16 * warp; t0 < chunks; t0 += 16 * kWarps) {
    int base[2], lim[2];
    long long out[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = t0 + g + 8 * r;
      const int l = q / ln.cpl, ch = q - l * ln.cpl;
      const bool ok = q < chunks;
      base[r] = ok ? l * ln.ldl + (16 + G::kPad) * ch : 0;
      lim[r] = ok ? li.cnt[l] - 8 * ch : 0;
      out[r] = ok ? li.out[l] + 8 * ch : 0;
    }
    float clo[4] = {0.f, 0.f, 0.f, 0.f}, chi[4] = {0.f, 0.f, 0.f, 0.f};
    mma::band_product<P>(
        clo, chi,
        [&](int k, int m) {
          return s_w[(m < 8 ? base[0] : base[1]) + k + G::kPad * (k >> 4)];
        },
        b_lo, b_hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, c = col + (i & 1);
      if (c < lim[r]) {
        lo[out[r] + c] = clo[i];
        hi[out[r] + c] = chi[i];
      }
    }
  }
}

// K7b's geometry: chunk m (8 outputs, 4 coefficients) reads coefficients
// 4 m + k, k < kSpan, of each of the two windows; rows 4 floats apart meet
// the banks as few times as a fragment allows, so no padding.
template <class P, int kSteps>
struct SynGeom {
  static constexpr int kSpan = kSteps * P::kK;
  __host__ __device__ static int window(int cpl) {
    return 4 * (cpl - 1) + kSpan;
  }
  static int ldl(int cpl) { return window(cpl); }
  static size_t smem(const Lines& ln) {
    return line_info_bytes(ln.lpb) + sizeof(float) * 4 * kHalfTaps +
           sizeof(float) * 2 * ln.lpb * ln.ldl;
  }
};

// One coefficient of each of the two planes.
struct Pair {
  float lo, hi;
};

// Lanes: Wrapped (K7b), or the LaneHalo<float, 2> of the rows a, d (K29f).
template <class P, int kSteps, class Lanes>
__global__ void __launch_bounds__(kThreads)
tc_idwt1d_kernel(const float* __restrict__ a, const float* __restrict__ d,
                 float* __restrict__ out, Lines ln, Taps taps, int hlen,
                 long long block0, Lanes lanes) {
  using G = SynGeom<P, kSteps>;
  unsigned char* smem = dynamic_smem<unsigned char>();
  const LineInfo li = line_info(smem, ln.lpb);
  float* g_lo = reinterpret_cast<float*>(smem + line_info_bytes(ln.lpb));
  float* g_hi = g_lo + 2 * kHalfTaps;  // [2][kHalfTaps] taps per parity
  float* s_a = g_hi + 2 * kHalfTaps;   // [lpb][ldl] coefficient windows
  float* s_d = s_a + ln.lpb * ln.ldl;

  const Polyphase ph(hlen);
  const int warp = threadIdx.x >> 5;
  decode_lines(ln, li, (block0 + blockIdx.x) * ln.lpb);
  load_polyphase_taps(taps, hlen, g_lo, g_hi);
  __syncthreads();

  // Window sample u of line l is coefficient (o0 / 2 - c + u) mod L (K29f:
  // coefficient o0 / 2 - c + u of the extended axis), zero from the window's
  // extent cnt / 2 + h2 on.
  const int wl = G::window(ln.cpl);
  stage_lines<4>(
      ln.lpb, wl,
      [&](int l, int u) {
        Pair v{0.f, 0.f};
        if (li.cnt[l] > 0 && u < li.cnt[l] / 2 + ph.h2) {
          const int q = li.o0[l] / 2 - ph.c + u;
          if constexpr (Lanes::kHalo) {
            if (static_cast<unsigned>(q) < static_cast<unsigned>(ln.n)) {
              v.lo = __ldg(a + li.in[l] + q);
              v.hi = __ldg(d + li.in[l] + q);
            } else {
              const long long row = li.in[l] / ln.n;
              v.lo = lanes.at(0, a + li.in[l], row, q, ln.n);
              v.hi = lanes.at(1, d + li.in[l], row, q, ln.n);
            }
          } else {
            const long long k = li.in[l] + wrap(q, ln.n);
            v.lo = __ldg(a + k);
            v.hi = __ldg(d + k);
          }
        }
        return v;
      },
      [&](int l, int u, const Pair& v) {
        s_a[l * ln.ldl + u] = v.lo;
        s_d[l * ln.ldl + u] = v.hi;
      });
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

  const int chunks = ln.lpb * ln.cpl;
  const int g = mma::lane_id() >> 2, col = 2 * (mma::lane_id() & 3);
  for (int t0 = 16 * warp; t0 < chunks; t0 += 16 * kWarps) {
    int base[2], lim[2];
    long long dst[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = t0 + g + 8 * r;
      const int l = q / ln.cpl, ch = q - l * ln.cpl;
      const bool ok = q < chunks;
      base[r] = ok ? l * ln.ldl + 4 * ch : 0;
      lim[r] = ok ? li.cnt[l] - 8 * ch : 0;
      dst[r] = ok ? li.out[l] + 8 * ch : 0;
    }
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma::band_product_pair<P>(
        c, [&](int k, int m) { return s_a[(m < 8 ? base[0] : base[1]) + k]; },
        [&](int k, int m) { return s_d[(m < 8 ? base[0] : base[1]) + k]; },
        b_lo, b_hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, cc = col + (i & 1);
      if (cc < lim[r]) out[dst[r] + cc] = c[i];
    }
  }
}

template <class Lanes>
using DwtKernel = void (*)(const float*, float*, float*, Lines, Taps, int,
                           long long, Lanes);
template <class Lanes>
using IdwtKernel = void (*)(const float*, const float*, float*, Lines, Taps,
                            int, long long, Lanes);

// A kernel instance, its per-line shared floats and its shared memory.
template <class Kernel>
struct Picked {
  Kernel kernel;
  int (*ldl)(int);
  size_t (*smem)(const Lines&);
};

template <class P, int S, class Lanes>
Picked<DwtKernel<Lanes>> dwt_instance() {
  return {tc_dwt1d_kernel<P, S, Lanes>, AnaGeom<P, S>::ldl,
          AnaGeom<P, S>::smem};
}

template <class P, int S, class Lanes>
Picked<IdwtKernel<Lanes>> idwt_instance() {
  return {tc_idwt1d_kernel<P, S, Lanes>, SynGeom<P, S>::ldl,
          SynGeom<P, S>::smem};
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
  return {nullptr, nullptr, nullptr};
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
  return {nullptr, nullptr, nullptr};
}

// Plan the lines, opt the kernel into its shared memory and launch its
// blocks, in launches of at most 2^31 - 1.
template <class Kernel, class Call>
int launch_lines(const Picked<Kernel>& inst, long long rows, int outs, int n,
                 int device, Call call) {
  if (inst.kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Lines ln = plan_lines(rows, outs, n);
  ln.ldl = inst.ldl(ln.cpl);
  const size_t smem = inst.smem(ln);
  err = cudaFuncSetAttribute(inst.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (ln.count + ln.lpb - 1) / ln.lpb;
  for (long long b0 = 0; b0 < blocks; b0 += 0x7fffffffLL)
    call(static_cast<unsigned>(std::min(blocks - b0, 0x7fffffffLL)), smem,
         ln, b0);
  return static_cast<int>(cudaGetLastError());
}

// K7a / K29e: lo, hi of (rows, n/2) from x of (rows, n), n even.
template <class Lanes>
int launch_dwt(const float* x, float* lo, float* hi, int rows, int n,
               const float* dec_lo, const float* dec_hi, int hlen, int bf16,
               int device, void* stream, Lanes lanes) {
  if (hlen < 4 || hlen > kMaxTaps || hlen % 2 || rows < 1 || n < 2 ||
      n % 2 || n > 0x3fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Lanes::kHalo) {
    if (!analysis_halos_ok(hlen, lanes.lp, lanes.rp))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Taps taps = make_taps(dec_lo, dec_hi, hlen);
  const auto inst = pick_dwt<Lanes>(bf16 != 0, hlen);
  return launch_lines(inst, rows, n / 2, n, device,
                      [&](unsigned grid, size_t smem, const Lines& ln,
                          long long b0) {
                        inst.kernel<<<grid, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
                            x, lo, hi, ln, taps, hlen, b0, lanes);
                      });
}

// K7b / K29f: out of (rows, 2 len) from lo, hi of (rows, len).
template <class Lanes>
int launch_idwt(const float* a, const float* d, float* out, int rows,
                int len, const float* rec_lo, const float* rec_hi, int hlen,
                int bf16, int device, void* stream, Lanes lanes) {
  if (hlen < 4 || hlen > kMaxTaps || hlen % 2 || rows < 1 || len < 1 ||
      len > 0x1fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Lanes::kHalo) {
    if (!synthesis_halos_ok(hlen, lanes.lp, lanes.rp))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Taps taps = make_taps(rec_lo, rec_hi, hlen);
  const auto inst = pick_idwt<Lanes>(bf16 != 0, hlen);
  return launch_lines(inst, rows, 2 * len, len, device,
                      [&](unsigned grid, size_t smem, const Lines& ln,
                          long long b0) {
                        inst.kernel<<<grid, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
                            a, d, out, ln, taps, hlen, b0, lanes);
                      });
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
