// K2: one periodized separable 2D synthesis level, float32 or float64; K20,
// the same level of float32 planes unshifted by a circular shift, with a
// spin accumulator and a scale fused into its store; and K26b, the level of
// one row shard's coefficient planes, float32 or float64.
//
// K2 replaces the TPU kernel pypwt_tpu/ops/pallas_dwt.py::idwt2d_fused
// (_build_idwt2d, :477). K20 replaces ::idwt2d_fused_unshift
// (_build_idwt2d_shifted, :721), and, with the shift a runtime argument, the
// synthesis halves of the phase-select, dynamic-shift and multi-shift
// kernels (_build_idwt2d_phasesel :943, _build_idwt2d_dynshift :1197,
// _build_idwt2d_multiunshift :1384: one accumulating K20 launch per spin).
// K26b replaces ::build_idwt2d_sharded (:1544), the shard_map-local
// synthesis level of pypwt_tpu/parallel/spatial.py's row-sharded path.
//
// Map (pypwt_tpu/core/dwt.py:214-223 on conv.synthesis_core), for a, h, v,
// d of (B?, Lr, Lc), an output y of (B?, Nr, Nc) (2Lr x 2Lc, or one less
// on an odd axis) and 2 <= hlen <= 40: a polyphase synthesis along axis -2
// of (a, h) -> t1 and of (v, d) -> t2, then one along the last axis of
// (t1, t2). One axis, as a direct modulo index per output parity p
// (n = 2m + p, L coefficients):
//   h2 = hlen/2, c = h2/2, sigma = (h2 even), delta = (p + sigma) >> 1,
//   off = 1 - ((p + sigma) & 1), g_p[j] = rec[hlen - 1 - 2j - off]
//   y[n] = sum_{j < h2} g_p_lo[j] * lo[(m + delta + j - c) mod L]
//                     + g_p_hi[j] * hi[(m + delta + j - c) mod L]
// (the sigma/c/delta/off/base centering of conv.synthesis_core, :133-167,
// and of the reference's separable.cu:252-287). K20 stores
//   out[i, j] = scale * (y[(i + sr) mod Nr, (j + sc) mod Nc] [+ acc[i, j]])
// (pallas_dwt.py:735-740: roll(y, (-sr, -sc)), then the accumulator and
// the 1/n of the cycle-spin average).
//
// Bound: 4*Nr*Nc bytes in and 4*Nr*Nc out per level (8 bytes per output
// pixel; K20 with acc 12), about hlen FMAs per output pixel per axis, 2*hlen
// in all: hlen/2 flop per byte, under the H100's float32 ridge of ~20 flop
// per byte for every hlen < 40, so memory-bound.
//
// Design. K2 and K26b run pair::tile (level2d.cuh): each block owns 16 x 64
// coefficients in float32 where the level gives every SM such a block, 8 x
// 64 on smaller levels, and 16 x 32 in float64, 2x that in outputs, picked
// on the host (pick_pair): 39,744 bytes of dynamic shared memory at db2
// (five blocks per SM in either type), 74,368 at hlen 40 in float32 (three)
// and 91,008 in float64 (two). A table of the window's source rows is
// built once per block (the plane's rows wrapped, or the shard's own rows
// and its halos' rows, null past both halos: no per-sample halo test or row
// wrap), then the four coefficient windows of (tile rows + h2 + sigma - 1)
// rows are staged by cp.async, every copy of a thread in flight before one
// wait: 16-byte copies from the window's first column rounded down to 16
// bytes, read shifted, where lc allows, else sample copies with the column
// wrap resolved once per copy; zero for a row past the halos. A thread then
// computes both parities of one coefficient row and window column along
// axis -2 into t1/t2, loading the h2 + sigma window samples they share
// once, and both parities of one coefficient column along the last axis,
// stored as one 8-byte (float) or 16-byte (double) pair where nc is even
// and the plane aligned; an odd output axis stores scalars within its crop.
// The taps are kernel parameters indexed by window sample (pair::Taps), so
// the unrolled tap loops read them as operands. Each output keeps
// syn::tile's order of summation, so the outputs are bit for bit those of
// the body before.
//
// K20 runs the same pair body with its unshift (idwt2d_unshift_kernel,
// float32, K2's tile shapes): along an axis shifted by s = 2q + e, output
// 2m + p is y's 2(m + q) + p + e, so the window's origin moves by q
// coefficients and an odd s swaps the parities, one window sample on for
// output parity 1: a tap table per axis (pair::make_taps with odd),
// kernel parameters as K2's, and an odd row or column shift a template
// parameter (four instances per tile shape), the span h2 + 1 along an odd
// shift. Each output adds the accumulator, read as an 8-byte pair where
// the store is one and acc is aligned, then takes the scale, in
// syn::tile's order, so the outputs are bit for bit those of K20's body
// before (syn::tile, now K25's alone). That holds where y has period Nr =
// 2Lr along a shifted axis; an odd axis that is not shifted is cropped as
// K2 crops it, and a shifted odd axis, whose y has period 2Lr - 1, takes
// the direct form instead (idwt2d_direct_kernel: each thread sums its
// pixel's 4 h2^2 taps from device memory through L1, no staging), which
// only odd cycle-spun planes reach.
//
// All: the batch is the grid's z axis, row tiles its y axis, in chunks
// where a level holds more than a grid's 65535 (launch_chunks); plane
// offsets are 64-bit. K26b's output is 2Lr x 2Lc.

#include "level2d.cuh"

namespace pypwt {
namespace {

// K20's direct form: one thread per output pixel, for a shifted odd axis.
__global__ void __launch_bounds__(kThreads)
idwt2d_direct_kernel(const float* __restrict__ a, const float* __restrict__ h,
                     const float* __restrict__ v, const float* __restrict__ d,
                     const float* __restrict__ acc, float* __restrict__ out,
                     int lr, int lc, int nr, int nc, Taps taps, int hlen,
                     int y0, int sr, int sc, float scale) {
  __shared__ float g_lo[2 * kHalfTaps], g_hi[2 * kHalfTaps];
  load_polyphase_taps(taps, hlen, g_lo, g_hi);
  __syncthreads();
  const Polyphase ph(hlen);
  const int i = (y0 + blockIdx.y) * 8 + threadIdx.x / 32;
  const int j = blockIdx.x * 32 + threadIdx.x % 32;
  if (i >= nr || j >= nc) return;
  int yr = i + sr, yc = j + sc;  // y pixel, both shifts in [0, n)
  if (yr >= nr) yr -= nr;
  if (yc >= nc) yc -= nc;
  const int pr = yr & 1, pc = yc & 1;
  const int br = (yr >> 1) + ph.delta(pr) - ph.c;
  const int bc = (yc >> 1) + ph.delta(pc) - ph.c;
  const float* glr = g_lo + pr * kHalfTaps;
  const float* ghr = g_hi + pr * kHalfTaps;
  const float* glc = g_lo + pc * kHalfTaps;
  const float* ghc = g_hi + pc * kHalfTaps;
  const long long ib = static_cast<long long>(blockIdx.z) * lr * lc;
  float s = 0.f;
  for (int jx = 0; jx < ph.h2; ++jx) {
    const int col = wrap(bc + jx, lc);
    float x1 = 0.f, x2 = 0.f;  // t1, t2 of this y row at coefficient column
    for (int jy = 0; jy < ph.h2; ++jy) {
      const long long k =
          ib + static_cast<long long>(wrap(br + jy, lr)) * lc + col;
      x1 = fmaf(__ldg(a + k), glr[jy], x1);
      x1 = fmaf(__ldg(h + k), ghr[jy], x1);
      x2 = fmaf(__ldg(v + k), glr[jy], x2);
      x2 = fmaf(__ldg(d + k), ghr[jy], x2);
    }
    s = fmaf(x1, glc[jx], s);
    s = fmaf(x2, ghc[jx], s);
  }
  const long long o = static_cast<long long>(blockIdx.z) * nr * nc +
                      static_cast<long long>(i) * nc + j;
  if (acc) s += acc[o];
  out[o] = s * scale;
}

// K2 and K26b: one level on the pair body (level2d.cuh) in tiles of kTR x
// kTC coefficients; Rows: Wrapped (K2), or the Halo<T, 4> of a shard's
// planes (K26b), moved to the block's plane here.
template <class T, int kTR, int kTC, class Rows>
__global__ void __launch_bounds__(kThreads)
idwt2d_pair_kernel(const T* __restrict__ a, const T* __restrict__ h,
                   const T* __restrict__ v, const T* __restrict__ d,
                   T* __restrict__ out, int lr, int lc, int nr, int nc,
                   pair::Taps<T> taps, int hlen, int y0, Rows rows) {
  const long long pi = static_cast<long long>(blockIdx.z) * lr * lc;
  const long long po = static_cast<long long>(blockIdx.z) * nr * nc;
  const int m0 = kTR * (y0 + blockIdx.y), n0 = kTC * blockIdx.x;
  T* smem = dynamic_smem<T>();
  if constexpr (Rows::kHalo) {
    pair::tile<T, kTR, kTC>(a + pi, h + pi, v + pi, d + pi, out + po, lr, lc,
                            nr, nc, hlen, taps, taps, m0, n0, smem,
                            rows.plane(blockIdx.z, lc));
  } else {
    pair::tile<T, kTR, kTC>(a + pi, h + pi, v + pi, d + pi, out + po, lr, lc,
                            nr, nc, hlen, taps, taps, m0, n0, smem, rows);
  }
}

template <class T, class Rows>
using PairKernel = void (*)(const T*, const T*, const T*, const T*, T*, int,
                            int, int, int, pair::Taps<T>, int, int, Rows);

template <class T, class Rows>
using PairInstance = TileInstance<PairKernel<T, Rows>>;

template <class T, class Rows, int kTR, int kTC>
PairInstance<T, Rows> pair_instance(int hlen) {
  return {idwt2d_pair_kernel<T, kTR, kTC, Rows>,
          pair::Geometry<T>(kTR, kTC, hlen).smem_bytes(), kTR, kTC};
}

// K20: one level on the pair body with K20's unshift (u: the window's
// origin moved by qr, qc coefficients, the accumulator and the scale), an
// odd row (kOddR) or column (kOddC) shift read through the taps gr / gc.
template <int kTR, int kTC, bool kOddR, bool kOddC>
__global__ void __launch_bounds__(kThreads)
idwt2d_unshift_kernel(const float* __restrict__ a,
                      const float* __restrict__ h,
                      const float* __restrict__ v,
                      const float* __restrict__ d,
                      const float* __restrict__ acc,
                      float* __restrict__ out, int lr, int lc, int nr,
                      int nc, pair::Taps<float> gr, pair::Taps<float> gc,
                      int hlen, int y0, int qr, int qc, float scale) {
  const long long pi = static_cast<long long>(blockIdx.z) * lr * lc;
  const long long po = static_cast<long long>(blockIdx.z) * nr * nc;
  const pair::Unshift<float> u{qr, qc, acc ? acc + po : acc, scale};
  pair::tile<float, kTR, kTC, Wrapped, kOddR, kOddC, true>(
      a + pi, h + pi, v + pi, d + pi, out + po, lr, lc, nr, nc, hlen, gr, gc,
      kTR * (y0 + blockIdx.y), kTC * blockIdx.x, dynamic_smem<float>(),
      Wrapped{}, u);
}

using UnshiftKernel = void (*)(const float*, const float*, const float*,
                               const float*, const float*, float*, int, int,
                               int, int, pair::Taps<float>,
                               pair::Taps<float>, int, int, int, int, float);
using UnshiftInstance = TileInstance<UnshiftKernel>;

template <int kTR, int kTC>
UnshiftInstance unshift_instance(int hlen, bool odd_r, bool odd_c) {
  const UnshiftKernel k =
      odd_r ? (odd_c ? idwt2d_unshift_kernel<kTR, kTC, true, true>
                     : idwt2d_unshift_kernel<kTR, kTC, true, false>)
            : (odd_c ? idwt2d_unshift_kernel<kTR, kTC, false, true>
                     : idwt2d_unshift_kernel<kTR, kTC, false, false>);
  return {k, pair::Geometry<float>(kTR, kTC, hlen, odd_r, odd_c).smem_bytes(),
          kTR, kTC};
}

// Whether a float32 level of (batch, nr, nc) outputs gives each of the
// device's `sms` SMs a block of 16 x 64 coefficients (pick_pair).
inline bool fills_sms(int batch, int nr, int nc, int sms) {
  return static_cast<long long>(batch) * ((nr + 31) / 32) *
             ((nc + 127) / 128) >= sms;
}

// K20's instance: K2's tile shape, the parities of the shifts (sr, sc).
inline UnshiftInstance pick_unshift(int hlen, int batch, int nr, int nc,
                                    int sr, int sc, int sms) {
  if (fills_sms(batch, nr, nc, sms))
    return unshift_instance<16, 64>(hlen, sr & 1, sc & 1);
  return unshift_instance<8, 64>(hlen, sr & 1, sc & 1);
}

// The tile shape of a level of (batch, nr, nc) outputs, in coefficients. In
// float32, 64 columns (512-byte output row segments) and 16 rows where the
// level gives each of the device's `sms` SMs such a block, else 8 rows
// (small levels, such as 512^2 outputs); three 16 x 64 blocks fit an SM's
// shared memory up to hlen 40. In float64, 16 x 32. Tiles of 32 rows,
// which stage fewer halo rows, measured slower (PERF.md).
template <class T, class Rows>
PairInstance<T, Rows> pick_pair(int hlen, int batch, int nr, int nc,
                                int sms) {
  if constexpr (std::is_same_v<T, float>) {
    if (fills_sms(batch, nr, nc, sms))
      return pair_instance<T, Rows, 16, 64>(hlen);
    return pair_instance<T, Rows, 8, 64>(hlen);
  } else {
    return pair_instance<T, Rows, 16, 32>(hlen);
  }
}

// Launch one level of (batch, lr, lc) coefficient planes into (batch, nr,
// nc) outputs on the pair body (the caller validated the arguments).
template <class T, class Rows>
int launch_pair(const T* a, const T* h, const T* v, const T* d, T* out,
                int batch, int lr, int lc, int nr, int nc, const T* rec_lo,
                const T* rec_hi, int hlen, const Rows& rows, int device,
                void* stream) {
  int sms = 0;
  cudaError_t err = device_sms(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PairInstance<T, Rows> inst = pick_pair<T, Rows>(hlen, batch, nr, nc,
                                                        sms);
  err = allow_smem(inst);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pair::Taps<T> taps = pair::make_taps(rec_lo, rec_hi, hlen);
  // output tiles of 2 tr x 2 tc pixels
  launch_chunks(
      (nc + 2 * inst.tc - 1) / (2 * inst.tc),
      (nr + 2 * inst.tr - 1) / (2 * inst.tr), batch,
      [&](dim3 grid, int y0, int z0) {
        const long long pi = static_cast<long long>(z0) * lr * lc;
        const long long po = static_cast<long long>(z0) * nr * nc;
        Rows rz = rows;
        if constexpr (Rows::kHalo) rz = rows.plane(z0, lc);
        inst.kernel<<<grid, kThreads, inst.smem,
                      static_cast<cudaStream_t>(stream)>>>(
            a + pi, h + pi, v + pi, d + pi, out + po, lr, lc, nr, nc, taps,
            hlen, y0, rz);
      });
  return static_cast<int>(cudaGetLastError());
}

// report_occupancy of the instance that a level of nr x nc outputs at hlen
// runs (tile shape in coefficients).
template <class T, class Rows>
int pair_occupancy(int nr, int nc, int hlen, int device, int* blocks,
                   int* smem, int* tr, int* tc) {
  if (hlen < 2 || hlen > kMaxTaps || nr < 1 || nc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = device_sms(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  return report_occupancy(pick_pair<T, Rows>(hlen, 1, nr, nc, sms), blocks,
                          smem, tr, tc);
}

template <class T>
int launch_sharded(const T* const* planes, const T* const* tops,
                   const T* const* bots, T* out, int batch, int lr, int lc,
                   int lp, int rp, const T* rec_lo, const T* rec_hi, int hlen,
                   int device, void* stream) {
  if (hlen < 2 || hlen > kMaxTaps || lr < 1 || lc < 1 || lr > 0x1fffffff ||
      lc > 0x1fffffff || batch < 1 || !synthesis_halos_ok(hlen, lp, rp))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_pair(planes[0], planes[1], planes[2], planes[3], out, batch,
                     lr, lc, 2 * lr, 2 * lc, rec_lo, rec_hi, hlen,
                     make_halo4(tops, bots, lp, rp), device, stream);
}

template <class T>
int launch(const T* a, const T* h, const T* v, const T* d, const T* acc,
           T* out, int batch, int lr, int lc, int nr, int nc, const T* rec_lo,
           const T* rec_hi, int hlen, int sr, int sc, float scale,
           bool shifted, int device, void* stream) {
  if (hlen < 2 || hlen > kMaxTaps || lr < 1 || lc < 1 || nr < 1 || nc < 1 ||
      lr > 0x3fffffff || lc > 0x3fffffff || nr > 0x3fffffff ||
      nc > 0x3fffffff || batch < 1 || sr < 0 || sr >= nr || sc < 0 ||
      sc >= nc)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!shifted)
    return launch_pair(a, h, v, d, out, batch, lr, lc, nr, nc, rec_lo, rec_hi,
                       hlen, Wrapped{}, device, stream);
  if constexpr (!std::is_same_v<T, float>) {
    return static_cast<int>(cudaErrorInvalidValue);  // K20 is float32 only
  } else {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    // y has period 2L along an axis of 2L samples; a shifted axis of
    // another size takes the direct form
    if ((sr && nr != 2 * lr) || (sc && nc != 2 * lc)) {
      const cudaError_t err = cudaSetDevice(device);
      if (err != cudaSuccess) return static_cast<int>(err);
      const Taps taps = make_taps(rec_lo, rec_hi, hlen);
      launch_chunks((nc + 31) / 32, (nr + 7) / 8, batch,
                    [&](dim3 grid, int y0, int z0) {
                      const long long pi =
                          static_cast<long long>(z0) * lr * lc;
                      const long long po =
                          static_cast<long long>(z0) * nr * nc;
                      idwt2d_direct_kernel<<<grid, kThreads, 0, st>>>(
                          a + pi, h + pi, v + pi, d + pi,
                          acc ? acc + po : acc, out + po, lr, lc, nr, nc,
                          taps, hlen, y0, sr, sc, scale);
                    });
      return static_cast<int>(cudaGetLastError());
    }
    int sms = 0;
    cudaError_t err = device_sms(device, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const UnshiftInstance inst =
        pick_unshift(hlen, batch, nr, nc, sr, sc, sms);
    err = allow_smem(inst);
    if (err != cudaSuccess) return static_cast<int>(err);
    const pair::Taps<float> gr = pair::make_taps(rec_lo, rec_hi, hlen,
                                                 sr & 1);
    const pair::Taps<float> gc = pair::make_taps(rec_lo, rec_hi, hlen,
                                                 sc & 1);
    // output tiles of 2 tr x 2 tc pixels
    launch_chunks((nc + 2 * inst.tc - 1) / (2 * inst.tc),
                  (nr + 2 * inst.tr - 1) / (2 * inst.tr), batch,
                  [&](dim3 grid, int y0, int z0) {
                    const long long pi = static_cast<long long>(z0) * lr * lc;
                    const long long po = static_cast<long long>(z0) * nr * nc;
                    inst.kernel<<<grid, kThreads, inst.smem, st>>>(
                        a + pi, h + pi, v + pi, d + pi, acc ? acc + po : acc,
                        out + po, lr, lc, nr, nc, gr, gc, hlen, y0, sr >> 1,
                        sc >> 1, scale);
                  });
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace
}  // namespace pypwt

// All return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. rec_lo/rec_hi are host arrays of hlen values of the
// data's type.
// K2: out of (batch, nr, nc) from coefficients of (batch, lr, lc).
extern "C" int pypwt_idwt2d(const float* a, const float* h, const float* v,
                            const float* d, float* out, int batch, int lr,
                            int lc, int nr, int nc, const float* rec_lo,
                            const float* rec_hi, int hlen, int device,
                            void* stream) {
  return pypwt::launch<float>(a, h, v, d, nullptr, out, batch, lr, lc, nr,
                              nc, rec_lo, rec_hi, hlen, 0, 0, 1.f, false,
                              device, stream);
}

extern "C" int pypwt_idwt2d_f64(const double* a, const double* h,
                                const double* v, const double* d,
                                double* out, int batch, int lr, int lc,
                                int nr, int nc, const double* rec_lo,
                                const double* rec_hi, int hlen, int device,
                                void* stream) {
  return pypwt::launch<double>(a, h, v, d, nullptr, out, batch, lr, lc, nr,
                               nc, rec_lo, rec_hi, hlen, 0, 0, 1.f, false,
                               device, stream);
}

// K20: out = scale * (roll(y, (-sr, -sc)) [+ acc]), acc of out's shape or
// null, sr and sc reduced into [0, nr) and [0, nc) by the caller.
extern "C" int pypwt_idwt2d_unshift(const float* a, const float* h,
                                    const float* v, const float* d,
                                    const float* acc, float* out, int batch,
                                    int lr, int lc, int nr, int nc, int sr,
                                    int sc, float scale, const float* rec_lo,
                                    const float* rec_hi, int hlen, int device,
                                    void* stream) {
  return pypwt::launch<float>(a, h, v, d, acc, out, batch, lr, lc, nr, nc,
                              rec_lo, rec_hi, hlen, sr, sc, scale, true,
                              device, stream);
}

// K26b: out of (batch, 2 lr, 2 lc) from one row shard's coefficient planes
// a, h, v, d of (batch, lr, lc); halos holds their eight halo tensors in
// JAX's order (a_top, a_bot, h_top, h_bot, v_top, v_bot, d_top, d_bot), tops
// of (batch, lp, lc) and bottoms of (batch, rp, lc), lp and rp the synthesis
// pads of hlen.
extern "C" int pypwt_idwt2d_sharded(const float* a, const float* h,
                                    const float* v, const float* d,
                                    const float* const* halos, float* out,
                                    int batch, int lr, int lc, int lp, int rp,
                                    const float* rec_lo, const float* rec_hi,
                                    int hlen, int device, void* stream) {
  const float* planes[4] = {a, h, v, d};
  const float* tops[4] = {halos[0], halos[2], halos[4], halos[6]};
  const float* bots[4] = {halos[1], halos[3], halos[5], halos[7]};
  return pypwt::launch_sharded(planes, tops, bots, out, batch, lr, lc, lp, rp,
                               rec_lo, rec_hi, hlen, device, stream);
}

extern "C" int pypwt_idwt2d_sharded_f64(const double* a, const double* h,
                                        const double* v, const double* d,
                                        const double* const* halos,
                                        double* out, int batch, int lr,
                                        int lc, int lp, int rp,
                                        const double* rec_lo,
                                        const double* rec_hi, int hlen,
                                        int device, void* stream) {
  const double* planes[4] = {a, h, v, d};
  const double* tops[4] = {halos[0], halos[2], halos[4], halos[6]};
  const double* bots[4] = {halos[1], halos[3], halos[5], halos[7]};
  return pypwt::launch_sharded(planes, tops, bots, out, batch, lr, lc, lp, rp,
                               rec_lo, rec_hi, hlen, device, stream);
}

// K2's and K26b's instance on a level of nr x nc outputs at hlen (f64: the
// float64 one; halo: K26b's): resident blocks per SM, dynamic shared memory
// in bytes, and the tile's coefficient rows and columns.
extern "C" int pypwt_idwt2d_occupancy(int nr, int nc, int hlen, int f64,
                                      int halo, int device, int* blocks,
                                      int* smem, int* tile_rows,
                                      int* tile_cols) {
  using namespace pypwt;
  if (f64)
    return halo ? pair_occupancy<double, Halo<double, 4>>(
                      nr, nc, hlen, device, blocks, smem, tile_rows,
                      tile_cols)
                : pair_occupancy<double, Wrapped>(nr, nc, hlen, device,
                                                  blocks, smem, tile_rows,
                                                  tile_cols);
  return halo ? pair_occupancy<float, Halo<float, 4>>(
                    nr, nc, hlen, device, blocks, smem, tile_rows, tile_cols)
              : pair_occupancy<float, Wrapped>(nr, nc, hlen, device, blocks,
                                               smem, tile_rows, tile_cols);
}

// K20's instance on a level of nr x nc outputs at hlen and shift (sr, sc)
// (the pair body's; a shifted odd axis takes the direct form instead):
// resident blocks per SM, dynamic shared memory in bytes, and the tile's
// coefficient rows and columns.
extern "C" int pypwt_idwt2d_unshift_occupancy(int nr, int nc, int hlen,
                                              int sr, int sc, int device,
                                              int* blocks, int* smem,
                                              int* tile_rows,
                                              int* tile_cols) {
  using namespace pypwt;
  if (hlen < 2 || hlen > kMaxTaps || nr < 1 || nc < 1 || sr < 0 || sc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = device_sms(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  return report_occupancy(pick_unshift(hlen, 1, nr, nc, sr, sc, sms), blocks,
                          smem, tile_rows, tile_cols);
}
