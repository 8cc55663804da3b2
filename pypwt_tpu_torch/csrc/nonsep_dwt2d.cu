// K16 / K17: one periodized non-separable 2D DWT level and its inverse,
// float32 or float64, with four dense hlen x hlen filters.
//
// Replace the TPU kernels pypwt_tpu/ops/nonsep_pallas.py::_build_ns_dwt2d
// (:147, behind nsdwt2d_fused) and ::_build_ns_idwt2d (:238, behind
// insdwt2d_fused).
//
// Maps (pypwt_tpu/core/nonsep.py:164-280; the reference's
// nonseparable.cu:114-225), any hlen <= 40, the first filter index along
// axis -2:
//   K16: out_b[i, j] = sum_{k,l} F_b[hlen-1-k, hlen-1-l]
//                      * x[(2i + k - lp) mod Mr, (2j + l - lp) mod Mc],
//        lp = hlen - 1 - hlen/2, for the four analysis filters b = a, h, v,
//        d, where an odd axis of n samples is extended by its last sample
//        (M = n + 1, wrap_ext) and an even one has M = n; (B?, Nr, Nc) in,
//        four (B?, ceil(Nr/2), ceil(Nc/2)) out;
//   K17: the 4-phase polyphase inverse, out[2m + py, 2n + px] =
//        sum_b sum_{jy,jx < h2} R_b[ty(py, jy), ty(px, jx)]
//              * p_b[(m + delta(py) + jy - c) mod Lr,
//                    (n + delta(px) + jx - c) mod Lc]
//        over the planes p_b = a, h, v, d of (B?, Lr, Lc) and the synthesis
//        filters R_b, with h2, c, delta and ty(p, j) = hlen - 1 - 2j - off(p)
//        of the separable polyphase (common.cuh, Polyphase), for the pixels
//        inside the output (B?, Nr, Nc) (a crop of 2Lr x 2Lc on an odd
//        level); hlen 1 has no polyphase tap and gives zeros.
//
// The TPU kernels factor each filter into rank-1 terms by SVD because
// Mosaic lowers no dense 2D stencil; these are the direct stencils, which
// need no factoring and take every bank.
//
// Bound: both move 8 bytes per full-size pixel (K16: 4 in and 4 out over
// the four quarter planes; K17 the reverse) and do hlen^2 FMAs per
// full-size pixel (K16: 4 hlen^2 per output position, K17: 4 (hlen/2)^2
// per output pixel), hlen^2 / 4 flop per byte: memory-bound below the
// H100's float32 ridge of ~20 flop per byte, i.e. for hlen <= 8, and
// FMA-bound above. At 2048^2 and hlen 6: 32 MiB, 10.0 us at 3.35 TB/s,
// against 0.30 GFLOP, 4.5 us at 67 TFLOP/s.
//
// Design (K16): each block owns a TR x TC tile of the four outputs; it
// stages the (2TR + hlen - 2) x (2TC + hlen - 2) input window in shared
// memory once, split into even and odd columns so that a warp's decimating
// reads hit consecutive words, and the bank as float4 [k][l] (one tap of
// each filter): one broadcast float4 load feeds the four subbands' FMAs of
// a window sample, and each thread computes two output rows, so a tap load
// feeds eight. Odd sizes only change the staging gather's index (a template
// flag). Design (K17): each block owns a 2TR x 2TC output tile; it stages
// the (TR + h2) x (TC + h2) windows of the four planes as one float4 per
// coefficient (a, h, v, d) and the taps as float4 [phase][jy][jx], so that
// one coefficient load and one tap load feed four FMAs. Both: the batch is
// the grid's z axis, row tiles its y axis, in chunks where a level holds
// more than a grid's 65535 (launch_chunks); the bank is a kernel parameter
// struct (Bank2D), so two launches with different banks cannot race. The
// float64 instances (pypwt_ns_dwt2d_f64, pypwt_ins_dwt2d_f64) read a bank
// the wrapper uploaded once (BankPtr; pypwt_ns_bank_f64 lays it out), and
// stage twice the bytes: up to 109 KB (K16) and 111 KB (K17) at hlen 40.

#include "common.cuh"

namespace pypwt {
namespace {

// K16: TR x TC outputs per block, each thread two rows TR/2 apart.
constexpr int TR = 16;
constexpr int TC = 32;
static_assert(TR * TC == 2 * kThreads, "two outputs per thread");

__host__ __device__ inline int win_rows(int hlen) { return 2 * TR + hlen - 2; }
// window columns of one parity: at least ceil((2TC + hlen - 2) / 2)
__host__ __device__ inline int win_half_cols(int hlen) {
  return TC + (hlen + 1) / 2 - 1;
}

template <class T>
inline size_t ns_dwt_smem(int hlen) {
  return sizeof(T) * 2 * win_rows(hlen) * win_half_cols(hlen) +
         sizeof(Vec4<T>) * hlen * hlen;
}

template <class T, bool kOdd, class Bank>
__global__ void __launch_bounds__(kThreads)
ns_dwt2d_kernel(const T* __restrict__ x, T* __restrict__ a,
                T* __restrict__ h, T* __restrict__ v, T* __restrict__ d,
                int nr, int nc, Bank bank, int hlen, int y0) {
  using V4 = Vec4<T>;
  const int wr = win_rows(hlen), wc2 = win_half_cols(hlen);
  V4* s_f = dynamic_smem<V4>();  // [hlen][hlen] reversed taps, one per filter
  T* s_ev = reinterpret_cast<T*>(s_f + hlen * hlen);  // [wr][wc2]
  T* s_od = s_ev + wr * wc2;                          // [wr][wc2]

  const int tid = threadIdx.x;
  const int lr = (nr + 1) >> 1, lc = (nc + 1) >> 1;
  const int r0 = (y0 + blockIdx.y) * TR, c0 = blockIdx.x * TC;
  const int lp = analysis_lpad(hlen);
  const T* xb = x + static_cast<long long>(blockIdx.z) * nr * nc;

  const int n2 = hlen * hlen;
  T* f = reinterpret_cast<T*>(s_f);
  for (int i = tid; i < 4 * n2; i += kThreads) f[i] = bank.f[i];
  const int row0 = 2 * r0 - lp, col0 = 2 * c0 - lp;
  for (int i = tid; i < wr * 2 * wc2; i += kThreads) {
    const int r = i / (2 * wc2), c = i - r * (2 * wc2);
    const int sr = kOdd ? wrap_ext(row0 + r, nr) : wrap(row0 + r, nr);
    const int sc = kOdd ? wrap_ext(col0 + c, nc) : wrap(col0 + c, nc);
    (c & 1 ? s_od : s_ev)[r * wc2 + (c >> 1)] =
        xb[static_cast<long long>(sr) * nc + sc];
  }
  __syncthreads();

  // Output (r, c) reads window sample (2r + k, 2c + l): column 2c + l is
  // even column c + l/2 or odd column c + (l-1)/2.
  const int tx = tid % TC, ty = tid / TC;
  V4 s0{0, 0, 0, 0}, s1 = s0;
  for (int k = 0; k < hlen; ++k) {
    const int w0 = (2 * ty + k) * wc2 + tx;
    const int w1 = w0 + TR * wc2;  // row ty + TR/2: window row + TR
    const V4* fk = s_f + k * hlen;
    for (int l = 0; l < hlen; ++l) {
      const T* src = (l & 1) ? s_od : s_ev;
      const T u = src[w0 + (l >> 1)], w = src[w1 + (l >> 1)];
      const V4 t = fk[l];
      s0.x = fmadd(u, t.x, s0.x);
      s0.y = fmadd(u, t.y, s0.y);
      s0.z = fmadd(u, t.z, s0.z);
      s0.w = fmadd(u, t.w, s0.w);
      s1.x = fmadd(w, t.x, s1.x);
      s1.y = fmadd(w, t.y, s1.y);
      s1.z = fmadd(w, t.z, s1.z);
      s1.w = fmadd(w, t.w, s1.w);
    }
  }
  const long long ob = static_cast<long long>(blockIdx.z) * lr * lc;
  const int ocol = c0 + tx;
  const V4 sums[2] = {s0, s1};
  for (int q = 0; q < 2; ++q) {
    const int orow = r0 + ty + q * (TR / 2);
    if (orow >= lr || ocol >= lc) continue;
    const long long o = ob + static_cast<long long>(orow) * lc + ocol;
    a[o] = sums[q].x;
    h[o] = sums[q].y;
    v[o] = sums[q].z;
    d[o] = sums[q].w;
  }
}

// K17: 2 SR x 2 SC output pixels per block.
constexpr int SR = 16;
constexpr int SC = 32;

template <class T>
inline size_t ns_idwt_smem(int hlen) {
  const size_t h2 = hlen / 2;
  return sizeof(Vec4<T>) * ((SR + h2) * (SC + h2) + 4 * h2 * h2);
}

template <class T, class Bank>
__global__ void __launch_bounds__(kThreads)
ns_idwt2d_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ v, const T* __restrict__ d,
                 T* __restrict__ out, int lr, int lc, int nr, int nc,
                 Bank phases, int hlen, int y0) {
  using V4 = Vec4<T>;
  const Polyphase ph(hlen);
  const int h2 = ph.h2, c = ph.c;
  const int wr = SR + h2, ww = SC + h2;
  V4* s_c = dynamic_smem<V4>();  // [wr][ww] (a, h, v, d) per coefficient
  V4* s_g = s_c + wr * ww;       // [py*2+px][jy][jx] one tap of each filter

  const int tid = threadIdx.x;
  const int m0 = (y0 + blockIdx.y) * SR, n0 = blockIdx.x * SC;
  const long long ib = static_cast<long long>(blockIdx.z) * lr * lc;

  T* g = reinterpret_cast<T*>(s_g);
  for (int i = tid; i < 16 * h2 * h2; i += kThreads) g[i] = phases.f[i];
  // window origin: coefficient (m0 - c, n0 - c)
  for (int i = tid; i < wr * ww; i += kThreads) {
    const int r = i / ww, q = i - r * ww;
    const long long o = ib + static_cast<long long>(wrap(m0 - c + r, lr)) * lc +
                        wrap(n0 - c + q, lc);
    s_c[i] = V4{a[o], h[o], v[o], d[o]};
  }
  __syncthreads();

  const long long obase = static_cast<long long>(blockIdx.z) * nr * nc;
  for (int i = tid; i < 4 * SR * SC; i += kThreads) {
    const int yy = i / (2 * SC), xx = i - yy * (2 * SC);
    const int orow = 2 * m0 + yy, ocol = 2 * n0 + xx;
    if (orow >= nr || ocol >= nc) continue;
    const int py = yy & 1, px = xx & 1;
    const V4* cw =
        s_c + ((yy >> 1) + ph.delta(py)) * ww + (xx >> 1) + ph.delta(px);
    const V4* gw = s_g + (py * 2 + px) * h2 * h2;
    T s = 0;
    for (int jy = 0; jy < h2; ++jy) {
      for (int jx = 0; jx < h2; ++jx) {
        const V4 p = cw[jy * ww + jx], t = gw[jy * h2 + jx];
        s = fmadd(p.x, t.x, s);
        s = fmadd(p.y, t.y, s);
        s = fmadd(p.z, t.z, s);
        s = fmadd(p.w, t.w, s);
      }
    }
    out[obase + static_cast<long long>(orow) * nc + ocol] = s;
  }
}

// The analysis bank reversed along both axes: [k][l][b] = F_b[hlen-1-k,
// hlen-1-l] (filters: [b][k][l], as make_bank takes them).
template <class T>
Bank2DT<T> reversed_bank(const T* filters, int hlen) {
  Bank2DT<T> bank{};
  const int n2 = hlen * hlen;
  for (int b = 0; b < 4; ++b)
    for (int k = 0; k < hlen; ++k)
      for (int l = 0; l < hlen; ++l)
        bank.f[4 * (k * hlen + l) + b] =
            filters[b * n2 + (hlen - 1 - k) * hlen + (hlen - 1 - l)];
  return bank;
}

// The synthesis bank by output phase: [py*2+px][jy][jx][b] =
// R_b[ty(py, jy), ty(px, jx)] (4 * 4 * h2^2 <= 4 * 40^2 values).
template <class T>
Bank2DT<T> phase_bank(const T* filters, int hlen) {
  Bank2DT<T> bank{};
  const Polyphase ph(hlen);
  const int h2 = ph.h2, n2 = hlen * hlen;
  for (int py = 0; py < 2; ++py)
    for (int px = 0; px < 2; ++px)
      for (int jy = 0; jy < h2; ++jy)
        for (int jx = 0; jx < h2; ++jx)
          for (int b = 0; b < 4; ++b)
            bank.f[4 * (((py * 2 + px) * h2 + jy) * h2 + jx) + b] =
                filters[b * n2 + ph.tap(py, jy) * hlen + ph.tap(px, jx)];
  return bank;
}

bool dwt_args_ok(int batch, int nr, int nc, int hlen) {
  return hlen >= 1 && hlen <= kMaxTaps && nr >= 1 && nc >= 1 &&
         nr <= 0x3fffffff && nc <= 0x3fffffff && batch >= 1;
}

bool idwt_args_ok(int batch, int lr, int lc, int nr, int nc, int hlen) {
  return dwt_args_ok(batch, nr, nc, hlen) && lr >= 1 && lc >= 1 &&
         lr <= 0x3fffffff && lc <= 0x3fffffff;
}

// K16 with its bank (Bank2D by value, or BankPtr to device memory).
template <class T, class Bank>
int launch_dwt(const T* x, T* a, T* h, T* v, T* d, int batch, int nr, int nc,
               const Bank& bank, int hlen, int device, void* stream) {
  if (!dwt_args_ok(batch, nr, nc, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = ((nr | nc) & 1) ? ns_dwt2d_kernel<T, true, Bank>
                                      : ns_dwt2d_kernel<T, false, Bank>;
  const size_t smem = ns_dwt_smem<T>(hlen);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lr = (nr + 1) / 2, lc = (nc + 1) / 2;
  launch_chunks((lc + TC - 1) / TC, (lr + TR - 1) / TR, batch,
                [&](dim3 grid, int y0, int z0) {
                  const long long pi = static_cast<long long>(z0) * nr * nc;
                  const long long po = static_cast<long long>(z0) * lr * lc;
                  kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
                      x + pi, a + po, h + po, v + po, d + po, nr, nc, bank,
                      hlen, y0);
                });
  return static_cast<int>(cudaGetLastError());
}

// K17 with its phase bank.
template <class T, class Bank>
int launch_idwt(const T* a, const T* h, const T* v, const T* d, T* out,
                int batch, int lr, int lc, int nr, int nc, const Bank& bank,
                int hlen, int device, void* stream) {
  if (!idwt_args_ok(batch, lr, lc, nr, nc, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = ns_idwt2d_kernel<T, Bank>;
  const size_t smem = ns_idwt_smem<T>(hlen);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // output tiles of 2SR x 2SC pixels
  launch_chunks((nc + 2 * SC - 1) / (2 * SC), (nr + 2 * SR - 1) / (2 * SR),
                batch, [&](dim3 grid, int y0, int z0) {
                  const long long pi = static_cast<long long>(z0) * lr * lc;
                  const long long po = static_cast<long long>(z0) * nr * nc;
                  kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
                      a + pi, h + pi, v + pi, d + pi, out + po, lr, lc, nr,
                      nc, bank, hlen, y0);
                });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pypwt

// All return a cudaError_t; they launch on `stream`, do not synchronise
// and allocate nothing. dec/rec: host arrays of 4 * hlen * hlen floats,
// [b][k][l] for the filters a, h, v, d.
// K16: a, h, v, d of (batch, ceil(nr/2), ceil(nc/2)).
extern "C" int pypwt_ns_dwt2d(const float* x, float* a, float* h, float* v,
                              float* d, int batch, int nr, int nc,
                              const float* dec, int hlen, int device,
                              void* stream) {
  using namespace pypwt;
  if (!dwt_args_ok(batch, nr, nc, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dwt(x, a, h, v, d, batch, nr, nc, reversed_bank(dec, hlen),
                    hlen, device, stream);
}

// K17: out of (batch, nr, nc) from planes of (batch, lr, lc).
extern "C" int pypwt_ins_dwt2d(const float* a, const float* h, const float* v,
                               const float* d, float* out, int batch, int lr,
                               int lc, int nr, int nc, const float* rec,
                               int hlen, int device, void* stream) {
  using namespace pypwt;
  if (!idwt_args_ok(batch, lr, lc, nr, nc, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_idwt(a, h, v, d, out, batch, lr, lc, nr, nc,
                     phase_bank(rec, hlen), hlen, device, stream);
}

// The float64 kernels' bank layouts on the host, for the wrapper to upload
// once: `out` receives 4 * hlen * hlen doubles of the layout `kind` of
// the filters ([b][k][l]): 0 the reversed analysis bank (K16), 1 the phase
// bank (K17), 2 the interleaved bank (K18a) and 3 the same times 1/4
// (K18b). Returns 0, or cudaErrorInvalidValue.
extern "C" int pypwt_ns_bank_f64(const double* filters, int hlen, int kind,
                                 double* out) {
  using namespace pypwt;
  if (hlen < 1 || hlen > kMaxTaps || kind < 0 || kind > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Bank2DT<double> bank =
      kind == 0   ? reversed_bank(filters, hlen)
      : kind == 1 ? phase_bank(filters, hlen)
                  : make_bank(filters, hlen, kind == 2 ? 1.0 : 0.25);
  std::copy(bank.f, bank.f + 4 * hlen * hlen, out);
  return 0;
}

// The float64 K16/K17: `bank` is the device copy of pypwt_ns_bank_f64's
// layout 0 (K16) or 1 (K17).
extern "C" int pypwt_ns_dwt2d_f64(const double* x, double* a, double* h,
                                  double* v, double* d, int batch, int nr,
                                  int nc, const double* bank, int hlen,
                                  int device, void* stream) {
  return pypwt::launch_dwt(x, a, h, v, d, batch, nr, nc,
                           pypwt::BankPtr<double>{bank}, hlen, device,
                           stream);
}

extern "C" int pypwt_ins_dwt2d_f64(const double* a, const double* h,
                                   const double* v, const double* d,
                                   double* out, int batch, int lr, int lc,
                                   int nr, int nc, const double* bank,
                                   int hlen, int device, void* stream) {
  return pypwt::launch_idwt(a, h, v, d, out, batch, lr, lc, nr, nc,
                            pypwt::BankPtr<double>{bank}, hlen, device,
                            stream);
}
