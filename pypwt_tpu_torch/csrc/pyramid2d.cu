// K24: every level of a float32 separable 2D analysis pyramid in one
// launch; K25: every level of its synthesis in one launch.
//
// K24 replaces the TPU kernel pypwt_tpu/ops/fused_pyramid.py::
// wavedec2_pyramid (_build_wavedec2, :168), K25 ::waverec2_pyramid
// (_build_waverec2, :308).
//
// Map: K24 is K1 (dwt2d.cu) applied L times, each level to the
// approximation of the one before (pypwt_tpu/core/dwt.py:269-280): x of
// (B?, Nr, Nc) -> a_L and the details (h, v, d) of levels 1..L, level l of
// (Nr >> l) x (Nc >> l). K25 is K2 (idwt2d.cu) applied L times, deepest
// level first (:283-298), with K2's polyphase centring at every level. The
// coverage is JAX's: an even bank of 2..40 taps, L >= 2 and 2^L dividing
// Nr and Nc, so every level's plane is even and no level needs the odd
// extension.
//
// Bound: each input read once, each output written once. K24 moves
// 4 Nr Nc bytes in and 4 Nr Nc (1 - 4^-L) out (the details of every level
// and a_L): 33.3 MB at 2048^2, L3, 9.9 us at 3.35 TB/s, against 44.0 MB for
// K1 at each level, which writes and re-reads the intermediate
// approximations. K25 moves the same the other way. The flops are those of
// K1/K2 at each level, under the float32 ridge, so both are memory-bound;
// the intermediate approximations (4 MB for the 1024^2 a_1 of a 2048^2
// frame) fit in the 50 MB L2.
//
// Design: a persistent, grid-synchronised kernel. The TPU kernel keeps a
// band's whole pyramid in VMEM and recomputes overlapping row margins; a
// block's 227 KB of shared memory holds no full band of 2048 columns, and
// margins on both axes grow as hlen 2^L (589 rows at sym20, L5), so the
// port does not carry that layout over. Instead the grid is launched
// cooperatively (cudaLaunchCooperativeKernel), sized from the occupancy of
// the kernel at its shared memory (every block co-resident), and each level
// is a grid-stride loop over 32 x 32 output tiles of ana::tile, the body
// K1 ran before its pair body and K19 still runs (K25: 64 x 64 of
// syn::tile, the body K2 ran before its pair body; level2d.cuh), followed
// by a grid-wide barrier
// (cooperative_groups::this_grid().sync()) before the next level reads what
// this one wrote. Blocks without a tile at a deep level go straight to the
// barrier. The intermediate approximations go to a device scratch that the
// wrapper allocates, one region per level (no buffer is reused within a
// launch), and every read of the kernel goes through L2 (ld.global.cg), so
// that no level reads data of an earlier one through the non-coherent
// read-only path. The batch is part of the tile index, so one launch takes
// a stack of any size; every offset is 64-bit. Taps are kernel parameters,
// as in K1/K2.

#include <cooperative_groups.h>

#include "level2d.cuh"

namespace pypwt {
namespace {

// At most 16 levels: 2^L divides both plane sizes, so a 17th level needs a
// plane of 2^34 samples, more than a card holds.
constexpr int kMaxLevels = 16;

// The pyramid's planes: approx[0] is the image (K24's input, K25's
// output), approx[l] the approximation of level l (1 <= l < L: scratch;
// approx[L]: K24's output a_L, K25's input), detail[3(l-1) + k] the
// detail k (h, v, d) of level l.
struct PyramidPlanes {
  float* approx[kMaxLevels + 1];
  float* detail[3 * kMaxLevels];
};

// The tile (ty, tx) of plane b of tile t of a level of `cols` tile columns
// and `per_plane` tiles per plane. Tile counts are 32-bit: a level holds at
// most B Nr Nc / 1024 tiles, under 2^31 for any tensor a card holds.
struct TileOf {
  int b, ty, tx;
  __device__ TileOf(int t, int per_plane, int cols)
      : b(t / per_plane),
        ty((t - b * per_plane) / cols),
        tx(t - b * per_plane - ty * cols) {}
};

__global__ void __launch_bounds__(kThreads)
wavedec2_kernel(PyramidPlanes p, int batch, int nr, int nc, int levels,
                Taps taps, int hlen) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float* smem = dynamic_smem<float>();
  float* f_lo = ana::taps(smem, hlen);
  load_reversed_taps(taps, hlen, f_lo, f_lo + kMaxTaps);
  for (int l = 0; l < levels; ++l) {
    // level l + 1: plane approx[l] of rows x cols -> four of lr x lc
    const int rows = nr >> l, cols = nc >> l, lr = rows >> 1, lc = cols >> 1;
    const int tc = (lc + ana::TC - 1) / ana::TC;
    const int per_plane = tc * ((lr + ana::TR - 1) / ana::TR);
    for (int t = blockIdx.x; t < per_plane * batch; t += gridDim.x) {
      const TileOf k(t, per_plane, tc);
      const long long pi = static_cast<long long>(k.b) * rows * cols;
      const long long po = static_cast<long long>(k.b) * lr * lc;
      ana::tile<float, false, false, kNone, true>(
          p.approx[l] + pi, p.approx[l + 1] + po, p.detail[3 * l] + po,
          p.detail[3 * l + 1] + po, p.detail[3 * l + 2] + po, rows, cols,
          hlen, k.ty * ana::TR, k.tx * ana::TC, 0, 0, 0.f, smem);
    }
    if (l + 1 < levels) grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads)
waverec2_kernel(PyramidPlanes p, int batch, int nr, int nc, int levels,
                Taps taps, int hlen) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float* smem = dynamic_smem<float>();
  float* g_lo = syn::taps<float>(smem, hlen);
  load_polyphase_taps(taps, hlen, g_lo, g_lo + 2 * kHalfTaps);
  for (int l = levels; l >= 1; --l) {
    // level l: four planes of lr x lc -> approx[l - 1] of rows x cols
    const int rows = nr >> (l - 1), cols = nc >> (l - 1);
    const int lr = rows >> 1, lc = cols >> 1;
    const int tc = (cols + 2 * syn::TC - 1) / (2 * syn::TC);
    const int per_plane = tc * ((rows + 2 * syn::TR - 1) / (2 * syn::TR));
    const int k0 = 3 * (l - 1);
    for (int t = blockIdx.x; t < per_plane * batch; t += gridDim.x) {
      const TileOf k(t, per_plane, tc);
      const long long pi = static_cast<long long>(k.b) * lr * lc;
      const long long po = static_cast<long long>(k.b) * rows * cols;
      syn::tile<float, true>(
          p.approx[l] + pi, p.detail[k0] + pi, p.detail[k0 + 1] + pi,
          p.detail[k0 + 2] + pi, p.approx[l - 1] + po, lr, lc, rows, cols,
          hlen, 2 * syn::TR * k.ty, 2 * syn::TC * k.tx, smem);
    }
    if (l > 1) grid.sync();
  }
}

template <class T>
struct Ident {
  using type = T;
};

// One cooperative launch of `kernel` on `blocks` blocks of kThreads.
template <class... Params>
cudaError_t launch_cooperative(void (*kernel)(Params...), int blocks,
                               size_t smem, cudaStream_t stream,
                               typename Ident<Params>::type... args) {
  void* argv[] = {static_cast<void*>(&args)...};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(blocks), dim3(kThreads), argv, smem,
                                     stream);
}

using PyramidKernel = void (*)(PyramidPlanes, int, int, int, int, Taps, int);

// Sizes the grid from the kernel's occupancy at `smem`
// bytes (capped at the tiles of the first level, the most of any level)
// and launches it once.
int launch(PyramidKernel kernel, size_t smem, long long first_tiles,
           const PyramidPlanes& planes, int batch, int nr, int nc,
           int levels, const Taps& taps, int hlen, int device,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0, coop = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int blocks = static_cast<int>(
      std::min<long long>(static_cast<long long>(per_sm) * sms, first_tiles));
  err = launch_cooperative(kernel, blocks, smem,
                           static_cast<cudaStream_t>(stream), planes, batch,
                           nr, nc, levels, taps, hlen);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool covered(int batch, int nr, int nc, int levels, int hlen) {
  return batch >= 1 && nr >= 1 && nc >= 1 && nr <= 0x3fffffff &&
         nc <= 0x3fffffff && levels >= 2 && levels <= kMaxLevels &&
         nr % (1 << levels) == 0 && nc % (1 << levels) == 0 && hlen >= 2 &&
         hlen <= kMaxTaps && hlen % 2 == 0 &&
         static_cast<long long>(batch) * nr * nc / 1024 < 0x7fffffff;
}

PyramidPlanes planes_of(float* image, float* const* approx,
                        float* const* detail, int levels) {
  PyramidPlanes p{};
  p.approx[0] = image;
  for (int l = 1; l <= levels; ++l) p.approx[l] = approx[l - 1];
  for (int k = 0; k < 3 * levels; ++k) p.detail[k] = detail[k];
  return p;
}

long long div_up(long long n, long long m) { return (n + m - 1) / m; }

}  // namespace
}  // namespace pypwt

// Both return a cudaError_t; they launch once on `stream`, do not
// synchronise and allocate nothing. approx is a host array of `levels`
// device pointers, a_1 .. a_L (a_l of (batch, nr >> l, nc >> l); a_1 ..
// a_{L-1} are scratch the kernel writes and reads), detail a host array of
// 3 levels device pointers, h, v, d of level 1, then of level 2, ...
// dec_lo/dec_hi (rec_lo/rec_hi) are host arrays of hlen float values.
// K24: x of (batch, nr, nc) -> a_L and the details.
extern "C" int pypwt_wavedec2_pyramid(const float* x, float* const* approx,
                                      float* const* detail, int batch, int nr,
                                      int nc, int levels, const float* dec_lo,
                                      const float* dec_hi, int hlen,
                                      int device, void* stream) {
  using namespace pypwt;
  if (!covered(batch, nr, nc, levels, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps taps = make_taps(dec_lo, dec_hi, hlen);
  const long long tiles = batch * div_up(nr / 2, ana::TR) *
                          div_up(nc / 2, ana::TC);
  return launch(wavedec2_kernel, ana::smem_bytes<float>(hlen), tiles,
                planes_of(const_cast<float*>(x), approx, detail, levels),
                batch, nr, nc, levels, taps, hlen, device, stream);
}

// K25: a_L and the details -> out of (batch, nr, nc).
extern "C" int pypwt_waverec2_pyramid(float* out, float* const* approx,
                                      float* const* detail, int batch, int nr,
                                      int nc, int levels, const float* rec_lo,
                                      const float* rec_hi, int hlen,
                                      int device, void* stream) {
  using namespace pypwt;
  if (!covered(batch, nr, nc, levels, hlen))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps taps = make_taps(rec_lo, rec_hi, hlen);
  const long long tiles = batch * div_up(nr, 2 * syn::TR) *
                          div_up(nc, 2 * syn::TC);
  return launch(waverec2_kernel, syn::smem_bytes<float>(hlen), tiles,
                planes_of(out, approx, detail, levels), batch, nr, nc,
                levels, taps, hlen, device, stream);
}
