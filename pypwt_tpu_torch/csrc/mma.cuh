// Warp-level tensor-core products (mma.sync) for the banded level kernels
// K5/K6 (tc_dwt2d.cu) and K11a/K11b (tc_swt2d.cu), in two precisions:
//
//   Tf32 ("highest"): 3xTF32. m16n8k8 TF32 products with float32
//     accumulation; each operand x is split into big = tf32(x) and
//     small = tf32(x - big) (cvt.rna), and a product is
//     small*big + big*small + big*big. One-pass TF32 keeps ~10 bits and
//     fails the reference's accuracy envelope; three passes keep ~21.
//   Bf16 ("bf16"): one m16n8k16 bf16 product with float32 accumulation,
//     both operands rounded to bf16 (__float2bfloat16_rn).
// The tensor cores truncate where they add to their accumulator, so a
// k-step's products start from zero (the two small terms apart from the
// big one) and join the running sum in rounded float32 adds, as in
// Ootomo and Yokota's 3xTF32 (2022): chained into one accumulator, the
// sym8 L3 roundtrip of a 0..255 frame missed the reference's 7e-4.
//
// A fragment is built from an accessor elem(m, k) of the 16 x kK tile of A
// and b(k, n) of the kK x 8 tile of B, in the register layouts of the PTX
// ISA ("Matrix Fragments for mma.m16n8k8" / "mma.m16n8k16"): with
// g = lane / 4 and t = lane % 4,
//   TF32 A: reg i holds (g + 8 (i & 1), t + 4 (i >> 1));  B: reg i (t + 4i, g)
//   BF16 A: reg i holds (g + 8 (i & 1), 2t + 8 (i >> 1) + {0, 1});
//           B: reg i holds (2t + 8i + {0, 1}, g), the lower index in the
//           lower 16 bits
//   C (both): c[i] is (g + 8 (i >> 1), 2t + (i & 1)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pypwt {
namespace mma {

#ifdef PYPWT_MMA_STANDIN
// A CPU rehearsal of the kernels (one std::thread per CUDA thread) links
// scalar stand-ins of these five functions; nvcc never defines the macro.
void split_tf32(float x, uint32_t& big, uint32_t& small);
uint32_t pack_bf16(float lo, float hi);
void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]);
void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]);
int lane_id();
#else
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// Asynchronous copies from device to shared memory: one float
// (cp.async.ca, 4 bytes) or four (16 bytes, both addresses 16-byte
// aligned: cp.async.cg, through L2 only, or cp_async16_ca, cached in L1
// too, which the 1D windows of tc_dwt1d.cu measured faster in "bf16").
// No register holds the samples, so a thread can have all of its window
// in flight at once. A thread commits its copies as one
// group and waits until at most kPending of its groups are pending; after
// the wait, a __syncthreads makes every thread's copies visible to the
// block. The CPU rehearsal copies at once and waits for nothing. The
// float64 windows of the tap-loop syntheses (swt2d.cu, level2d.cuh's
// pair::tile) copy one double (cp_async8, 8 bytes) or two (cp_async16 on
// doubles).
#ifdef PYPWT_MMA_STANDIN
inline void cp_async4(float* dst, const float* src) { *dst = *src; }
inline void cp_async8(double* dst, const double* src) { *dst = *src; }
inline void cp_async16(float* dst, const float* src) {
  for (int e = 0; e < 4; ++e) dst[e] = src[e];
}
inline void cp_async16(double* dst, const double* src) {
  dst[0] = src[0];
  dst[1] = src[1];
}
inline void cp_async16_ca(float* dst, const float* src) {
  cp_async16(dst, src);
}
inline void cp_async_commit() {}
template <int kPending>
inline void cp_async_wait() {}
#else
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16_ca(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  cp_async16(reinterpret_cast<float*>(dst),
             reinterpret_cast<const float*>(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}
#endif

// One sample of either type (the tap-loop windows of swt2d.cu and
// level2d.cuh): cp_async4 or cp_async8.
__device__ __forceinline__ void cp_async_sample(float* dst,
                                                const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void cp_async_sample(double* dst,
                                                const double* src) {
  cp_async8(dst, src);
}

struct Tf32 {
  static constexpr int kK = 8;  // depth of one product
  struct A {
    uint32_t big[4], small[4];
  };
  struct B {
    uint32_t big[2], small[2];
  };
  template <class Elem>
  __device__ static __forceinline__ A load_a(Elem elem) {
    const int g = lane_id() >> 2, t = lane_id() & 3;
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(elem(g + 8 * (i & 1), t + 4 * (i >> 1)), a.big[i],
                 a.small[i]);
    return a;
  }
  template <class Val>
  __device__ static __forceinline__ B load_b(Val val) {
    const int g = lane_id() >> 2, t = lane_id() & 3;
    B b;
#pragma unroll
    for (int i = 0; i < 2; ++i) split_tf32(val(t + 4 * i, g), b.big[i], b.small[i]);
    return b;
  }
  __device__ static __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    float fix[4] = {0.f, 0.f, 0.f, 0.f}, main[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(fix, a.small, b.big);
    mma_tf32(fix, a.big, b.small);
    mma_tf32(main, a.big, b.big);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += main[i] + fix[i];
  }
};

struct Bf16 {
  static constexpr int kK = 16;
  struct A {
    uint32_t v[4];
  };
  struct B {
    uint32_t v[2];
  };
  template <class Elem>
  __device__ static __forceinline__ A load_a(Elem elem) {
    const int g = lane_id() >> 2, t = lane_id() & 3;
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = g + 8 * (i & 1), k = 2 * t + 8 * (i >> 1);
      a.v[i] = pack_bf16(elem(m, k), elem(m, k + 1));
    }
    return a;
  }
  template <class Val>
  __device__ static __forceinline__ B load_b(Val val) {
    const int g = lane_id() >> 2, t = lane_id() & 3;
    B b;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      b.v[i] = pack_bf16(val(2 * t + 8 * i, g), val(2 * t + 8 * i + 1, g));
    return b;
  }
  __device__ static __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(part, a.v, b.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += part[i];
  }
};

// The B fragments of a band for each of kSteps k-steps: B_s[k][n] =
// tap(s kK + k, n), n an output of the 8-column tile and s kK + k its
// window sample counted from the tile's first.
template <class P, int kSteps, class Tap>
__device__ __forceinline__ void band_fragments(typename P::B (&b)[kSteps],
                                               Tap tap) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    b[s] = P::load_b([&](int k, int n) { return tap(s * P::kK + k, n); });
}

// c0 += A B0 and c1 += A B1 over the k-steps, A read by elem(k, m) (k
// counted from the tile's first window sample): one A fragment per k-step
// serves both bands.
template <class P, int kSteps, class Elem>
__device__ __forceinline__ void band_product(
    float (&c0)[4], float (&c1)[4], Elem elem,
    const typename P::B (&b0)[kSteps], const typename P::B (&b1)[kSteps]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const auto a =
        P::load_a([&](int m, int k) { return elem(s * P::kK + k, m); });
    P::mma(c0, a, b0[s]);
    P::mma(c1, a, b1[s]);
  }
}

// c += A0 B0 + A1 B1 over the k-steps: a synthesis pass of a (lo, hi) pair.
template <class P, int kSteps, class Elem0, class Elem1>
__device__ __forceinline__ void band_product_pair(
    float (&c)[4], Elem0 elem0, Elem1 elem1,
    const typename P::B (&b0)[kSteps], const typename P::B (&b1)[kSteps]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const auto a0 =
        P::load_a([&](int m, int k) { return elem0(s * P::kK + k, m); });
    P::mma(c, a0, b0[s]);
    const auto a1 =
        P::load_a([&](int m, int k) { return elem1(s * P::kK + k, m); });
    P::mma(c, a1, b1[s]);
  }
}

// One tap of a band, zero outside [0, n).
__device__ __forceinline__ float band(const float* f, int j, int n) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n) ? f[j] : 0.f;
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// A kernel instance and its dynamic shared memory.
template <class Kernel>
struct Instance {
  Kernel kernel;
  size_t smem;
};

// Row and column of C element i in its 16 x 8 tile.
__device__ __forceinline__ int c_row(int i) { return (lane_id() >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int c_col(int i) { return 2 * (lane_id() & 3) + (i & 1); }

// Leading dimension (in floats) of a shared tile of at least `cols` columns
// whose fragments are read without bank conflicts: a tile read as A
// (row-major, elem(m, k) at row m) wants ld = 4 (TF32) or 8 (BF16, pairs of
// consecutive k) mod 32; one read transposed (elem(m, k) at row k) wants
// 8 (TF32) or 4 (BF16, pairs of rows k, k + 1) mod 32.
template <class P>
__host__ __device__ constexpr int lead_dim(int cols, bool transposed) {
  const int want = (P::kK == 8) != transposed ? 4 : 8;
  const int r = ((want - cols) % 32 + 32) % 32;
  return cols + r;
}

}  // namespace mma
}  // namespace pypwt
