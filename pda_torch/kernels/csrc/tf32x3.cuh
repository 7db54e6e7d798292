// Tensor-core helpers for float32 accuracy on Hopper (sm_90a): the 3xTF32
// product on mma.sync, and cp.async stages into shared memory.
//
// 3xTF32. A float32 x splits into hi = tf32(x) and lo = tf32(x - hi), both
// rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero; the
// port's pda_torch/kernels/tf32x3.py does the same on the CPU). A product a*b is
// then lo_a*hi_b + hi_a*lo_b + hi_a*hi_b: three TF32 tensor-core products,
// the small ones first; the dropped lo_a*lo_b is about 2^-22 of a*b. One
// TF32 product alone keeps about three decimal digits.
//
// Accumulation. The tensor cores add into their float32 accumulator with
// round-toward-zero, so a long chain of mma.sync drifts: on an H100, one
// chain over K = 4,608 (the dgrad's depth at 512 channels) is 3.7e-5 of its
// largest value off float64 on normal data, over K = 65,536 4.6e-4 (up to
// 5.5e-5 and 4.9e-4 on all-positive data). Callers therefore run
// short chains (<= 18 k-steps of 8) into a zeroed fragment and add each into
// a float32 sum with ordinary round-to-nearest adds (flush); chains of 8
// k-steps stay within 1.5e-6 of float64 at every depth measured (up to
// K = 65,536), closer than one float32 FMA chain (9.3e-6 there).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

// mma.sync.m16n8k8 fragments of one warp (lane = 4 * group + quad):
//   A (16 x 8, row-major): a[0] (group, quad), a[1] (group + 8, quad),
//                          a[2] (group, quad + 4), a[3] (group + 8, quad + 4)
//   B (8 x 8, col):        b[0] (k = quad, n = group), b[1] (k = quad + 4)
//   C (16 x 8):            c[0] (group, 2 quad), c[1] (group, 2 quad + 1),
//                          c[2] (group + 8, 2 quad), c[3] (group + 8, 2 quad + 1)
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi = tf32(x): the bits of cvt.rna.tf32.f32 (to nearest, ties away from
// zero) for finite x, as two integer ops; the instruction itself adds an
// inf/NaN guard of three more. lo = tf32(x - hi) as the mma reads it: the
// tensor cores ignore the low 13 bits, so adding half a unit is enough.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// A fragment from a[0..3] and a B fragment from b[0..1], in the order above.
__device__ __forceinline__ void split(float a0, float a1, float a2, float a3,
                                      FragA& f) {
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void split(float b0, float b1, FragB& f) {
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// acc[f * stride] += chain[f]; chain = 0: the round-to-nearest flush of a
// short chain into float32 sums kept in shared memory (one float4 a
// fragment, each thread its own, so no barrier is needed).
template <int N>
__device__ __forceinline__ void flush(float4* acc, int stride, float (&chain)[N][4]) {
#pragma unroll
  for (int f = 0; f < N; ++f) {
    float4 v = acc[f * stride];
    v.x += chain[f][0];
    v.y += chain[f][1];
    v.z += chain[f][2];
    v.w += chain[f][3];
    acc[f * stride] = v;
#pragma unroll
    for (int j = 0; j < 4; ++j) chain[f][j] = 0.f;
  }
}

// cp.async of V floats (V = 4: 16 bytes, both addresses 16-byte aligned; V =
// 1: 4 bytes); with valid false nothing is read and dst gets zeros.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * V : 0;
  if (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
