// Tensor-core helpers for bf16 operands on Hopper (sm_90a): mma.sync
// m16n8k16 with float32 accumulators, and the packing of two bf16 values
// into the 32-bit registers its fragments take.
//
// Numerics (pda's kernels, pda/kernels/conv_block.py, mc_consensus.py):
// operands in bf16, products accumulated in float32, the bias added in
// float32, one rounding to bf16 (to nearest even) per layer. A bf16 product
// is exact in float32, so what a kernel can add is the accumulation's
// rounding: the tensor cores accumulate with round-toward-zero, so callers
// keep their chains short and flush them into float32 sums with ordinary
// round-to-nearest adds, as the 3xTF32 path does (tf32x3.cuh flush).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bf {

using bf16 = __nv_bfloat16;

// mma.sync.m16n8k16 fragments of one warp (lane = 4 * group + quad), two
// bf16 a register, the lower k (or column) in the low half:
//   A (16 x 16, row): a[0] (group, 2 quad + {0,1}), a[1] (group + 8, 2 quad + {0,1}),
//                     a[2] (group, 2 quad + 8 + {0,1}), a[3] (group + 8, 2 quad + 8 + {0,1})
//   B (16 x 8, col):  b[0] (k = 2 quad + {0,1}, n = group), b[1] (k = 2 quad + 8 + {0,1})
//   C (16 x 8, f32):  as m16n8k8's: c[0..1] (group, 2 quad + {0,1}),
//                     c[2..3] (group + 8, 2 quad + {0,1})
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// {lo, hi} rounded to bf16 (to nearest even) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float hi(uint32_t r) { return __uint_as_float(r & 0xFFFF0000u); }

// The low halves of x and y as one register {x.lo, y.lo}; the high halves {x.hi, y.hi}.
__device__ __forceinline__ uint32_t lows(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x5410);
}
__device__ __forceinline__ uint32_t highs(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x7632);
}

// cp.async of 16 bytes (8 bf16, both addresses 16-byte aligned); with valid
// false nothing is read and dst gets zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

}  // namespace bf
