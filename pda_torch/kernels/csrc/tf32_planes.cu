// The float32 ConvBlock's per-call weight copy, with the 3xTF32 split of
// its weights (tf32x3.cuh): three planes of (9, R, K), [tap][r][k] with k
// contiguous, as the layer bodies read a kernel:
//   plane 0  the kernel itself (conv3x3_tc.cuh's mma.sync body and the
//            entry layer read it and split it themselves);
//   plane 1  hi = tf32(w), cvt.rna.tf32.f32's rounding (to nearest, ties
//            away from zero); inf and NaN pass unchanged;
//   plane 2  lo = tf32(w - hi);
// read by the wgmma body (conv3x3_wgmma_tf32.cuh), which splits only the
// activations in the kernel. The forward reads the kernel as HWOI (the HWIO
// argument transposed: r = Cout, k = Cin), the dgrad as HWIO (r = Cin, k =
// Cout). Replaces no TPU kernel: pda's kernels take float32 weights whole
// (the TPU's float32 matmul splits them itself). What bounds it: bytes, one
// read of the kernel and three planes written (9.4 MB read at 512 -> 512).
// Its plain version: pda_torch/kernels/conv_block.py tf32_planes_plain.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float rna_tf32(float x) {
  return isfinite(x) ? __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u) : x;
}

// out[p][tap][r][k] for n = 9 * R * K elements a plane, from w (9, R, K)
// or, with transpose, from w (9, K, R).
__global__ void tf32_planes(const float* __restrict__ w, float* __restrict__ out, int R, int K,
                            int transpose, long long n) {
  const long long plane = static_cast<long long>(R) * K;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = w[i];
    if (transpose) {
      const long long tap = i / plane, rk = i - tap * plane;
      const long long r = rk / K, k = rk - r * K;
      v = w[tap * plane + k * R + r];
    }
    const float hi = rna_tf32(v);
    out[i] = v;
    out[n + i] = hi;
    out[2 * n + i] = rna_tf32(v - hi);
  }
}

}  // namespace

// w: the kernel (3, 3, K, R) HWIO with transpose (the forward's HWOI copy,
// r = Cout), else (3, 3, R, K) (the dgrad's, r = Cin); out: (3, 3, 3, R, K),
// the three planes above. Returns cudaGetLastError().
extern "C" int pda_tf32_planes(const void* w, void* out, int R, int K, int transpose,
                               void* stream) {
  const long long n = 9LL * R * K;
  const long long blocks = (n + 255) / 256;
  tf32_planes<<<blocks < 4096 ? static_cast<int>(blocks) : 4096, 256, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(w),
                                                     static_cast<float*>(out), R, K, transpose,
                                                     n);
  return cudaGetLastError();
}
