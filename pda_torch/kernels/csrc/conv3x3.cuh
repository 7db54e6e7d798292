// The entry layer of the fused ConvBlock forward (conv_block_fwd.cuh) when it
// has 1 or 2 input channels (the image: Cin 1; the posterior's image + mask:
// Cin 2): one 3x3 SAME conv (zero padding) + bias + ReLU, float32, NHWC
// activations, HWOI weights ([tap][co][ci]), on the FMA pipes. T is float or
// bf16 (pda's bf16 configuration): bf16 input and weights, read into float32
// shared memory, the FMAs and the bias in float32, one rounding to bf16 as
// the output is stored.
//
// Why not the tensor cores (conv3x3_tc.cuh, every other layer): its stages
// take 16 input channels, of which Cin 1-2 would fill 1-2, through 4-byte
// copies. The layer does 18 * Cin FLOPs for each output value it writes
// (1,152 a pixel at 1 -> 64, 0.8% of the 1 -> 64 block's), so its time is
// mostly the 64-channel output it must write; the SIMT path keeps the whole
// input (CIN channels) in one shared-memory stage. On an H100 the
// tensor-core body in its place made the 1 -> 64 block at 4 x 512^2 8-14%
// slower and the 2 -> 64 block at 2 x 512^2 8% (PERF.md).
//
// A block computes an 8x16-pixel x 64-channel output tile; every thread holds
// a 4-pixel x 8-channel accumulator tile in registers, so one shared-memory
// load feeds about 8 FMAs. The sum adds the bias last, then the ReLU.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "bf16.cuh"

namespace {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 16;       // output columns per block
constexpr int TCO = 64;      // output channels per block
constexpr int THREADS = 256;
constexpr int IH = TH + 2;   // input tile rows, with the halo
constexpr int IW = TW + 2;   // input tile columns, with the halo

// Thread layout: cg = tid % 8 owns output channels cg*4+{0..3} and
// 32+cg*4+{0..3} of the block's 64 (two float4 weight reads that a quarter
// warp takes from 8 distinct 16-byte words, free of bank conflicts);
// pg = tid / 8 owns the 4 pixels (row pg/4, columns (pg%4)*4 + {0..3}).
template <typename T>
__device__ __forceinline__ float entry_float(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

template <typename T, int CIN>
__global__ void __launch_bounds__(THREADS, 3)
conv3x3_entry(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ y, int H,
              int W, int cout, int tiles_x) {
  __shared__ __align__(16) float s_in[CIN][IH][IW];
  __shared__ __align__(16) float s_w[CIN][9][TCO];

  const int tid = threadIdx.x;
  const int cg = tid & 7;
  const int pg = tid >> 3;
  const int row = pg >> 2;
  const int col0 = (pg & 3) * 4;

  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * TCO;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W;

  for (int e = tid; e < CIN * IH * IW; e += THREADS) {
    const int ci = e % CIN;
    const int pix = e / CIN;
    const int iy = pix / IW;
    const int ix = pix % IW;
    const int gy = y0 - 1 + iy;
    const int gx = x0 - 1 + ix;
    s_in[ci][iy][ix] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W)
            ? entry_float(x[(img + static_cast<size_t>(gy) * W + gx) * CIN + ci])
            : 0.f;
  }
  for (int e = tid; e < CIN * 9 * TCO; e += THREADS) {
    const int ci = e % CIN;
    const int r = e / CIN;  // tap * TCO + co
    const int co = r % TCO;
    const int tap = r / TCO;
    const int o = co0 + co;
    s_w[ci][tap][co] =
        o < cout ? entry_float(w[(static_cast<size_t>(tap) * cout + o) * CIN + ci]) : 0.f;
  }
  __syncthreads();

  float acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

#pragma unroll 1
  for (int ci = 0; ci < CIN; ++ci) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      float r[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) r[q] = s_in[ci][row + ky][col0 + q];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4 wa =
            *reinterpret_cast<const float4*>(&s_w[ci][ky * 3 + kx][cg * 4]);
        const float4 wb = *reinterpret_cast<const float4*>(
            &s_w[ci][ky * 3 + kx][32 + cg * 4]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = r[j + kx];
          acc[j][0] = fmaf(a, wa.x, acc[j][0]);
          acc[j][1] = fmaf(a, wa.y, acc[j][1]);
          acc[j][2] = fmaf(a, wa.z, acc[j][2]);
          acc[j][3] = fmaf(a, wa.w, acc[j][3]);
          acc[j][4] = fmaf(a, wb.x, acc[j][4]);
          acc[j][5] = fmaf(a, wb.y, acc[j][5]);
          acc[j][6] = fmaf(a, wb.z, acc[j][6]);
          acc[j][7] = fmaf(a, wb.w, acc[j][7]);
        }
      }
    }
  }

  const int oy = y0 + row;
  if (oy >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ox = x0 + col0 + j;
    if (ox >= W) continue;
    const size_t p = img + static_cast<size_t>(oy) * W + ox;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int o = co0 + (k < 4 ? cg * 4 + k : 32 + cg * 4 + (k - 4));
      if (o >= cout) continue;
      const float v = fmaxf(acc[j][k] + bias[o], 0.f);
      if constexpr (std::is_same<T, float>::value) {
        y[p * cout + o] = v;
      } else {
        y[p * cout + o] = __float2bfloat16_rn(v);
      }
    }
  }
}

// Launch the entry layer (Cin 1 or 2) over a (B, H, W, Cin) batch on
// ``stream``.
template <typename T>
cudaError_t conv3x3_entry_layer(const T* x, int Cin, const T* w, const float* b,
                                T* y, int Cout, int B, int H, int W,
                                cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (Cout + TCO - 1) / TCO, B);
  const auto kernel = Cin == 1 ? &conv3x3_entry<T, 1> : &conv3x3_entry<T, 2>;
  kernel<<<grid, THREADS, 0, stream>>>(x, w, b, y, H, W, Cout, tiles_x);
  return cudaGetLastError();
}

}  // namespace
