// One 3x3 SAME conv layer (zero padding) + bias + ReLU, float32, NHWC
// activations, HWIO weights: the layer kernel of the fused ConvBlock forward
// (conv_block_fwd.cu), y = relu(conv(x) + bias).
//
// The input's channels may come from two tensors, [0, Ca) from xa and
// [Ca, Ca+Cb) from xb (the decoder's [upsample | skip], never concatenated in
// device memory).
//
// What bounds it: at 64..512 channels a layer does 18*Cin FLOPs per output
// value and is compute-bound on the float32 FMA pipes (no tensor cores in f32
// without TF32). The design keeps the FMA units fed from shared memory: a
// block computes an 8x16-pixel x 64-channel output tile; each stage copies an
// 8-channel slice of the input tile with its one-pixel halo (zeros outside the
// image) and the matching 3x3x8x64 weights into shared memory; every thread
// holds a 4-pixel x 8-channel accumulator tile in registers, so one
// shared-memory load feeds about 8 FMAs.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 16;       // output columns per block
constexpr int TCO = 64;      // output channels per block
constexpr int CK = 8;        // input channels per shared-memory stage
constexpr int THREADS = 256;
constexpr int IH = TH + 2;   // input tile rows, with the halo
constexpr int IW = TW + 2;   // input tile columns, with the halo

// Thread layout: cg = tid % 8 owns output channels cg*4+{0..3} and
// 32+cg*4+{0..3} of the block's 64 (two float4 weight reads that a quarter
// warp takes from 8 distinct 16-byte words, free of bank conflicts);
// pg = tid / 8 owns the 4 pixels (row pg/4, columns (pg%4)*4 + {0..3}).
__global__ void __launch_bounds__(THREADS)
conv3x3_layer(const float* __restrict__ xa, const float* __restrict__ xb,
              const float* __restrict__ w, const float* __restrict__ bias,
              float* __restrict__ y, int H, int W, int Ca, int Cb, int cout,
              int tiles_x) {
  __shared__ __align__(16) float s_in[CK][IH][IW];
  __shared__ __align__(16) float s_w[CK][9][TCO];

  const int cin = Ca + Cb;
  const int tid = threadIdx.x;
  const int cg = tid & 7;
  const int pg = tid >> 3;
  const int row = pg >> 2;
  const int col0 = (pg & 3) * 4;

  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * TCO;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W;

  float acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    for (int e = tid; e < CK * IH * IW; e += THREADS) {
      const int ci = e % CK;
      const int pix = e / CK;
      const int iy = pix / IW;
      const int ix = pix % IW;
      const int gy = y0 - 1 + iy;
      const int gx = x0 - 1 + ix;
      const int c = c0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin) {
        const size_t p = img + static_cast<size_t>(gy) * W + gx;
        v = c < Ca ? xa[p * Ca + c] : xb[p * Cb + (c - Ca)];
      }
      s_in[ci][iy][ix] = v;
    }
    for (int e = tid; e < CK * 9 * TCO; e += THREADS) {
      const int co = e % TCO;
      const int r = e / TCO;
      const int tap = r % 9;
      const int ci = r / 9;
      const int c = c0 + ci;
      const int o = co0 + co;
      s_w[ci][tap][co] =
          (c < cin && o < cout)
              ? w[(static_cast<size_t>(tap) * cin + c) * cout + o]
              : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
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
    __syncthreads();
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
      y[p * cout + o] = fmaxf(acc[j][k] + bias[o], 0.f);
    }
  }
}

// Launch one layer over a (B, H, W, *) batch on ``stream``.
cudaError_t conv3x3(const float* xa, const float* xb, int Ca, int Cb,
                    const float* w, const float* b, float* y, int Cout, int B,
                    int H, int W, cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (Cout + TCO - 1) / TCO, B);
  conv3x3_layer<<<grid, THREADS, 0, stream>>>(xa, xb, w, b, y, H, W, Ca, Cb,
                                               Cout, tiles_x);
  return cudaGetLastError();
}

}  // namespace
