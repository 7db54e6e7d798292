// Fused ConvBlock forward for Hopper (sm_90a): three layers of
// 3x3 SAME conv (zero padding) + bias + ReLU, float32 or bf16, NHWC activations.
//
// Replaces the Pallas TPU forward kernels of pda/kernels/:
//   conv_block.py         conv_block_fused_flat (:391, body _kernel :183),
//                         conv_block_fused_canvas (:337), conv_block_fused
//                         (:517), and the dual-input conv_block_fused_flat_dual
//                         (:447);
//   conv_block_packed.py  conv_block_packed_flat (:536), conv_block_packed_canvas
//                         (:482), conv_block_packed (:719), conv_block_packed_image
//                         (:591) and the decoder conv_block_packed_flat_dec (:648).
// On the TPU those differ only in layout (flat canvases, lane-pair packing);
// here one entry serves them all. The first layer may read its input channels
// from two tensors, [0, Ca) from xa and [Ca, Ca+Cb) from xb, so the decoder's
// [upsample | skip] concat is never built in device memory.
//
// Each layer is an implicit GEMM on the tensor cores in 3xTF32: M = pixels,
// N = Cout, K = 9 * Cin. 3xTF32 rather than TF32 or bf16: one TF32 product
// keeps ~3 decimal digits (1e-3 off float64) and bf16 fewer, while the port
// is held to pda's float32 reference; three TF32 products keep float32's
// accuracy (~1e-6 off float64) at a ceiling of 495 / 3 = 165 TFLOP/s, above
// the FMA pipes' 67. Routes, chosen by shape before launch (fwd_layer):
// every layer whose input and output channel counts are multiples of 8
// with 16-byte-aligned pointers on Hopper's asynchronous body
// (conv3x3_wgmma_tf32.cuh: TMA, wgmma, the activations split into hi and
// lo once a 32-channel chunk, float32 sums in registers; it says what bounds
// a layer and how it is tiled), which is every layer of the flagship but
// its entry layer; any other layer (Cin 3-7, a count off 8, an unaligned
// view) on the mma.sync body (conv3x3_tc.cuh: 16x16 pixels x 64 channels a
// block, a 2-stage cp.async ring, chains flushed into float32 sums in
// shared memory). A single-input first layer with Cin 1 or 2 (the image, or
// image + mask) would fill 1-2 of a tensor-core chunk's channels; it runs
// on the FMA pipes (conv3x3.cuh) and is bound by writing its output.
//
// Weights come as HWOI, (3, 3, Cout, Cin): the reduction index (Cin) is the
// contiguous one, as the tensor-core tiles read it. The wrapper
// (pda_torch/kernels/conv_block.py) copies them from the HWIO layout pda
// keeps its kernels in (at most 9.4 MB a layer, for 512 -> 512); in float32
// the copy is three planes (tf32_planes.cu: the kernel, then its 3xTF32 hi
// and lo, which the wgmma body reads; the other bodies read the first).
//
// h1 and h2 go to buffers the caller allocates; the caller keeps them (with
// the output h3) for the backward, as pda's save_intermediates does, or, in
// the memory-lean mode (PDA_PALLAS_CONV_MODE=mixed), the backward recomputes
// them with these layer bodies (conv_block_bwd.cuh). Keeping
// h1/h2 on chip between the layers would not pay here: a 16x16 tile of h1 at
// 512 channels with its halo is 819 KB, beyond the SM's 227 KB.
//
// bf16 (pda's bf16 configuration, pda_conv_block_fwd_bf16): bf16 input,
// HWOI weights copied as bf16 by the wrapper (pda's w.astype(dtype)), float32
// biases; each layer sums in float32, adds the bias in float32, applies the
// ReLU and rounds to bf16 once (pda/kernels/conv_block.py _kernel), so h1,
// h2 and the output are bf16. Routes, chosen by shape before launch
// (fwd_layer): a single-input first layer of 1 or 2 channels on the FMA
// pipes (conv3x3.cuh, bf16 instance); every layer whose input and output
// channel counts are multiples of 8 with 16-byte-aligned pointers on the
// wgmma body (conv3x3_wgmma.cuh: TMA, wgmma, float32 sums in registers),
// which is every other layer of the flagship; any other layer (Cin 3-7, a
// count off 8, an unaligned view) on conv3x3_tc<bf16, V, true>.
//
// Not done yet (later work): persistent bodies that overlap one tile's
// epilogue with the next tile's loads.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "conv3x3.cuh"
#include "conv3x3_tc.cuh"
#include "conv3x3_wgmma.cuh"
#include "conv3x3_wgmma_tf32.cuh"

namespace {

// One tensor-core layer of the block, y = relu(conv(x) + bias) with x =
// [xa | xb]: where the tensor maps describe the shape (wgmma_takes), the
// wgmma body of its type (bf16: conv3x3_wgmma.cuh; float32: 3xTF32 on
// conv3x3_wgmma_tf32.cuh, reading the hi and lo planes that follow the
// kernel, tf32_planes.cu); else conv3x3_tc<T, V, true> (float32: 3xTF32
// on mma.sync). The route is chosen by shape before launch; a failed launch
// or encode returns its error. w: the HWOI kernel (3, 3, N, Ka + Kb), in
// float32 the first of its three planes.
template <typename T>
cudaError_t fwd_layer(const T* xa, const T* xb, int Ka, int Kb, const T* w, const float* bias,
                      T* y, int N, int B, int H, int W, cudaStream_t s) {
  if (wgmma_takes(Ka, Kb, N, xa, xb, w, y)) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return conv3x3_wgmma_layer<T>(xa, xb, Ka, Kb, w, bias, y, N, B, H, W, s);
    else
      return conv3x3_wgmma_tf32_layer<T>(xa, xb, Ka, Kb, w + 9LL * N * (Ka + Kb), bias, y, N,
                                         B, H, W, s);
  }
  return conv3x3_tc_layer<T, true>(xa, xb, Ka, Kb, w, bias, nullptr, y, nullptr, N, 0, B, H,
                                   W, s);
}

// Whether the block's first layer is the FMA-pipe entry layer: a single
// input of 1 or 2 channels (the image, or image + mask).
inline bool entry_layer(int Ca, int Cb) { return Cb == 0 && Ca < 3; }

// The block's first layer, relu(conv1(x) + b1) into h1: the entry layer
// (conv3x3.cuh) or fwd_layer. The backward's recompute (conv_block_bwd.cuh)
// rebuilds h1 with it, and h2 with fwd_layer, so that its h1 and h2 are the
// forward's bit for bit.
template <typename T>
cudaError_t fwd_layer1(const T* xa, const T* xb, int Ca, int Cb, const T* w1,
                       const float* b1, T* h1, int B, int H, int W, int C,
                       cudaStream_t s) {
  return entry_layer(Ca, Cb) ? conv3x3_entry_layer<T>(xa, Ca, w1, b1, h1, C, B, H, W, s)
                             : fwd_layer<T>(xa, xb, Ca, Cb, w1, b1, h1, C, B, H, W, s);
}

// Whether every tensor-core layer of a block on x = [xa | xb] takes the
// wgmma body of its type (the wrapper's count of that route); the weights
// and the outputs are the wrapper's own allocations, 16-byte aligned.
inline bool block_on_wgmma(const void* xa, const void* xb, int Ca, int Cb, int C) {
  return wgmma_takes(C, 0, C, nullptr, nullptr, nullptr, nullptr) &&
         (entry_layer(Ca, Cb) || wgmma_takes(Ca, Cb, C, xa, xb, nullptr, nullptr));
}

// The whole ConvBlock: y = relu(conv3(relu(conv2(relu(conv1(x)+b1))+b2))+b3).
// x = [xa | xb] along channels (xb may be null with Cb = 0); weights are HWOI
// (3, 3, C, Cin) and (3, 3, C, C) of type T (float32: each the first of its
// three planes, tf32_planes.cu), biases float32; h1, h2 are (B, H, W, C)
// outputs.
template <typename T>
cudaError_t block_fwd(const void* xa, const void* xb, int Ca, int Cb, const void* w1,
                      const void* b1, const void* w2, const void* b2, const void* w3,
                      const void* b3, void* h1, void* h2, void* y, int B, int H, int W,
                      int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const T*>(p); };
  const auto o = [](void* p) { return static_cast<T*>(p); };
  const auto b = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = fwd_layer1<T>(f(xa), f(xb), Ca, Cb, f(w1), b(b1), o(h1), B, H, W, C, s);
  if (err != cudaSuccess) return err;
  err = fwd_layer<T>(f(h1), nullptr, C, 0, f(w2), b(b2), o(h2), C, B, H, W, s);
  if (err != cudaSuccess) return err;
  return fwd_layer<T>(f(h2), nullptr, C, 0, f(w3), b(b3), o(y), C, B, H, W, s);
}

}  // namespace
