// Fused ConvBlock forward for Hopper (sm_90a): three layers of
// 3x3 SAME conv (zero padding) + bias + ReLU, float32, NHWC activations,
// HWIO weights (the layout pda keeps its kernels in).
//
// Replaces the Pallas TPU forward kernels of pda/kernels/:
//   conv_block.py         conv_block_fused_flat (:391), conv_block_fused_canvas
//                         (:337), conv_block_fused (:517), and the dual-input
//                         conv_block_fused_flat_dual (:447);
//   conv_block_packed.py  conv_block_packed_flat (:536), conv_block_packed_canvas
//                         (:482), conv_block_packed (:719), conv_block_packed_image
//                         (:591) and the decoder conv_block_packed_flat_dec (:648).
// On the TPU those differ only in layout (flat canvases, lane-pair packing);
// here one layer kernel (conv3x3.cuh, which says what bounds it and how it is
// tiled) serves them all. Its first layer may read its input channels from two
// tensors, [0, Ca) from xa and [Ca, Ca+Cb) from xb, so the decoder's
// [upsample | skip] concat is never built in device memory.
//
// h1 and h2 go to buffers the caller allocates; the caller keeps them (with
// the output h3) for the backward, as pda's save_intermediates does.
//
// Not done yet (later work): keeping h1/h2 on chip between the three layers,
// double-buffered cp.async/TMA staging, and bf16 with wgmma.

#include "conv3x3.cuh"

// The whole ConvBlock: y = relu(conv3(relu(conv2(relu(conv1(x)+b1))+b2))+b3).
// x = [xa | xb] along channels (xb may be null with Cb = 0); weights are HWIO
// (3, 3, Cin, C) and (3, 3, C, C); h1, h2 are (B, H, W, C) outputs.
extern "C" int pda_conv_block_fwd(const void* xa, const void* xb, int Ca,
                                  int Cb, const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* w3, const void* b3, void* h1,
                                  void* h2, void* y, int B, int H, int W,
                                  int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err = conv3x3<false>(f(xa), f(xb), nullptr, Ca, Cb, f(w1), f(b1),
                                   o(h1), nullptr, C, 0, B, H, W, s);
  if (err != cudaSuccess) return err;
  err = conv3x3<false>(f(h1), nullptr, nullptr, C, 0, f(w2), f(b2), o(h2),
                       nullptr, C, 0, B, H, W, s);
  if (err != cudaSuccess) return err;
  return conv3x3<false>(f(h2), nullptr, nullptr, C, 0, f(w3), f(b3), o(y),
                        nullptr, C, 0, B, H, W, s);
}
