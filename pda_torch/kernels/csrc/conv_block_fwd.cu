// Fused ConvBlock forward for Hopper (sm_90a): three layers of
// 3x3 SAME conv (zero padding) + bias + ReLU, float32, NHWC activations.
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
// Each layer is an implicit GEMM on the tensor cores in 3xTF32
// (conv3x3_tc.cuh, the body the backward's dgrad shares; it says what bounds
// a layer and how it is tiled): M = pixels, N = Cout, K = 9 * Cin, 16x16
// pixels x 64 channels a block, a 2-stage cp.async ring in dynamic shared
// memory, mma chains of 6 k-steps (3 taps; the dgrad's are 18, see
// conv3x3_tc.cuh for why) flushed into float32 sums, the bias added
// to the sum and then the ReLU. 3xTF32 rather than TF32 or bf16: one TF32
// product keeps ~3 decimal digits (1e-3 off float64) and bf16 fewer, while
// the port is held to pda's float32 reference; three TF32 products keep
// float32's accuracy (~1e-6 off float64) at a ceiling of 495 / 3 = 165
// TFLOP/s, above the FMA pipes' 67. A single-input first layer with Cin 1
// or 2 (the image, or image + mask) would fill 1-2 of a stage's 16 channels;
// it runs on the FMA pipes (conv3x3.cuh) and is bound by writing its output.
//
// Weights come as HWOI, (3, 3, Cout, Cin): the reduction index (Cin) is the
// contiguous one, as the tensor-core tiles read it. The wrapper
// (pda_torch/kernels/conv_block.py) copies them from the HWIO layout pda
// keeps its kernels in (at most 9.4 MB a layer, for 512 -> 512).
//
// h1 and h2 go to buffers the caller allocates; the caller keeps them (with
// the output h3) for the backward, as pda's save_intermediates does. Keeping
// h1/h2 on chip between the layers would not pay here: a 16x16 tile of h1 at
// 512 channels with its halo is 819 KB, beyond the SM's 227 KB.
//
// Not done yet (later work): TMA and wgmma, warp-specialised producers, bf16.

#include "conv3x3.cuh"
#include "conv3x3_tc.cuh"

// The whole ConvBlock: y = relu(conv3(relu(conv2(relu(conv1(x)+b1))+b2))+b3).
// x = [xa | xb] along channels (xb may be null with Cb = 0); weights are HWOI
// (3, 3, C, Cin) and (3, 3, C, C); h1, h2 are (B, H, W, C) outputs.
extern "C" int pda_conv_block_fwd(const void* xa, const void* xb, int Ca,
                                  int Cb, const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* w3, const void* b3, void* h1,
                                  void* h2, void* y, int B, int H, int W,
                                  int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err =
      Cb == 0 && Ca < 3
          ? conv3x3_entry_layer(f(xa), Ca, f(w1), f(b1), o(h1), C, B, H, W, s)
          : conv3x3_tc_layer<true>(f(xa), f(xb), Ca, Cb, f(w1), f(b1), o(h1),
                                   nullptr, C, 0, B, H, W, s);
  if (err != cudaSuccess) return err;
  err = conv3x3_tc_layer<true>(f(h1), nullptr, C, 0, f(w2), f(b2), o(h2),
                               nullptr, C, 0, B, H, W, s);
  if (err != cudaSuccess) return err;
  return conv3x3_tc_layer<true>(f(h2), nullptr, C, 0, f(w3), f(b3), o(y),
                                nullptr, C, 0, B, H, W, s);
}
