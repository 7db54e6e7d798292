// The fused ConvBlock forward's float32 entry (3xTF32); the body, what it
// replaces and how it is tiled: conv_block_fwd.cuh. The bf16 entry is
// conv_block_fwd_bf16.cu's: two sources, so that nvcc builds them side by side.

#include "conv_block_fwd.cuh"

extern "C" int pda_conv_block_fwd(const void* xa, const void* xb, int Ca,
                                  int Cb, const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* w3, const void* b3, void* h1,
                                  void* h2, void* y, int B, int H, int W,
                                  int C, void* stream) {
  return block_fwd<float>(xa, xb, Ca, Cb, w1, b1, w2, b2, w3, b3, h1, h2, y, B, H, W, C,
                          stream);
}
