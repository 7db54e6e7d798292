// The fused ConvBlock forward's float32 entry (3xTF32); the bodies, what
// they replace and how they are routed: conv_block_fwd.cuh. w1..w3 are the
// three planes of each HWOI kernel (tf32_planes.cu). The bf16 entry is
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

// 1 when every tensor-core layer of the float32 block on [xa | xb] (Ca + Cb
// channels, C outputs) runs on the 3xTF32 wgmma body, 0 when one runs on the
// mma.sync body: the route pda_conv_block_fwd takes, for the wrapper's
// launch count of it.
extern "C" int pda_conv_block_fwd_wgmma(const void* xa, const void* xb, int Ca, int Cb, int C) {
  return block_on_wgmma(xa, xb, Ca, Cb, C) ? 1 : 0;
}
