// The fused ConvBlock forward's bf16 entry (pda's bf16 configuration); the
// body: conv_block_fwd.cuh.

#include "conv_block_fwd.cuh"

// The same block in bf16: xa, xb, w1..w3, h1, h2, y bf16; b1..b3 float32.
extern "C" int pda_conv_block_fwd_bf16(const void* xa, const void* xb, int Ca,
                                       int Cb, const void* w1, const void* b1,
                                       const void* w2, const void* b2,
                                       const void* w3, const void* b3, void* h1,
                                       void* h2, void* y, int B, int H, int W,
                                       int C, void* stream) {
  return block_fwd<__nv_bfloat16>(xa, xb, Ca, Cb, w1, b1, w2, b2, w3, b3, h1, h2, y, B,
                                  H, W, C, stream);
}

// 1 when every tensor-core layer of the bf16 block on [xa | xb] (Ca + Cb
// channels, C outputs) runs on the wgmma body, 0 when one runs on the
// mma.sync body: the route pda_conv_block_fwd_bf16 takes, for the wrapper's
// launch count of it.
extern "C" int pda_conv_block_fwd_wgmma_bf16(const void* xa, const void* xb, int Ca, int Cb,
                                             int C) {
  return block_on_wgmma(xa, xb, Ca, Cb, C) ? 1 : 0;
}
