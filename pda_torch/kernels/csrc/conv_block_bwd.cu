// The fused ConvBlock backward's float32 entries (3xTF32); the bodies, what
// they replace and how they are tiled: conv_block_bwd.cuh. The bf16 entries
// are conv_block_bwd_bf16.cu's: two sources, so that nvcc builds them side
// by side.

#include "conv_block_bwd.cuh"

// Floats of the `work` buffer the two entries need for a block with input
// channels Cin (= Ca + Cb) and width C at (B, H, W) on the current device.
extern "C" long long pda_conv_block_bwd_work(int B, int H, int W, int Cin, int C) {
  return bwd_work<float>(B, H, W, Cin, C);
}

PDA_BWD_ENTRIES(, float)

// 1 when every dgrad and every wgrad but an entry layer's (Cin 1 or 2, on the
// FMA pipes) of the float32 backward of a block on [xa | xb] (Ca + Cb
// channels, C outputs, dx with need_dx; with recompute also every
// tensor-core layer that rebuilds h1, h2) runs on the 3xTF32 wgmma bodies
// (conv3x3_wgmma_tf32.cuh, wgrad_wgmma_tf32.cuh), 0 when one runs on an
// mma.sync body: the route pda_conv_block_bwd[_dual] take, for the wrapper's
// launch count of it.
extern "C" int pda_conv_block_bwd_wgmma(const void* xa, const void* xb, int Ca, int Cb, int C,
                                        int need_dx, int recompute) {
  return bwd_f32_on_wgmma(xa, xb, Ca, Cb, C, need_dx != 0, recompute != 0) ? 1 : 0;
}
