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
