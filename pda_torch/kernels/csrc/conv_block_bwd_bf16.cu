// The fused ConvBlock backward's bf16 entries (pda's bf16 configuration); the
// bodies: conv_block_bwd.cuh.

#include "conv_block_bwd.cuh"

// Floats of the `work` buffer the two bf16 entries need (pda_conv_block_bwd_work's).
extern "C" long long pda_conv_block_bwd_work_bf16(int B, int H, int W, int Cin, int C) {
  return bwd_work<bf16>(B, H, W, Cin, C);
}

PDA_BWD_ENTRIES(_bf16, bf16)
