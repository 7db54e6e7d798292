// The fused ConvBlock backward's bf16 entries (pda's bf16 configuration); the
// bodies: conv_block_bwd.cuh (its dgrad on conv3x3_wgmma.cuh, its wgrad on
// wgrad_wgmma.cuh, routed by shape).

#include "conv_block_bwd.cuh"

// Floats of the `work` buffer the two bf16 entries need (pda_conv_block_bwd_work's).
extern "C" long long pda_conv_block_bwd_work_bf16(int B, int H, int W, int Cin, int C) {
  return bwd_work<bf16>(B, H, W, Cin, C);
}

PDA_BWD_ENTRIES(_bf16, bf16)

// 1 when every dgrad and every wgrad but an entry layer's (Cin 1 or 2) of
// the bf16 backward of a block on [xa | xb] (Ca + Cb channels, C outputs,
// dx with need_dx) runs on the wgmma bodies (conv3x3_wgmma.cuh,
// wgrad_wgmma.cuh), 0 when one runs on an mma.sync body: the route
// pda_conv_block_bwd[_dual]_bf16 take, for the wrapper's launch count of it.
extern "C" int pda_conv_block_bwd_wgmma_bf16(const void* xa, const void* xb, int Ca, int Cb,
                                             int C, int need_dx) {
  return bwd_on_wgmma(xa, xb, Ca, Cb, C, need_dx != 0) ? 1 : 0;
}
