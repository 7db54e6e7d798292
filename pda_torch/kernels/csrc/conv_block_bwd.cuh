// Fused ConvBlock backward for Hopper (sm_90a), float32 or bf16, NHWC activations,
// HWIO weights: the gradients of y = relu(conv3(relu(conv2(relu(conv1(x) +
// b1)) + b2)) + b3) from the saved h1, h2, h3 (= y) and the cotangent g.
//
// Replaces the Pallas TPU backward kernels of pda/kernels/:
//   conv_block_bwd.py         conv_block_bwd_flat (:402, body _kernel :69),
//                             conv_block_bwd_canvas (:291), conv_block_bwd
//                             (:610), and the dual-input
//                             conv_block_bwd_flat_dual (:502);
//   conv_block_packed_bwd.py  conv_block_packed_bwd_flat (:501, body :92),
//                             conv_block_packed_bwd_canvas (:403),
//                             conv_block_packed_bwd (:891), the decoder
//                             conv_block_packed_bwd_flat_dec (:760) and the
//                             dense-image entry conv_block_packed_bwd_image
//                             (:648).
// The TPU variants differ in layout only (flat canvases, lane-pair packing,
// image mode); here two entries serve them all: pda_conv_block_bwd (one input,
// dx optional: the entry blocks take none, as pda's need_dx=False) and
// pda_conv_block_bwd_dual (input [xa | xb], dxa and dxb written apart, so
// neither the concat nor its cotangent exists).
//
// With da_3 = [h3 > 0] * g (one elementwise pass, below), for layer k = 3, 2, 1:
//   wgrad  dW_k[tap, ci, co] = sum_p in_k[p + tap, ci] * da_k[p, co]
//          db_k[co]          = sum_p da_k[p, co]
//          a GEMM with M = 9 * Cin (taps x input channels), N = Cout and
//          K = B * H * W pixels;
//   dgrad  da_{k-1}[p, ci] = [h_{k-1}[p, ci] > 0] *
//                            sum_{tap, co} da_k[p + tap, co] * W_k[8 - tap, ci, co]
//          an implicit GEMM with M = pixels, N = Cin, K = 9 * Cout; the ReLU
//          mask of the layer below is applied as it is stored (none for dx).
// in_1 = x, whose border loads are zero-filled (the dense-image entry).
//
// What bounds it: both halves are 18 * Cin * Cout FLOPs a pixel (1.7 TFLOP
// each per MT step). The card's float32 FMA pipes top out at 67 TFLOP/s; the
// tensor cores reach 495 TFLOP/s in TF32, but one TF32 product keeps ~3
// decimal digits, which would move the gradients against pda's float32
// reference (pda's bf16 configuration runs the bf16 instances, below). So
// both float32 halves run 3xTF32 (tf32x3.cuh): three TF32 products a
// multiply-add, at a third of the TF32 rate but still above the FMA pipes,
// with float32 accuracy. The tensor cores accumulate with round-toward-zero,
// so each body runs short chains into zeroed accumulators and adds them
// into float32 sums with round-to-nearest adds.
//   - The float32 dgrad runs on the forward's Hopper body (conv3x3_wgmma_tf32.cuh,
//     DgradEpi): TMA, wgmma with both operands K-major from shared memory
//     (da in NHWC, the HWIO kernel with k = Cout contiguous), the da chunk
//     split into hi and lo once, chains of 9 taps (the lo products in a
//     chain of their own), float32 sums in registers; wherever the channel
//     counts are multiples of 8 and the tensors 16-byte aligned
//     (wgmma_takes_dgrad), else on the mma.sync body (conv3x3_tc.cuh, 18
//     k-steps a chain, sums flushed into shared memory).
//   - The float32 wgrad runs on its own Hopper body (wgrad_wgmma_tf32.cuh):
//     TF32 wgmma reads shared-memory operands only K-major, which neither wgrad
//     operand is in NHWC (the reduction runs over pixels, and channels are
//     the contiguous index), so TMA lands the x and da tiles as they lie and
//     a transpose-and-split pass in shared memory writes x (its three kx
//     shifts side by side) as K-major hi and lo planes; da's fragments are
//     loaded and split in registers; chains of CHAIN_TILES tiles (the small
//     products apart), float32 sums in shared memory; wherever the channel
//     counts are multiples of 8 and the tensors 16-byte aligned
//     (wgmma_takes). An entry layer (a single input of 1 or 2 channels) runs
//     on the FMA pipes (wgrad_entry below), any other shape on mma.sync
//     (wgrad_tc below: 8 k-steps a chain, sums in shared memory; per k-step
//     a warp runs 24 mma and splits 16 values, about 0.3 mma a cycle an SM
//     on an H100). mma.sync gathers its fragments from [pixel][channel]
//     tiles, with the fragments' rows, columns or k-slots mapped to channels
//     so that a lane's values are 4 adjacent channels: one 16-byte load,
//     free of bank conflicts.
//
// wgrad_tc (the shapes off the wgmma bodies: a channel count off 8, an
// unaligned view): a block owns a 9-tap x 32-input x 64-output-channel tile of dW and
// one chunk of 8x8-pixel tiles; 18 warps, one a tap and 32 output channels,
// each a 32 x 32 tile of dW (2 x 4 fragments). The halo input tile and the
// da tile stream through a 3-stage cp.async ring in dynamic shared memory
// (177,024 bytes with the sums). The input tile is shared by the nine tap
// warps (each reads it shifted), da by all. Each chunk writes its partial dW
// and db to a workspace and a second pass adds the chunks in order: no float
// atomics, so repeats are bit-equal. db is a plain float32 sum of da (no
// split). The number of chunks fills the card's block slots (occupancy
// query). A layer with Cin = 1 or 2 that reaches it (not an entry layer: a
// dual input) skips the second m-fragment, which holds none of its channels.
// dgrad: the implicit-GEMM layer body it shares with the forward
// (conv3x3_wgmma_tf32.cuh, or conv3x3_tc.cuh off its shapes; each gives its
// tiling), with the tap flipped at the weight load (no flipped copy of W:
// its HWIO layout, in float32 as the wrapper's three planes, tf32_planes.cu),
// the output split into dxa | dxb, and the ReLU mask of the layer below
// applied as it is stored.
//
// bf16 (pda's bf16 configuration, the _bf16 entries): x, h1..h3, g, the
// saved kernels (copied as bf16 by the wrapper, pda's w.astype(dtype)), the
// da workspaces and dx in bf16; dW, db, the chunk partials and their sums in
// float32 (pda/kernels/conv_block_bwd.py: da in the compute dtype, dW and db
// accumulated in float32). The mask reads the bf16 cotangent. The bf16
// dgrad and wgrad run on Hopper's asynchronous path (wgmma, TMA, float32
// sums in registers), routed by shape before launch: the dgrad is the forward's
// wgmma body with the dgrad's epilogue (conv3x3_wgmma.cuh DgradEpi: the
// flipped tap read from the HWIO kernel, float32 sums, one rounding to bf16,
// the mask, the dxa | dxb split), the wgrad wgrad_wgmma (wgrad_wgmma.cuh:
// both operands MN-major, float32 register sums, its own chunking, then the
// same in-order chunk pass), wherever every channel count of the layer is a
// multiple of 8 and the tensors 16-byte aligned (wgmma_takes); an entry
// layer's wgrad (Cin 1 or 2) on the FMA pipes (wgrad_entry). Any other bf16
// layer (a count off 8, an unaligned view; a dx of 1-7 channels) keeps the
// mma.sync bodies: conv3x3_tc<bf16, V, false> (float32
// sums flushed every 3 taps, mask, one rounding) and wgrad_tc<bf16, V>
// (mma.sync.m16n8k16 into float32 chains of 4 k-steps (a tile) flushed as
// above). pda_conv_block_bwd_wgmma_bf16 (float32: pda_conv_block_bwd_wgmma,
// the dgrads' route) tells the wrapper which route a launch took.
//
// The pooled cotangent (pda's gpf: conv_block_packed_bwd.py :501 and :648,
// the in-kernel transpose :158-189). When the block's output feeds a 2x2
// average pool, the entries take the pool's cotangent gp (B, H/2, W/2, C)
// beside, or instead of, the full-resolution g, and the first pass computes
//   da_3[p] = [h3[p] > 0] * round_T(g[p] + 0.25 * gp[p / 2])
// with the sum in float32 and one rounding to T (a no-op in float32; in bf16
// pda's (g + gexp).astype(dtype)). So neither the pool's transposed cotangent
// nor its sum with the skip's cotangent exists in device memory, and the
// backward of a pooled block is this one launch sequence. The pass is a
// plain elementwise CUDA kernel, not a Triton one: it is one more kernel of
// this header's launch sequence, on the stream and the pointers the entry
// already holds, and it stays beside the wgrad it feeds. It reads g, gp and
// h3 once and writes da_3 once (bound by bytes); fusing the mask into the
// wgrad's loads is later work.
//
// Recompute (pda's PDA_PALLAS_CONV_MODE=mixed: conv_block_bwd.py _kernel
// (:69) with recompute=True, from conv_block_bwd (:610), and the packed twin
// conv_block_packed_bwd.py :97): the forward kept only x and h3, and the
// entries rebuild h1 and h2 from x (or [xa | xb]) before the chain, with the
// forward's own layer bodies (conv_block_fwd.cuh fwd_layer1, then
// fwd_layer: in bf16 the wgmma body where the forward takes it, so h1, h2
// are the forward's bit for bit), into h1 and h2 buffers the caller allocates for
// this call only. What this buys is memory between the forward and the
// backward: h1 and h2 of every block are no longer held for the whole step.
// It costs two forward layers a block and does not save HBM traffic; keeping
// the recomputed band on chip, as pda's kernel does, is later speed work.
//
// Not done yet (later work): keeping da on chip between the wgrad and the
// dgrad, the masked cotangent fused into the wgrad's loads.

#pragma once

#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

#include "bf16.cuh"
#include "conv3x3_tc.cuh"
#include "conv_block_fwd.cuh"
#include "tf32x3.cuh"
#include "wgrad_wgmma.cuh"
#include "wgrad_wgmma_tf32.cuh"

namespace {

using bf::bf16;

// ---- wgrad -----------------------------------------------------------------
constexpr int WG_T = 8;                    // pixel tile: 8 x 8, one row a k-step (bf16: two)
constexpr int WG_PIX = WG_T * WG_T;
constexpr int WG_I = WG_T + 2;             // halo tile side
constexpr int WG_HALO = WG_I * WG_I;
constexpr int WG_CI = 32;                  // input channels a block
constexpr int WG_CO = 64;                  // output channels a block
constexpr int WG_WARPS = 9 * (WG_CO / 32); // a tap and 32 output channels each
constexpr int WG_THREADS = 32 * WG_WARPS;
constexpr int WG_STAGES = 3;
constexpr int WG_ACC = 8 * 4 * WG_THREADS;  // the float32 sums, 8 fragments a thread

// Row strides (elements) of the input and da tiles: float 8 * odd (mod 32)
// floats; bf16 16 * odd (mod 64) elements, 8 * odd words, so that the four
// pixels a warp's quads read land in distinct banks. All rows 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int wg_ldi() {
  return std::is_same<T, float>::value ? WG_CI + 8 : WG_CI + 16;
}
template <typename T>
__host__ __device__ constexpr int wg_ldd() {
  return std::is_same<T, float>::value ? WG_CO + 8 : WG_CO + 16;
}
template <typename T>
__host__ __device__ constexpr int wg_stage() {
  return WG_HALO * wg_ldi<T>() + WG_PIX * wg_ldd<T>();
}
template <typename T>
constexpr int wg_smem() {  // bytes
  return WG_STAGES * wg_stage<T>() * static_cast<int>(sizeof(T)) + WG_ACC * 4;
}

// Partial dW and db of one layer over one chunk of pixel tiles.
// grid = (input-channel slices, output-channel slices, chunks).
// ws_w: [chunk][9][Cin][Cout]; ws_b: [chunk][Cout] (written by the blocks of
// input-channel slice 0). V: elements a copy (copy_in, conv3x3_tc.cuh; the
// larger needs every channel count a multiple of it and 16-byte aligned
// pointers). T: float (3xTF32) or bf16 (h_in and da bf16, sums float32).
//
// float: a warp's 32 x 32 tile of dW is 2 x 4 m16n8k8 fragments. Row r of
// m-fragment mf is channel 4 (r % 8) + 2 mf + r / 8 and column n of
// n-fragment nf is channel 4 n + nf, so that a lane's A values of both
// m-fragments are 4 adjacent channels of one pixel, and its B values of all
// four n-fragments too: one 16-byte load each (conflict-free: row strides
// 8 * odd floats).
// bf16: 2 x 4 m16n8k16 fragments, a k-step = 16 pixels (two rows of the
// tile: k-slot 2q + j is pixel (row 2s + j, column q), 2q + 8 + j pixel
// (row 2s + j, column q + 4)). A fragment register pairs two pixels of one
// channel, so a lane loads 4 bytes (2 adjacent channels) at each of its 4
// pixels and pairs them with two byte permutes: row grp of m-fragment mf is
// input channel 16 mf + 2 grp, row grp + 8 channel 16 mf + 2 grp + 1;
// n-fragments 2p and 2p + 1 take output channels 16 p + 2 grp and
// 16 p + 2 grp + 1 as column grp.
template <typename T, int V>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_tc(const T* __restrict__ xa, const T* __restrict__ xb, int Ca,
         int Cb, const T* __restrict__ da, float* __restrict__ ws_w,
         float* __restrict__ ws_b, int B, int H, int W, int Cout,
         int tiles_per_chunk) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int LDI = wg_ldi<T>(), LDD = wg_ldd<T>(), STAGE = wg_stage<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float4* s_acc = reinterpret_cast<float4*>(smem + WG_STAGES * STAGE);
  const int cin = Ca + Cb;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int tap = warp % 9, ky = tap / 3, kx = tap % 3;
  const int co_w = (warp / 9) * 32;
  const int ci0 = blockIdx.x * WG_CI;
  const int co0 = blockIdx.y * WG_CO;
  const int chunk = blockIdx.z;
  // m-fragment 1 has channels (float: 2, 3 mod 4; bf16: 16 .. 31)
  const bool two_rows = ci0 + (F32 ? 2 : 16) < cin;
  const bool sums_bias = blockIdx.x == 0;

  const int tiles_x = cdiv(W, WG_T);
  const int tiles_img = cdiv(H, WG_T) * tiles_x;
  const int t_begin = chunk * tiles_per_chunk;
  const int n_tiles = min(B * tiles_img, t_begin + tiles_per_chunk) - t_begin;

  // Tile t_begin + i into stage i % WG_STAGES.
  auto load = [&](int i) {
    T* s_in = smem + (i % WG_STAGES) * STAGE;
    T* s_da = s_in + WG_HALO * LDI;
    const int t = t_begin + i;
    const int b = t / tiles_img, r = t % tiles_img;
    const int y0 = (r / tiles_x) * WG_T, x0 = (r % tiles_x) * WG_T;
    const size_t img = static_cast<size_t>(b) * H * W;
    for (int e = tid; e < WG_HALO * WG_CI / V; e += WG_THREADS) {
      const int c = (e % (WG_CI / V)) * V;
      const int pix = e / (WG_CI / V);
      const int gy = y0 - 1 + pix / WG_I, gx = x0 - 1 + pix % WG_I;
      const int ch = ci0 + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < cin;
      const T* src = xa;
      if (in) {
        const size_t p = img + static_cast<size_t>(gy) * W + gx;
        src = ch < Ca ? xa + p * Ca + ch : xb + p * Cb + (ch - Ca);
      }
      copy_in<T, V>(s_in + pix * LDI + c, src, in);
    }
    for (int e = tid; e < WG_PIX * WG_CO / V; e += WG_THREADS) {
      const int c = (e % (WG_CO / V)) * V;
      const int pix = e / (WG_CO / V);
      const int gy = y0 + pix / WG_T, gx = x0 + pix % WG_T;
      const bool in = gy < H && gx < W && co0 + c < Cout;
      const T* src =
          in ? da + (img + static_cast<size_t>(gy) * W + gx) * Cout + co0 + c : da;
      copy_in<T, V>(s_da + pix * LDD + c, src, in);
    }
  };

  float chain[8][4] = {};  // fragment mf * 4 + nf
#pragma unroll
  for (int f = 0; f < 8; ++f) s_acc[f * WG_THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  float bsum = 0.f;  // db: channel tid % 64 over pixels tid / 64 + 9j
  const int b_co = tid % WG_CO, b_pix = tid / WG_CO;

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < n_tiles) load(s);
    tc::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    tc::cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    if (i + WG_STAGES - 1 < n_tiles) load(i + WG_STAGES - 1);
    tc::cp_async_commit();

    const T* s_in = smem + (i % WG_STAGES) * STAGE;
    const T* s_da = s_in + WG_HALO * LDI;
    if constexpr (F32) {
      const float* a_ptr = s_in + (ky * WG_I + kx + quad) * LDI + 4 * grp;
      const float* b_ptr = s_da + quad * LDD + co_w + 4 * grp;
#pragma unroll
      for (int row = 0; row < WG_T; ++row) {  // k-step: 8 pixels of one row
        const float4 x0 = *reinterpret_cast<const float4*>(a_ptr + row * WG_I * LDI);
        const float4 x4 = *reinterpret_cast<const float4*>(a_ptr + (row * WG_I + 4) * LDI);
        const float4 y0 = *reinterpret_cast<const float4*>(b_ptr + row * WG_T * LDD);
        const float4 y4 = *reinterpret_cast<const float4*>(b_ptr + (row * WG_T + 4) * LDD);
        tc::FragA a0, a1;
        tc::split(x0.x, x0.y, x4.x, x4.y, a0);
        tc::split(x0.z, x0.w, x4.z, x4.w, a1);
        const float b0[4] = {y0.x, y0.y, y0.z, y0.w}, b1[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          tc::FragB bf;
          tc::split(b0[nf], b1[nf], bf);
          tc::mma3(chain[nf], a0, bf);
          if (two_rows) tc::mma3(chain[4 + nf], a1, bf);
        }
      }
    } else {
      // 4-byte words: input channels 2 grp, 2 grp + 1 (+ 16 mf) at halo
      // pixel (row + ky, column quad + kx); output channels 2 grp, 2 grp + 1
      // (+ co_w + 16 p) at tile pixel (row, column quad)
      const uint32_t* a_ptr = reinterpret_cast<const uint32_t*>(
          s_in + (ky * WG_I + kx + quad) * LDI + 2 * grp);
      const uint32_t* b_ptr =
          reinterpret_cast<const uint32_t*>(s_da + quad * LDD + co_w + 2 * grp);
#pragma unroll
      for (int ks = 0; ks < WG_T / 2; ++ks) {  // k-step: rows 2 ks, 2 ks + 1
        uint32_t bw[2][4];  // [p][pixel (2ks, q), (2ks + 1, q), (2ks, q + 4), (2ks + 1, q + 4)]
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            bw[p][k] = b_ptr[((2 * ks + (k & 1)) * WG_T + 4 * (k >> 1)) * LDD / 2 + 8 * p];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          if (mf == 1 && !two_rows) break;
          uint32_t aw[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            aw[k] = a_ptr[((2 * ks + (k & 1)) * WG_I + 4 * (k >> 1)) * LDI / 2 + 8 * mf];
          const uint32_t a[4] = {bf::lows(aw[0], aw[1]), bf::highs(aw[0], aw[1]),
                                 bf::lows(aw[2], aw[3]), bf::highs(aw[2], aw[3])};
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint32_t be[2] = {bf::lows(bw[p][0], bw[p][1]), bf::lows(bw[p][2], bw[p][3])};
            const uint32_t bo[2] = {bf::highs(bw[p][0], bw[p][1]),
                                    bf::highs(bw[p][2], bw[p][3])};
            bf::mma(chain[mf * 4 + 2 * p], a, be);
            bf::mma(chain[mf * 4 + 2 * p + 1], a, bo);
          }
        }
      }
    }
    tc::flush(s_acc + tid, WG_THREADS, chain);
    if (sums_bias) {
      for (int p = b_pix; p < WG_PIX; p += WG_WARPS * 32 / WG_CO)
        bsum += to_float(s_da[p * LDD + b_co]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const float4 v = s_acc[f * WG_THREADS + tid];
    const float c[4] = {v.x, v.y, v.z, v.w};
    const int mf = f / 4, nf = f % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // c[j]: row grp (+8 for j >= 2), column 2 quad + j % 2
      int c_i, c_o;
      if constexpr (F32) {
        c_i = ci0 + 4 * grp + 2 * mf + j / 2;
        c_o = co0 + co_w + 8 * quad + nf + 4 * (j % 2);
      } else {
        c_i = ci0 + 16 * mf + 2 * grp + j / 2;
        c_o = co0 + co_w + 16 * (nf / 2) + 4 * quad + 2 * (j % 2) + nf % 2;
      }
      if (c_i < cin && c_o < Cout)
        ws_w[((static_cast<size_t>(chunk) * 9 + tap) * cin + c_i) * Cout + c_o] = c[j];
    }
  }
  if (sums_bias) {  // the 9 partial sums of each channel, in a fixed order
    float* s_b = reinterpret_cast<float*>(smem_raw);
    s_b[tid] = bsum;
    __syncthreads();
    if (tid < WG_CO && co0 + tid < Cout) {
      float s = 0.f;
      for (int k = 0; k < WG_THREADS / WG_CO; ++k) s += s_b[k * WG_CO + tid];
      ws_b[static_cast<size_t>(chunk) * Cout + co0 + tid] = s;
    }
  }
}

// The wgrad of an entry layer (a single input of CIN = 1 or 2 channels: the
// image, or image + mask), float32 or bf16, on the FMA pipes: 9 * CIN * Cout outputs summed over every pixel, too few for a
// tensor-core tile (wgrad_tc filled 1-2 of its 32 input-channel rows, ~0.33
// ms a call at 2 x 512^2 on an H100 in bf16).
// What bounds it: reading da once (bytes; 18 * CIN FLOPs a pixel and output
// channel). grid = (chunks, output-channel slices of 64); a block's 8 warps
// take every 8th pixel of the chunk's range, lane l output channels 64 y +
// 2 l and + 1: the pixel's 9 * CIN inputs are broadcast loads, its two da
// values one 4-byte row segment of the warp's 128 bytes. Sums in float32,
// each lane's in pixel order, the warps' added in order in shared memory,
// each chunk's written to the workspace for sum_chunks.
template <typename T, int CIN>
__global__ void __launch_bounds__(256, 4)
wgrad_entry(const T* __restrict__ x, const T* __restrict__ da, float* __restrict__ ws_w,
            float* __restrict__ ws_b, int H, int W, int Cout, long long n_pix,
            long long pix_per_chunk) {
  constexpr int OUT = 9 * CIN * 64 + 64;  // a warp's partial dW (tap, ci, channel) and db
  __shared__ float red[8][OUT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int co = blockIdx.y * 64 + 2 * lane;
  const long long p0 = blockIdx.x * pix_per_chunk;
  const long long p1 = p0 + pix_per_chunk < n_pix ? p0 + pix_per_chunk : n_pix;
  float acc[9 * CIN][2] = {}, bacc[2] = {};
  long long p = p0 + warp;
  int gx = static_cast<int>(p % W), gy = static_cast<int>((p / W) % H);
  const auto load_da = [&](long long q, int c) {  // the next pixel's, one step ahead
    return q < p1 && c < Cout ? to_float(da[q * Cout + c]) : 0.f;
  };
  float n0 = load_da(p, co), n1 = load_da(p, co + 1);
  for (; p < p1; p += 8) {
    const float d0 = n0, d1 = n1;
    n0 = load_da(p + 8, co);
    n1 = load_da(p + 8, co + 1);
    bacc[0] += d0;
    bacc[1] += d1;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bool in = gy + dy >= 0 && gy + dy < H && gx + dx >= 0 && gx + dx < W;
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        const float v = in ? to_float(x[(p + dy * W + dx) * CIN + ci]) : 0.f;
        acc[tap * CIN + ci][0] += v * d0;
        acc[tap * CIN + ci][1] += v * d1;
      }
    }
    for (gx += 8; gx >= W; gx -= W) gy = gy + 1 == H ? 0 : gy + 1;
  }
#pragma unroll
  for (int k = 0; k < 9 * CIN; ++k) {
    red[warp][k * 64 + 2 * lane] = acc[k][0];
    red[warp][k * 64 + 2 * lane + 1] = acc[k][1];
  }
  red[warp][9 * CIN * 64 + 2 * lane] = bacc[0];
  red[warp][9 * CIN * 64 + 2 * lane + 1] = bacc[1];
  __syncthreads();
  for (int i = threadIdx.x; i < OUT; i += 256) {
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += red[w][i];
    const int c = blockIdx.y * 64 + i % 64;
    if (c >= Cout) continue;
    if (i < 9 * CIN * 64) {
      ws_w[(static_cast<size_t>(blockIdx.x) * 9 * CIN + i / 64) * Cout + c] = v;
    } else {
      ws_b[static_cast<size_t>(blockIdx.x) * Cout + c] = v;
    }
  }
}

// out[i] = sum over c in [0, chunks) of ws[c * n + i], in that order, in
// Acc (float32 for the bf16 layers; float64 for the float32 ones: hundreds
// of float32 partials added in float32 drift by ~1e-6 of the sum, more than
// the chunks' own sums, PERF.md §6), rounded once.
template <typename Acc>
__global__ void sum_chunks(const float* __restrict__ ws, float* __restrict__ out,
                           int n, int chunks) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    Acc s = 0;
    for (int c = 0; c < chunks; ++c) s += ws[static_cast<size_t>(c) * n + i];
    out[i] = static_cast<float>(s);
  }
}

// da[p, c] = [h[p, c] > 0] * round_T(g[p, c] + 0.25 * gp[p / 2, c]) over a
// (B, H, W, C) batch: g (full resolution) or gp ((B, H/2, W/2, C), the 2x2
// pool's cotangent; H, W even) may be null, not both; the sum in float32.
// I: the index type, 32-bit below 2^31 elements (its divisions are the
// pooled pass's cost), else 64-bit.
template <typename T, typename I>
__global__ void masked_cotangent(const T* __restrict__ g, const T* __restrict__ gp,
                                 const T* __restrict__ h, T* __restrict__ da, I H, I W, I C,
                                 I n) {
  for (I i = blockIdx.x * static_cast<I>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<I>(gridDim.x) * blockDim.x) {
    if (!(to_float(h[i]) > 0.f)) {
      da[i] = from_float<T>(0.f);
      continue;
    }
    if (gp == nullptr) {
      da[i] = g[i];
      continue;
    }
    const I pix = i / C, c = i - pix * C;
    const I row = pix / W, x = pix - row * W;  // row = b * H + y
    const I b = row / H, y = row - b * H;
    const I q = ((b * (H / 2) + y / 2) * (W / 2) + x / 2) * C + c;
    const float v = 0.25f * to_float(gp[q]);
    da[i] = from_float<T>(g == nullptr ? v : to_float(g[i]) + v);
  }
}

// ---- host ------------------------------------------------------------------
int grid_1d(long long n) {
  const long long blocks = (n + 255) / 256;
  return blocks < 4096 ? static_cast<int>(blocks) : 4096;
}

// The masked cotangent da_3 of g and/or gp (masked_cotangent) over (B, H, W, C).
template <typename T>
cudaError_t masked_cotangent_pass(const void* g, const void* gp, const void* h3, void* da,
                                  int B, int H, int W, int C, cudaStream_t s) {
  if ((g == nullptr && gp == nullptr) || (gp != nullptr && (H % 2 || W % 2)))
    return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(B) * H * W * C;
  const T *gt = static_cast<const T*>(g), *gpt = static_cast<const T*>(gp);
  const T* ht = static_cast<const T*>(h3);
  T* dat = static_cast<T*>(da);
  if (n < (1LL << 31))
    masked_cotangent<T, unsigned><<<grid_1d(n), 256, 0, s>>>(gt, gpt, ht, dat, H, W, C,
                                                             static_cast<unsigned>(n));
  else
    masked_cotangent<T, long long><<<grid_1d(n), 256, 0, s>>>(gt, gpt, ht, dat, H, W, C, n);
  return cudaGetLastError();
}

template <typename T>
constexpr int wg_vec() { return std::is_same<T, float>::value ? 4 : 8; }

// Blocks of wgrad_tc the card runs at once (SMs x blocks an SM), queried
// once a device (the occupancy query costs the host microseconds a call).
template <typename T>
int wgrad_slots() {
  static int known[64] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && known[dev] > 0) return known[dev];
  const auto kernel = &wgrad_tc<T, wg_vec<T>()>;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem<T>());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG_THREADS, wg_smem<T>());
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) known[dev] = slots;
  return slots;
}

int wgrad_tiles(int B, int H, int W) {
  return B * cdiv(H, WG_T) * cdiv(W, WG_T);
}

// Pixel tiles a chunk for a grid of ``slices`` blocks a chunk: the chunk
// count that fills the card's block slots best (the fewest chunks among the
// best), each chunk >= 1 tile.
int tiles_per_chunk(int slices, int tiles, int slots) {
  const int most = std::min(tiles, std::max(1, cdiv(4 * slots, slices)));
  int best = 1;
  long long best_num = 0, best_den = 1;  // fill = blocks / (waves * slots)
  for (int c = 1; c <= most; ++c) {
    const long long blocks = static_cast<long long>(slices) * c;
    const long long den = (blocks + slots - 1) / slots * slots;
    if (blocks * best_den > best_num * den) {
      best = c;
      best_num = blocks;
      best_den = den;
    }
  }
  return cdiv(tiles, best);
}

// ... of wgrad_tc for one layer.
int wgrad_tiles_per_chunk(int cin, int cout, int tiles, int slots) {
  return tiles_per_chunk(cdiv(cin, WG_CI) * cdiv(cout, WG_CO), tiles, slots);
}

long long wgrad_work(int cin, int cout, int tiles, int slots) {
  const int chunks = cdiv(tiles, wgrad_tiles_per_chunk(cin, cout, tiles, slots));
  return static_cast<long long>(chunks) * (9LL * cin * cout + cout);
}

// The wgmma wgrads' chunking of one layer over its ``tiles`` pixel tiles
// for a grid of ``slices`` blocks a chunk: (tiles a chunk, chunks). A
// block's fixed cost (its first loads, its partial sums written and read
// back by sum_chunks) is about ``block_cost`` tiles' work (bf16: 4 of its
// 8 x 8-pixel tiles; float32: 8 of its 4 x 8), so the count minimises waves
// x (tiles a chunk + that cost), the fewest chunks among the best, within
// the workspace's bound (4 x slots blocks: wgmma_chunks_most).
int wgmma_chunks_most(int tiles, int slices, int slots) {
  return std::min(tiles, std::max(1, cdiv(4 * slots, slices)));
}
void wgmma_chunks(int tiles, int slices, int slots, int block_cost, int* tpc, int* chunks) {
  const int most = wgmma_chunks_most(tiles, slices, slots);
  long long best = -1;
  for (int c = 1; c <= most; ++c) {
    const long long waves = cdiv(slices * c, slots);
    const long long cost = waves * (cdiv(tiles, c) + block_cost);
    if (best < 0 || cost < best) {
      best = cost;
      *tpc = cdiv(tiles, c);
    }
  }
  *chunks = cdiv(tiles, *tpc);
}

// The chunking of a layer's wgrad on its type's wgmma body: tiles a chunk,
// chunks, and the workspace's partial dW (chunks, or twice as many where the
// two consumers take alternate tiles).
template <typename T>
void wgmma_wgrad_plan(int Ca, int Cb, int Cout, int B, int H, int W, int wg_slots, int* tpc,
                      int* chunks, int* parts) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int tiles = F32 ? wgt::wgrad_tiles(B, H, W) : B * cdiv(H, wg::GT) * cdiv(W, wg::GT);
  const int slices = F32 ? wgt::wgrad_slices(Ca, Cb, Cout) : wg::wgrad_slices(Ca, Cb, Cout);
  wgmma_chunks(tiles, slices, wg_slots, F32 ? 8 : 4, tpc, chunks);
  *parts = *chunks * (F32 ? wgt::wgrad_parts(Cout) : wg::wgrad_parts(Cout));
}

// Chunks of wgrad_entry: four blocks an SM (``sms``), so that 32 warps an
// SM hide the loads' latency, at least 1024 pixels each.
int wgrad_entry_chunks(long long n_pix, int sms) {
  const long long most = (n_pix + 1023) / 1024;
  return static_cast<int>(most < 4 * sms ? most : 4 * sms);
}

// dw, db from the partial sums: ws_w's ``parts`` partial dW (n floats
// each), ws_b's ``chunks`` partial db (Cout each), each added in order (in
// float64 for a float32 layer: sum_chunks).
template <typename T>
cudaError_t sum_partials(const float* ws_w, const float* ws_b, float* dw, float* db, int n,
                         int parts, int Cout, int chunks, cudaStream_t s) {
  using Acc = std::conditional_t<std::is_same<T, float>::value, double, float>;
  sum_chunks<Acc><<<grid_1d(n), 256, 0, s>>>(ws_w, dw, n, parts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_chunks<Acc><<<grid_1d(Cout), 256, 0, s>>>(ws_b, db, Cout, chunks);
  return cudaGetLastError();
}

// dW, db of one layer (input [xa | xb], output cotangent da = dh * [h > 0]):
// on its type's wgmma body where wgmma_takes the shape (bf16: wgrad_wgmma,
// float32: wgrad_wgmma_tf32), an entry layer on wgrad_entry, else on
// wgrad_tc; then the chunks' partials added in order. slots: wgrad_tc's
// block slots, wg_slots the wgmma body's.
template <typename T>
cudaError_t wgrad(const T* xa, const T* xb, int Ca, int Cb, const T* da, float* dw,
                  float* db, float* work, int B, int H, int W, int Cout, int slots,
                  int wg_slots, cudaStream_t s) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int VEC = wg_vec<T>();
  const int cin = Ca + Cb;
  cudaError_t err;
  if (wgmma_takes(Ca, Cb, Cout, xa, xb, da, nullptr)) {
    int tpc, chunks, parts;
    wgmma_wgrad_plan<T>(Ca, Cb, Cout, B, H, W, wg_slots, &tpc, &chunks, &parts);
    float* ws_w = work;
    float* ws_b = work + static_cast<size_t>(parts) * 9 * cin * Cout;
    if constexpr (F32)
      err = wgrad_wgmma_tf32_partials<T>(xa, xb, Ca, Cb, da, Cout, ws_w, ws_b, B, H, W, tpc,
                                         chunks, s);
    else
      err = wgrad_wgmma_partials<T>(xa, xb, Ca, Cb, da, Cout, ws_w, ws_b, B, H, W, tpc, chunks,
                                    s);
    if (err != cudaSuccess) return err;
    return sum_partials<T>(ws_w, ws_b, dw, db, 9 * cin * Cout, parts, Cout, chunks, s);
  }
  if (entry_layer(Ca, Cb)) {
    const long long n_pix = static_cast<long long>(B) * H * W;
    const int chunks = wgrad_entry_chunks(n_pix, wg_slots);
    const long long per = (n_pix + chunks - 1) / chunks;
    float* ws_w = work;
    float* ws_b = work + static_cast<size_t>(chunks) * 9 * cin * Cout;
    const dim3 grid(chunks, cdiv(Cout, 64));
    if (Ca == 1)
      wgrad_entry<T, 1><<<grid, 256, 0, s>>>(xa, da, ws_w, ws_b, H, W, Cout, n_pix, per);
    else
      wgrad_entry<T, 2><<<grid, 256, 0, s>>>(xa, da, ws_w, ws_b, H, W, Cout, n_pix, per);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return sum_partials<T>(ws_w, ws_b, dw, db, 9 * cin * Cout, chunks, Cout, chunks, s);
  }
  const int tiles = wgrad_tiles(B, H, W);
  const int tpc = wgrad_tiles_per_chunk(cin, Cout, tiles, slots);
  const int chunks = cdiv(tiles, tpc);
  float* ws_w = work;
  float* ws_b = work + static_cast<size_t>(chunks) * 9 * cin * Cout;
  const dim3 grid(cdiv(cin, WG_CI), cdiv(Cout, WG_CO), chunks);
  const bool vec = Ca % VEC == 0 && Cb % VEC == 0 && Cout % VEC == 0 && aligned16(xa) &&
                   aligned16(xb) && aligned16(da);
  const auto kernel = vec ? &wgrad_tc<T, VEC> : &wgrad_tc<T, 1>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem<T>());
  if (err != cudaSuccess) return err;
  kernel<<<grid, WG_THREADS, wg_smem<T>(), s>>>(xa, xb, Ca, Cb, da, ws_w, ws_b, B, H, W,
                                               Cout, tpc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_partials<T>(ws_w, ws_b, dw, db, 9 * cin * Cout, chunks, Cout, chunks, s);
}

// da_{k-1} (or dx, split into ya: Coa channels, yb: Cob) of one layer with
// kernel w (3, 3, Coa+Cob, C), masked by [m > 0] unless m is null: on the
// wgmma body of its type where wgmma_takes_dgrad the shape (bf16:
// conv3x3_wgmma.cuh; float32: 3xTF32 on conv3x3_wgmma_tf32.cuh, reading the
// hi and lo planes that follow the kernel, tf32_planes.cu), else on
// conv3x3_tc<T, V, false>.
template <typename T>
cudaError_t dgrad(const T* da, const T* w, const T* m, T* ya, T* yb, int Coa, int Cob,
                  int B, int H, int W, int C, cudaStream_t s) {
  if (wgmma_takes_dgrad(C, Coa, Cob, da, w, m, ya, yb)) {
    if constexpr (std::is_same<T, bf16>::value)
      return conv3x3_wgmma_dgrad<T>(da, C, w, m, ya, yb, Coa, Cob, B, H, W, s);
    else
      return conv3x3_wgmma_tf32_dgrad<T>(da, C, w + 9LL * (Coa + Cob) * C, m, ya, yb, Coa, Cob,
                                         B, H, W, s);
  }
  return conv3x3_tc_layer<T, false>(da, nullptr, C, 0, w, nullptr, m, ya, yb, Coa, Cob,
                                    B, H, W, s);
}

// Whether every dgrad and every wgrad but an entry layer's (a single input
// of 1 or 2 channels) of a bf16 block backward on x = [xa | xb] takes the
// wgmma bodies (the wrapper's count of that route); the kernels, h1..h3,
// the workspaces and dx are the wrapper's own allocations, 16-byte aligned.
inline bool bwd_on_wgmma(const void* xa, const void* xb, int Ca, int Cb, int C, bool need_dx) {
  const bool inner = wgmma_takes(C, 0, C, nullptr, nullptr, nullptr, nullptr);
  const bool first = wgmma_takes(Ca, Cb, C, xa, xb, nullptr, nullptr);
  const bool dx = !need_dx || wgmma_takes_dgrad(C, Ca, Cb, nullptr, nullptr, nullptr,
                                                nullptr, nullptr);
  return inner && dx && (first || entry_layer(Ca, Cb));
}

// Whether every dgrad and every wgrad but an entry layer's (a single input
// of 1 or 2 channels, on wgrad_entry) of a float32 block backward on x = [xa
// | xb] (and, with recompute, every tensor-core layer that rebuilds h1, h2)
// takes the 3xTF32 wgmma bodies (conv3x3_wgmma_tf32.cuh,
// wgrad_wgmma_tf32.cuh): the wrapper's count of that route.
inline bool bwd_f32_on_wgmma(const void* xa, const void* xb, int Ca, int Cb, int C,
                             bool need_dx, bool recompute) {
  return bwd_on_wgmma(xa, xb, Ca, Cb, C, need_dx) &&
         (!recompute || block_on_wgmma(xa, xb, Ca, Cb, C));
}

// The wgmma wgrad's block slots of type T (wgrad_wgmma, wgrad_wgmma_tf32).
template <typename T>
int bwd_wgmma_slots() {
  if constexpr (std::is_same<T, bf16>::value) {
    return wgrad_wgmma_slots();
  } else {
    return wgrad_wgmma_tf32_slots();
  }
}

// da1 and da2 are (B, H, W, C) workspaces: da_3 goes to da1, da_2 to da2,
// da_1 to da1 again (da_3 is spent by then). T: float (the kernels HWIO,
// each the first of its three planes, tf32_planes.cu), or bf16 for x, the
// kernels (HWIO, copied as bf16 by the wrapper), h1..h3, g, gp, dx and the
// workspaces; dW, db and work are float32 in both. g or gp may be null (not
// both). With recompute, h1 and h2 are workspaces that the entry first fills
// from x with the forward's layers: f1, f2 the kernels of layers 1 and 2 as
// the forward reads them (HWOI, T; float32: three planes), b1, b2 their
// float32 biases.
template <typename T>
cudaError_t block_bwd(const void* xa_, const void* xb_, int Ca, int Cb, const void* w1_,
                      const void* w2_, const void* w3_, const void* f1_, const void* b1_,
                      const void* f2_, const void* b2_, void* h1_, void* h2_,
                      const void* h3_, const void* g_, const void* gp_, void* dxa_,
                      void* dxb_, void* dw1_, void* db1_, void* dw2_, void* db2_,
                      void* dw3_, void* db3_, void* da1_, void* da2_, void* work_, int B,
                      int H, int W, int C, bool need_dx, bool recompute, cudaStream_t s) {
  const auto c = [](const void* p) { return static_cast<const T*>(p); };
  const auto m = [](void* p) { return static_cast<T*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const T *xa = c(xa_), *xb = c(xb_), *w1 = c(w1_), *w2 = c(w2_), *w3 = c(w3_);
  const T *h3 = c(h3_), *g = c(g_), *gp = c(gp_);
  T *h1 = m(h1_), *h2 = m(h2_), *da1 = m(da1_), *da2 = m(da2_);
  float* work = f(work_);
  if (recompute && (f1_ == nullptr || f2_ == nullptr || b1_ == nullptr || b2_ == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (recompute) {
    const auto b = [](const void* p) { return static_cast<const float*>(p); };
    if ((err = fwd_layer1<T>(xa, xb, Ca, Cb, c(f1_), b(b1_), h1, B, H, W, C, s)) !=
        cudaSuccess)
      return err;
    if ((err = fwd_layer<T>(h1, nullptr, C, 0, c(f2_), b(b2_), h2, C, B, H, W, s)) !=
        cudaSuccess)
      return err;
  }
  const int slots = wgrad_slots<T>(), wg_slots = bwd_wgmma_slots<T>();
  if ((err = masked_cotangent_pass<T>(g, gp, h3, da1, B, H, W, C, s)) != cudaSuccess)
    return err;
  if ((err = wgrad<T>(h2, nullptr, C, 0, da1, f(dw3_), f(db3_), work, B, H, W, C, slots,
                      wg_slots, s)) != cudaSuccess)
    return err;
  if ((err = dgrad<T>(da1, w3, h2, da2, nullptr, C, 0, B, H, W, C, s)) != cudaSuccess)
    return err;
  if ((err = wgrad<T>(h1, nullptr, C, 0, da2, f(dw2_), f(db2_), work, B, H, W, C, slots,
                      wg_slots, s)) != cudaSuccess)
    return err;
  if ((err = dgrad<T>(da2, w2, h1, da1, nullptr, C, 0, B, H, W, C, s)) != cudaSuccess)
    return err;
  if ((err = wgrad<T>(xa, xb, Ca, Cb, da1, f(dw1_), f(db1_), work, B, H, W, C, slots,
                      wg_slots, s)) != cudaSuccess)
    return err;
  if (!need_dx) return cudaSuccess;
  return dgrad<T>(da1, w1, nullptr, m(dxa_), m(dxb_), Ca, Cb, B, H, W, C, s);
}

// Floats of the work buffer of a block with Cin (= Ca + Cb) input channels:
// the most any of its wgrads needs on any route. A wgmma wgrad's chunk count
// is at most wgmma_chunks_most for its input slices of the single-input
// layer (a dual block's split at Ca only adds slices, so fewer chunks).
template <typename T>
long long bwd_work(int B, int H, int W, int Cin, int C) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int slots = wgrad_slots<T>();
  const int tiles = wgrad_tiles(B, H, W);
  long long most = std::max(wgrad_work(C, C, tiles, slots), wgrad_work(Cin, C, tiles, slots));
  const int wg_slots = bwd_wgmma_slots<T>();
  const int wg_tiles = F32 ? wgt::wgrad_tiles(B, H, W) : B * cdiv(H, wg::GT) * cdiv(W, wg::GT);
  for (const int cin : {C, Cin}) {
    const int slices = F32 ? wgt::wgrad_slices(cin, 0, C) : wg::wgrad_slices(cin, 0, C);
    const int parts = F32 ? wgt::wgrad_parts(C) : wg::wgrad_parts(C);
    const long long chunks = wgmma_chunks_most(wg_tiles, slices, wg_slots);
    most = std::max(most, chunks * (parts * 9LL * cin * C + C));
  }
  const long long entry = wgrad_entry_chunks(static_cast<long long>(B) * H * W, wg_slots);
  return std::max(most, entry * (9LL * Cin * C + C));
}

// Which body the wgrad of a layer on x = [xa | xb] with Cout outputs and
// cotangent da takes (wgrad's rule): 1 its type's wgmma body, 2 wgrad_entry,
// 0 wgrad_tc.
inline int wgrad_route(const void* xa, const void* xb, int Ca, int Cb, const void* da,
                       int Cout) {
  return wgmma_takes(Ca, Cb, Cout, xa, xb, da, nullptr) ? 1 : entry_layer(Ca, Cb) ? 2 : 0;
}

}  // namespace

// Single-input block. x: (B, H, W, Cin); w1: (3, 3, Cin, C); w2, w3:
// (3, 3, C, C) (in float32 each followed by its hi and lo planes:
// tf32_planes.cu); h1, h2, h3, g: (B, H, W, C); gp: (B, H/2, W/2, C), the
// cotangent through a 2x2 average pool of the output (g or gp may be null,
// not both). Writes dW (HWIO) and db of the three layers and, with need_dx,
// dx (B, H, W, Cin) (dx may be null without). With recompute, h1 and h2 are
// (B, H, W, C) workspaces the entry fills from x first, with f1 (3, 3, C,
// Cin) and f2 (3, 3, C, C) (HWOI, the forward's layout) and the float32
// biases b1, b2 (null without). Workspaces: da1, da2 (B, H, W, C); work
// (pda_conv_block_bwd_work floats). A null g and gp, an odd H or W with gp,
// or recompute without f1, f2, b1, b2 returns cudaErrorInvalidValue.
//
// Dual-input block on [xa | xb] (Ca + Cb channels): as above, with dx written
// apart into dxa (B, H, W, Ca) and dxb (B, H, W, Cb).
//
// pda_masked_cotangent: the backward's first pass alone, da_3 of g, gp and
// h3 into da (B, H, W, C): what a check holds against its plain version.
//
// pda_wgrad: one layer's wgrad alone, as the block's entries run it: dw (3,
// 3, Ca + Cb, Cout) (HWIO) and db (Cout) of x = [xa | xb] ((B, H, W, Ca),
// (B, H, W, Cb); xb null with Cb = 0) and the layer's output cotangent da
// (B, H, W, Cout), float32; work: pda_wgrad_work floats. pda_wgrad_route:
// the body it takes (wgrad_route); pda_wgrad_wgmma_floats: the floats of
// work its partials take on the wgmma body (which pda_conv_block_bwd_work
// must cover). What a check and a benchmark of the wgrad alone call.
//
// The entries of one operand type T, named with SUFFIX: the _bf16 entries take
// x, w1..w3, f1, f2, h1..h3, g, gp, dx, da1, da2 as bf16; dW, db, b1, b2 and
// work stay float32.
#define PDA_BWD_ENTRIES(SUFFIX, T)                                                     \
  extern "C" int pda_conv_block_bwd##SUFFIX(                                           \
      const void* x, int Cin, const void* w1, const void* w2, const void* w3,          \
      const void* f1, const void* b1, const void* f2, const void* b2, void* h1,        \
      void* h2, const void* h3, const void* g, const void* gp, void* dx, void* dw1,    \
      void* db1, void* dw2, void* db2, void* dw3, void* db3, void* da1, void* da2,     \
      void* work, int B, int H, int W, int C, int need_dx, int recompute,              \
      void* stream) {                                                                  \
    return block_bwd<T>(x, nullptr, Cin, 0, w1, w2, w3, f1, b1, f2, b2, h1, h2, h3, g, \
                        gp, dx, nullptr, dw1, db1, dw2, db2, dw3, db3, da1, da2, work, \
                        B, H, W, C, need_dx != 0, recompute != 0,                      \
                        static_cast<cudaStream_t>(stream));                            \
  }                                                                                    \
  extern "C" int pda_conv_block_bwd_dual##SUFFIX(                                      \
      const void* xa, const void* xb, int Ca, int Cb, const void* w1, const void* w2,  \
      const void* w3, const void* f1, const void* b1, const void* f2, const void* b2,  \
      void* h1, void* h2, const void* h3, const void* g, const void* gp, void* dxa,    \
      void* dxb, void* dw1, void* db1, void* dw2, void* db2, void* dw3, void* db3,     \
      void* da1, void* da2, void* work, int B, int H, int W, int C, int recompute,     \
      void* stream) {                                                                  \
    return block_bwd<T>(xa, xb, Ca, Cb, w1, w2, w3, f1, b1, f2, b2, h1, h2, h3, g, gp, \
                        dxa, dxb, dw1, db1, dw2, db2, dw3, db3, da1, da2, work, B, H,  \
                        W, C, true, recompute != 0, static_cast<cudaStream_t>(stream)); \
  }                                                                                    \
  extern "C" int pda_masked_cotangent##SUFFIX(const void* g, const void* gp,           \
                                              const void* h3, void* da, int B, int H,  \
                                              int W, int C, void* stream) {            \
    return masked_cotangent_pass<T>(g, gp, h3, da, B, H, W, C,                         \
                                    static_cast<cudaStream_t>(stream));                \
  }                                                                                    \
  extern "C" long long pda_wgrad_work##SUFFIX(int B, int H, int W, int Cin, int Cout) { \
    return bwd_work<T>(B, H, W, Cin, Cout);                                            \
  }                                                                                    \
  extern "C" int pda_wgrad_route##SUFFIX(const void* xa, const void* xb, int Ca, int Cb, \
                                         const void* da, int Cout) {                   \
    return wgrad_route(xa, xb, Ca, Cb, da, Cout);                                      \
  }                                                                                    \
  extern "C" long long pda_wgrad_wgmma_floats##SUFFIX(int Ca, int Cb, int Cout, int B,   \
                                                      int H, int W) {                  \
    int tpc, chunks, parts;                                                            \
    wgmma_wgrad_plan<T>(Ca, Cb, Cout, B, H, W, bwd_wgmma_slots<T>(), &tpc, &chunks,    \
                        &parts);                                                       \
    return static_cast<long long>(parts) * 9 * (Ca + Cb) * Cout +                      \
           static_cast<long long>(chunks) * Cout;                                      \
  }                                                                                    \
  extern "C" int pda_wgrad##SUFFIX(const void* xa, const void* xb, int Ca, int Cb,     \
                                   const void* da, void* dw, void* db, void* work,     \
                                   int B, int H, int W, int Cout, void* stream) {      \
    return wgrad<T>(static_cast<const T*>(xa), static_cast<const T*>(xb), Ca, Cb,      \
                    static_cast<const T*>(da), static_cast<float*>(dw),                \
                    static_cast<float*>(db), static_cast<float*>(work), B, H, W, Cout, \
                    wgrad_slots<T>(), bwd_wgmma_slots<T>(),                            \
                    static_cast<cudaStream_t>(stream));                                \
  }
