// One float32 3x3 SAME conv layer (zero padding) in 3xTF32 on Hopper's
// asynchronous tensor-core path (sm_90a): wgmma with TF32 operands from
// shared memory, float32 sums in registers, TMA loads with zero-filled halos
// into an mbarrier ring fed by one producer warp. The float32 layer body of
// the fused ConvBlock forward (conv_block_fwd.cuh: K1 and K2), of the
// backward's recompute of h1, h2 and of the backward's dgrad
// (conv_block_bwd.cuh): one kernel, templated on its epilogue (FwdEpi,
// DgradEpi below), as conv3x3_wgmma.cuh is for bf16.
//
// Replaces, in pda's float32 configuration, the layer of the Pallas TPU
// forward kernels pda/kernels/conv_block.py _kernel (:183) (conv_block.py
// conv_block_fused_flat :391, conv_block_fused_canvas :337, conv_block_fused
// :517, conv_block_fused_flat_dual :447; conv_block_packed.py :536, :482,
// :719, :591, :648) and the dgrad of pda/kernels/conv_block_bwd.py _kernel
// (:69) and conv_block_packed_bwd.py's (rows 1-18 of PERF.md's table).
//
//   forward: y[p, n] = relu(bias[n] + sum_{tap, k} x[p + tap, k] * w[tap][n][k])
//   dgrad:   y[p, n] = [m[p, n] > 0] * sum_{tap, k} da[p + tap, k] * w[8 - tap][n][k]
//
// an implicit GEMM with M = pixels, N = output channels, K = 9 * input
// channels; x = [xa | xb] along channels (K2's [upsample | skip]); the dgrad
// reads the layer's HWIO kernel as [tap][n = Cin][k = Cout] and splits its
// output at Na into ya | yb (the dual block's dxa | dxb). Both operands are
// K-major, which is all TF32 wgmma takes: x is NHWC (channels contiguous),
// the forward's w the wrapper's HWOI copy, the dgrad's w HWIO (k = Cout
// contiguous).
//
// What bounds it: 18 * Cin * Cout FLOPs a pixel against 495 / 3 = 165
// TFLOP/s (3xTF32: three TF32 products a multiply-add, tf32x3.cuh), far
// above the card's 49 FLOPs a byte at every PUNet shape: the tensor cores,
// when they are fed. The mma.sync body (conv3x3_tc.cuh) ran at 34-35% of
// that, bound by shared-memory fragment loads (16 channels a stage, 16-byte
// loads, each value split once a warp that reads it), its chains flushed
// into sums in shared memory every 3 taps, and mma.sync's own rate. Here:
//   - wgmma reads both operands from shared memory by descriptor (no
//     fragment loads, no splits in the inner loop), a 32-channel chunk a
//     stage (4 k8 steps a tap), and promotes its chains into float32 sums
//     held in registers (no flushes to shared memory).
//   - 3xTF32 is three runs of wgmma a tap, in tf32x3.cuh's order: lo_a *
//     hi_b, then hi_a * lo_b, then hi_a * hi_b, over the chunk's 4 k8 steps
//     each. The activations are split once a chunk: when a halo chunk lands,
//     the two consumer warpgroups rewrite it as hi = tf32(x) in place and
//     lo = tf32(x - hi) in a twin plane, and that split serves all nine
//     taps. The weights' hi and lo planes come split from the wrapper's
//     per-call copy of the kernel (tf32_planes.cu).
//   - the tensor cores accumulate with truncation (tf32x3.cuh), each add at
//     the scale of its accumulator. So the two small products run into a
//     chain of their own (8 wgmma a tap, their adds at 2^-11 of the sum's
//     scale) and hi_a * hi_b into another (4 a tap); both run
//     Epi::CHAIN_TAPS taps from zeroed registers and are then added into
//     the float32 sums held in registers with round-to-nearest adds. The
//     chain length is the longest whose drift against float64 is no larger
//     than the mma.sync body's at the same shapes: 3 taps in the forward, 9
//     in the dgrad (on an H100, PERF.md §6: one chain of all three products
//     drifts 1.0-1.8e-6 at 3 taps against that body's 0.7-1.2e-6; split in
//     two, 0.5-1.0e-6). Three accumulators of BN / 2 floats a thread (192 at
//     BN = 128) fit the consumers' 232 registers only with the consumers'
//     barrier waits bounded by a count of polls (mbar_wait_polls): with the
//     clock's reads in the wait loop ptxas spilled 676-1,468 bytes and
//     serialized the wgmma (its C7512).
//   - one producer warp issues TMA loads; threads spend nothing on copies.
//     The halo tile is a 4-D tiled map over NHWC (C, W, H, B) read at
//     coordinates that may be negative or past the image: TMA zero-fills
//     outside it, which is the SAME padding, and past C, which is a ragged
//     chunk (C = 16, 48, ...). K2 takes one map for xa and one for xb: a
//     chunk reads one of them. Weights: one (K, N, 18) map over the hi
//     plane (taps 0-8) and the lo plane after it (taps 9-17), one box of 32
//     k x BN n a plane, tap and chunk, its 128-byte rows swizzled (128B),
//     the layout wgmma reads a K-major B in.
//   - the halo tile of a chunk stays while its nine taps' weight tiles (hi
//     and lo) stream through a ring as deep as shared memory allows (4 at
//     BN = 128, 3 at 64); the halo ring is two deep.
//
// The shifted A operand, as conv3x3_wgmma.cuh's with 4 float32 channels to
// a 16-byte core-matrix row: shared memory holds each 4-channel group of the
// halo apart, [group][halo row][halo column][4 channels]; eight neighbouring
// pixels of a halo row are one core matrix whatever the shift; an m64 tile
// is 8 x 8 pixels, its stride-byte offset the halo row pitch (288 bytes), its
// leading-byte offset the group pitch (one k8 step spans two groups), and a
// tap moves the start address by whole 16-byte pixels.
//
// Tiling: a block owns 8 * MT x 16 pixels x BN output channels; three
// warpgroups: the producer (one thread issues every load; setmaxnreg gives
// its registers to the others) and two consumers, each 8 * MT x 8 pixels (MT
// m64 tiles) x BN channels. BN = 128, MT = 1 where N > 64; BN = 64, MT = 2
// where N <= 64. The epilogue stores each thread's two adjacent channels of
// a pixel as one 8-byte store (a quad of lanes: 32 contiguous bytes).
//
// Shapes: Ka, Kb and N multiples of 8 and every pointer 16-byte aligned, as
// conv3x3_wgmma.cuh's wgmma_takes; for the dgrad's split Na, Nb multiples of
// 8 (wgmma_takes_dgrad). conv_block_fwd.cuh and conv_block_bwd.cuh route
// every other float32 layer to conv3x3_tc<float, V, FWD> by shape, before
// launch. Each output pixel's sum runs in the same order wherever its tile
// lies, so a row shard's outputs are the whole image's bit for bit.
#pragma once

#include <type_traits>

#include "conv3x3_wgmma.cuh"

namespace {
namespace wt {

constexpr int KC = 32;               // input channels a chunk: 4 k8 steps a tap
constexpr int GROUPS = KC / 4;       // 4-channel groups a chunk (16 bytes a pixel each)
constexpr int TW = 16;               // pixel columns a block (8 a consumer)
constexpr int HALO_W = TW + 2;       // halo columns
constexpr int ROW_PITCH = HALO_W * 16;  // bytes between halo rows of one group
constexpr int HALO_STAGES = 2;
constexpr int THREADS = 384;         // producer warpgroup + two consumer warpgroups
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may take
constexpr int SPLIT_BAR = 1;         // the consumers' named barrier after a chunk's split

// Shared-memory layout of one instance (bytes from a 1024-byte-aligned base:
// the 128-byte swizzle of the weight tiles repeats every 1024 bytes).
template <int BN, int MT>
struct Layout {
  static constexpr int HALO_H = 8 * MT + 2;
  static constexpr int GROUP_BYTES = wg::round_up(HALO_H * ROW_PITCH, 128);
  static constexpr int HALO_BOX = HALO_H * ROW_PITCH;         // bytes TMA writes a group
  static constexpr int PLANE = GROUPS * GROUP_BYTES;           // a chunk's hi (or lo)
  static constexpr int HALO_STAGE = 2 * PLANE;                 // hi, then lo
  static constexpr int W_TILE = BN * KC * 4;                   // BN rows of 128 bytes
  static constexpr int W_STAGE = 2 * W_TILE;                   // hi, then lo
  static constexpr int HALO = 0;
  static constexpr int WEIGHTS = wg::round_up(HALO + HALO_STAGES * HALO_STAGE, 1024);
  // as many weight stages as fit beside the halo ring, at most 6
  static constexpr int W_FIT = (SMEM_MAX - 1024 - WEIGHTS - 8 * 2 * (HALO_STAGES + 6)) / W_STAGE;
  static constexpr int W_STAGES = W_FIT < 6 ? W_FIT : 6;
  static constexpr int BARS = WEIGHTS + W_STAGES * W_STAGE;    // 8-byte mbarriers
  static constexpr int BYTES = BARS + 8 * 2 * (HALO_STAGES + W_STAGES);
  static constexpr int SMEM = BYTES + 1024;                    // + the base's alignment
  static_assert(W_STAGES >= 2 && SMEM <= SMEM_MAX, "the rings fit in shared memory");
};

// d (+)= A * B, m64nBNk8, TF32 operands from shared memory (both K-major),
// float32 accumulators; scale_d 0 starts a chain (d = A * B).
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 128) {
    mma_n128(d, a, b, scale_d);
  } else {
    mma_n64(d, a, b, scale_d);
  }
}

// hi = tf32(x) (cvt.rna.tf32.f32's bits for finite x, as tf32x3.cuh's split)
// and lo = tf32(x - hi), both with their low 13 bits zero
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
  lo = __uint_as_float((__float_as_uint(x - hi) + 0x1000u) & 0xFFFFE000u);
}

// The forward's epilogue: relu(sum + bias[n]) into y with N channels.
struct FwdEpi {
  static constexpr bool FLIP = false;  // tap' = tap
  // taps a chain runs before it is added into the float32 sums (9 must be a
  // multiple: a chunk ends a chain)
  static constexpr int CHAIN_TAPS = 3;
  const float* bias;
  float* y;
  int N;
  __device__ float2 prep(int n) const { return make_float2(bias[n], bias[n + 1]); }
  // channels n, n + 1 of pixel pix
  __device__ void store(size_t pix, int n, float a, float b, float2 p) const {
    *reinterpret_cast<float2*>(y + pix * N + n) = make_float2(fmaxf(a + p.x, 0.f),
                                                              fmaxf(b + p.y, 0.f));
  }
};

// The dgrad's epilogue: the sum, zeroed where mask[p, n] is not > 0 (mask
// null: none), into ya (channels [0, Na)) or yb ([Na, N)). A masked value is
// +0, as the plain version's where().
struct DgradEpi {
  static constexpr bool FLIP = true;  // tap' = 8 - tap: the flipped kernel
  static constexpr int CHAIN_TAPS = 9;
  const float* mask;
  float* ya;
  float* yb;
  int Na, N;
  __device__ float2 prep(int) const { return make_float2(0.f, 0.f); }
  __device__ void store(size_t pix, int n, float a, float b, float2) const {
    if (mask != nullptr) {
      const float2 m = *reinterpret_cast<const float2*>(mask + pix * N + n);
      a = m.x > 0.f ? a : 0.f;
      b = m.y > 0.f ? b : 0.f;
    }
    if (n < Na) {
      *reinterpret_cast<float2*>(ya + pix * Na + n) = make_float2(a, b);
    } else {
      *reinterpret_cast<float2*>(yb + pix * (N - Na) + (n - Na)) = make_float2(a, b);
    }
  }
};

// grid = (pixel tiles of an image, output-channel slices of BN, B). xa_map,
// xb_map: (C, W, H, B) maps of xa and xb (xb_map = xa_map when Kb = 0), box
// (4, 18, 8 * MT + 2, 1); w_map: (K, N, 18) over the [tap][n][k] hi plane
// and the lo plane after it, box (32, BN, 1). chunks_a, chunks_b: 32-channel
// chunks of xa and xb; Ka: where xb's rows of w start. Epi: FwdEpi or
// DgradEpi (its N the output channels).
template <int BN, int MT, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_tf32(const __grid_constant__ CUtensorMap xa_map,
                   const __grid_constant__ CUtensorMap xb_map,
                   const __grid_constant__ CUtensorMap w_map, int chunks_a, int chunks_b, int Ka,
                   const Epi epi, int H, int W, int tiles_x) {
  using L = Layout<BN, MT>;
  constexpr int CHAIN = Epi::CHAIN_TAPS;
  static_assert(9 % CHAIN == 0, "a chunk's nine taps end a chain");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = wg::smem_u32(smem);
  const uint32_t halo_full = base + L::BARS, halo_empty = halo_full + 8 * HALO_STAGES;
  const uint32_t w_full = halo_empty + 8 * HALO_STAGES, w_empty = w_full + 8 * L::W_STAGES;
  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_x) * 8 * MT;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int n_chunks = chunks_a + chunks_b;

  if (tid == 0) {
    for (int s = 0; s < HALO_STAGES; ++s) {
      wg::mbar_init(halo_full + 8 * s, 1);
      wg::mbar_init(halo_empty + 8 * s, 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < L::W_STAGES; ++s) {
      wg::mbar_init(w_full + 8 * s, 1);
      wg::mbar_init(w_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int t = 0;  // weight stages issued
      for (int c = 0; c < n_chunks; ++c) {
        const int hs = c % HALO_STAGES;
        wg::mbar_wait(halo_empty + 8 * hs, ((c / HALO_STAGES) & 1) ^ 1);
        const uint32_t hbar = halo_full + 8 * hs;
        wg::mbar_expect_tx(hbar, GROUPS * L::HALO_BOX);
        const bool from_a = c < chunks_a;
        const int c0 = (from_a ? c : c - chunks_a) * KC;  // the chunk's first channel of x
        const CUtensorMap* map = from_a ? &xa_map : &xb_map;
        const uint32_t hdst = base + L::HALO + hs * L::HALO_STAGE;
        for (int g = 0; g < GROUPS; ++g)
          wg::tma_load_4d(hdst + g * L::GROUP_BYTES, map, hbar, c0 + 4 * g, x0 - 1, y0 - 1, b);
        const int k0 = from_a ? c0 : Ka + c0;  // the chunk's first row of w's K
        for (int tap = 0; tap < 9; ++tap, ++t) {
          const int ws = t % L::W_STAGES;
          wg::mbar_wait(w_empty + 8 * ws, ((t / L::W_STAGES) & 1) ^ 1);
          const uint32_t wbar = w_full + 8 * ws;
          wg::mbar_expect_tx(wbar, L::W_STAGE);
          const uint32_t wdst = base + L::WEIGHTS + ws * L::W_STAGE;
          const int wtap = Epi::FLIP ? 8 - tap : tap;
          wg::tma_load_3d(wdst, &w_map, wbar, k0, n0, wtap);                 // hi
          wg::tma_load_3d(wdst + L::W_TILE, &w_map, wbar, k0, n0, 9 + wtap);  // lo
        }
      }
    }
  } else {  // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ctid = tid - 128;        // 0 .. 255 over both consumers
    const int cw = ctid / 128;         // 8-pixel column half of the block
    const int wtid = tid % 128;
    const int warp = wtid / 32, lane = tid % 32;
    // chain: the hi_a * hi_b products; small: the two small ones (lo_a *
    // hi_b, hi_a * lo_b), in a chain of their own so that their adds truncate
    // at their own scale (2^-11 of the sum's), not at the large chain's
    float sum[MT][BN / 2], chain[MT][BN / 2], small[MT][BN / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[mt][i] = chain[mt][i] = small[mt][i] = 0.f;

    for (int c = 0, t = 0; c < n_chunks; ++c) {
      const int hs = c % HALO_STAGES;
      wg::mbar_wait_polls(halo_full + 8 * hs, (c / HALO_STAGES) & 1);
      // the chunk's split, once for all nine taps: hi in place, lo in the twin
      {
        float4* hi = reinterpret_cast<float4*>(smem + L::HALO + hs * L::HALO_STAGE);
        float4* lo = reinterpret_cast<float4*>(smem + L::HALO + hs * L::HALO_STAGE + L::PLANE);
        for (int i = ctid; i < L::PLANE / 16; i += 256) {
          const float4 v = hi[i];
          float4 h, l;
          split(v.x, h.x, l.x);
          split(v.y, h.y, l.y);
          split(v.z, h.z, l.z);
          split(v.w, h.w, l.w);
          hi[i] = h;
          lo[i] = l;
        }
        // the generic proxy's writes, before the async proxy (wgmma) reads them
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 256;\n" ::"n"(SPLIT_BAR) : "memory");
      }
      const uint32_t halo = base + L::HALO + hs * L::HALO_STAGE + cw * 8 * 16;
      int pending = -1;  // a weight stage read by a group still in flight
      // The taps are unrolled, so that no wgmma group is in flight where
      // control flow merges (ptxas would otherwise wait for every group there)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++t) {
        const int ws = t % L::W_STAGES;
        wg::mbar_wait_polls(w_full + 8 * ws, (t / L::W_STAGES) & 1);
        const int ky = tap / 3, kx = tap % 3;
        const uint32_t wst = base + L::WEIGHTS + ws * L::W_STAGE;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wg::fence_regs(chain[mt]);
          wg::fence_regs(small[mt]);
        }
        wg::wgmma_fence();
        // lo_a * hi_b, hi_a * lo_b, hi_a * hi_b, each over the chunk's 4 k8 steps
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const uint32_t a_plane = term == 0 ? L::PLANE : 0;
          const uint32_t b_tile = term == 1 ? L::W_TILE : 0;
#pragma unroll
          for (int ks = 0; ks < KC / 8; ++ks) {
            const uint64_t bd = wg::desc_sw128(wst + b_tile + 32 * ks);
            // 0 starts a chain: the first product of each chain's first tap
            const int scale = (tap % CHAIN != 0 || term == 1 || ks != 0) ? 1 : 0;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const uint64_t ad = wg::desc(
                  halo + a_plane + 2 * ks * L::GROUP_BYTES + ((8 * mt + ky) * HALO_W + kx) * 16,
                  L::GROUP_BYTES, ROW_PITCH);
              mma<BN>(term < 2 ? small[mt] : chain[mt], ad, bd, scale);
            }
          }
        }
        wg::wgmma_commit();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wg::fence_regs(chain[mt]);
          wg::fence_regs(small[mt]);
        }
        if (tap % CHAIN == CHAIN - 1) {  // the chains end: into the sums
          wg::wgmma_wait<0>();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            wg::fence_regs(chain[mt]);
            wg::fence_regs(small[mt]);
          }
          wg::mbar_arrive_if(w_empty + 8 * pending, lane == 0 && pending >= 0);
          wg::mbar_arrive_if(w_empty + 8 * ws, lane == 0);
          pending = -1;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < BN / 2; ++i)
              sum[mt][i] += chain[mt][i] + small[mt][i];
        } else {  // the previous tap's group is done: free its weights
          wg::wgmma_wait<1>();
          wg::mbar_arrive_if(w_empty + 8 * pending, lane == 0 && pending >= 0);
          pending = ws;
        }
      }
      wg::mbar_arrive_if(halo_empty + 8 * hs, lane == 0);  // the chunk's last chain is done
    }

    // Epilogue: accumulator element 4 j + 2 h + e of m-tile mt is m-row 16
    // warp + lane / 4 + 8 h, channel 8 j + 2 (lane % 4) + e; m-row r of the
    // 8 x 8 tile is pixel (r / 8, r % 8). A thread's channels e = 0, 1 of a
    // pixel go out as one 8-byte store.
    const int grp = lane / 4, quad = lane % 4;
    const size_t img = static_cast<size_t>(b) * H * W;
    const int gx = x0 + 8 * cw + grp;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * quad;
      if (n >= epi.N) continue;  // N a multiple of 8: n + 1 < N too
      const float2 p = epi.prep(n);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gy = y0 + 8 * mt + 2 * warp + h;
          if (gy < H && gx < W)
            epi.store(img + static_cast<size_t>(gy) * W + gx, n, sum[mt][4 * j + 2 * h],
                      sum[mt][4 * j + 2 * h + 1], p);
        }
    }
  }
}

// The (C, W, H, B) halo map of a float32 NHWC tensor with C channels.
template <int MT>
inline bool encode_x(CUtensorMap* map, const float* x, int C, int B, int H, int W) {
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {4ull * C, 4ull * C * W, 4ull * C * W * H};
  const uint32_t box[4] = {4, HALO_W, 8 * MT + 2, 1};
  return wg::encode(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// One layer: x = [xa | xb] (Ka + Kb channels), w_hilo the hi plane
// [tap][n][k] (9, N, Ka + Kb) with the lo plane after it, epi.N outputs.
template <int BN, int MT, class Epi>
cudaError_t launch(const float* xa, const float* xb, int Ka, int Kb, const float* w_hilo,
                   const Epi& epi, int B, int H, int W, cudaStream_t s) {
  using L = Layout<BN, MT>;
  CUtensorMap ma, mb, mw;
  const int K = Ka + Kb, N = epi.N;
  const uint64_t wdims[3] = {static_cast<uint64_t>(K), static_cast<uint64_t>(N), 18};
  const uint64_t wstrides[2] = {4ull * K, 4ull * K * N};
  const uint32_t wbox[3] = {KC, BN, 1};
  if (!encode_x<MT>(&ma, xa, Ka, B, H, W) ||
      !wg::encode(&mw, w_hilo, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  if (Kb == 0) {
    mb = ma;  // never read
  } else if (!encode_x<MT>(&mb, xb, Kb, B, H, W)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = &conv3x3_wgmma_tf32<BN, MT, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = cdiv(W, TW);
  const dim3 grid(tiles_x * cdiv(H, 8 * MT), cdiv(N, BN), B);
  kernel<<<grid, THREADS, L::SMEM, s>>>(ma, mb, mw, cdiv(Ka, KC), cdiv(Kb, KC), Ka, epi, H, W,
                                        tiles_x);
  return cudaGetLastError();
}

}  // namespace wt

// Launch one float32 layer over a (B, H, W, *) batch on ``s``: x = [xa |
// xb] (xb null with Kb = 0), w_hilo the hi and lo planes of the HWOI kernel
// (2, 3, 3, N, Ka + Kb; tf32_planes.cu), bias float32, y (B, H, W, N). The
// caller checks wgmma_takes first. A failed encode returns
// cudaErrorInvalidValue. A template, so that only the sources that launch
// it (T = float) compile its kernels.
template <typename T>
cudaError_t conv3x3_wgmma_tf32_layer(const T* xa, const T* xb, int Ka, int Kb, const T* w_hilo,
                                     const float* bias, T* y, int N, int B, int H, int W,
                                     cudaStream_t s) {
  static_assert(std::is_same<T, float>::value, "the 3xTF32 wgmma body is float32's");
  const wt::FwdEpi epi{bias, y, N};
  return N <= 64 ? wt::launch<64, 2>(xa, xb, Ka, Kb, w_hilo, epi, B, H, W, s)
                 : wt::launch<128, 1>(xa, xb, Ka, Kb, w_hilo, epi, B, H, W, s);
}

// Launch one float32 dgrad over a (B, H, W, *) batch on ``s``: da (B, H, W,
// K), w_hilo the hi and lo planes of the layer's HWIO kernel (2, 3, 3, Na +
// Nb, K), y = [ya | yb] (yb null with Nb = 0) = the flipped conv of da
// masked by [m > 0] (m (B, H, W, Na + Nb), or null). The caller checks
// wgmma_takes_dgrad first.
template <typename T>
cudaError_t conv3x3_wgmma_tf32_dgrad(const T* da, int K, const T* w_hilo, const T* m, T* ya,
                                     T* yb, int Na, int Nb, int B, int H, int W, cudaStream_t s) {
  static_assert(std::is_same<T, float>::value, "the 3xTF32 wgmma body is float32's");
  const wt::DgradEpi epi{m, ya, yb, Na, Na + Nb};
  return epi.N <= 64 ? wt::launch<64, 2>(da, nullptr, K, 0, w_hilo, epi, B, H, W, s)
                     : wt::launch<128, 1>(da, nullptr, K, 0, w_hilo, epi, B, H, W, s);
}

}  // namespace
