// One bf16 3x3 SAME conv layer (zero padding) + bias + ReLU on Hopper's
// asynchronous tensor-core path (sm_90a): wgmma with float32 sums in
// registers, TMA loads with zero-filled halos into an mbarrier ring fed by one
// producer warp. The bf16 layer body of the fused ConvBlock forward
// (conv_block_fwd.cuh: K1 and K2), of the backward's recompute of h1, h2 and
// of the backward's dgrad (conv_block_bwd.cuh): one kernel, templated on its
// epilogue (FwdEpi, DgradEpi below).
//
// Replaces, in pda's bf16 configuration, the layer of the Pallas TPU forward
// kernels pda/kernels/conv_block.py _kernel (:183), which every forward row
// runs: conv_block.py conv_block_fused_flat (:391), conv_block_fused_canvas
// (:337), conv_block_fused (:517), conv_block_fused_flat_dual (:447);
// conv_block_packed.py conv_block_packed_flat (:536), conv_block_packed_canvas
// (:482), conv_block_packed (:719), conv_block_packed_image (:591),
// conv_block_packed_flat_dec (:648). Its numerics: bf16 operands, products
// summed in float32, the float32 bias added, the ReLU, one rounding to bf16.
//
//   y[p, n] = relu(bias[n] + sum_{tap, k} x[p + tap, k] * w[tap][n][k])
//
// an implicit GEMM with M = pixels, N = output channels, K = 9 * input
// channels; x = [xa | xb] along channels (K2's [upsample | skip], never
// concatenated in device memory); w HWOI, [tap][n][k] with k contiguous, as
// wgmma reads a K-major B.
//
// The dgrad (DgradEpi; replaces the dgrad of pda/kernels/conv_block_bwd.py
// _kernel (:69) and conv_block_packed_bwd.py's, rows 10-18 of PERF.md's
// table) is the same GEMM with x = da_k (the layer's masked output
// cotangent), N = the layer's input channels, K = 9 * its output channels,
// and the kernel flipped: tap' = 8 - tap, read from the layer's HWIO kernel
// ([tap][n = Cin][k = Cout], k contiguous: already the K-major B, no copy).
// Its epilogue: no bias, no ReLU; the float32 sum rounded to bf16 once, then
// zeroed where the layer below's output m[p, n] is not > 0 (the ReLU mask;
// none for dx), and stored split at Na into ya | yb (the dual block's dxa |
// dxb: neither the concat nor its cotangent exists).
//
// What bounds it: 18 * Cin * Cout FLOPs a pixel against 989 TFLOP/s dense
// bf16, and 128-1,152 FLOPs for every byte a layer must move at the PUNet's
// shapes, above the card's ~295: the tensor cores, when they are fed. The
// mma.sync body (conv3x3_tc.cuh) was bound by shared-memory traffic: 16
// input channels a stage, 8-byte fragment loads, and its chains flushed into
// float32 sums held in shared memory every 3 taps. Here:
//   - wgmma reads both operands from shared memory by descriptor (no
//     fragment loads), a 64-channel chunk a stage, and its float32 chain is
//     promoted into float32 sums held in registers (no flushes to shared
//     memory). The tensor cores accumulate with truncation (bf16.cuh), so a
//     chain runs WG_CHAIN_TAPS taps (4 k16 steps a tap) into zeroed
//     registers and is then added into the sums with round-to-nearest adds.
//     Nine taps (a chunk, 576 products) keep every layer of the flagship's
//     shapes >= 99.98% bit-equal to float64 sums rounded once, three taps
//     >= 99.99%, at about the same time (PERF.md §6).
//   - one producer warp issues TMA loads; threads spend nothing on copies.
//     The halo tile is one 4-D tiled map over NHWC (C, W, H, B) read at
//     coordinates that may be negative or past the image: TMA zero-fills
//     outside it, which is the SAME padding, and past C, which is a ragged
//     chunk (C = 16, 48, ...). K2 takes one map for xa and one for xb: a
//     chunk reads one of them. Weights: a (K, N, 9 taps) map, one box of 64
//     k x BN n a tap and chunk, its 128-byte rows swizzled (128B), the
//     layout wgmma reads a K-major B in (16-byte boxes, as the halo's, fetch
//     each 32-byte sector twice: PERF.md §6).
//   - the halo tile of a chunk (64 channels) stays while its nine taps'
//     weight tiles stream through a W_STAGES-deep ring; the halo ring is two
//     deep (a chunk spans nine weight stages).
//   - the nine taps of a chunk are unrolled: where control flow merges with
//     a wgmma group in flight, ptxas waits for the group (its C7517), which
//     left one group in flight a warpgroup instead of two.
//
// The shifted A operand. A tap reads the halo tile shifted by (ky, kx)
// pixels. Shared memory holds each 8-channel group of the halo apart,
// [group][halo row][halo column][8 channels]: a pixel is one 16-byte row of
// a core matrix, so with no swizzle (K-major, the "interleave" layout) eight
// neighbouring pixels of a halo row are one core matrix, whatever the shift.
// An m64 tile is 8 x 8 pixels: its eight core-matrix rows are eight halo
// rows, the stride-byte offset is the halo row pitch (18 pixels, 288
// bytes), the leading-byte offset the group pitch, and a tap moves the start
// address by whole 16-byte pixels. (TMA writes each group as one box of
// (8 channels, 18, rows, 1).)
//
// Tiling: a block owns 8 * MT x 16 pixels x BN output channels; three
// warpgroups: the producer (one thread issues every load; setmaxnreg gives
// its registers to the others) and two consumers, each 8 * MT x 8 pixels (MT
// m64 tiles) x BN channels. BN = 128, MT = 1 where N > 64; BN = 64, MT =
// 2 (16 x 16 pixels a block) where N <= 64, so a 64-channel layer wastes
// no half tile. The epilogue (the forward's: the float32 bias, the ReLU)
// rounds to bf16 once, stages the tile in shared memory and writes whole
// 16-byte pieces of each pixel's channels, masked at the ragged edge (the
// dgrad's: the mask read and applied 16 bytes at a time, then the split).
//
// Shapes: Ka, Kb and N multiples of 8 and every pointer 16-byte aligned
// (what a tensor map describes), and for the dgrad's split Na, Nb multiples
// of 8; conv_block_fwd.cuh and conv_block_bwd.cuh route every other bf16
// layer to conv3x3_tc<bf16, V, FWD> by shape, before launch.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv3x3_tc.cuh"

namespace {
namespace wg {

constexpr int KC = 64;               // input channels a chunk
constexpr int GROUPS = KC / 8;       // 8-channel groups a chunk (16 bytes a pixel each)
constexpr int TW = 16;               // pixel columns a block (8 a consumer)
constexpr int HALO_W = TW + 2;       // halo columns
constexpr int ROW_PITCH = HALO_W * 16;  // bytes between halo rows of one group
constexpr int HALO_STAGES = 2;
constexpr int W_STAGES = 6;
constexpr int THREADS = 384;         // producer warpgroup + two consumer warpgroups
// taps a wgmma chain runs into zeroed registers before it is added into the
// float32 sums (9 must be a multiple: a chunk ends a chain)
constexpr int WG_CHAIN_TAPS = 9;
static_assert(9 % WG_CHAIN_TAPS == 0, "a chunk's nine taps end a chain");

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Shared-memory layout of one instance (bytes from a 1024-byte-aligned base:
// the 128-byte swizzle of the weight tiles repeats every 1024 bytes).
template <int BN, int MT>
struct Layout {
  static constexpr int HALO_H = 8 * MT + 2;
  static constexpr int GROUP_BYTES = round_up(HALO_H * ROW_PITCH, 128);  // one 8-channel group
  static constexpr int HALO_BOX = HALO_H * ROW_PITCH;               // bytes TMA writes a group
  static constexpr int HALO_STAGE = GROUPS * GROUP_BYTES;
  static constexpr int W_STAGE = BN * KC * 2;                       // BN rows of 128 bytes
  static constexpr int OUT_PITCH = BN * 2 + 16;                     // staging row (a pixel)
  static constexpr int OUT_WG = MT * 64 * OUT_PITCH;                // a consumer's staging
  static constexpr int HALO = 0;
  static constexpr int WEIGHTS = round_up(HALO + HALO_STAGES * HALO_STAGE, 1024);
  static constexpr int OUT = WEIGHTS + W_STAGES * W_STAGE;
  static constexpr int BARS = OUT + 2 * OUT_WG;                     // 8-byte mbarriers
  static constexpr int BYTES = BARS + 8 * 2 * (HALO_STAGES + W_STAGES);
  static constexpr int SMEM = BYTES + 1024;                         // + the base's alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (shared::cta)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// An arrival where ``pred`` holds, predicated rather than branched around:
// the consumers arrive while a wgmma group is in flight.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}
// Wait for the phase of parity ``parity`` to complete. A barrier that never
// completes (a fault in this file) traps after 20 s, so the launch fails
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
      if (t0 == 0) {
        t0 = t;
      } else if (t - t0 > 20000000000ull) {
        __trap();
      }
    }
  }
}

// The same wait, bounded by a count of polls instead of the clock: in a
// consumer that holds its sums in registers (wgrad_wgmma.cuh) the clock's
// 64-bit reads in the wait loop made ptxas spill them (276 bytes; none
// without). 2^26 polls take over a second (each one tens of cycles at the
// least, more where try_wait suspends the thread), far beyond any wait on a
// tile of a running kernel.
__device__ __forceinline__ void mbar_wait_polls(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; n < (1u << 26); ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// TMA tile loads into shared memory, completing on an mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor, K-major with no swizzle: the start
// address, the leading-byte offset (between the two 8-element core matrices
// of a k16 step) and the stride-byte offset (between 8-row core matrices
// along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// ... and K-major with the 128-byte swizzle (as TMA writes a box whose rows
// are 128 bytes): 8-row atoms of 1024 bytes (the stride-byte offset), the
// leading-byte offset unused; a k16 step starts 32 bytes further along the
// row (the swizzle is applied to the address, so the start needs no base
// offset while the atoms are 1024-byte aligned).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of the accumulators across
// the wgmma fences, commits and waits around it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A * B, m64nBNk16, bf16 operands from shared memory, float32
// accumulators; scale_d 0 starts a chain (d = A * B).
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// The forward's epilogue: relu(sum + bias[n]) (float32 bias), into y with N
// channels.
struct FwdEpi {
  static constexpr bool FLIP = false;  // tap' = tap
  const float* bias;
  __nv_bfloat16* y;
  int N;
  __device__ float2 prep(int n) const {  // the bias of channels n, n + 1
    return make_float2(n < N ? bias[n] : 0.f, n < N ? bias[n + 1] : 0.f);
  }
  __device__ float2 apply(float a, float b, float2 p) const {
    return make_float2(fmaxf(a + p.x, 0.f), fmaxf(b + p.y, 0.f));
  }
  // 8 channels from n of pixel pix, rounded to bf16
  __device__ void store(size_t pix, int n, uint4 v) const {
    *reinterpret_cast<uint4*>(y + pix * N + n) = v;
  }
};

// The dgrad's epilogue: the sum as it is, rounded to bf16, zeroed where
// mask[p, n] is not > 0 (mask null: none), into ya (channels [0, Na)) or yb
// ([Na, N)). A masked value is +0, as the plain version's where().
struct DgradEpi {
  static constexpr bool FLIP = true;  // tap' = 8 - tap: the flipped kernel
  const __nv_bfloat16* mask;
  __nv_bfloat16* ya;
  __nv_bfloat16* yb;
  int Na, N;
  __device__ float2 prep(int) const { return make_float2(0.f, 0.f); }
  __device__ float2 apply(float a, float b, float2) const { return make_float2(a, b); }
  __device__ void store(size_t pix, int n, uint4 v) const {
    if (mask != nullptr) {
      const uint4 m = *reinterpret_cast<const uint4*>(mask + pix * N + n);
      v.x &= keep(m.x);
      v.y &= keep(m.y);
      v.z &= keep(m.z);
      v.w &= keep(m.w);
    }
    if (n < Na) {
      *reinterpret_cast<uint4*>(ya + pix * Na + n) = v;
    } else {
      *reinterpret_cast<uint4*>(yb + pix * (N - Na) + (n - Na)) = v;
    }
  }
  // the bits of each bf16 half of m that is > 0 (NaN is not)
  __device__ static uint32_t keep(uint32_t m) {
    return (__uint_as_float(m << 16) > 0.f ? 0x0000FFFFu : 0u) |
           (__uint_as_float(m & 0xFFFF0000u) > 0.f ? 0xFFFF0000u : 0u);
  }
};

// grid = (pixel tiles of an image, output-channel slices of BN, B). xa_map,
// xb_map: (C, W, H, B) maps of xa and xb (xb_map = xa_map when Kb = 0), box
// (8, 18, 8 * MT + 2, 1); w_map: (K, N, 9) over the [tap][n][k] kernel, box
// (64, BN, 1). chunks_a, chunks_b: 64-channel chunks of xa and xb; ka_groups
// = Ka / 8 (where xb's rows of w start). Epi: FwdEpi or DgradEpi (its N the
// output channels).
template <int BN, int MT, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma(const __grid_constant__ CUtensorMap xa_map,
              const __grid_constant__ CUtensorMap xb_map,
              const __grid_constant__ CUtensorMap w_map, int chunks_a, int chunks_b,
              int ka_groups, const Epi epi, int H, int W, int tiles_x) {
  using L = Layout<BN, MT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t halo_full = base + L::BARS, halo_empty = halo_full + 8 * HALO_STAGES;
  const uint32_t w_full = halo_empty + 8 * HALO_STAGES, w_empty = w_full + 8 * W_STAGES;
  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_x) * 8 * MT;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int n_chunks = chunks_a + chunks_b;

  if (tid == 0) {
    for (int s = 0; s < HALO_STAGES; ++s) {
      mbar_init(halo_full + 8 * s, 1);
      mbar_init(halo_empty + 8 * s, 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, 8);
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
        mbar_wait(halo_empty + 8 * hs, ((c / HALO_STAGES) & 1) ^ 1);
        const uint32_t hbar = halo_full + 8 * hs;
        mbar_expect_tx(hbar, GROUPS * L::HALO_BOX);
        const bool from_a = c < chunks_a;
        const int g0 = (from_a ? c : c - chunks_a) * GROUPS;  // first group in x's channels
        const CUtensorMap* map = from_a ? &xa_map : &xb_map;
        const uint32_t hdst = base + L::HALO + hs * L::HALO_STAGE;
        for (int g = 0; g < GROUPS; ++g)
          tma_load_4d(hdst + g * L::GROUP_BYTES, map, hbar, 8 * (g0 + g), x0 - 1, y0 - 1, b);
        const int k0 = 8 * (from_a ? g0 : ka_groups + g0);  // the chunk's first row of w's K
        for (int tap = 0; tap < 9; ++tap, ++t) {
          const int ws = t % W_STAGES;
          mbar_wait(w_empty + 8 * ws, ((t / W_STAGES) & 1) ^ 1);
          const uint32_t wbar = w_full + 8 * ws;
          mbar_expect_tx(wbar, L::W_STAGE);
          const uint32_t wdst = base + L::WEIGHTS + ws * L::W_STAGE;
          tma_load_3d(wdst, &w_map, wbar, k0, n0, Epi::FLIP ? 8 - tap : tap);
        }
      }
    }
  } else {  // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = (tid - 128) / 128;  // 8-pixel column half of the block
    const int wtid = tid % 128;
    const int warp = wtid / 32, lane = tid % 32;
    float sum[MT][BN / 2], chain[MT][BN / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[mt][i] = chain[mt][i] = 0.f;

    // The taps are unrolled, so that no wgmma group is in flight where
    // control flow merges (ptxas would otherwise wait for every group there)
    for (int c = 0, t = 0; c < n_chunks; ++c) {
      const int hs = c % HALO_STAGES;
      mbar_wait(halo_full + 8 * hs, (c / HALO_STAGES) & 1);
      const uint32_t halo = base + L::HALO + hs * L::HALO_STAGE + cw * 8 * 16;
      int pending = -1;  // a weight stage read by a group still in flight
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++t) {
        const int ws = t % W_STAGES;
        mbar_wait(w_full + 8 * ws, (t / W_STAGES) & 1);
        const int ky = tap / 3, kx = tap % 3;
        const uint32_t wst = base + L::WEIGHTS + ws * L::W_STAGE;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(chain[mt]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          const uint64_t bd = desc_sw128(wst + 32 * ks);
          const int scale = (tap % WG_CHAIN_TAPS != 0 || ks != 0) ? 1 : 0;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint64_t ad = desc(
                halo + 2 * ks * L::GROUP_BYTES + ((8 * mt + ky) * HALO_W + kx) * 16,
                L::GROUP_BYTES, ROW_PITCH);
            mma<BN>(chain[mt], ad, bd, scale);
          }
        }
        wgmma_commit();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(chain[mt]);
        if (tap % WG_CHAIN_TAPS == WG_CHAIN_TAPS - 1) {  // the chain ends: into the sums
          wgmma_wait<0>();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) fence_regs(chain[mt]);
          mbar_arrive_if(w_empty + 8 * pending, lane == 0 && pending >= 0);
          mbar_arrive_if(w_empty + 8 * ws, lane == 0);
          pending = -1;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) sum[mt][i] += chain[mt][i];
        } else {  // the previous tap's group is done: free its weights
          wgmma_wait<1>();
          mbar_arrive_if(w_empty + 8 * pending, lane == 0 && pending >= 0);
          pending = ws;
        }
      }
      mbar_arrive_if(halo_empty + 8 * hs, lane == 0);  // the chunk's last chain is done
    }

    // Epilogue (the forward's: the float32 bias, the ReLU), one rounding to
    // bf16, staged in shared memory as [pixel][channel]; then 16-byte stores
    // (the dgrad's: the mask, the split). Accumulator element 4 j + 2 h + e
    // of m-tile mt: m-row 16 warp + lane / 4 + 8 h, channel 8 j + 2 (lane %
    // 4) + e; m-row r * 8 + px is pixel (r, px) of the 8 x 8 tile.
    unsigned char* out = smem + L::OUT + cw * L::OUT_WG;
    const int grp = lane / 4, quad = lane % 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 pj = epi.prep(n0 + 8 * j + 2 * quad);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mt * 64 + (2 * warp + h) * 8 + grp;
          const float2 v = epi.apply(sum[mt][4 * j + 2 * h], sum[mt][4 * j + 2 * h + 1], pj);
          *reinterpret_cast<__nv_bfloat162*>(out + p * L::OUT_PITCH + (8 * j + 2 * quad) * 2) =
              __floats2bfloat162_rn(v.x, v.y);
        }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    const size_t img = static_cast<size_t>(b) * H * W;
    for (int e = wtid; e < MT * 64 * (BN / 8); e += 128) {
      const int p = e / (BN / 8), c8 = e % (BN / 8);
      const int gy = y0 + 8 * (p / 64) + (p % 64) / 8, gx = x0 + 8 * cw + p % 8;
      const int n = n0 + 8 * c8;
      if (gy >= H || gx >= W || n >= epi.N) continue;
      epi.store(img + static_cast<size_t>(gy) * W + gx, n,
                *reinterpret_cast<const uint4*>(out + p * L::OUT_PITCH + c8 * 16));
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda on the link line); null if the driver lacks it.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled map with zero fill outside the tensor, of bf16 elements unless
// ``type`` says otherwise (the float32 body's: conv3x3_wgmma_tf32.cuh).
inline bool encode(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                   const uint64_t* strides, const uint32_t* box, CUtensorMapSwizzle swizzle,
                   CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return false;
  const uint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (C, W, H, B) halo map of an NHWC tensor with C channels.
template <int MT>
inline bool encode_x(CUtensorMap* map, const __nv_bfloat16* x, int C, int B, int H, int W) {
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};
  const uint32_t box[4] = {8, HALO_W, 8 * MT + 2, 1};
  return encode(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// One layer: x = [xa | xb] (Ka + Kb channels), w [tap][n][k] (9, N, Ka +
// Kb), epi.N outputs.
template <int BN, int MT, class Epi>
cudaError_t launch(const __nv_bfloat16* xa, const __nv_bfloat16* xb, int Ka, int Kb,
                   const __nv_bfloat16* w, const Epi& epi, int B, int H, int W,
                   cudaStream_t s) {
  using L = Layout<BN, MT>;
  CUtensorMap ma, mb, mw;
  const int K = Ka + Kb, N = epi.N;
  const uint64_t wdims[3] = {static_cast<uint64_t>(K), static_cast<uint64_t>(N), 9};
  const uint64_t wstrides[2] = {2ull * K, 2ull * K * N};
  const uint32_t wbox[3] = {KC, BN, 1};
  if (!encode_x<MT>(&ma, xa, Ka, B, H, W) ||
      !encode(&mw, w, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (Kb == 0) {
    mb = ma;  // never read
  } else if (!encode_x<MT>(&mb, xb, Kb, B, H, W)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = &conv3x3_wgmma<BN, MT, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = cdiv(W, TW);
  const dim3 grid(tiles_x * cdiv(H, 8 * MT), cdiv(N, BN), B);
  kernel<<<grid, THREADS, L::SMEM, s>>>(ma, mb, mw, cdiv(Ka, KC), cdiv(Kb, KC), Ka / 8, epi,
                                        H, W, tiles_x);
  return cudaGetLastError();
}

}  // namespace wg

// Whether a bf16 layer with x = [xa | xb] (Ka + Kb channels) and N outputs
// takes this body: every channel count a multiple of 8 and every pointer
// 16-byte aligned (null counts as aligned), as a tensor map needs.
inline bool wgmma_takes(int Ka, int Kb, int N, const void* xa, const void* xb, const void* w,
                        const void* y) {
  return Ka > 0 && Ka % 8 == 0 && Kb % 8 == 0 && N > 0 && N % 8 == 0 && aligned16(xa) &&
         aligned16(xb) && aligned16(w) && aligned16(y);
}

// Launch one layer over a (B, H, W, *) batch on ``s``: x = [xa | xb] (xb
// null with Kb = 0), w HWOI (3, 3, N, Ka + Kb), bias float32, y (B, H, W,
// N). The caller checks wgmma_takes first. A failed encode returns
// cudaErrorInvalidValue. A template, so that only the sources that launch
// it (T = bf16) compile its kernels.
template <typename T>
cudaError_t conv3x3_wgmma_layer(const T* xa, const T* xb, int Ka, int Kb, const T* w,
                                const float* bias, T* y, int N, int B, int H, int W,
                                cudaStream_t s) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the wgmma body is bf16's");
  const wg::FwdEpi epi{bias, y, N};
  return N <= 64 ? wg::launch<64, 2>(xa, xb, Ka, Kb, w, epi, B, H, W, s)
                 : wg::launch<128, 1>(xa, xb, Ka, Kb, w, epi, B, H, W, s);
}

// Whether a bf16 dgrad of da (K channels) into ya | yb (Na + Nb channels),
// masked by m (or null), takes this body: wgmma_takes, and the split and the
// mask on 16-byte pieces.
inline bool wgmma_takes_dgrad(int K, int Na, int Nb, const void* da, const void* w,
                              const void* m, const void* ya, const void* yb) {
  return wgmma_takes(K, 0, Na + Nb, da, nullptr, w, ya) && Na > 0 && Na % 8 == 0 &&
         Nb % 8 == 0 && aligned16(m) && aligned16(yb);
}

// Launch one bf16 dgrad over a (B, H, W, *) batch on ``s``: da (B, H, W, K),
// w the layer's HWIO kernel (3, 3, Na + Nb, K), y = [ya | yb] (yb null with
// Nb = 0) = the flipped conv of da masked by [m > 0] (m (B, H, W, Na + Nb),
// or null). The caller checks wgmma_takes_dgrad first.
template <typename T>
cudaError_t conv3x3_wgmma_dgrad(const T* da, int K, const T* w, const T* m, T* ya, T* yb,
                                int Na, int Nb, int B, int H, int W, cudaStream_t s) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the wgmma body is bf16's");
  const wg::DgradEpi epi{m, ya, yb, Na, Na + Nb};
  return epi.N <= 64 ? wg::launch<64, 2>(da, nullptr, K, 0, w, epi, B, H, W, s)
                     : wg::launch<128, 1>(da, nullptr, K, 0, w, epi, B, H, W, s);
}

}  // namespace
