// The bf16 weight gradient of one 3x3 SAME conv layer on Hopper's
// asynchronous tensor-core path (sm_90a): wgmma with both operands read
// transposed (MN-major) from shared memory, float32 sums in registers, TMA
// loads with zero-filled edges into an mbarrier ring fed by one producer
// thread. The bf16 wgrad of the fused ConvBlock backward (conv_block_bwd.cuh).
//
// Replaces, in pda's bf16 configuration, the weight gradient of the Pallas
// TPU backward kernels: pda/kernels/conv_block_bwd.py _kernel (:69), which
// conv_block_bwd_flat (:402), conv_block_bwd_canvas (:291), conv_block_bwd
// (:610) and conv_block_bwd_flat_dual (:502) run, and
// conv_block_packed_bwd.py's (:501, :403, :891, :760, :648). Its numerics:
// bf16 operands, products summed in float32, dW and db float32.
//
//   dW[tap, ci, co] = sum_p x[p + tap, ci] * da[p, co],   db[co] = sum_p da[p, co]
//
// a GEMM with K = pixels; x = [xa | xb] along channels (the dual block's
// input, never concatenated), da the layer's masked output cotangent. In
// NHWC both operands are [pixel][channel], channel contiguous: MN-major,
// which wgmma reads for 16-bit types (its transpose bits; TF32 it reads
// K-major only, so the float32 wgrad, wgrad_wgmma_tf32.cuh, transposes its
// landed tiles in shared memory first).
//
// The GEMM: M = 64 output channels (A = da), N = 192 = the three kx taps of
// one kernel row ky x 64 input channels (B = x shifted by (ky - 1, kx - 1)),
// one m64n192k16 a k16 step (16 pixels). A block owns one ky, 64 input
// channels and 128 output channels (64 a consumer warpgroup), and a chunk of
// 8 x 8-pixel tiles (64 pixels, 4 k16 steps); where Cout <= 64 it owns 64
// output channels and its two consumers take alternate tiles (SPLIT), each
// with its own partial sums. A stage holds the tile's three input tiles
// (kx = 0, 1, 2: TMA boxes of 8 x 8 pixels x 64 channels read at columns x0
// - 1, x0, x0 + 1 and row y0 + ky - 1, zero-filled outside the image, which
// is the SAME padding, and past the tensor's channels) and its da tiles
// (8 x 8 pixels x 64 channels each), every tile [pixel][64 channels] with
// 128-byte rows swizzled (128B): the canonical MN-major atom, 8 pixels x 64
// channels = 1024 bytes, so a k16 step starts 2048 bytes further, the
// second 8 pixels of the step lie 1024 bytes on (the stride-byte offset) and
// the three kx tiles lie one tile apart (the leading-byte offset, between
// the N atoms). Shifting by whole tile loads keeps every start on the
// swizzle's 1024-byte period. (The forward's unswizzled layout, [8-channel
// group][halo row][halo column][8] with a tap a start offset in whole
// pixels, one load a stage, times 4% slower on an H100; PERF.md §6.)
//
// What bounds it: 18 * Cin * Cout FLOPs a pixel against 989 TFLOP/s dense
// bf16, and 48-77 FLOPs for every byte a block loads (its three input tiles
// and its da tiles a tile: L2 traffic, the ky blocks of a chunk run side by
// side so that HBM sees each byte about once), above the card's ~295 FLOPs
// a byte of HBM. Registers bound the tile: a consumer's m64n192 chain and
// its float32 sums are 2 x 96 registers a thread.
//
// Sums: the tensor cores accumulate with truncation (bf16.cuh), so a chain
// runs one tile (4 k16 steps, 64 products) into zeroed registers and is then
// added into the float32 sums with round-to-nearest adds. db is a plain
// float32 sum of the bf16 da in a fixed order, by two of the producer
// warpgroup's idle warps in the blocks of ky 0 and the first input-channel
// slice. Each chunk (and each consumer, with SPLIT) writes its partial dW
// and db to a workspace; sum_chunks adds them in order: no float atomics, so
// repeats are bit-equal.
//
// Shapes: Ca, Cb and Cout multiples of 8 and every pointer 16-byte aligned
// (wgmma_takes); conv_block_bwd.cuh routes, by shape before launch, an
// entry layer (a single input of 1 or 2 channels) to wgrad_entry (FMA pipes)
// and every other bf16 layer to wgrad_tc<bf16, V>.
#pragma once

#include "conv3x3_wgmma.cuh"

namespace {
namespace wg {

constexpr int GT = 8;                   // pixel tile: 8 x 8
constexpr int GPIX = GT * GT;           // 64 pixels, 4 k16 steps: one chain
constexpr int GTILE = GPIX * 128;       // bytes of a [pixel][64 channels] tile
constexpr int G_DA = 3 * GTILE;         // a stage: the three input tiles, then da's
constexpr int G_STAGE = G_DA + 2 * GTILE;
constexpr int G_STAGES = 5;
constexpr int G_BSUM = G_STAGES * G_STAGE;      // db's partials: 64 threads x 8 floats
constexpr int G_BARS = G_BSUM + 64 * 8 * 4;
constexpr int G_SMEM = G_BARS + 8 * 2 * G_STAGES + 1024;  // + the base's alignment
constexpr int G_DB_WARPS = 2;  // producer-warpgroup warps that sum db

// A wgmma shared-memory descriptor, MN-major with the 128-byte swizzle:
// atoms of 8 K rows x 64 elements (1024 bytes), the next 8 K rows at the
// stride-byte offset (1024: the atoms of a tile are consecutive) and the next
// 64 M or N elements at the leading-byte offset ``lbo``.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (+)= A * B, m64n192k16, both bf16 operands MN-major (transposed) from
// shared memory, float32 accumulators; scale_d 0 starts a chain.
__device__ __forceinline__ void mma_n192_tt(float (&d)[96], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Partial dW and db of one layer over one chunk of 8 x 8-pixel tiles.
// grid = (3 ky x input-channel slices x output-channel slices, chunks).
// xa_map, xb_map, da_map: (C, W, H, B) maps of xa, xb (xb_map = xa_map when
// Cb = 0) and da, boxes of (64, 8, 8, 1), 128B-swizzled.
// slices_a = cdiv(Ca, 64): the input-channel slices that read xa. ws_w:
// [part][9][Ca + Cb][Cout] with part = chunk (SPLIT: 2 chunk + consumer);
// ws_b: [chunk][Cout], written by the blocks of ky 0 and slice 0.
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_wgmma(const __grid_constant__ CUtensorMap xa_map,
            const __grid_constant__ CUtensorMap xb_map,
            const __grid_constant__ CUtensorMap da_map, int Ca, int Cb, int Cout, int slices_a,
            int ci_slices, float* __restrict__ ws_w, float* __restrict__ ws_b, int tiles_x,
            int tiles_img, int tiles, int tiles_per_chunk) {
  constexpr int CO = SPLIT ? 64 : 128;  // output channels a block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + G_BARS, empty = full + 8 * G_STAGES;
  const int tid = threadIdx.x;
  const int ky = blockIdx.x % 3, slice = blockIdx.x / 3;
  const int cs = slice % ci_slices, os = slice / ci_slices;
  const bool from_a = cs < slices_a;
  const int ci_in = 64 * (from_a ? cs : cs - slices_a);  // first channel in its tensor
  const int ci0 = from_a ? ci_in : Ca + ci_in;           // ... in [xa | xb]
  const int ci_n = min(64, (from_a ? Ca : Cb) - ci_in);  // channels of the slice
  const int co0 = os * CO;
  const int cin = Ca + Cb;
  const int chunk = blockIdx.y;
  const int t_begin = chunk * tiles_per_chunk;
  const int n_tiles = min(tiles, t_begin + tiles_per_chunk) - t_begin;
  const bool sums_bias = ky == 0 && cs == 0;

  if (tid == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      // one arrival a warp that reads the stage
      mbar_init(empty + 8 * s, (SPLIT ? 4 : 8) + (sums_bias ? G_DB_WARPS : 0));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {  // one thread issues every load
      const CUtensorMap* in_map = from_a ? &xa_map : &xb_map;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % G_STAGES;
        mbar_wait(empty + 8 * s, ((i / G_STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, (SPLIT ? 4 : 5) * GTILE);
        const int t = t_begin + i, b = t / tiles_img, r = t % tiles_img;
        const int y0 = (r / tiles_x) * GT, x0 = (r % tiles_x) * GT;
        const uint32_t st = base + s * G_STAGE;
        for (int kx = 0; kx < 3; ++kx)
          tma_load_4d(st + kx * GTILE, in_map, bar, ci_in, x0 + kx - 1, y0 + ky - 1, b);
        for (int h = 0; h < (SPLIT ? 1 : 2); ++h)
          tma_load_4d(st + G_DA + h * GTILE, &da_map, bar, co0 + 64 * h, x0, y0, b);
      }
    } else if (sums_bias && tid >= 32 && tid < 32 * (1 + G_DB_WARPS)) {
      // db: thread dt sums 8 output channels (16 bytes, c8) of every PG-th
      // pixel from pg, in order, over the chunk's tiles
      constexpr int C8 = CO / 8, PG = 32 * G_DB_WARPS / C8;
      const int dt = tid - 32, c8 = dt % C8, pg = dt / C8, lane = tid % 32;
      float acc[8] = {};
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % G_STAGES;
        mbar_wait(full + 8 * s, (i / G_STAGES) & 1);
        const unsigned char* tile = smem + s * G_STAGE + G_DA + (c8 / 8) * GTILE;
#pragma unroll 1
        for (int p = pg; p < GPIX; p += PG) {  // the 128B swizzle: chunk c ^ (row % 8)
          const uint4 v = *reinterpret_cast<const uint4*>(tile + p * 128 + ((c8 % 8) ^ (p % 8)) * 16);
          const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[2 * k] += bf::lo(u[k]);
            acc[2 * k + 1] += bf::hi(u[k]);
          }
        }
        __syncwarp();
        mbar_arrive_if(empty + 8 * s, lane == 0);
      }
      float* bsum = reinterpret_cast<float*>(smem + G_BSUM);
#pragma unroll
      for (int k = 0; k < 8; ++k) bsum[dt * 8 + k] = acc[k];
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * G_DB_WARPS) : "memory");
      for (int o = dt; o < CO; o += 32 * G_DB_WARPS) {  // the pixel groups, in order
        float v = 0.f;
        for (int g = 0; g < PG; ++g) v += bsum[(g * C8 + o / 8) * 8 + o % 8];
        if (co0 + o < Cout) ws_b[static_cast<size_t>(chunk) * Cout + co0 + o] = v;
      }
    }
  } else {  // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = (tid - 128) / 128;
    const int wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
    float sum[96], chain[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) sum[i] = chain[i] = 0.f;
    const uint32_t da_off = G_DA + (SPLIT ? 0 : cw * GTILE);
    // One chain a tile, waited for before the next: no wgmma group is in
    // flight where the loop's control flow merges (ptxas would wait there)
    for (int i = SPLIT ? cw : 0; i < n_tiles; i += SPLIT ? 2 : 1) {
      const int s = i % G_STAGES;
      mbar_wait_polls(full + 8 * s, (i / G_STAGES) & 1);
      const uint32_t st = base + s * G_STAGE;
      fence_regs(chain);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < GPIX / 16; ++ks) {  // pixel rows 2 ks, 2 ks + 1
        mma_n192_tt(chain, desc_mn_sw128(st + da_off + 2048 * ks, GTILE),
                    desc_mn_sw128(st + 2048 * ks, GTILE), ks != 0);
      }
      wgmma_commit();
      fence_regs(chain);
      wgmma_wait<0>();
      fence_regs(chain);
      mbar_arrive_if(empty + 8 * s, lane == 0);
#pragma unroll
      for (int k = 0; k < 96; ++k) sum[k] += chain[k];
    }
    // Accumulator element 4 j + 2 h + e: output channel (m-row) 16 warp +
    // lane / 4 + 8 h, N column 8 j + 2 (lane % 4) + e = 64 kx + input channel
    const int part = SPLIT ? 2 * chunk + cw : chunk;
    const int co_w = co0 + (SPLIT ? 0 : 64 * cw) + 16 * warp + lane / 4;
#pragma unroll
    for (int k = 0; k < 96; ++k) {
      const int co = co_w + 8 * ((k >> 1) & 1);
      const int n = 8 * (k >> 2) + 2 * (lane % 4) + (k & 1);
      const int kx = n / 64, c = n % 64;
      if (c < ci_n && co < Cout)
        ws_w[((static_cast<size_t>(part) * 9 + 3 * ky + kx) * cin + ci0 + c) * Cout + co] =
            sum[k];
    }
  }
}

// The (C, W, H, B) map of an NHWC tensor with C channels read by the wgrad:
// 128B-swizzled boxes of 64 channels x 8 x 8 pixels.
inline bool encode_wgrad(CUtensorMap* map, const __nv_bfloat16* x, int C, int B, int H, int W) {
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};
  const uint32_t box[4] = {64, GT, GT, 1};
  return encode(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The blocks a slice of the grid (3 ky x input-channel slices x
// output-channel slices) and the workspace parts a chunk.
inline int wgrad_slices(int Ca, int Cb, int Cout) {
  return 3 * (cdiv(Ca, 64) + cdiv(Cb, 64)) * (Cout <= 64 ? 1 : cdiv(Cout, 128));
}
inline int wgrad_parts(int Cout) { return Cout <= 64 ? 2 : 1; }

}  // namespace wg

// Launch the bf16 wgrad's partial pass over a (B, H, W, *) batch on ``s``:
// x = [xa | xb] (Ca + Cb channels, xb null with Cb = 0), da (B, H, W, Cout);
// ws_w gets chunks * wg::wgrad_parts(Cout) partial dW, ws_b chunks partial
// db, chunk c the tiles [c * tiles_per_chunk, ...) of the batch's 8 x 8-pixel
// tiles. The caller checks wgmma_takes first. A template, so that only the
// sources that launch it (T = bf16) compile its kernels.
template <typename T>
cudaError_t wgrad_wgmma_partials(const T* xa, const T* xb, int Ca, int Cb, const T* da,
                                 int Cout, float* ws_w, float* ws_b, int B, int H, int W,
                                 int tiles_per_chunk, int chunks, cudaStream_t s) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the wgmma body is bf16's");
  CUtensorMap ma, mb, md;
  if (!wg::encode_wgrad(&ma, xa, Ca, B, H, W) || !wg::encode_wgrad(&md, da, Cout, B, H, W))
    return cudaErrorInvalidValue;
  if (Cb == 0) {
    mb = ma;  // never read
  } else if (!wg::encode_wgrad(&mb, xb, Cb, B, H, W)) {
    return cudaErrorInvalidValue;
  }
  const bool split = Cout <= 64;
  const auto kernel = split ? &wg::wgrad_wgmma<true> : &wg::wgrad_wgmma<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::G_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = cdiv(W, wg::GT), tiles_img = tiles_x * cdiv(H, wg::GT);
  const dim3 grid(wg::wgrad_slices(Ca, Cb, Cout), chunks);
  kernel<<<grid, wg::THREADS, wg::G_SMEM, s>>>(ma, mb, md, Ca, Cb, Cout, cdiv(Ca, 64),
                                               cdiv(Ca, 64) + cdiv(Cb, 64), ws_w, ws_b,
                                               tiles_x, tiles_img, B * tiles_img,
                                               tiles_per_chunk);
  return cudaGetLastError();
}

// Blocks of wgrad_wgmma the card runs at once (SMs x blocks an SM), queried
// once a device.
inline int wgrad_wgmma_slots() {
  static int known[64] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && known[dev] > 0) return known[dev];
  const auto kernel = &wg::wgrad_wgmma<false>;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::G_SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wg::THREADS, wg::G_SMEM);
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) known[dev] = slots;
  return slots;
}

}  // namespace
