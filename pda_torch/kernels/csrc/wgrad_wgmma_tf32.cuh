// The float32 weight gradient of one 3x3 SAME conv layer in 3xTF32 on
// Hopper's asynchronous tensor-core path (sm_90a): TMA loads into an mbarrier
// ring, a transpose-and-split of the landed tiles into K-major TF32 planes,
// wgmma with float32 chains in registers. The float32 wgrad of the fused
// ConvBlock backward (conv_block_bwd.cuh); bf16's is wgrad_wgmma.cuh.
//
// Replaces, in pda's float32 configuration, the weight gradient of the Pallas
// TPU backward kernels: pda/kernels/conv_block_bwd.py _kernel (:69, its wgrad
// closure :269-285), which conv_block_bwd_flat (:402), conv_block_bwd_canvas
// (:291), conv_block_bwd (:610) and conv_block_bwd_flat_dual (:502) run, and
// conv_block_packed_bwd.py's (:501, :403, :891, :760, :648).
//
//   dW[tap, ci, co] = sum_p x[p + tap, ci] * da[p, co],   db[co] = sum_p da[p, co]
//
// a GEMM with K = pixels; x = [xa | xb] along channels (the dual block's
// input, never concatenated), da the layer's masked output cotangent.
//
// What bounds it: 18 * Cin * Cout FLOPs a pixel against 495 / 3 = 165
// TFLOP/s (3xTF32: three TF32 products a multiply-add, tf32x3.cuh), far above
// the card's FLOPs a byte of HBM at every PUNet shape: the tensor cores, when
// they are fed, and the shared memory and issue slots that feed them. The
// mma.sync body (conv_block_bwd.cuh wgrad_tc) ran at 28% of that bound:
// fragments gathered with 16-byte loads and split in the inner loop, chains
// flushed into sums in shared memory.
//
// The operands. TF32 wgmma reads B only K-major from shared memory (here:
// pixels contiguous), and in NHWC neither x nor da is (channels are the
// contiguous index). So:
//   - one producer thread lands each pixel tile as it lies, [pixel][channel]:
//     TMA boxes of 32 channels (128-byte rows, 128B-swizzled) over 4-D (C,
//     W, H, B) maps; the zero fill outside the image is the SAME padding, and
//     past C a ragged channel slice;
//   - B = x: seven warps (XPOSE_WARPS) read each landed x tile once and write
//     it as K-major hi and lo planes, hi = tf32(v) and lo = tf32(v - hi)
//     (split below), in the 128B-swizzled layout wgmma reads (atoms of 8 rows
//     x 32 pixels of 4 bytes). The block owns one kernel row ky, and its
//     three kx shifts lie side by side along N (as wgrad_wgmma.cuh does for
//     bf16): the shift is applied as the plane is written, since a 4-byte
//     pixel shift cannot be a descriptor's start address under the swizzle.
//     A tile is 8 items (a row, a column parity), each one warp's (32 input
//     channels, one 128-byte pixel row a load), dealt round-robin;
//   - A = da, M = output channels, from registers: each consumer thread
//     loads its fragment from the landed [pixel][channel] tile and splits it
//     there (wgmma takes a TF32 A from registers), so only x is transposed.
//     A from split planes in shared memory, written by the same warps, ran
//     1.5-1.8x slower on an H100 (PERF.md §6).
// A tile's K order (its 32 pixels, 4 rows x 8 columns) is row by row, and
// within a row of 8 the even columns first, then the odd: a thread's four A
// values of a k8 step then fall in four distinct 16-byte swizzle chunks of
// four pixel rows, free of bank conflicts, and the planes follow that order.
//
// The products and chains, as conv3x3_wgmma_tf32.cuh's: each k8 step runs
// lo_a * hi_b and hi_a * lo_b into one chain (small) and hi_a * hi_b into
// another (chain); the tensor cores add with truncation, each add at the
// scale of its accumulator, so the small products keep their own. Both
// chains start from zeroed registers, run CHAIN_TILES tiles (4 k8 steps a
// tile), and are then added into float32 sums with round-to-nearest adds.
// CHAIN_TILES is the longest whose dW drift against float64 stays at or
// under wgrad_tc's at the MT step's shapes (PERF.md §6, the chain sweep: 8
// tiles passed it at 256 -> 256). The sums live in shared memory (a chain's
// end adds into them), so that the consumers' registers hold the two chains
// (2 x 48) and a tile's A fragments (32).
//
// Tiling: a block owns one ky, a slice of 32 input channels (N = 3 kx x 32 =
// 96) and 128 output channels, two consumer warpgroups of 64 (M) each, and a
// chunk of 4 x 8-pixel tiles; where Cout <= 64 it owns 64 output channels and
// its two consumers take alternate tiles (SPLIT), each with its own partial
// sums. A dual block's slices split at Ca: none reads both xa and xb. Each
// consumer issues a tile's 12 wgmma as one group and waits for it before the
// next (a group in flight across the loop's back edge makes ptxas wait for
// every group there; two tiles a group, one in flight, timed no faster).
// What it is bound by, on an H100 (PERF.md §6): the transposers alone
// (no TMA, no wgmma) and the consumers alone (no TMA, no transpose) each
// take 70-95% of the whole kernel's time, TMA alone 40-50%. Sharing the
// three ky blocks' da tiles by TMA multicast in clusters of three ran 2x
// slower.
//
// Determinism: each chunk (and each consumer, with SPLIT) writes its partial
// dW to a workspace, and the transposer warps of the blocks of ky 0 and the
// first input-channel slice sum db (a plain float32 sum of da in a fixed
// order: each warp over its items, then the warps in order; float64 lane
// sums there slowed the kernel 1.2-1.4x, PERF.md §6) into it;
// sum_chunks adds the partials in order (in float64). No float atomics, so
// repeats are bit-equal.
//
// Shapes: Ca, Cb and Cout multiples of 8 and every pointer 16-byte aligned
// (wgmma_takes); conv_block_bwd.cuh routes an entry layer (a single input of
// 1 or 2 channels) to wgrad_entry (FMA pipes) and any other float32 layer
// to wgrad_tc, by shape before launch.
#pragma once

#include <type_traits>

#include "conv3x3_wgmma_tf32.cuh"

namespace {
namespace wgt {

// Tiles (4 k8 steps each) a chain runs before it is added into the sums.
constexpr int CHAIN_TILES = 4;

constexpr int TH = 4, TW = 8;              // pixel tile: 4 rows x 8 columns
constexpr int TPIX = TH * TW;              // 32 pixels: a tile's K, 4 k8 steps
constexpr int CI = 32;                     // input channels a block: a 128-byte row a pixel
constexpr int HALO_W = TW + 2;             // halo columns (kx = 0, 1, 2)
constexpr int X_BOX = TH * HALO_W * 128;   // bytes of a tile's halo rows for one ky
constexpr int DA_BOX = TPIX * 128;         // bytes of 32 output channels of a tile
constexpr int NB = 3 * CI;                 // 96: the GEMM's N, three kx x 32 input channels
constexpr int X_PLANE = NB * 128;          // bytes of x's hi (or lo) plane of a tile
constexpr int THREADS = 512;               // two producer warpgroups, two consumer warpgroups
constexpr int XPOSE_WARPS = 7;             // warps 1-7: the transpose-and-split (and db)
constexpr int XPOSE_THREADS = 32 * XPOSE_WARPS;
constexpr int ITEMS = 2 * TH;              // a tile's transpose items: (row, column parity)
constexpr int XPOSE_BAR = 1;               // the transposers' named barrier (db's partials)
constexpr int SMEM_MAX = 232448;

// Shared-memory layout (bytes from a 1024-byte-aligned base: the 128-byte
// swizzle repeats every 1024 bytes): landing stages (x's halo box, then up
// to four da boxes), plane stages (x's hi plane, then its lo plane), the
// consumers' float32 sums ([consumer][48][128 threads]), db's partials (one
// row of 128 channels a transposer warp), the mbarriers.
struct Layout {
  static constexpr int LAND = X_BOX + 4 * DA_BOX;
  static constexpr int PLANE = 2 * X_PLANE;
  static constexpr int L_STAGES = 4;
  static constexpr int P_STAGES = 3;
  static constexpr int PLANES = L_STAGES * LAND;
  static constexpr int SUMS = PLANES + P_STAGES * PLANE;
  static constexpr int BSUM = SUMS + 2 * 48 * 128 * 4;
  static constexpr int BARS = BSUM + XPOSE_WARPS * 128 * 4;
  static constexpr int BYTES = BARS + 8 * 2 * (L_STAGES + P_STAGES);
  static constexpr int SMEM = BYTES + 1024;  // + the base's alignment
  static_assert(SMEM <= SMEM_MAX, "the rings fit in shared memory");
};

// d (+)= A * B, m64n96k8, TF32, A from registers (a[0..3]: rows grp, grp +
// 8 at k = quad, then at k = quad + 4, of the warp's 16 rows), B from
// shared memory (K-major descriptor); float32 accumulators; scale_d 0 starts
// a chain (d = A * B).
__device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// hi = tf32(x) (cvt.rna's bits for finite x) and lo = tf32(x - hi) as the
// tensor cores read it: they ignore the low 13 bits, so adding half a unit
// rounds it (tf32x3.cuh's split).
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
  lo = __uint_as_float(__float_as_uint(x - hi) + 0x1000u);
}

// Shared-memory loads and stores at 32-bit shared addresses.
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}
// The float at channel c (of a 32-channel box) of pixel row p of a
// 128B-swizzled landed box at shared address ``box``: 16-byte chunk c / 4 of
// the row lies at chunk (c / 4) ^ (p % 8).
__device__ __forceinline__ float landed(uint32_t box, int p, int c) {
  return lds(box + p * 128 + ((((c >> 2) ^ (p & 7)) << 4) | ((c & 3) << 2)));
}

// Partial dW and db of one layer over one chunk of 4 x 8-pixel tiles.
// grid = (3 ky x input-channel slices x output-channel slices, chunks).
// xa_map, xb_map: (C, W, H, B) maps of xa, xb (xb_map = xa_map when Cb = 0),
// boxes of (32, 10, 4, 1); da_map: boxes of (32, 8, 4, 1); all 128B-swizzled.
// slices_a = cdiv(Ca, 32): the input-channel slices that read xa. ws_w:
// [part][9][Ca + Cb][Cout] with part = chunk (SPLIT: 2 chunk + consumer);
// ws_b: [chunk][Cout], written by the blocks of ky 0 and slice 0.
//
// Warps: 0 (lane 0) issues every TMA load; 1-7 transpose and split (item g
// of the chunk, tile g / 8, row and column parity g % 8, is warp 1 + g % 7's;
// each item one arrival on its tile's barriers); 8-15, two warpgroups, the
// consumers.
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_wgmma_tf32(const __grid_constant__ CUtensorMap xa_map,
                 const __grid_constant__ CUtensorMap xb_map,
                 const __grid_constant__ CUtensorMap da_map, int Ca, int Cb, int Cout,
                 int slices_a, int ci_slices, float* __restrict__ ws_w, float* __restrict__ ws_b,
                 int tiles_x, int tiles_img, int tiles, int tiles_per_chunk) {
  using L = Layout;
  constexpr int CO = SPLIT ? 64 : 128;  // output channels a block
  constexpr int NDA = CO / 32;          // da boxes a tile
  constexpr int CONSUMER_WARPS = SPLIT ? 4 : 8;  // warps that read a tile's planes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = wg::smem_u32(smem);
  const uint32_t land_full = base + L::BARS, land_empty = land_full + 8 * L::L_STAGES;
  const uint32_t plane_full = land_empty + 8 * L::L_STAGES;
  const uint32_t plane_empty = plane_full + 8 * L::P_STAGES;
  const int tid = threadIdx.x;
  const int ky = blockIdx.x % 3, slice = blockIdx.x / 3;
  const int cs = slice % ci_slices, os = slice / ci_slices;
  const bool from_a = cs < slices_a;
  const int ci_in = CI * (from_a ? cs : cs - slices_a);  // first channel in its tensor
  const int ci0 = from_a ? ci_in : Ca + ci_in;           // ... in [xa | xb]
  const int ci_n = min(CI, (from_a ? Ca : Cb) - ci_in);  // channels of the slice
  const int co0 = os * CO;
  const int cin = Ca + Cb;
  const int chunk = blockIdx.y;
  const int t_begin = chunk * tiles_per_chunk;
  const int n_tiles = min(tiles, t_begin + tiles_per_chunk) - t_begin;
  const bool sums_bias = ky == 0 && cs == 0;

  if (tid == 0) {
    for (int s = 0; s < L::L_STAGES; ++s) {
      wg::mbar_init(land_full + 8 * s, 1);
      wg::mbar_init(land_empty + 8 * s, ITEMS + CONSUMER_WARPS);  // an item, a consumer warp
    }
    for (int s = 0; s < L::P_STAGES; ++s) {
      wg::mbar_init(plane_full + 8 * s, ITEMS);
      wg::mbar_init(plane_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 256) {  // the producer warpgroups
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    if (tid == 0) {  // one thread issues every load
      const CUtensorMap* in_map = from_a ? &xa_map : &xb_map;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::L_STAGES;
        wg::mbar_wait(land_empty + 8 * s, ((i / L::L_STAGES) & 1) ^ 1);
        const uint32_t bar = land_full + 8 * s;
        wg::mbar_expect_tx(bar, X_BOX + NDA * DA_BOX);
        const int t = t_begin + i, b = t / tiles_img, r = t % tiles_img;
        const int y0 = (r / tiles_x) * TH, x0 = (r % tiles_x) * TW;
        const uint32_t st = base + s * L::LAND;
        wg::tma_load_4d(st, in_map, bar, ci_in, x0 - 1, y0 + ky - 1, b);
        for (int k = 0; k < NDA; ++k)
          wg::tma_load_4d(st + X_BOX + k * DA_BOX, &da_map, bar, co0 + 32 * k, x0, y0, b);
      }
    } else if (tid >= 32) {  // the transpose-and-split, and db
      const int xw = tid / 32 - 1, ci = tid % 32;  // lane: an input (db: output) channel
      float bacc[NDA] = {};  // db: channels ci + 32 c, this warp's pixels, in order
      // Item g: tile g / ITEMS, its row k / 2 and column parity h = k % 2 (k =
      // g % ITEMS): the 9 halo values of columns h .. h + 8 of channel ci,
      // split once; plane row kx * 32 + ci takes columns h + kx + 2j (j =
      // 0..3) as its 16-byte chunk 2 row + h. A warp's lanes read one
      // 128-byte pixel row and write 8 rows' chunks a quarter-warp: free of
      // bank conflicts.
#pragma unroll 1
      for (int g = xw; g < ITEMS * n_tiles; g += XPOSE_WARPS) {
        const int i = g / ITEMS, k = g % ITEMS, row = k / 2, h = k % 2;
        const int s = i % L::L_STAGES, ps = i % L::P_STAGES;
        wg::mbar_wait_polls(land_full + 8 * s, (i / L::L_STAGES) & 1);
        wg::mbar_wait_polls(plane_empty + 8 * ps, ((i / L::P_STAGES) & 1) ^ 1);
        const uint32_t land = base + s * L::LAND;
        const uint32_t plane = base + L::PLANES + ps * L::PLANE;
        float hi[9], lo[9];
#pragma unroll
        for (int m = 0; m < 9; ++m)
          split(landed(land, row * HALO_W + h + m, ci), hi[m], lo[m]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const uint32_t at = plane + (kx * CI + ci) * 128 + (((2 * row + h) ^ (ci & 7)) << 4);
          sts4(at, hi[kx], hi[kx + 2], hi[kx + 4], hi[kx + 6]);
          sts4(at + X_PLANE, lo[kx], lo[kx + 2], lo[kx + 4], lo[kx + 6]);
        }
        // the generic proxy's writes, before the async proxy (wgmma) reads them
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        wg::mbar_arrive_if(plane_full + 8 * ps, ci == 0);
        if (sums_bias) {  // db: the item's 4 pixels (row, h + 2j) of channels ci + 32 c
#pragma unroll
          for (int c = 0; c < NDA; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bacc[c] += landed(land + X_BOX + c * DA_BOX, row * TW + h + 2 * j, ci);
        }
        __syncwarp();
        wg::mbar_arrive_if(land_empty + 8 * s, ci == 0);
      }
      if (sums_bias) {  // the transposer warps' partials of each channel, in order
        float* bsum = reinterpret_cast<float*>(smem + L::BSUM);
#pragma unroll
        for (int c = 0; c < NDA; ++c) bsum[xw * CO + 32 * c + ci] = bacc[c];
        asm volatile("bar.sync %0, %1;\n" ::"n"(XPOSE_BAR), "n"(XPOSE_THREADS) : "memory");
        for (int o = tid - 32; o < CO; o += XPOSE_THREADS) {
          float v = 0.f;
          for (int w = 0; w < XPOSE_WARPS; ++w) v += bsum[w * CO + o];
          if (co0 + o < Cout) ws_b[static_cast<size_t>(chunk) * Cout + co0 + o] = v;
        }
      }
    }
  } else {  // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n");
    const int cw = (tid - 256) / 128;
    const int wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
    const int grp = lane / 4, quad = lane % 4;
    // the float32 sums in shared memory (this thread's 48, 512 bytes apart):
    // a chain's end adds into them, so that the registers hold the chains
    float* sums = reinterpret_cast<float*>(smem + L::SUMS) + cw * 48 * 128 + wtid;
#pragma unroll
    for (int k = 0; k < 48; ++k) sums[128 * k] = 0.f;
    float chain[48], small[48];
#pragma unroll
    for (int k = 0; k < 48; ++k) chain[k] = small[k] = 0.f;
    // The byte offsets, in a landing stage, of this thread's four da values
    // of a tile's first k8 step (a k8 step is a tile row: 1024 bytes
    // further). Row grp (+ 8) of the warp's 16 output channels, k = quad at
    // pixel column 2 quad, k = quad + 4 at 2 quad + 1
    const int co_l = (SPLIT ? 0 : 64 * cw) + 16 * warp + grp;  // in the block's CO
    const int a_box = X_BOX + (co_l / 32) * DA_BOX, c0 = (co_l & 31) >> 2, w4 = (co_l & 3) * 4;
    const int a_off[4] = {a_box + 2 * quad * 128 + ((c0 ^ (2 * quad)) << 4) + w4,
                          a_box + 2 * quad * 128 + (((c0 + 2) ^ (2 * quad)) << 4) + w4,
                          a_box + (2 * quad + 1) * 128 + ((c0 ^ (2 * quad + 1)) << 4) + w4,
                          a_box + (2 * quad + 1) * 128 + (((c0 + 2) ^ (2 * quad + 1)) << 4) + w4};
    int n_local = 0;  // tiles this consumer took
    // One group a tile, waited for before the next: no wgmma group is in
    // flight where the loop's control flow merges (ptxas would wait there)
    for (int i = SPLIT ? cw : 0; i < n_tiles; i += SPLIT ? 2 : 1, ++n_local) {
      const int s = i % L::L_STAGES, ps = i % L::P_STAGES;
      uint32_t ahi[4][4], alo[4][4];
      wg::mbar_wait_polls(land_full + 8 * s, (i / L::L_STAGES) & 1);
      const uint32_t land = base + s * L::LAND;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float h, l;
          split(lds(land + a_off[r] + 1024 * ks), h, l);
          ahi[ks][r] = __float_as_uint(h);
          alo[ks][r] = __float_as_uint(l);
        }
      __syncwarp();
      wg::mbar_arrive_if(land_empty + 8 * s, lane == 0);
      wg::mbar_wait_polls(plane_full + 8 * ps, (i / L::P_STAGES) & 1);
      const uint32_t plane = base + L::PLANES + ps * L::PLANE;
      const int start = n_local % CHAIN_TILES == 0 ? 0 : 1;  // 0: the chains restart
      wg::fence_regs(chain);
      wg::fence_regs(small);
      wg::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // lo_a * hi_b, hi_a * lo_b, hi_a * hi_b
        const uint64_t bh = wg::desc_sw128(plane + 32 * ks);
        const uint64_t bl = wg::desc_sw128(plane + X_PLANE + 32 * ks);
        const int sc = ks == 0 ? start : 1;
        mma(small, alo[ks], bh, sc);
        mma(small, ahi[ks], bl, 1);
        mma(chain, ahi[ks], bh, sc);
      }
      wg::wgmma_commit();
      wg::fence_regs(chain);
      wg::fence_regs(small);
      wg::wgmma_wait<0>();
      wg::fence_regs(chain);
      wg::fence_regs(small);
      wg::mbar_arrive_if(plane_empty + 8 * ps, lane == 0);
      if (n_local % CHAIN_TILES == CHAIN_TILES - 1) {  // the chains end: into the sums
#pragma unroll
        for (int k = 0; k < 48; ++k) sums[128 * k] += chain[k] + small[k];
      }
    }
    if (n_local % CHAIN_TILES != 0) {  // the last, shorter chains
#pragma unroll
      for (int k = 0; k < 48; ++k) sums[128 * k] += chain[k] + small[k];
    }
    // Accumulator element 4 j + 2 h + e: output channel (m-row) 16 warp +
    // grp + 8 h, N column 8 j + 2 quad + e = 32 kx + input channel
    const int part = SPLIT ? 2 * chunk + cw : chunk;
    const int co_w = co0 + co_l;
#pragma unroll
    for (int k = 0; k < 48; ++k) {
      const int co = co_w + 8 * ((k >> 1) & 1);
      const int n = 8 * (k >> 2) + 2 * quad + (k & 1);
      const int kx = n / CI, c = n % CI;
      if (c < ci_n && co < Cout)
        ws_w[((static_cast<size_t>(part) * 9 + 3 * ky + kx) * cin + ci0 + c) * Cout + co] =
            sums[128 * k];
    }
  }
}

// The (C, W, H, B) map of a float32 NHWC tensor with C channels:
// 128B-swizzled boxes of 32 channels x ``w`` x 4 pixels.
inline bool encode(CUtensorMap* map, const float* x, int C, int B, int H, int W, int w) {
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {4ull * C, 4ull * C * W, 4ull * C * W * H};
  const uint32_t box[4] = {CI, static_cast<uint32_t>(w), TH, 1};
  return wg::encode(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The blocks a slice of the grid (3 ky x input-channel slices x
// output-channel slices), the workspace parts a chunk, the 4 x 8-pixel tiles.
inline int wgrad_slices(int Ca, int Cb, int Cout) {
  return 3 * (cdiv(Ca, CI) + cdiv(Cb, CI)) * (Cout <= 64 ? 1 : cdiv(Cout, 128));
}
inline int wgrad_parts(int Cout) { return Cout <= 64 ? 2 : 1; }
inline int wgrad_tiles(int B, int H, int W) { return B * cdiv(H, TH) * cdiv(W, TW); }

template <bool SPLIT>
constexpr auto kernel() {
  return &wgrad_wgmma_tf32<SPLIT>;
}

}  // namespace wgt

// Launch the float32 wgrad's partial pass over a (B, H, W, *) batch on
// ``s``: x = [xa | xb] (Ca + Cb channels, xb null with Cb = 0), da (B, H, W,
// Cout); ws_w gets chunks * wgt::wgrad_parts(Cout) partial dW, ws_b chunks
// partial db, chunk c the tiles [c * tiles_per_chunk, ...) of the batch's
// 4 x 8-pixel tiles. The caller checks wgmma_takes first; a failed encode
// returns cudaErrorInvalidValue. A template, so that only the sources that
// launch it (T = float) compile its kernels.
template <typename T>
cudaError_t wgrad_wgmma_tf32_partials(const T* xa, const T* xb, int Ca, int Cb, const T* da,
                                      int Cout, float* ws_w, float* ws_b, int B, int H, int W,
                                      int tiles_per_chunk, int chunks, cudaStream_t s) {
  static_assert(std::is_same<T, float>::value, "the 3xTF32 wgmma wgrad is float32's");
  CUtensorMap ma, mb, md;
  if (!wgt::encode(&ma, xa, Ca, B, H, W, wgt::HALO_W) ||
      !wgt::encode(&md, da, Cout, B, H, W, wgt::TW))
    return cudaErrorInvalidValue;
  if (Cb == 0) {
    mb = ma;  // never read
  } else if (!wgt::encode(&mb, xb, Cb, B, H, W, wgt::HALO_W)) {
    return cudaErrorInvalidValue;
  }
  const bool split = Cout <= 64;
  const auto kernel = split ? wgt::kernel<true>() : wgt::kernel<false>();
  constexpr int SMEM = wgt::Layout::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = cdiv(W, wgt::TW), tiles_img = tiles_x * cdiv(H, wgt::TH);
  const dim3 grid(wgt::wgrad_slices(Ca, Cb, Cout), chunks);
  kernel<<<grid, wgt::THREADS, SMEM, s>>>(ma, mb, md, Ca, Cb, Cout, cdiv(Ca, wgt::CI),
                                          cdiv(Ca, wgt::CI) + cdiv(Cb, wgt::CI), ws_w, ws_b,
                                          tiles_x, tiles_img, B * tiles_img, tiles_per_chunk);
  return cudaGetLastError();
}

// Blocks of the float32 wgmma wgrad the card runs at once (SMs x blocks an
// SM), queried once a device.
inline int wgrad_wgmma_tf32_slots() {
  static int known[64] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && known[dev] > 0) return known[dev];
  const auto kernel = wgt::kernel<false>();
  constexpr int SMEM = wgt::Layout::SMEM;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wgt::THREADS, SMEM);
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) known[dev] = slots;
  return slots;
}

}  // namespace
