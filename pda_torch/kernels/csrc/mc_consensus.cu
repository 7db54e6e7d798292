// Fused Monte-Carlo Fcomb tail + consensus for Hopper (sm_90a) on the
// asynchronous tensor-core path (wgmma): the float32 tail, its mid layers in
// 3xTF32 (mc_consensus_wgmma_tf32, below the bf16 body), and the bf16 tail
// for pda's bf16 configuration (mc_consensus_wgmma).
//
// Replaces the Pallas TPU kernel pda/kernels/mc_consensus.py
// mc_consensus_decode (:136, body _kernel :49). Per pixel and sample s:
//   h     = relu(feat_term + z_term[s])             (C channels)
//   h     = relu(h @ W_m + b_m)   for each mid layer m
//   logit = h . w_last + b_last
// and over the S samples: mean of sigmoid(logit), and the fraction of logits
// in the confident band (>= logit_hi or <= logit_lo), or, with masking, 1
// where all S samples are confident and 0 elsewhere. Outputs are (B, H*W).
// No atomics in either body: repeats are bit-equal.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

#include "bf16.cuh"
#include "tf32x3.cuh"

namespace {

constexpr size_t MAX_SMEM = 232448;   // bytes a block may opt in to on sm_90

// ---- bf16 -------------------------------------------------------------------
// pda's bf16 configuration (pda/kernels/mc_consensus.py _kernel :96-113) on
// Hopper's asynchronous tensor-core path: mc_consensus_wgmma<C, NMID>. feat
// and the mid and last kernels bf16, the latent terms and the biases
// float32, at pda's rounding points: per sample the z row rounded to bf16;
// h = relu(feat + z) rounded to bf16; each mid layer bf16 x bf16 with
// float32 sums, + b (float32), ReLU, one rounding to bf16; the last layer
// a float32 sum of the bf16 h times the bf16 w_last, + b_last: the logit in
// float32; the sigmoid mean and the band test in float32.
//
// What bounds it: 2 C^2 FLOPs a pixel, sample and mid layer at 989 TFLOP/s
// (0.14 ms at S = 16, four 512^2 tiles, C = 64, n_mid 1) against 2 C bytes
// of features a pixel (40 us): operations, but only if the CUDA-core work
// around each product (the layer entry, the bias, ReLU and rounding of
// every hidden value, the last layer, the sigmoid) overlaps the products.
// An mma.sync body (m16n8k16, one warp a 16-pixel tile, the last layer and
// the reduction on the FMA pipes, each product holding the warp's stream)
// took 0.80-0.82 ms a call there (launches back to back). Here:
//   - A warpgroup (the block's 128 threads) owns a 64-pixel tile, 16 pixels
//     a warp; a mid layer is one wgmma m64nCk16 chain over K = C (C / 16
//     k-steps), A from registers, B = W_m from shared memory. A warp's part
//     of A is the m16n8k16 A fragment (bf16.cuh) and its accumulator the
//     m16n8 C fragments, so a layer's output, rounded and packed, is the
//     next layer's A in the same registers (no shuffles). W_m is stored once
//     a block as K-major core matrices without swizzle ([k / 8][n][8 k], 128
//     contiguous bytes each: no bank conflicts at any C), so no lane loads
//     B fragments.
//   - Two samples in flight: the warpgroup runs two sample streams (slots
//     0 and 1, samples s and s + 1). It issues one slot's next product and
//     commits it, then waits (wait_group 1) for the other slot's and runs
//     that slot's epilogue while the first product runs. Each slot has its
//     own A (C / 4 registers) and sums (C / 2).
//   - The layer entry is packed: relu(feat + z) is one fma.rn.relu.bf16x2
//     (f * 1 + z, one rounding of the exact sum) a channel pair. pda adds
//     the two bf16 values in float32 and rounds to bf16: the float32 sum of
//     two bf16 values (8-bit significands) is that exact sum rounded to 24
//     bits, and rounding to 24 bits and then to 8 gives what rounding to 8
//     once gives (24 >= 2 * 8 + 2: the second rounding cannot land on a tie
//     that the first one made); the sum of two bf16 values is a multiple of
//     the least bf16 subnormal, so it never underflows to 0; ReLU commutes
//     with rounding to nearest. So the two agree bit for bit
//     (tests/test_torch_mc_bf16_entry.py over every bf16 feat value;
//     chip_smoke.py on the card).
//   - The mid epilogue adds the float32 bias to the float32 sums (sums
//     first, as pda), then one cvt.rn.relu.bf16x2.f32 rounds and packs two
//     channels.
//   - The last layer is one more wgmma chain, m64n8k16. Its B_c holds w_last
//     in column c and zeros elsewhere, and sample s takes B_(s % 8), so the
//     float32 logits of 8 samples gather in the columns of one 64 x 8
//     accumulator (lane quad q: samples 2 q, 2 q + 1) and each lane takes 4
//     sigmoids and band tests every 8 samples, not 2 a sample; a column's
//     other products are exact zeros. Its sum order differs from pda's XLA
//     dot; both are held against float64 sums (chip_smoke.py,
//     tests/test_torch_cuda.py).
//   - Feature rows are read once from device memory straight into the A
//     fragment's registers and held across all S samples; the next tile's
//     are read while a tile runs. The blocks are one wave (as many 64-pixel
//     tiles a block as the card's resident blocks need), so each sets up its
//     shared memory once.
// Sample loop: groups of 8 samples (one accumulator's columns) as four
// pairs, each wait leaving the newest group in flight; no group is in
// flight across the loop's back edge, where ptxas would serialize every
// wgmma (its C7514: the loop's register copies read accumulators in
// flight). Past S a slot repeats sample S - 1, not counted (S off a
// multiple of 8 computes up to 7 samples more). The probabilities sum per
// lane in sample order, then over a row's four lanes in lane order; no
// atomics, so repeats are bit-equal. NMID (0, 1, 2; -1 any other n_mid) is
// a template parameter, so that the layer loop unrolls; with -1 ptxas
// serializes the products (C7514).
//
// On an H100 (700 W) at S = 16, C = 64, n_mid 1, launches back to back:
// four 512^2 tiles 0.376-0.385 ms (38% of the bound), the MT teacher's
// 2 x 512^2 0.193-0.200, the pseudo export's 1 x 528 x 704 0.144-0.146,
// against the mma.sync body's 0.795-0.815, 0.413-0.420, 0.293-0.298 in
// the same run (pda_torch/tools/bench_variants.py --only mc --dtype bf16
// --burst 10, PERF.md); 162 registers, no spills, ~102 warp instructions a
// sample (pda_torch/tools/profile.py --what ptxas,sass). Without its mid
// products (their sums made by the CUDA cores instead) it takes 0.30 ms,
// and its warps spend under 4% of the loop waiting on wgmma: each warp's
// own instruction stream around the products binds it, not the tensor
// cores.
namespace mcw {

constexpr int THREADS = 128;   // one warpgroup: a 64-pixel tile at a time, 16 a warp
constexpr int MIN_BLOCKS = 3;  // blocks an SM (caps the registers at 168)
constexpr int LAST_N = 8;      // the last layer's N: 8 samples' logits, one a column

// 32-bit words of a sample's latent row a quad of lanes reads: its C / 8
// channel pairs, rounded up to whole 16-byte loads
__host__ __device__ constexpr int z_words(int c) { return (c / 8 + 3) / 4 * 4; }

// Shared memory (bytes): W_m of every mid layer, the last layer's LAST_N
// B operands (w_last in column c of the c-th), the S latent rows, the mid
// biases.
struct Layout {
  size_t last, z, bias, bytes;
  __host__ __device__ Layout(int c, int s, int n_mid)
      : last(2 * static_cast<size_t>(n_mid) * c * c),
        z(last + 2 * static_cast<size_t>(LAST_N) * LAST_N * c),
        bias(z + 16 * static_cast<size_t>(z_words(c)) * s),
        bytes(bias + 4 * static_cast<size_t>(n_mid) * c) {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor, K-major without swizzle: the start
// address, the leading-byte offset (between the core matrices of a k16 step
// along K) and the stride-byte offset (between 8-row core matrices along N),
// in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
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
// Keep the compiler from moving reads or writes of a wgmma's registers (its
// A operand, its sums) across the fences, commits and waits around it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int NK>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[j][k])::"memory");
}

// d (+)= A * B, m64nNk16, A (bf16) from registers, B (bf16) from shared
// memory by descriptor, float32 sums; scale_d 0 starts a chain (d = A * B).
__device__ __forceinline__ void mma_n8(float (&d)[4], const uint32_t (&a)[4],
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void mma_n16(float (&d)[8], const uint32_t (&a)[4],
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t (&a)[4],
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void mma_n48(float (&d)[24], const uint32_t (&a)[4],
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                    int scale_d) {
  if constexpr (N == 8) {
    mma_n8(d, a, b, scale_d);
  } else if constexpr (N == 16) {
    mma_n16(d, a, b, scale_d);
  } else if constexpr (N == 32) {
    mma_n32(d, a, b, scale_d);
  } else if constexpr (N == 48) {
    mma_n48(d, a, b, scale_d);
  } else {
    mma_n64(d, a, b, scale_d);
  }
}

// relu(f + z) for two channels: f * 1 + z rounded once to bf16, then ReLU.
__device__ __forceinline__ uint32_t entry2(uint32_t f, uint32_t z) {
  uint32_t d;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(f), "r"(0x3F803F80u), "r"(z));
  return d;
}

// relu(lo), relu(hi) rounded to bf16 (to nearest even) in one register, lo
// in the low half.
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// grid = (blocks of an image, B): block x takes the image's 64-pixel tiles
// [x T, (x + 1) T), T = tiles_per_block, one after the other.
template <int C, int NMID>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mc_consensus_wgmma(const bf::bf16* __restrict__ feat, const float* __restrict__ z_terms,
                   const bf::bf16* __restrict__ mid_w, const float* __restrict__ mid_b,
                   const bf::bf16* __restrict__ last_w, const float* __restrict__ last_b,
                   float* __restrict__ mean_out, float* __restrict__ cons_out, int B, int HW,
                   int S, int n_mid_arg, float logit_hi, float logit_lo, int masking,
                   int tiles_per_block) {
  static_assert(C % 16 == 0 && C >= 16 && C <= 64, "C: a multiple of 16 up to 64");
  constexpr int NK = C / 16;  // k-steps (channel blocks of 16)
  constexpr int ZQ = z_words(C);
  const int n_mid = NMID >= 0 ? NMID : n_mid_arg;
  extern __shared__ __align__(16) unsigned char mc_smem[];
  const Layout L(C, S, n_mid);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int b = blockIdx.y;

  // W_m[k][n] (in, out) as K-major core matrices: element (k, n) of layer m
  // at m C^2 + (k / 8) 8 C + 8 n + k % 8; read 8 n at a time
  auto* s_w = reinterpret_cast<bf::bf16*>(mc_smem);
  for (int e = tid; e < n_mid * C * C / 8; e += THREADS) {
    const int n0 = 8 * (e % (C / 8)), k = (e / (C / 8)) % C, m = e / (C * C / 8);
    const uint4 v = *reinterpret_cast<const uint4*>(mid_w + 8 * static_cast<size_t>(e));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    bf::bf16* dst = s_w + m * C * C + (k / 8) * 8 * C + 8 * n0 + k % 8;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[8 * i] = __ushort_as_bfloat16(static_cast<unsigned short>(w[i / 2] >> (16 * (i % 2))));
  }
  // B_c of the last layer (c < LAST_N): w_last in column c, the other
  // columns zero; the same layout, row n of k-group g (16 bytes) at
  // 16 (LAST_N (g + c C / 8) + n)
  for (int e = tid; e < LAST_N * C; e += THREADS) {
    const int n = e % LAST_N, g = (e / LAST_N) % (C / 8), c = e / C;
    uint32_t v[4] = {};
    if (n == c) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = __bfloat16_as_ushort(last_w[8 * g + 2 * i]) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(last_w[8 * g + 2 * i + 1])) << 16);
    }
    reinterpret_cast<uint4*>(mc_smem + L.last)[e] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  // this image's latent rows rounded to bf16, as pairs in the order a lane
  // reads them: word (s, q, 2 j + h) = channels 16 j + 8 h + 2 q, + 1
  auto* s_z = reinterpret_cast<uint32_t*>(mc_smem + L.z);
  for (int e = tid; e < S * 4 * ZQ; e += THREADS) {
    const int w = e % ZQ, q = (e / ZQ) % 4, s = e / (4 * ZQ);
    const float* zr = z_terms + (static_cast<size_t>(s) * B + b) * C + 8 * w + 2 * q;
    s_z[e] = w < C / 8 ? bf::pack(zr[0], zr[1]) : 0u;
  }
  // the mid biases as a lane reads them: (m, q, 2 t + e) = channel 8 t + 2 q + e
  auto* s_b = reinterpret_cast<float*>(mc_smem + L.bias);
  for (int e = tid; e < n_mid * C; e += THREADS) {
    const int i = e % (C / 4), q = (e / (C / 4)) % 4, m = e / C;
    s_b[e] = mid_b[m * C + 8 * (i / 2) + 2 * q + i % 2];
  }
  // the B operands' writes made visible to wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const float bl = last_b[0];
  // the descriptors of k-step 0 (a k-step adds 2 lbo / 16 to the address)
  const uint64_t w_desc = desc(smem_u32(mc_smem), 16 * C, 128);
  const uint64_t last_desc = desc(smem_u32(mc_smem + L.last), 16 * LAST_N, 16 * LAST_N);
  const uint4* zq = reinterpret_cast<const uint4*>(s_z) + quad * (ZQ / 4);  // + s 4 ZQ / 4
  const float4* bq = reinterpret_cast<const float4*>(s_b) + quad * (C / 16);  // + m C / 4
  const uint32_t* fb = reinterpret_cast<const uint32_t*>(feat + static_cast<size_t>(b) * HW * C);
  const int n_tiles = (HW + 63) / 64;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);

  // the feature rows of tile t, in A-fragment order (zero past HW)
  const auto load_rows = [&](uint32_t(&f)[NK][4], int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 64 * t + 16 * warp + grp + 8 * r;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f[j][r + 2 * h] =
              p < HW ? fb[(static_cast<size_t>(p) * C + 16 * j + 8 * h + 2 * quad) / 2] : 0u;
    }
  };
  uint32_t f[NK][4], f_next[NK][4];
  load_rows(f, t_begin);

  for (int t = t_begin; t < t_end; ++t) {
    load_rows(f_next, t + 1 < t_end ? t + 1 : t);  // read while this tile runs

    uint32_t a[2][NK][4];       // each slot's A: h of its sample, packed bf16 pairs
    float acc[2][C / 2] = {};  // ... a mid layer's float32 sums
    float lg[4] = {};          // the last layer's sums: sample 8 g + c in column c
    float sum_prob[2] = {}, n_agree[2] = {};  // rows grp, grp + 8

    // slot sl's registers, ordered against its products (a wgmma reads its
    // A and writes its sums until the wait for it)
    const auto done = [&](int sl) {
      fence_regs(a[sl]);
      if (NMID != 0) fence_regs(acc[sl]);
    };
    // relu(feat + z_s) into slot sl's A
    const auto entry = [&](int sl, int s) {
      uint32_t z[ZQ];
#pragma unroll
      for (int i = 0; i < ZQ / 4; ++i) {
        const uint4 v = zq[s * ZQ + i];
        z[4 * i] = v.x;
        z[4 * i + 1] = v.y;
        z[4 * i + 2] = v.z;
        z[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) a[sl][j][k] = entry2(f[j][k], z[2 * j + (k >> 1)]);
    };
    // slot sl's product of layer m, committed; m = n_mid: the last layer,
    // into column c of lg (c = 0 starts lg anew)
    const auto issue = [&](int sl, int m, int c) {
      done(sl);
      fence_regs(lg);
      wgmma_fence();
      if (m < n_mid) {
        const uint64_t d = w_desc + ((2 * m * C * C) >> 4);
#pragma unroll
        for (int j = 0; j < NK; ++j) mma<C>(acc[sl], a[sl][j], d + 2 * j * C, j > 0);
      } else {
        const uint64_t d = last_desc + ((2 * LAST_N * C * c) >> 4);
#pragma unroll
        for (int j = 0; j < NK; ++j) mma<LAST_N>(lg, a[sl][j], d + 2 * j * LAST_N, j > 0 || c > 0);
      }
      wgmma_commit();
      if (NMID != 0) fence_regs(acc[sl]);
      fence_regs(lg);
    };
    // relu(sums + b_m) rounded into slot sl's A: n-tile 2 j + u (channels
    // 16 j + 8 u + 2 q + {0, 1}) is k-step j's a[2 u] (row grp), a[2 u + 1]
    const auto mid_epilogue = [&](int sl, int m) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float4 bb = bq[m * (C / 4) + j];  // n-tiles 2 j (x, y), 2 j + 1 (z, w)
        const float* d = acc[sl] + 8 * j;
        a[sl][j][0] = pack_relu(d[0] + bb.x, d[1] + bb.y);
        a[sl][j][1] = pack_relu(d[2] + bb.x, d[3] + bb.y);
        a[sl][j][2] = pack_relu(d[4] + bb.z, d[5] + bb.w);
        a[sl][j][3] = pack_relu(d[6] + bb.z, d[7] + bb.w);
      }
    };

    // Groups of LAST_N samples, their logits in the columns of lg: this
    // lane's are samples g0 + 2 quad + {0, 1}, rows grp (lg[0], lg[1]) and
    // grp + 8 (lg[2], lg[3]). A group runs as four pairs: sample g0 + 2 p in
    // slot 0, g0 + 2 p + 1 in slot 1 (past S, repeats of sample S - 1, not
    // counted). Each wait leaves the newest group in flight; none is in
    // flight across the loop's back edge.
    for (int g0 = 0; g0 < S; g0 += LAST_N) {
#pragma unroll
      for (int p = 0; p < LAST_N / 2; ++p) {
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          if (p > 0) wgmma_wait<1>();  // slot sl's last product of the pair before
          done(sl);
          entry(sl, min(g0 + 2 * p + sl, S - 1));
          issue(sl, 0, 2 * p + sl);
        }
#pragma unroll
        for (int m = 0; m < n_mid; ++m) {
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            wgmma_wait<1>();  // slot sl's product (the other slot's may run on)
            done(sl);
            mid_epilogue(sl, m);
            issue(sl, m + 1, 2 * p + sl);
          }
        }
      }
      wgmma_wait<0>();
      done(0);
      done(1);
      fence_regs(lg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // sample g0 + 2 quad + i % 2, row grp + 8 (i / 2)
        const float logit = lg[i] + bl;
        const bool valid = g0 + 2 * quad + i % 2 < S;
        sum_prob[i / 2] += valid ? __fdividef(1.f, 1.f + __expf(-logit)) : 0.f;
        n_agree[i / 2] += (valid && (logit >= logit_hi || logit <= logit_lo)) ? 1.f : 0.f;
      }
    }

    // the four quads' sums of a row, in quad order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[4], n[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = __shfl_sync(0xffffffffu, sum_prob[r], 4 * grp + q);
        n[q] = __shfl_sync(0xffffffffu, n_agree[r], 4 * grp + q);
      }
      sum_prob[r] = ((v[0] + v[1]) + v[2]) + v[3];
      n_agree[r] = ((n[0] + n[1]) + n[2]) + n[3];
    }
    if (quad == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 64 * t + 16 * warp + grp + 8 * r;
        if (p >= HW) continue;
        const size_t o = static_cast<size_t>(b) * HW + p;
        mean_out[o] = sum_prob[r] / static_cast<float>(S);
        cons_out[o] = masking ? (n_agree[r] == static_cast<float>(S) ? 1.f : 0.f)
                              : n_agree[r] / static_cast<float>(S);
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) f[j][k] = f_next[j][k];
  }
}

// Blocks of ``KERNEL`` (a THREADS-thread MC tail) the card runs at once
// with ``bytes`` of shared memory (SMs x blocks an SM), after setting the
// kernel's shared-memory limit; queried once a device and size (the
// queries cost the host microseconds a launch).
template <auto KERNEL>
int resident_blocks(size_t bytes) {
  static std::mutex lock;
  static size_t known_bytes[64] = {};
  static int known[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const std::lock_guard<std::mutex> guard(lock);
  if (dev < 64 && known[dev] > 0 && known_bytes[dev] == bytes) return known[dev];
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, THREADS, bytes) !=
          cudaSuccess)
    return 0;
  if (dev < 64) {
    known[dev] = sms * per_sm;
    known_bytes[dev] = bytes;
  }
  return sms * per_sm;
}

// One wave: as many 64-pixel tiles a block as spread the batch's tiles over
// the blocks the card holds at once (each block then sets up its shared
// memory once for all its tiles). Returns the tiles a block; *blocks is the
// grid's blocks an image.
inline int one_wave(int HW, int B, int resident, int* blocks) {
  const int tiles = (HW + 63) / 64;
  const int per_block =
      static_cast<int>((static_cast<long long>(tiles) * B + resident - 1) / resident);
  *blocks = (tiles + per_block - 1) / per_block;
  return per_block;
}

template <int C, int NMID>
cudaError_t launch_wgmma(const bf::bf16* feat, const float* z, const bf::bf16* mw,
                         const float* mb, const bf::bf16* lw, const float* lb, float* mean,
                         float* cons, int B, int HW, int S, int n_mid, float hi, float lo,
                         int masking, cudaStream_t stream) {
  const size_t bytes = Layout(C, S, n_mid).bytes;
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  const int resident = resident_blocks<&mc_consensus_wgmma<C, NMID>>(bytes);
  if (resident <= 0) return cudaErrorInvalidValue;
  int blocks = 0;
  const int per_block = one_wave(HW, B, resident, &blocks);
  mc_consensus_wgmma<C, NMID><<<dim3(blocks, B), THREADS, bytes, stream>>>(
      feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi, lo, masking, per_block);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bf16(const bf::bf16* feat, const float* z, const bf::bf16* mw,
                        const float* mb, const bf::bf16* lw, const float* lb, float* mean,
                        float* cons, int B, int HW, int S, int n_mid, float hi, float lo,
                        int masking, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(feat) % 4 != 0 ||
      (n_mid > 0 && reinterpret_cast<uintptr_t>(mw) % 16 != 0))
    return cudaErrorMisalignedAddress;
  switch (n_mid) {
    case 0:
      return launch_wgmma<C, 0>(feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi, lo,
                                masking, stream);
    case 1:
      return launch_wgmma<C, 1>(feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi, lo,
                                masking, stream);
    case 2:
      return launch_wgmma<C, 2>(feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi, lo,
                                masking, stream);
    default:
      return launch_wgmma<C, -1>(feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi, lo,
                                 masking, stream);
  }
}

// The layer entry alone, for the card's check of its rounding: out[i] =
// entry2(f[i], z[i]), two bf16 a word.
__global__ void entry_pairs(const uint32_t* __restrict__ f, const uint32_t* __restrict__ z,
                            uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = entry2(f[i], z[i]);
}

// ---- float32 ----------------------------------------------------------------
// The float32 tail, mc_consensus_wgmma_tf32<C, NMID>: float32 in and out, each
// mid layer's product in 3xTF32 (tf32x3.cuh: hi = tf32(x), lo = tf32(x - hi),
// lo_a * hi_b + hi_a * lo_b + hi_a * hi_b), the rest in float32.
//
// What bounds it: 2 C^2 FLOPs a pixel, sample and mid layer against 4 (C + 2)
// bytes a pixel (the plain version instead writes and reads an S x B x H x
// W x C hidden stack a layer). Operations bind: 0.87 ms at S = 16, four 512^2
// tiles, C = 64, n_mid 1, at 165 TFLOP/s (3xTF32 on the tensor cores), 2.15
// ms on the FMA pipes (67 TFLOP/s). One TF32 product (~1e-3 relative) would
// move logits by more than the 1e-4 window the consensus tolerates. The
// mma.sync body this replaced (a warp owned 16 pixels, three mma.sync a
// k-step, each issued in the warp's own stream between its CUDA-core work;
// every 128-pixel block split W again) ran at 69-71 TFLOP/s (2.01 ms there).
// Here:
//   - A warpgroup owns a 64-pixel tile, 16 pixels a warp; a mid layer is one
//     wgmma m64nCk8 chain over K = C: C / 8 k-steps of three products each,
//     in tf32x3.cuh's order (lo_a * hi_b, hi_a * lo_b, hi_a * hi_b) into one
//     float32 accumulator, as the mma.sync body's mma3 ran them (chains of 8
//     k-steps stay within 1.5e-6 of float64, tf32x3.cuh). The small
//     products in a chain of their own would take C / 2 more registers a
//     thread, and at C = 8 drift no less (tests/test_torch_tf32x3.py's
//     model of this order; PERF.md).
//   - A comes from registers. A warp's part of a TF32 A is the m16n8k8 A
//     fragment (a[0], a[1]: rows grp, grp + 8 at k-slot quad; a[2], a[3]
//     at k-slot quad + 4) and its accumulator the m16n8 C fragments (n-tile
//     j: rows grp, grp + 8 at channels 8 j + 2 quad, + 1). Reading k-slot
//     quad of k-step j as channel 8 j + 2 quad and k-slot quad + 4 as 8 j +
//     2 quad + 1, a lane's C fragment of n-tile j is its A fragment of
//     k-step j: relu(feat + z_s) is formed and split once a sample and
//     element by the lane that owns it, and a layer's output is the next
//     layer's A in the same registers (no shuffles). W_m's K rows are
//     stored in that order.
//   - B = W_m from shared memory, split once a block into a hi and a lo
//     plane, each C x C floats as K-major core matrices without swizzle
//     (TF32 wgmma reads B only K-major): k-slot k, output channel n at
//     (k / 4) 4 C + 4 n + k % 4, a core matrix 8 n x 4 k (128 contiguous
//     bytes), the leading-byte offset 16 C (k / 4 to k / 4 + 1), the stride
//     128 (8 n).
//   - Overlap by warpgroups: a block is one warpgroup, and three blocks an
//     SM (the registers' cap: each thread holds its split A, 2 C / 4, its
//     sums, C / 2, and its feature rows, C / 2) take turns on the tensor
//     cores: each issues a sample's chain, commits and waits for it while
//     the others run their layer entries and epilogues. No group is in
//     flight across a loop's back edge, where ptxas would serialize every
//     wgmma (its C7514). NMID (0, 1, 2; -1 any other n_mid) is a template
//     parameter, so that the layer loop unrolls.
//   - The last layer, h . w_last, stays on the FMA pipes in float32 (C FMAs
//     a pixel and sample, in the mma.sync body's order: per lane over its
//     channel pairs, then a two-step exchange over the quad's four lanes,
//     after which even lanes hold row grp's logit and odd lanes row grp +
//     8's: one sigmoid and band test a lane and sample).
//   - Feature rows are read from device memory straight into registers in
//     fragment order (8-byte loads, every 32-byte sector used whole) and
//     held across the S samples. The next tile's rows are read into the
//     same registers once the tile's last sample has taken its A from them,
//     while that sample's products run. The blocks are one wave (one_wave),
//     so each splits W_m and stages the biases, w_last and this image's S
//     latent rows once for all its tiles.
// Each pixel's sums run in the same order wherever its tile lies, so a row
// shard's outputs are the whole image's bit for bit, and the mma.sync body's
// were this body's bit for bit at every K3 shape measured.
//
// On an H100 (700 W) at S = 16, C = 64, n_mid 1, in turns with the mma.sync
// body (pda_torch/tools/bench_variants.py --only mc, PERF.md): four 512^2
// tiles 1.26-1.36 ms (65-69% of the bound; that body 1.96-2.09), the MT
// teacher's 2 x 512^2 0.65-0.70 (1.02-1.13), the pseudo export's 1 x 528 x
// 704 0.46-0.54 (0.69-0.77); 154 registers, no spills. What bounds it: its
// products alone (the layer entry once a tile, no last layer) take 0.91 ms
// at the tiled shape, 96% of the bound, and its CUDA-core work alone (no
// products) 0.40 ms; the whole body takes about their sum, so warpgroups do
// not hide one's epilogue behind another's products. Two blocks an SM took
// 1.16-1.19x as long at the tiled shape, four (the feature rows in shared
// memory) were no faster overall, A from shared-memory planes 1.38x slower.

// d (+)= A * B, m64nNk8, A (TF32) from registers, B (TF32) from shared memory
// by descriptor (K-major), float32 sums; scale_d 0 starts a chain (d = A * B).
__device__ __forceinline__ void tf32_n8(float (&d)[4], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void tf32_n16(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void tf32_n24(float (&d)[12], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void tf32_n40(float (&d)[20], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void tf32_n48(float (&d)[24], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void tf32_n56(float (&d)[28], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 8) {
    tf32_n8(d, a, b, scale_d);
  } else if constexpr (N == 16) {
    tf32_n16(d, a, b, scale_d);
  } else if constexpr (N == 24) {
    tf32_n24(d, a, b, scale_d);
  } else if constexpr (N == 32) {
    tf32_n32(d, a, b, scale_d);
  } else if constexpr (N == 40) {
    tf32_n40(d, a, b, scale_d);
  } else if constexpr (N == 48) {
    tf32_n48(d, a, b, scale_d);
  } else if constexpr (N == 56) {
    tf32_n56(d, a, b, scale_d);
  } else {
    tf32_n64(d, a, b, scale_d);
  }
}

// Shared memory (bytes) of mc_consensus_wgmma_tf32: each mid layer's W_m as
// its TF32 hi plane, then its lo plane (C x C 32-bit words each), the mid
// biases, w_last, this image's S latent rows.
struct LayoutF32 {
  size_t bias, last, z, bytes;
  __host__ __device__ LayoutF32(int c, int s, int n_mid)
      : bias(8 * static_cast<size_t>(n_mid) * c * c),
        last(bias + 4 * static_cast<size_t>(n_mid) * c),
        z(last + 4 * static_cast<size_t>(c)),
        bytes(z + 4 * static_cast<size_t>(s) * c) {}
};

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// grid = (blocks of an image, B): block x takes the image's 64-pixel tiles
// [x T, (x + 1) T), T = tiles_per_block, one after the other.
template <int C, int NMID>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mc_consensus_wgmma_tf32(const float* __restrict__ feat, const float* __restrict__ z_terms,
                        const float* __restrict__ mid_w, const float* __restrict__ mid_b,
                        const float* __restrict__ last_w, const float* __restrict__ last_b,
                        float* __restrict__ mean_out, float* __restrict__ cons_out, int B,
                        int HW, int S, int n_mid_arg, float logit_hi, float logit_lo,
                        int masking, int tiles_per_block) {
  static_assert(C % 8 == 0 && C >= 8 && C <= 64, "C: a multiple of 8 up to 64");
  constexpr int NK = C / 8;  // k-steps of a mid layer, n-tiles of its sums
  const int n_mid = NMID >= 0 ? NMID : n_mid_arg;
  extern __shared__ __align__(16) unsigned char mc_smem[];
  const LayoutF32 L(C, S, n_mid);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int c2 = 2 * quad;  // this lane's first channel of each block of 8
  const int b = blockIdx.y;

  // W_m[k][n] (in, out) split into planes: input channel 8 j + c (c < 8) is
  // k-slot 8 j + r, r = c / 2 for even c, 4 + c / 2 for odd c; word (slot,
  // n) of a plane at (slot / 4) 4 C + 4 n + slot % 4, the lo plane C^2
  // words after the hi plane
  auto* s_w = reinterpret_cast<uint32_t*>(mc_smem);
  for (int e = tid; e < n_mid * C * C; e += THREADS) {
    const int n = e % C, k = (e / C) % C, m = e / (C * C);
    const int slot = (k & ~7) + 4 * (k & 1) + (k & 7) / 2;
    uint32_t* plane = s_w + 2 * m * C * C + (slot / 4) * 4 * C + 4 * n + slot % 4;
    tc::split(mid_w[e], plane[0], plane[C * C]);
  }
  auto* s_b = reinterpret_cast<float*>(mc_smem + L.bias);
  for (int e = tid; e < n_mid * C; e += THREADS) s_b[e] = mid_b[e];
  auto* s_wl = reinterpret_cast<float*>(mc_smem + L.last);
  for (int e = tid; e < C; e += THREADS) s_wl[e] = last_w[e];
  auto* s_z = reinterpret_cast<float*>(mc_smem + L.z);
  for (int e = tid; e < S * C; e += THREADS)
    s_z[e] = z_terms[(static_cast<size_t>(e / C) * B + b) * C + e % C];
  // the B operands' writes made visible to wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const float bl = last_b[0];
  // layer m's hi plane at k-step 0; its lo plane C^2 / 4 descriptor units
  // on, k-step j 2 j C on, layer m 2 m C^2 / 4 on
  const uint64_t w_desc = desc(smem_u32(mc_smem), 16 * C, 128);
  const float* fb = feat + static_cast<size_t>(b) * HW * C + c2;
  const int n_tiles = (HW + 63) / 64;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);

  // the feature rows of tile t in fragment order (zero past HW): f[j][2 r +
  // e] = row grp + 8 r, channel 8 j + c2 + e
  float f[NK][4];
  const auto load_rows = [&](int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 64 * t + 16 * warp + grp + 8 * r;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float2 v =
            p < HW ? __ldg(reinterpret_cast<const float2*>(fb + static_cast<size_t>(p) * C + 8 * j))
                   : make_float2(0.f, 0.f);
        f[j][2 * r] = v.x;
        f[j][2 * r + 1] = v.y;
      }
    }
  };
  load_rows(t_begin);

  uint32_t a_hi[NK][4], a_lo[NK][4];  // a mid layer's A, split
  float acc[C / 2] = {};              // ... its sums
  // x (row grp, k-slot quad), y (row grp, k-slot quad + 4), z (row grp + 8,
  // k-slot quad), w (row grp + 8, k-slot quad + 4) into k-step j's A
  const auto to_a = [&](int j, float x, float y, float z, float w) {
    tc::split(x, a_hi[j][0], a_lo[j][0]);
    tc::split(z, a_hi[j][1], a_lo[j][1]);
    tc::split(y, a_hi[j][2], a_lo[j][2]);
    tc::split(w, a_hi[j][3], a_lo[j][3]);
  };
  // layer m's product, committed and waited for
  const auto product = [&](int m) {
    const uint64_t d = w_desc + ((8 * m * C * C) >> 4);
    fence_regs(a_hi);
    fence_regs(a_lo);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NK; ++j) {  // lo_a * hi_b, hi_a * lo_b, hi_a * hi_b
      mma_tf32<C>(acc, a_lo[j], d + 2 * j * C, j > 0);
      mma_tf32<C>(acc, a_hi[j], d + (C * C) / 4 + 2 * j * C, 1);
      mma_tf32<C>(acc, a_hi[j], d + 2 * j * C, 1);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a_hi);
    fence_regs(a_lo);
  };

  for (int t = t_begin; t < t_end; ++t) {
    const bool more = t + 1 < t_end;
    float sum_prob = 0.f, n_agree = 0.f;  // row grp (even quad) or grp + 8 (odd quad)
    for (int s = 0; s < S; ++s) {
      const float* zs = s_z + s * C;
      float part[2] = {};  // rows grp, grp + 8: this lane's 2 NK channels
      // part += relu(h + bias) . w_last, h(n, i) the last hidden layer's
      // n-tile n in fragment order
      const auto last_layer = [&](const float* bias, auto h) {
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * n + c2);
          const float2 wl = *reinterpret_cast<const float2*>(s_wl + 8 * n + c2);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            part[r] = fmaf(relu(h(n, 2 * r) + bb.x), wl.x, part[r]);
            part[r] = fmaf(relu(h(n, 2 * r + 1) + bb.y), wl.y, part[r]);
          }
        }
      };
      if constexpr (NMID == 0) {  // h = relu(feat + z_s)
        last_layer(zs, [&](int n, int i) { return f[n][i]; });
      } else {
#pragma unroll
        for (int j = 0; j < NK; ++j) {  // relu(feat + z_s)
          const float2 z = *reinterpret_cast<const float2*>(zs + 8 * j + c2);
          to_a(j, relu(f[j][0] + z.x), relu(f[j][1] + z.y), relu(f[j][2] + z.x),
               relu(f[j][3] + z.y));
        }
        if (s == S - 1 && more) load_rows(t + 1);  // read while the products run
#pragma unroll
        for (int m = 0; m < n_mid; ++m) {
          product(m);
          if (m + 1 < n_mid) {
            const float* bm = s_b + m * C;
#pragma unroll
            for (int j = 0; j < NK; ++j) {
              const float2 bb = *reinterpret_cast<const float2*>(bm + 8 * j + c2);
              const float* d = acc + 4 * j;
              to_a(j, relu(d[0] + bb.x), relu(d[1] + bb.y), relu(d[2] + bb.x),
                   relu(d[3] + bb.y));
            }
          }
        }
        last_layer(s_b + (n_mid - 1) * C, [&](int n, int i) { return acc[4 * n + i]; });
      }
      // the quad's sums: even lanes keep row grp, odd lanes row grp + 8
      const bool odd = quad & 1;
      float v = odd ? part[1] : part[0];
      v += __shfl_xor_sync(0xffffffffu, odd ? part[0] : part[1], 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const float logit = v + bl;
      sum_prob += 1.f / (1.f + expf(-logit));
      n_agree += (logit >= logit_hi || logit <= logit_lo) ? 1.f : 0.f;
    }
    if constexpr (NMID == 0) {
      if (more) load_rows(t + 1);
    }
    if (quad < 2) {
      const int p = 64 * t + 16 * warp + grp + 8 * quad;
      if (p < HW) {
        const size_t o = static_cast<size_t>(b) * HW + p;
        mean_out[o] = sum_prob / static_cast<float>(S);
        cons_out[o] = masking ? (n_agree == static_cast<float>(S) ? 1.f : 0.f)
                              : n_agree / static_cast<float>(S);
      }
    }
  }
}

template <int C, int NMID>
cudaError_t launch_wgmma_tf32(const float* feat, const float* z, const float* mw,
                              const float* mb, const float* lw, const float* lb, float* mean,
                              float* cons, int B, int HW, int S, int n_mid, float hi, float lo,
                              int masking, cudaStream_t stream) {
  const size_t bytes = LayoutF32(C, S, n_mid).bytes;
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  const int resident = resident_blocks<&mc_consensus_wgmma_tf32<C, NMID>>(bytes);
  if (resident <= 0) return cudaErrorInvalidValue;
  int blocks = 0;
  const int per_block = one_wave(HW, B, resident, &blocks);
  mc_consensus_wgmma_tf32<C, NMID><<<dim3(blocks, B), THREADS, bytes, stream>>>(
      feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi, lo, masking, per_block);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_f32(const float* feat, const float* z, const float* mw, const float* mb,
                       const float* lw, const float* lb, float* mean, float* cons, int B,
                       int HW, int S, int n_mid, float hi, float lo, int masking,
                       cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(feat) % 8 != 0) return cudaErrorMisalignedAddress;
  switch (n_mid) {
    case 0:
      return launch_wgmma_tf32<C, 0>(feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi,
                                     lo, masking, stream);
    case 1:
      return launch_wgmma_tf32<C, 1>(feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi,
                                     lo, masking, stream);
    case 2:
      return launch_wgmma_tf32<C, 2>(feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi,
                                     lo, masking, stream);
    default:
      return launch_wgmma_tf32<C, -1>(feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi,
                                      lo, masking, stream);
  }
}

}  // namespace mcw

}  // namespace

// feat (B, HW, C), z_terms (S, B, C), mid_w (n_mid, C, C) as (in, out),
// mid_b (n_mid, C), last_w (C,), last_b (1,); mean and cons are (B, HW).
// Runs mc_consensus_wgmma_tf32. C must be a multiple of 8 up to 64 (the
// wrapper zero-pads any other C up to 64: a zero channel stays relu(0 + 0) =
// 0 through every layer and meets a zero row of last_w); feat 8-byte aligned;
// S as far as mcw::LayoutF32 fits in shared memory. Above 64 a thread's split
// A, sums and feature rows no longer fit in its registers.
extern "C" int pda_mc_consensus(const void* feat, const void* z_terms,
                                const void* mid_w, const void* mid_b,
                                const void* last_w, const void* last_b,
                                void* mean, void* cons, int B, int HW, int C,
                                int S, int n_mid, float logit_hi,
                                float logit_lo, int masking, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<float*>(mean);
  auto* c = static_cast<float*>(cons);
  switch (C) {
#define PDA_MC_WIDTH(W)                                                          \
  case W:                                                                        \
    return mcw::launch_f32<W>(f(feat), f(z_terms), f(mid_w), f(mid_b), f(last_w), \
                              f(last_b), m, c, B, HW, S, n_mid, logit_hi, logit_lo, \
                              masking, s);
    PDA_MC_WIDTH(8)
    PDA_MC_WIDTH(16)
    PDA_MC_WIDTH(24)
    PDA_MC_WIDTH(32)
    PDA_MC_WIDTH(40)
    PDA_MC_WIDTH(48)
    PDA_MC_WIDTH(56)
    PDA_MC_WIDTH(64)
#undef PDA_MC_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
}

// The bf16 tail (mc_consensus_wgmma): feat (B, HW, C) bf16, z_terms (S, B,
// C) float32, mid_w (n_mid, C, C) bf16, mid_b (n_mid, C) float32, last_w
// (C,) bf16, last_b (1,) float32; mean and cons (B, HW) float32. C a
// multiple of 16 up to 64 (the wrapper zero-pads any other C to the next
// one); feat 4-byte aligned; S as far as mcw::Layout fits in shared memory.
extern "C" int pda_mc_consensus_bf16(const void* feat, const void* z_terms,
                                     const void* mid_w, const void* mid_b,
                                     const void* last_w, const void* last_b, void* mean,
                                     void* cons, int B, int HW, int C, int S, int n_mid,
                                     float logit_hi, float logit_lo, int masking,
                                     void* stream) {
  const auto h = [](const void* p) { return static_cast<const bf::bf16*>(p); };
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<float*>(mean);
  auto* c = static_cast<float*>(cons);
  switch (C) {
#define PDA_MC_WIDTH_BF16(W)                                                        \
  case W:                                                                           \
    return mcw::launch_bf16<W>(h(feat), f(z_terms), h(mid_w), f(mid_b), h(last_w),  \
                               f(last_b), m, c, B, HW, S, n_mid, logit_hi, logit_lo, \
                               masking, s);
    PDA_MC_WIDTH_BF16(16)
    PDA_MC_WIDTH_BF16(32)
    PDA_MC_WIDTH_BF16(48)
    PDA_MC_WIDTH_BF16(64)
#undef PDA_MC_WIDTH_BF16
    default:
      return cudaErrorInvalidValue;
  }
}

// The bf16 tail's layer entry alone: out[i] = relu(f[i] + z[i]) for n
// words of two bf16 each, as mc_consensus_wgmma forms it (one
// fma.rn.relu.bf16x2): the card's check of its rounding.
extern "C" int pda_mc_bf16_entry(const void* f, const void* z, void* out, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  mcw::entry_pairs<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(z),
      static_cast<uint32_t*>(out), n);
  return cudaGetLastError();
}
