// Fused Monte-Carlo Fcomb tail + consensus for Hopper (sm_90a), float32
// accurate, the mid layers on the tensor cores in 3xTF32; and its bf16
// instance for pda's bf16 configuration (mc_consensus_bf16, at the end).
//
// Replaces the Pallas TPU kernel pda/kernels/mc_consensus.py
// mc_consensus_decode (:136, body _kernel :49). Per pixel and sample s:
//   h     = relu(feat_term + z_term[s])             (C channels)
//   h     = relu(h @ W_m + b_m)   for each mid layer m
//   logit = h . w_last + b_last
// and over the S samples: mean of sigmoid(logit), and the fraction of logits
// in the confident band (>= logit_hi or <= logit_lo), or, with masking, 1
// where all S samples are confident and 0 elsewhere. Outputs are (B, H*W).
//
// What bounds it: 2 * C * C FLOPs a pixel, sample and mid layer against
// 4 * (C + 2) bytes a pixel (the plain version instead writes and reads an
// S x B x H x W x C hidden stack a layer: 4.3 GB a mid layer at S = 16, four
// 512^2 tiles, C = 64). Operations bind: 0.87 ms at S = 16, 4 x 512^2 x 64
// at 165 TFLOP/s (3xTF32), 2.15 ms on the FMA pipes (67 TFLOP/s), so only
// the tensor cores can bring it near its bound. One TF32 product (~1e-3
// relative) would move logits by more than the 1e-4 window the consensus
// tolerates, so each product is 3xTF32 (tf32x3.cuh).
//
// Design: one small GEMM a sample, M = pixels, N = K = C. A warp owns 16
// pixels and all C output channels; its feature rows are loaded once into
// registers and kept there for all S samples. Channel block j (channels
// 8j .. 8j + 7) of the warp's 16 rows sits in a lane (grp, quad) as
//   v[0] = (row grp, ch 8j + 2 quad)      v[1] = (row grp, ch 8j + 2 quad + 1)
//   v[2] = (row grp + 8, ch 8j + 2 quad)  v[3] = (row grp + 8, ch 8j + 2 quad + 1)
// which is the m16n8 C fragment of n-tile j and, reading k-slot quad as
// channel 8j + 2 quad and k-slot quad + 4 as 8j + 2 quad + 1, the m16n8k8 A
// fragment {v0, v2, v1, v3} of k-step j. So relu(feat + z_s) is formed, and
// split into hi and lo, once a sample and element, by the one lane that
// feeds it to the tensor cores, and a layer's output is the next layer's A
// in the same registers' order. W_m is split once a block and stored in
// shared memory in B-fragment order (one 16-byte {hi0, hi1, lo0, lo1} a lane,
// k-step and n-tile: conflict-free). K = C is one chain of C / 8 k-steps
// (tf32x3.cuh: chains of 8 stay within 1.5e-6 of float64), so no flush. The
// epilogue stays in registers: bias, ReLU, times w_last, a two-step shuffle
// over the quad, sigmoid and band test, sums per row; quad 0 writes the two
// outputs at the end. With n_mid >= 2 a layer's output waits for the next
// layer in this thread's own shared-memory slots (written and read by the
// same thread: no barrier). No atomics: repeats are bit-equal. n_mid = 0 has
// no product (h = relu(feat + z) goes straight to the epilogue).
//
// The feature rows go from device memory straight into registers in
// fragment order (8-byte loads, every 32-byte sector used whole, issued
// before the block's weight split so that their latency overlaps it): each
// element is read once, so staging them through shared memory would only
// add a copy and a barrier.
//
// On an H100 (700 W) this runs at 69-71 TFLOP/s (2.02 ms at S = 16, four
// 512^2 tiles, C = 64, n_mid 1; 42% of the bound): the 3 x 64 mma.sync a
// warp, 16 pixels and sample bound it. With one TF32 product (a third of
// the mma; not accurate enough) it takes 1.54 ms, and 32 pixels a warp
// (half the B-fragment loads, 222 registers) are no faster than 16 (128
// registers, 4 bytes of spill) (pda_torch/tools/bench_variants.py --only mc,
// PERF.md).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bf16.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;         // blocks an SM (caps the registers at 128)
constexpr int PIXELS = WARPS * 16;    // a block's pixels
constexpr size_t MAX_SMEM = 232448;   // bytes a block may opt in to on sm_90

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// grid = (pixel tiles of an image, B)
template <int C>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mc_consensus_tc(const float* __restrict__ feat, const float* __restrict__ z_terms,
                const float* __restrict__ mid_w, const float* __restrict__ mid_b,
                const float* __restrict__ last_w, const float* __restrict__ last_b,
                float* __restrict__ mean_out, float* __restrict__ cons_out,
                int B, int HW, int S, int n_mid, float logit_hi, float logit_lo,
                int masking) {
  static_assert(C % 8 == 0 && C >= 8 && C <= 64, "C: a multiple of 8 up to 64");
  constexpr int NB = C / 8;  // channel blocks: n-tiles and k-steps
  extern __shared__ __align__(16) float smem[];
  uint4* s_w = reinterpret_cast<uint4*>(smem);  // [m][j][n][lane]: W_m split
  float4* s_h = reinterpret_cast<float4*>(s_w + n_mid * NB * NB * 32);  // [j][tid]
  float* s_b = reinterpret_cast<float*>(s_h + (n_mid >= 2 ? NB * THREADS : 0));
  float* s_wl = s_b + n_mid * C;  // C
  float* s_z = s_wl + C;          // S * C, this image's latent terms

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * PIXELS + warp * 16;  // the warp's first pixel

  float f[NB][4];  // the feature rows, in fragment order
  const float* fb = feat + static_cast<size_t>(b) * HW * C + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row0 + grp + 8 * r;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float2 v =
          p < HW ? __ldg(reinterpret_cast<const float2*>(fb + static_cast<size_t>(p) * C + 8 * j))
                 : make_float2(0.f, 0.f);
      f[j][2 * r] = v.x;
      f[j][2 * r + 1] = v.y;
    }
  }

  // W_m[k][n] (in, out) as B fragments: b[0] = (k-slot quad, n grp) =
  // W[8j + 2 quad][8n + grp], b[1] = (k-slot quad + 4) = W[8j + 2 quad + 1][8n + grp]
  for (int e = tid; e < n_mid * NB * NB * 32; e += THREADS) {
    const int l = e % 32, n = (e / 32) % NB, j = (e / (32 * NB)) % NB, m = e / (32 * NB * NB);
    const float* w = mid_w + static_cast<size_t>(m) * C * C +
                     (8 * j + 2 * (l & 3)) * C + 8 * n + (l >> 2);
    uint4 v;
    tc::split(w[0], v.x, v.z);
    tc::split(w[C], v.y, v.w);
    s_w[e] = v;
  }
  for (int e = tid; e < n_mid * C; e += THREADS) s_b[e] = mid_b[e];
  for (int e = tid; e < C; e += THREADS) s_wl[e] = last_w[e];
  for (int e = tid; e < S * C; e += THREADS)
    s_z[e] = z_terms[(static_cast<size_t>(e / C) * B + b) * C + e % C];
  __syncthreads();

  const float bl = last_b[0];
  const int c2 = 2 * quad;  // this lane's first channel of each block
  float4* h_own = s_h + tid;
  float sum_prob[2] = {}, n_agree[2] = {};  // rows grp, grp + 8

  for (int s = 0; s < S; ++s) {
    const float* zs = s_z + s * C;
    float acc[NB][4];
    for (int m = 0; m < n_mid; ++m) {
      const uint4* wm = s_w + m * NB * NB * 32 + lane;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        tc::FragA a;
        if (m == 0) {  // relu(feat + z_s), formed here once an element
          const float2 z = *reinterpret_cast<const float2*>(zs + 8 * j + c2);
          tc::split(relu(f[j][0] + z.x), relu(f[j][2] + z.x), relu(f[j][1] + z.y),
                    relu(f[j][3] + z.y), a);
        } else {
          const float4 h = h_own[j * THREADS];
          tc::split(h.x, h.z, h.y, h.w, a);
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const uint4 w = wm[(j * NB + n) * 32];
          const tc::FragB bf = {{w.x, w.y}, {w.z, w.w}};
          tc::mma3(acc[n], a, bf);
        }
      }
      if (m + 1 < n_mid) {  // relu(acc + b_m) waits in this thread's slots
        const float* bm = s_b + m * C;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float2 bb = *reinterpret_cast<const float2*>(bm + 8 * n + c2);
          h_own[n * THREADS] = make_float4(relu(acc[n][0] + bb.x), relu(acc[n][1] + bb.y),
                                           relu(acc[n][2] + bb.x), relu(acc[n][3] + bb.y));
        }
      }
    }
    // the last mid layer's output is relu(acc + b); without mid layers it
    // is relu(feat + z_s)
    const float* bias = zs;
    if (n_mid == 0) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = f[n][e];
    } else {
      bias = s_b + (n_mid - 1) * C;
    }
    float part[2] = {};  // rows grp, grp + 8: this lane's 2 NB channels
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * n + c2);
      const float2 wl = *reinterpret_cast<const float2*>(s_wl + 8 * n + c2);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[r] = fmaf(relu(acc[n][2 * r] + bb.x), wl.x, part[r]);
        part[r] = fmaf(relu(acc[n][2 * r + 1] + bb.y), wl.y, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = part[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const float logit = v + bl;
      sum_prob[r] += 1.f / (1.f + expf(-logit));
      n_agree[r] += (logit >= logit_hi || logit <= logit_lo) ? 1.f : 0.f;
    }
  }

  if (quad != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row0 + grp + 8 * r;
    if (p >= HW) continue;
    const size_t o = static_cast<size_t>(b) * HW + p;
    mean_out[o] = sum_prob[r] / static_cast<float>(S);
    cons_out[o] = masking ? (n_agree[r] == static_cast<float>(S) ? 1.f : 0.f)
                          : n_agree[r] / static_cast<float>(S);
  }
}

template <int C>
cudaError_t launch(const float* feat, const float* z, const float* mw,
                   const float* mb, const float* lw, const float* lb,
                   float* mean, float* cons, int B, int HW, int S, int n_mid,
                   float hi, float lo, int masking, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(feat) % 8 != 0) return cudaErrorMisalignedAddress;
  const size_t bytes =
      static_cast<size_t>(n_mid) * C * C * 8 +
      (n_mid >= 2 ? static_cast<size_t>(C) * THREADS * 2 : 0) +
      4 * (static_cast<size_t>(n_mid) * C + C + static_cast<size_t>(S) * C);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mc_consensus_tc<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((HW + PIXELS - 1) / PIXELS, B);
  mc_consensus_tc<C><<<grid, THREADS, bytes, stream>>>(
      feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi, lo, masking);
  return cudaGetLastError();
}


// ---- bf16 -------------------------------------------------------------------
// pda's bf16 configuration (pda/kernels/mc_consensus.py _kernel :96-110):
// feat and the mid and last kernels bf16, the latent terms and the biases
// float32. Per sample: the z row rounded to bf16, h = relu(feat + z) rounded
// to bf16; each mid layer bf16 x bf16 on mma.sync.m16n8k16 with float32
// sums, + b (float32), ReLU, one rounding to bf16; the last layer a float32
// dot product of the bf16 h with the bf16 w_last, + b_last: the logit in
// float32, then the sigmoid mean and the band test in float32. K = C is one
// chain of C / 16 k-steps (at most 4). Channel block j (16 channels) of the
// warp's 16 rows sits in a lane as the m16n8k16 A fragment of k-step j,
// two bf16 a register (bf16.cuh): r0 = (row grp, 16j + 2q + {0,1}),
// r1 = (row grp + 8, the same channels), r2 = (row grp, 16j + 8 + 2q + {0,1}),
// r3 = (row grp + 8, those); the C fragments of n-tiles 2j and 2j + 1 give
// the next layer's A fragment of k-step j in the same lanes, rounded and
// packed (no shuffles). Every layer's hidden stays in registers (C / 4 of
// them). W_m is stored once a block in shared memory in B-fragment order
// (one 8-byte {b0, b1} a lane, k-step and n-tile).
template <int C>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mc_consensus_bf16(const bf::bf16* __restrict__ feat, const float* __restrict__ z_terms,
                  const bf::bf16* __restrict__ mid_w, const float* __restrict__ mid_b,
                  const bf::bf16* __restrict__ last_w, const float* __restrict__ last_b,
                  float* __restrict__ mean_out, float* __restrict__ cons_out, int B, int HW,
                  int S, int n_mid, float logit_hi, float logit_lo, int masking) {
  static_assert(C % 16 == 0 && C >= 16 && C <= 64, "C: a multiple of 16 up to 64");
  constexpr int NK = C / 16;  // k-steps (channel blocks of 16)
  constexpr int NB = C / 8;   // n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint2* s_w = reinterpret_cast<uint2*>(smem_raw);  // [m][j][n][lane]: W_m's B fragments
  float* s_b = reinterpret_cast<float*>(s_w + n_mid * NK * NB * 32);
  float* s_wl = s_b + n_mid * C;  // C: w_last as float32
  float* s_z = s_wl + C;          // S * C: this image's latent terms, rounded to bf16

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * PIXELS + warp * 16;  // the warp's first pixel

  uint32_t f[NK][4];  // the feature rows, in fragment order
  const uint32_t* fb = reinterpret_cast<const uint32_t*>(feat + static_cast<size_t>(b) * HW * C);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row0 + grp + 8 * r;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f[j][r + 2 * h] =
            p < HW ? __ldg(fb + (static_cast<size_t>(p) * C + 16 * j + 8 * h + 2 * quad) / 2)
                   : 0u;
  }

  // W_m[k][n] (in, out) as B fragments: b0 = W[16j + 2q + {0,1}][8n + grp],
  // b1 = W[16j + 8 + 2q + {0,1}][8n + grp]
  for (int e = tid; e < n_mid * NK * NB * 32; e += THREADS) {
    const int l = e % 32, n = (e / 32) % NB, j = (e / (32 * NB)) % NK, m = e / (32 * NB * NK);
    const bf::bf16* w = mid_w + static_cast<size_t>(m) * C * C +
                        (16 * j + 2 * (l & 3)) * C + 8 * n + (l >> 2);
    const auto u = [&](int k) { return __bfloat16_as_ushort(w[k * C]); };
    s_w[e] = make_uint2(u(0) | (static_cast<uint32_t>(u(1)) << 16),
                        u(8) | (static_cast<uint32_t>(u(9)) << 16));
  }
  for (int e = tid; e < n_mid * C; e += THREADS) s_b[e] = mid_b[e];
  for (int e = tid; e < C; e += THREADS) s_wl[e] = __bfloat162float(last_w[e]);
  for (int e = tid; e < S * C; e += THREADS)
    s_z[e] = __bfloat162float(
        __float2bfloat16_rn(z_terms[(static_cast<size_t>(e / C) * B + b) * C + e % C]));
  __syncthreads();

  const float bl = last_b[0];
  const int c2 = 2 * quad;  // this lane's first channel of each half block
  float sum_prob[2] = {}, n_agree[2] = {};  // rows grp, grp + 8

  for (int s = 0; s < S; ++s) {
    const float* zs = s_z + s * C;
    uint32_t h[NK][4];  // relu(feat + z_s), rounded: the first layer's input
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 z = *reinterpret_cast<const float2*>(zs + 16 * j + 8 * (k >> 1) + c2);
        h[j][k] = bf::pack(fmaxf(bf::lo(f[j][k]) + z.x, 0.f), fmaxf(bf::hi(f[j][k]) + z.y, 0.f));
      }
    for (int m = 0; m < n_mid; ++m) {
      float acc[NB][4] = {};
      const uint2* wm = s_w + m * NK * NB * 32 + lane;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const uint2 w = wm[(j * NB + n) * 32];
          const uint32_t bw[2] = {w.x, w.y};
          bf::mma(acc[n], h[j], bw);
        }
      }
      const float* bm = s_b + m * C;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t) {  // n-tile 2j + t: channels 16j + 8t + 2q + {0,1}
          const float2 bb = *reinterpret_cast<const float2*>(bm + 16 * j + 8 * t + c2);
          const float* a = acc[2 * j + t];
          h[j][2 * t] = bf::pack(fmaxf(a[0] + bb.x, 0.f), fmaxf(a[1] + bb.y, 0.f));
          h[j][2 * t + 1] = bf::pack(fmaxf(a[2] + bb.x, 0.f), fmaxf(a[3] + bb.y, 0.f));
        }
    }
    float part[2] = {};  // rows grp, grp + 8: this lane's C / 4 channels
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 wl = *reinterpret_cast<const float2*>(s_wl + 16 * j + 8 * (k >> 1) + c2);
        part[k & 1] = fmaf(bf::lo(h[j][k]), wl.x, part[k & 1]);
        part[k & 1] = fmaf(bf::hi(h[j][k]), wl.y, part[k & 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = part[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const float logit = v + bl;
      sum_prob[r] += 1.f / (1.f + expf(-logit));
      n_agree[r] += (logit >= logit_hi || logit <= logit_lo) ? 1.f : 0.f;
    }
  }

  if (quad != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row0 + grp + 8 * r;
    if (p >= HW) continue;
    const size_t o = static_cast<size_t>(b) * HW + p;
    mean_out[o] = sum_prob[r] / static_cast<float>(S);
    cons_out[o] = masking ? (n_agree[r] == static_cast<float>(S) ? 1.f : 0.f)
                          : n_agree[r] / static_cast<float>(S);
  }
}

template <int C>
cudaError_t launch_bf16(const bf::bf16* feat, const float* z, const bf::bf16* mw,
                        const float* mb, const bf::bf16* lw, const float* lb, float* mean,
                        float* cons, int B, int HW, int S, int n_mid, float hi, float lo,
                        int masking, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(feat) % 4 != 0) return cudaErrorMisalignedAddress;
  const size_t bytes = static_cast<size_t>(n_mid) * C * C * 2 +
                       4 * (static_cast<size_t>(n_mid) * C + C + static_cast<size_t>(S) * C);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mc_consensus_bf16<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((HW + PIXELS - 1) / PIXELS, B);
  mc_consensus_bf16<C><<<grid, THREADS, bytes, stream>>>(
      feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi, lo, masking);
  return cudaGetLastError();
}

}  // namespace

// feat (B, HW, C), z_terms (S, B, C), mid_w (n_mid, C, C) as (in, out),
// mid_b (n_mid, C), last_w (C,), last_b (1,); mean and cons are (B, HW).
// C must be a multiple of 8 up to 64 (the wrapper zero-pads any other C up to
// 64: a zero channel stays relu(0 + 0) = 0 through every layer and meets a
// zero row of last_w); feat 8-byte aligned. Above 64 one warp's 16 x C feature
// rows no longer fit in its registers (C = 64 already takes 128 a thread).
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
    return launch<W>(f(feat), f(z_terms), f(mid_w), f(mid_b), f(last_w),         \
                     f(last_b), m, c, B, HW, S, n_mid, logit_hi, logit_lo,       \
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

// The bf16 tail: feat (B, HW, C) bf16, z_terms (S, B, C) float32, mid_w
// (n_mid, C, C) bf16, mid_b (n_mid, C) float32, last_w (C,) bf16, last_b (1,)
// float32; mean and cons (B, HW) float32. C a multiple of 16 up to 64 (the
// wrapper zero-pads any other C to the next one); feat 4-byte aligned.
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
    return launch_bf16<W>(h(feat), f(z_terms), h(mid_w), f(mid_b), h(last_w),       \
                          f(last_b), m, c, B, HW, S, n_mid, logit_hi, logit_lo,     \
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
