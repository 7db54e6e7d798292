// Fused Monte-Carlo Fcomb tail + consensus for Hopper (sm_90a), float32.
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
// What bounds it: the plain version writes and reads an S x B x H x W x C
// hidden stack per layer (4.3 GB per mid layer at S=16, 4 tiles of 512^2,
// C=64); this kernel reads the feature term once and keeps every hidden value
// on chip, so it is bound by float32 FMAs (2*C*C per pixel, sample and mid
// layer). A block takes 4*256/(C/8) pixels of one image: their feature term,
// the mid and last weights and this image's S latent terms sit in shared
// memory; the S loop runs inside. Each thread accumulates a 4-pixel x
// 8-channel tile of a mid layer's output in registers; the C/8 threads of a
// pixel group reduce the last layer's dot product with warp shuffles. Rows of
// the pixel buffers are padded to C+1 floats so the four pixel groups of a
// warp read distinct banks.
//
// Not done yet (later work): bf16 and tensor-core (mma/wgmma) mid layers.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // bytes a block may opt in to on sm_90

// pixels per block: 256 threads, C/8 threads per group of 4 pixels
template <int C>
constexpr int kPixels = 4 * THREADS / (C / 8);

template <int C>
__global__ void __launch_bounds__(THREADS)
mc_consensus(const float* __restrict__ feat, const float* __restrict__ z_terms,
             const float* __restrict__ mid_w, const float* __restrict__ mid_b,
             const float* __restrict__ last_w, const float* __restrict__ last_b,
             float* __restrict__ mean_out, float* __restrict__ cons_out, int B,
             int HW, int S, int n_mid, float logit_hi, float logit_lo,
             int masking) {
  constexpr int CG = C / 8;  // threads per pixel group (8 channels each)
  constexpr int P = kPixels<C>;
  constexpr int LDA = C + 1;
  constexpr int HALF = C / 2;

  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                  // n_mid * C * C (offset 0: 16B aligned)
  float* s_b = s_w + n_mid * C * C;   // n_mid * C
  float* s_wl = s_b + n_mid * C;      // C
  float* s_z = s_wl + C;              // S * C, this image's latent terms
  float* s_feat = s_z + S * C;        // P * LDA
  float* s_h = s_feat + P * LDA;      // P * LDA, used when n_mid >= 2

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int pg = tid / CG;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * P;

  for (int e = tid; e < n_mid * C * C; e += THREADS) s_w[e] = mid_w[e];
  for (int e = tid; e < n_mid * C; e += THREADS) s_b[e] = mid_b[e];
  for (int e = tid; e < C; e += THREADS) s_wl[e] = last_w[e];
  for (int e = tid; e < S * C; e += THREADS)
    s_z[e] = z_terms[(static_cast<size_t>(e / C) * B + b) * C + e % C];
  const float* fb = feat + (static_cast<size_t>(b) * HW + p0) * C;
  for (int e = tid; e < P * C; e += THREADS) {
    const int p = e / C;
    s_feat[p * LDA + e % C] = p0 + p < HW ? fb[e] : 0.f;
  }
  __syncthreads();

  int ch[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    ch[k] = k < 4 ? cg * 4 + k : HALF + cg * 4 + (k - 4);
  const float bl = last_b[0];

  float sum_prob[4] = {0.f, 0.f, 0.f, 0.f};
  float n_agree[4] = {0.f, 0.f, 0.f, 0.f};

  for (int s = 0; s < S; ++s) {
    const float* zs = s_z + s * C;
    float h[4][8];
    if (n_mid == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          h[j][k] = fmaxf(s_feat[(pg * 4 + j) * LDA + ch[k]] + zs[ch[k]], 0.f);
    }
    for (int m = 0; m < n_mid; ++m) {
      const float* wm = s_w + m * C * C;
      const float* A = m == 0 ? s_feat : s_h;
      float acc[4][8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;
#pragma unroll 4
      for (int k = 0; k < C; ++k) {
        float a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = A[(pg * 4 + j) * LDA + k];
        if (m == 0) {
          const float zk = zs[k];
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = fmaxf(a[j] + zk, 0.f);
        }
        const float4 w0 = *reinterpret_cast<const float4*>(wm + k * C + cg * 4);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wm + k * C + HALF + cg * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] = fmaf(a[j], w0.x, acc[j][0]);
          acc[j][1] = fmaf(a[j], w0.y, acc[j][1]);
          acc[j][2] = fmaf(a[j], w0.z, acc[j][2]);
          acc[j][3] = fmaf(a[j], w0.w, acc[j][3]);
          acc[j][4] = fmaf(a[j], w1.x, acc[j][4]);
          acc[j][5] = fmaf(a[j], w1.y, acc[j][5]);
          acc[j][6] = fmaf(a[j], w1.z, acc[j][6]);
          acc[j][7] = fmaf(a[j], w1.w, acc[j][7]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          h[j][k] = fmaxf(acc[j][k] + s_b[m * C + ch[k]], 0.f);
      if (m + 1 < n_mid) {
        __syncthreads();  // every thread is done reading s_h for layer m
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 8; ++k) s_h[(pg * 4 + j) * LDA + ch[k]] = h[j][k];
        __syncthreads();
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) part = fmaf(h[j][k], s_wl[ch[k]], part);
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const float logit = part + bl;
      sum_prob[j] += 1.f / (1.f + expf(-logit));
      n_agree[j] += (logit >= logit_hi || logit <= logit_lo) ? 1.f : 0.f;
    }
  }

  if (cg != 0) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = p0 + pg * 4 + j;
    if (p >= HW) continue;
    const size_t o = static_cast<size_t>(b) * HW + p;
    mean_out[o] = sum_prob[j] / static_cast<float>(S);
    cons_out[o] = masking ? (n_agree[j] == static_cast<float>(S) ? 1.f : 0.f)
                          : n_agree[j] / static_cast<float>(S);
  }
}

template <int C>
cudaError_t launch(const float* feat, const float* z, const float* mw,
                   const float* mb, const float* lw, const float* lb,
                   float* mean, float* cons, int B, int HW, int S, int n_mid,
                   float hi, float lo, int masking, cudaStream_t stream) {
  constexpr int P = kPixels<C>;
  const size_t floats = static_cast<size_t>(n_mid) * C * C + n_mid * C + C +
                        static_cast<size_t>(S) * C +
                        static_cast<size_t>(n_mid >= 2 ? 2 : 1) * P * (C + 1);
  const size_t bytes = floats * sizeof(float);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mc_consensus<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((HW + P - 1) / P, B);
  mc_consensus<C><<<grid, THREADS, bytes, stream>>>(
      feat, z, mw, mb, lw, lb, mean, cons, B, HW, S, n_mid, hi, lo, masking);
  return cudaGetLastError();
}

}  // namespace

// feat (B, HW, C), z_terms (S, B, C), mid_w (n_mid, C, C) as (in, out),
// mid_b (n_mid, C), last_w (C,), last_b (1,); mean and cons are (B, HW).
// C must be 32 or 64.
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
    case 32:
      return launch<32>(f(feat), f(z_terms), f(mid_w), f(mid_b), f(last_w),
                        f(last_b), m, c, B, HW, S, n_mid, logit_hi, logit_lo,
                        masking, s);
    case 64:
      return launch<64>(f(feat), f(z_terms), f(mid_w), f(mid_b), f(last_w),
                        f(last_b), m, c, B, HW, S, n_mid, logit_hi, logit_lo,
                        masking, s);
    default:
      return cudaErrorInvalidValue;
  }
}
