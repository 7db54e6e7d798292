// One 3x3 SAME conv layer (zero padding) as an implicit GEMM on Hopper's
// tensor cores with mma.sync, in 3xTF32 (float32 accurate) or in bf16, NHWC
// activations: the layer body of the fused ConvBlock forward
// (conv_block_fwd.cuh) and of the backward's dgrad (conv_block_bwd.cuh) for
// the layers that Hopper's asynchronous bodies (conv3x3_wgmma_tf32.cuh in
// float32, conv3x3_wgmma.cuh in bf16) cannot describe as tensor maps: an
// input or output channel count that is not a multiple of 8 (Cin 3-7, a
// dx of 1-7 channels, the learning checks' odd widths) or a pointer off 16
// bytes; the wrappers route by shape before launch. On the flagship's,
// MitoEM's and Lung's shapes no layer takes it. One template serves both:
//
//   y[p, n] = epilogue(sum_{tap, k} x[p + tap, k] * w[tap', n, k])
//
// with M = pixels, N = output channels, K = 9 * input channels; w is read as
// [tap][n][k] (k contiguous: one 16-byte load gives 4 k-slots), x's channels
// may come from two tensors ([0, Ka) from xa, [Ka, Ka + Kb) from xb: the
// forward's [upsample | skip] input, never concatenated in device memory) and
// y's channels may go to two ([0, Na) to ya, [Na, Na + Nb) to yb: the
// dgrad's dxa | dxb). T is the operand type: float (3xTF32, below) or
// bf16 (pda's bf16 configuration, after the float32 notes).
//   forward (FWD): tap' = tap, w = the layer's kernel as HWOI (the wrapper's
//                  copy of the HWIO argument), epilogue relu(sum + bias[n]);
//   dgrad:         tap' = 8 - tap (the flipped kernel), w = the layer's
//                  kernel as HWIO (n = its input channel, k = its output
//                  channel), epilogue sum * [m[p, n] > 0] (no mask when m is
//                  null).
//
// What bounds it: 18 * Cin * Cout FLOPs a pixel; compute-bound at every
// shape it takes in the PUNet (144-1,152 FLOPs for every byte a layer must
// move, against the card's 49 at 165 TFLOP/s and 3.35 TB/s). float32 on the
// FMA pipes tops out at 67 TFLOP/s; the tensor cores reach 495 TFLOP/s in
// TF32, but one TF32 product keeps ~3 decimal digits (1e-3 off float64),
// which would move the port off pda's float32 reference (pda's bf16
// configuration runs the bf16 instance, below). So each float32 product runs
// as 3xTF32 (tf32x3.cuh: hi/lo
// split, three mma.sync a multiply-add), whose ceiling is 495 / 3 = 165
// TFLOP/s. The tensor cores accumulate with
// round-toward-zero, so a warp's mma chains are short and then added into
// float32 sums kept in shared memory (tf32x3.cuh flush), which also keeps the
// sums out of the registers; the bias is added to the flushed sum, then the
// ReLU. Chain length: 6 k-steps (3 taps) in the forward, 18 (a stage) in the
// dgrad. On an H100 the forward with 18-k-step chains drifted 2-3e-6 of its
// largest value off float64 at the serving shapes, with 6 0.7-1.2e-6, for
// about 10% more time; the closer forward also sets fewer ReLU masks apart
// from the CPU port's (the 128^2 MT step's gradients: 1.7e-4 of their
// largest value off the CPU port, against 9.7e-4). The dgrad keeps 18
// (2.2-2.8e-6 at the MT step's shapes): 6 would cost the backward 3-5%.
//
// The float32 numbers below are this body's at the flagship's shapes, from
// when every float32 layer ran on it; those layers now run on
// conv3x3_wgmma_tf32.cuh (its chains and drift: PERF.md §6).
//
// Tiling: a block owns 16x16 pixels x 64 output channels; 8 warps, each 4
// pixel rows (64 pixels) x 32 channels = 4 x 4 m16n8k8 fragments (204
// registers in the forward; 255 with under 128 bytes of spills in the
// dgrad). Each stage holds 16 input channels of the halo tile (18x18
// pixels) and the matching 9 x 64 x 16 slice of w; 2 stages of cp.async in
// dynamic shared memory and the sums, 180,736 bytes (bf16: 123,136): one
// block an SM. The
// next stage's copies fly while the tensor cores work on this one. On an H100 this beat 16 warps of 2 x 4 fragments by 1-12% on the
// forward (tied on the dgrad), and beat both splitting the x tile into hi/lo
// once a stage in shared memory (20-31% slower: one more barrier a stage,
// twice the A loads) and sums in registers (spills): the splits' integer
// work is not what bounds it (pda_torch/tools/bench_variants.py, PERF.md).
//
// A stage's two k-steps of a tap take its 16 channels so that k-slot q of
// k-step ks is channel 4 q + 2 ks and k-slot q + 4 is channel 4 q + 2 ks + 1:
// a lane's A values of both k-steps are 4 adjacent channels of one pixel and
// its B values 4 adjacent channels of one weight row, one 16-byte load each
// (conflict-free: rows of 16 floats).
//
// bf16 (T = __nv_bfloat16): pda's kernels' numerics in its bf16
// configuration (pda/kernels/conv_block.py _kernel, conv_block_bwd.py
// stencil): bf16 operands, products accumulated in float32
// (mma.sync.m16n8k16.f32.bf16.bf16.f32, one k-step a tap: the stage's 16
// channels), chains of 3 taps flushed into the float32 sums as above in
// both modes, the bias added in float32, then the ReLU (forward) or the
// mask (dgrad), and one rounding to bf16 as the value is stored. No split:
// a bf16 product is exact in float32. k-slots 2q, 2q + 1 take channels
// 4q, 4q + 1 and k-slots 2q + 8, 2q + 9 channels 4q + 2, 4q + 3, so a
// lane's A values of a pixel and its B values of a weight row are one
// 8-byte load each (rows of 16 bf16: a half warp reads 128 contiguous
// bytes, conflict-free); the tile's rows are 32 bytes, copied as two
// 16-byte cp.async (channel counts multiples of 8) or element by element.
// What bounds it: the same FLOPs against 989 TFLOP/s dense bf16; the
// stage layout, the flushes to shared memory and mma.sync (not wgmma)
// keep it far from that (PERF.md).
#pragma once

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "tf32x3.cuh"

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

constexpr int IG_T = 16;                   // pixel tile: 16 x 16
constexpr int IG_I = IG_T + 2;             // halo tile side
constexpr int IG_HALO = IG_I * IG_I;
constexpr int IG_N = 64;                   // output channels a block
constexpr int IG_CK = 16;                  // input channels a stage; row stride of both tiles
constexpr int IG_MF = 4;                   // pixel rows (m16 fragments) a warp
constexpr int IG_WM = IG_T / IG_MF;        // warps along the pixel rows
constexpr int IG_WARPS = 2 * IG_WM;        // x 2 along the channels (32 each)
constexpr int IG_THREADS = 32 * IG_WARPS;
constexpr int IG_FRAGS = 4 * IG_MF;        // m16n8 fragments a warp
constexpr int IG_STAGES = 2;
constexpr int IG_STAGE = IG_HALO * IG_CK + 9 * IG_N * IG_CK;  // elements
constexpr int IG_ACC = IG_FRAGS * 4 * IG_THREADS;  // the float32 sums

template <typename T>
constexpr int ig_smem() {  // bytes
  return IG_STAGES * IG_STAGE * static_cast<int>(sizeof(T)) + IG_ACC * 4;
}

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// V elements of T from src into shared memory at dst (zeros with valid
// false): float V = 4 / 1 as 16- / 4-byte cp.async; bf16 V = 8 as a 16-byte
// cp.async, V = 1 as a plain store (a 2-byte copy has no cp.async).
template <typename T, int V>
__device__ __forceinline__ void copy_in(T* dst, const T* src, bool valid) {
  if constexpr (std::is_same<T, float>::value) {
    tc::cp_async<V>(dst, src, valid);
  } else if constexpr (V == 8) {
    bf::cp_async16(dst, src, valid);
  } else {
    *dst = valid ? *src : __float2bfloat16_rn(0.f);
  }
}

// grid = (pixel tiles of an image, output-channel slices, B). V: elements a
// copy (float 4 or 1, bf16 8 or 1; the larger needs Ka, Kb multiples of V and
// xa, xb, w 16-byte aligned). bias: float32 (FWD); mask: the dgrad's m, of
// type T (or null).
template <typename T, int V, bool FWD>
__global__ void __launch_bounds__(IG_THREADS, 1)
conv3x3_tc(const T* __restrict__ xa, const T* __restrict__ xb, int Ka,
           int Kb, const T* __restrict__ w, const float* __restrict__ bias,
           const T* __restrict__ mask, T* __restrict__ ya, T* __restrict__ yb,
           int Na, int Nb, int H, int W, int tiles_x) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float4* s_acc = reinterpret_cast<float4*>(smem + IG_STAGES * IG_STAGE);
  const int K = Ka + Kb, N = Na + Nb;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int wm = warp % IG_WM, wn = warp / IG_WM;
  const int y0 = (blockIdx.x / tiles_x) * IG_T;
  const int x0 = (blockIdx.x % tiles_x) * IG_T;
  const int n0 = blockIdx.y * IG_N;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W;
  const int n_stages = cdiv(K, IG_CK);

  // Channels [s * IG_CK, (s + 1) * IG_CK) of x's halo tile and of w into
  // stage s % IG_STAGES; zeros outside the image and past K or N.
  auto load = [&](int s) {
    T* s_x = smem + (s % IG_STAGES) * IG_STAGE;
    T* s_w = s_x + IG_HALO * IG_CK;
    const int c0 = s * IG_CK;
    for (int e = tid; e < IG_HALO * IG_CK / V; e += IG_THREADS) {
      const int c = c0 + (e % (IG_CK / V)) * V;
      const int pix = e / (IG_CK / V);
      const int gy = y0 - 1 + pix / IG_I, gx = x0 - 1 + pix % IG_I;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < K;
      const T* src = xa;
      if (in) {
        const size_t p = img + static_cast<size_t>(gy) * W + gx;
        src = c < Ka ? xa + p * Ka + c : xb + p * Kb + (c - Ka);
      }
      copy_in<T, V>(s_x + pix * IG_CK + c - c0, src, in);
    }
    for (int e = tid; e < 9 * IG_N * IG_CK / V; e += IG_THREADS) {
      const int c = (e % (IG_CK / V)) * V;
      const int r = e / (IG_CK / V);  // tap * IG_N + n
      const int n = n0 + r % IG_N, tap = r / IG_N;
      const bool in = n < N && c0 + c < K;
      const T* src = in ? w + (static_cast<size_t>(tap) * N + n) * K + c0 + c : w;
      copy_in<T, V>(s_w + r * IG_CK + c, src, in);
    }
  };

  // taps a chain runs before its flush: 3 (6 k-steps) in the float32
  // forward, 9 (18) in its dgrad; 3 (3 k-steps) in bf16
  constexpr int flush_taps = (FWD || !F32) ? 3 : 9;
  float chain[IG_FRAGS][4] = {};  // fragment mf * 4 + nf
#pragma unroll
  for (int f = 0; f < IG_FRAGS; ++f)
    s_acc[f * IG_THREADS + tid] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int s = 0; s < IG_STAGES - 1; ++s) {
    if (s < n_stages) load(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    tc::cp_async_wait<IG_STAGES - 2>();
    __syncthreads();
    if (s + IG_STAGES - 1 < n_stages) load(s + IG_STAGES - 1);
    tc::cp_async_commit();

    const T* s_x = smem + (s % IG_STAGES) * IG_STAGE;
    const T* s_w = s_x + IG_HALO * IG_CK;
    const T* a_ptr = s_x + (IG_MF * wm * IG_I + grp) * IG_CK + 4 * quad;
    const T* b_ptr = s_w + (wn * 32 + grp) * IG_CK + 4 * quad;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const int wtap = FWD ? tap : 8 - tap;
      if constexpr (F32) {
        float4 wv[4];  // channels 4 quad .. 4 quad + 3 of weight rows nf * 8 + grp
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
          wv[nf] = *reinterpret_cast<const float4*>(b_ptr + (wtap * IG_N + nf * 8) * IG_CK);
        float4 xv[IG_MF][2];  // [mf][pixel grp, grp + 8]
#pragma unroll
        for (int mf = 0; mf < IG_MF; ++mf) {
          const float* p = a_ptr + ((mf + ky) * IG_I + kx) * IG_CK;
          xv[mf][0] = *reinterpret_cast<const float4*>(p);
          xv[mf][1] = *reinterpret_cast<const float4*>(p + 8 * IG_CK);
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          tc::FragB bf[4];
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
            tc::split(ks ? wv[nf].z : wv[nf].x, ks ? wv[nf].w : wv[nf].y, bf[nf]);
#pragma unroll
          for (int mf = 0; mf < IG_MF; ++mf) {
            const float4& u = xv[mf][0];
            const float4& v = xv[mf][1];
            tc::FragA a;
            tc::split(ks ? u.z : u.x, ks ? v.z : v.x, ks ? u.w : u.y, ks ? v.w : v.y, a);
#pragma unroll
            for (int nf = 0; nf < 4; ++nf) tc::mma3(chain[mf * 4 + nf], a, bf[nf]);
          }
        }
      } else {
        uint32_t b[4][2];  // channels 4 quad .. 4 quad + 3 of weight rows nf * 8 + grp
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          const uint2 v = *reinterpret_cast<const uint2*>(b_ptr + (wtap * IG_N + nf * 8) * IG_CK);
          b[nf][0] = v.x;
          b[nf][1] = v.y;
        }
#pragma unroll
        for (int mf = 0; mf < IG_MF; ++mf) {
          const T* p = a_ptr + ((mf + ky) * IG_I + kx) * IG_CK;
          const uint2 u = *reinterpret_cast<const uint2*>(p);               // pixel grp
          const uint2 v = *reinterpret_cast<const uint2*>(p + 8 * IG_CK);  // pixel grp + 8
          const uint32_t a[4] = {u.x, v.x, u.y, v.y};
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) bf::mma(chain[mf * 4 + nf], a, b[nf]);
        }
      }
      if (tap % flush_taps == flush_taps - 1) tc::flush(s_acc + tid, IG_THREADS, chain);
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int f = 0; f < IG_FRAGS; ++f) {
    const float4 sum = s_acc[f * IG_THREADS + tid];
    const float acc[4] = {sum.x, sum.y, sum.z, sum.w};
    const int gy = y0 + IG_MF * wm + f / 4;
    const int n = n0 + wn * 32 + (f % 4) * 8 + 2 * quad;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // acc[j]: pixel grp (+8 for j >= 2), channel n + j % 2
      const int gx = x0 + grp + (j >= 2 ? 8 : 0), c = n + (j & 1);
      if (gy >= H || gx >= W || c >= N) continue;
      const size_t p = img + static_cast<size_t>(gy) * W + gx;
      float v = acc[j];
      if constexpr (FWD) {
        v = fmaxf(v + bias[c], 0.f);
      } else {
        if (mask != nullptr && !(to_float(mask[p * N + c]) > 0.f)) v = 0.f;
      }
      if (c < Na) {
        ya[p * Na + c] = from_float<T>(v);
      } else {
        yb[p * Nb + (c - Na)] = from_float<T>(v);
      }
    }
  }
}

// Launch one layer over a (B, H, W, *) batch on ``s``: x = [xa | xb]
// (xb may be null with Kb = 0), y = [ya | yb] (yb may be null with Nb = 0);
// the float32 bias (FWD) or the mask m (dgrad, or null).
template <typename T, bool FWD>
cudaError_t conv3x3_tc_layer(const T* xa, const T* xb, int Ka, int Kb, const T* w,
                             const float* bias, const T* mask, T* ya, T* yb, int Na,
                             int Nb, int B, int H, int W, cudaStream_t s) {
  constexpr int VEC = std::is_same<T, float>::value ? 4 : 8;
  constexpr int SMEM = ig_smem<T>();
  const int tiles_x = cdiv(W, IG_T);
  const dim3 grid(tiles_x * cdiv(H, IG_T), cdiv(Na + Nb, IG_N), B);
  const bool vec = Ka % VEC == 0 && Kb % VEC == 0 && aligned16(xa) &&
                   aligned16(xb) && aligned16(w);
  const auto kernel = vec ? &conv3x3_tc<T, VEC, FWD> : &conv3x3_tc<T, 1, FWD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, IG_THREADS, SMEM, s>>>(xa, xb, Ka, Kb, w, bias, mask, ya, yb, Na,
                                        Nb, H, W, tiles_x);
  return cudaGetLastError();
}

}  // namespace
