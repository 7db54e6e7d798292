// Fused ConvBlock backward for Hopper (sm_90a), float32, NHWC activations,
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
// With da_3 = g * [h3 > 0] (one elementwise pass), for layer k = 3, 2, 1:
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
// reference (and bf16 waits for a numerics decision). So both halves run
// 3xTF32 on mma.sync (tf32x3.cuh): three TF32 products a multiply-add, at a
// third of the TF32 rate but still above the FMA pipes, with float32
// accuracy. The tensor cores accumulate with round-toward-zero, so each
// warp runs short mma chains (8 k-steps in the wgrad, 18 in the dgrad) into
// zeroed fragments and adds them into float32 sums kept in shared memory
// (tf32x3.cuh), which also keeps them out of the registers. Per k-step a
// wgrad warp runs 24 mma and splits 16 values (4 integer/float ops each);
// on an H100 that runs at about 0.3 mma a cycle an SM. Splitting each value
// once instead of once a warp made the dgrad's body slower, not faster
// (conv3x3_tc.cuh), so the splits are not the bound; what is (mma.sync's own
// rate, latency) is not measured: stall reasons cannot be read on the card.
// wgmma would take TF32 only
// K-major from shared memory, which neither operand of the wgrad is in NHWC;
// mma.sync gathers its fragments from [pixel][channel] tiles, with the
// fragments' rows, columns or k-slots mapped to channels so that a lane's
// values are 4 adjacent channels: one 16-byte load, free of bank conflicts.
//
// wgrad: a block owns a 9-tap x 32-input x 64-output-channel tile of dW and
// one chunk of 8x8-pixel tiles; 18 warps, one a tap and 32 output channels,
// each a 32 x 32 tile of dW (2 x 4 fragments). The halo input tile and the
// da tile stream through a 3-stage cp.async ring in dynamic shared memory
// (177,024 bytes with the sums). The input tile is shared by the nine tap
// warps (each reads it shifted), da by all. Each chunk writes its partial dW
// and db to a workspace and a second pass adds the chunks in order: no float
// atomics, so repeats are bit-equal. db is a plain float32 sum of da (no
// split). The number of chunks fills the card's block slots (occupancy
// query). The entry layer (Cin 1 or 2) runs the same path and skips the
// second m-fragment, which holds none of its channels; a SIMT path for it
// is later work.
// dgrad: the implicit-GEMM layer body it shares with the forward
// (conv3x3_tc.cuh, which gives its tiling), with the tap flipped at the
// fragment load (no flipped copy of W, read in its HWIO layout), the output
// split into dxa | dxb, and the ReLU mask of the layer below applied as it
// is stored.
//
// Not done yet (later work): TMA and warp-specialised producers, keeping da
// on chip between the wgrad and the dgrad, the 2x2 pool's transpose.

#include <algorithm>

#include "conv3x3_tc.cuh"
#include "tf32x3.cuh"

namespace {

// ---- wgrad -----------------------------------------------------------------
constexpr int WG_T = 8;                    // pixel tile: 8 x 8, one row a k-step
constexpr int WG_PIX = WG_T * WG_T;
constexpr int WG_I = WG_T + 2;             // halo tile side
constexpr int WG_HALO = WG_I * WG_I;
constexpr int WG_CI = 32;                  // input channels a block
constexpr int WG_CO = 64;                  // output channels a block
constexpr int WG_WARPS = 9 * (WG_CO / 32); // a tap and 32 output channels each
constexpr int WG_THREADS = 32 * WG_WARPS;
constexpr int WG_LDI = WG_CI + 8;          // s_in row stride, 8 * odd (mod 32)
constexpr int WG_LDD = WG_CO + 8;          // s_da row stride, 8 * odd (mod 32)
constexpr int WG_STAGES = 3;
constexpr int WG_STAGE = WG_HALO * WG_LDI + WG_PIX * WG_LDD;  // floats
constexpr int WG_ACC = 8 * 4 * WG_THREADS;  // the float32 sums, 8 fragments a thread
constexpr int WG_SMEM = (WG_STAGES * WG_STAGE + WG_ACC) * 4;  // bytes

// Partial dW and db of one layer over one chunk of pixel tiles.
// grid = (input-channel slices, output-channel slices, chunks).
// ws_w: [chunk][9][Cin][Cout]; ws_b: [chunk][Cout] (written by the blocks of
// input-channel slice 0). V = 4: 16-byte copies (every channel count a
// multiple of 4, pointers 16-byte aligned); V = 1: 4-byte copies.
//
// A warp's 32 x 32 tile of dW is 2 x 4 fragments. Row r of m-fragment mf is
// channel 4 (r % 8) + 2 mf + r / 8 and column n of n-fragment nf is channel
// 4 n + nf, so that a lane's A values of both m-fragments are 4 adjacent
// channels of one pixel, and its B values of all four n-fragments too: one
// 16-byte load each (conflict-free: row strides 8 * odd floats).
template <int V>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_tc(const float* __restrict__ xa, const float* __restrict__ xb, int Ca,
         int Cb, const float* __restrict__ da, float* __restrict__ ws_w,
         float* __restrict__ ws_b, int B, int H, int W, int Cout,
         int tiles_per_chunk) {
  extern __shared__ __align__(16) float smem[];
  float4* s_acc = reinterpret_cast<float4*>(smem + WG_STAGES * WG_STAGE);
  const int cin = Ca + Cb;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int tap = warp % 9, ky = tap / 3, kx = tap % 3;
  const int co_w = (warp / 9) * 32;
  const int ci0 = blockIdx.x * WG_CI;
  const int co0 = blockIdx.y * WG_CO;
  const int chunk = blockIdx.z;
  const bool two_rows = ci0 + 2 < cin;  // m-fragment 1 (channels 2, 3 mod 4) has channels
  const bool sums_bias = blockIdx.x == 0;

  const int tiles_x = cdiv(W, WG_T);
  const int tiles_img = cdiv(H, WG_T) * tiles_x;
  const int t_begin = chunk * tiles_per_chunk;
  const int n_tiles = min(B * tiles_img, t_begin + tiles_per_chunk) - t_begin;

  // Tile t_begin + i into stage i % WG_STAGES.
  auto load = [&](int i) {
    float* s_in = smem + (i % WG_STAGES) * WG_STAGE;
    float* s_da = s_in + WG_HALO * WG_LDI;
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
      const float* src = xa;
      if (in) {
        const size_t p = img + static_cast<size_t>(gy) * W + gx;
        src = ch < Ca ? xa + p * Ca + ch : xb + p * Cb + (ch - Ca);
      }
      tc::cp_async<V>(s_in + pix * WG_LDI + c, src, in);
    }
    for (int e = tid; e < WG_PIX * WG_CO / V; e += WG_THREADS) {
      const int c = (e % (WG_CO / V)) * V;
      const int pix = e / (WG_CO / V);
      const int gy = y0 + pix / WG_T, gx = x0 + pix % WG_T;
      const bool in = gy < H && gx < W && co0 + c < Cout;
      const float* src =
          in ? da + (img + static_cast<size_t>(gy) * W + gx) * Cout + co0 + c
             : da;
      tc::cp_async<V>(s_da + pix * WG_LDD + c, src, in);
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

    const float* s_in = smem + (i % WG_STAGES) * WG_STAGE;
    const float* s_da = s_in + WG_HALO * WG_LDI;
    const float* a_ptr = s_in + (ky * WG_I + kx + quad) * WG_LDI + 4 * grp;
    const float* b_ptr = s_da + quad * WG_LDD + co_w + 4 * grp;
#pragma unroll
    for (int row = 0; row < WG_T; ++row) {  // k-step: 8 pixels of one row
      const float4 x0 = *reinterpret_cast<const float4*>(a_ptr + row * WG_I * WG_LDI);
      const float4 x4 = *reinterpret_cast<const float4*>(a_ptr + (row * WG_I + 4) * WG_LDI);
      const float4 y0 = *reinterpret_cast<const float4*>(b_ptr + row * WG_T * WG_LDD);
      const float4 y4 = *reinterpret_cast<const float4*>(b_ptr + (row * WG_T + 4) * WG_LDD);
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
    tc::flush(s_acc + tid, WG_THREADS, chain);
    if (sums_bias) {
      for (int p = b_pix; p < WG_PIX; p += WG_WARPS * 32 / WG_CO)
        bsum += s_da[p * WG_LDD + b_co];
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const float4 v = s_acc[f * WG_THREADS + tid];
    const float c[4] = {v.x, v.y, v.z, v.w};
    const int ci = ci0 + 4 * grp + 2 * (f / 4);
    const int co = co0 + co_w + 8 * quad + f % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // c[j]: row grp (+8 for j >= 2), column 2 quad + j % 2
      const int c_i = ci + j / 2, c_o = co + 4 * (j % 2);
      if (c_i < cin && c_o < Cout)
        ws_w[((static_cast<size_t>(chunk) * 9 + tap) * cin + c_i) * Cout + c_o] = c[j];
    }
  }
  if (sums_bias) {  // the 9 partial sums of each channel, in a fixed order
    smem[tid] = bsum;
    __syncthreads();
    if (tid < WG_CO && co0 + tid < Cout) {
      float s = 0.f;
      for (int k = 0; k < WG_THREADS / WG_CO; ++k) s += smem[k * WG_CO + tid];
      ws_b[static_cast<size_t>(chunk) * Cout + co0 + tid] = s;
    }
  }
}

// out[i] = sum over c in [0, chunks) of ws[c * n + i], in that order.
__global__ void sum_chunks(const float* __restrict__ ws, float* __restrict__ out,
                           int n, int chunks) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += ws[static_cast<size_t>(c) * n + i];
    out[i] = s;
  }
}

// da = g * [h > 0]
__global__ void relu_mask(const float* __restrict__ g, const float* __restrict__ h,
                          float* __restrict__ da, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    da[i] = h[i] > 0.f ? g[i] : 0.f;
}

// ---- host ------------------------------------------------------------------
int grid_1d(long long n) {
  const long long blocks = (n + 255) / 256;
  return blocks < 4096 ? static_cast<int>(blocks) : 4096;
}

// Blocks of wgrad_tc the card runs at once (SMs x blocks an SM).
int wgrad_slots() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(&wgrad_tc<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       WG_SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, &wgrad_tc<4>,
                                                WG_THREADS, WG_SMEM);
  return sms * (per_sm > 0 ? per_sm : 1);
}

int wgrad_tiles(int B, int H, int W) {
  return B * cdiv(H, WG_T) * cdiv(W, WG_T);
}

// Pixel tiles a chunk for one layer: the chunk count that fills the card's
// block slots best (the fewest chunks among the best), each chunk >= 1 tile.
int wgrad_tiles_per_chunk(int cin, int cout, int tiles, int slots) {
  const int slices = cdiv(cin, WG_CI) * cdiv(cout, WG_CO);
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

long long wgrad_work(int cin, int cout, int tiles, int slots) {
  const int chunks = cdiv(tiles, wgrad_tiles_per_chunk(cin, cout, tiles, slots));
  return static_cast<long long>(chunks) * (9LL * cin * cout + cout);
}

// dW, db of one layer (input [xa | xb], output cotangent da = dh * [h > 0]).
cudaError_t wgrad(const float* xa, const float* xb, int Ca, int Cb,
                  const float* da, float* dw, float* db, float* work, int B,
                  int H, int W, int Cout, int slots, cudaStream_t s) {
  const int cin = Ca + Cb;
  const int tiles = wgrad_tiles(B, H, W);
  const int tpc = wgrad_tiles_per_chunk(cin, Cout, tiles, slots);
  const int chunks = cdiv(tiles, tpc);
  float* ws_w = work;
  float* ws_b = work + static_cast<size_t>(chunks) * 9 * cin * Cout;
  const dim3 grid(cdiv(cin, WG_CI), cdiv(Cout, WG_CO), chunks);
  const bool vec = Ca % 4 == 0 && Cb % 4 == 0 && Cout % 4 == 0 && aligned16(xa) &&
                   aligned16(xb) && aligned16(da);
  const auto kernel = vec ? &wgrad_tc<4> : &wgrad_tc<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WG_THREADS, WG_SMEM, s>>>(xa, xb, Ca, Cb, da, ws_w, ws_b, B, H,
                                           W, Cout, tpc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = 9 * cin * Cout;
  sum_chunks<<<grid_1d(n), 256, 0, s>>>(ws_w, dw, n, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_chunks<<<grid_1d(Cout), 256, 0, s>>>(ws_b, db, Cout, chunks);
  return cudaGetLastError();
}

// da_{k-1} (or dx, split into ya: Coa channels, yb: Cob) of one layer with
// kernel w (3, 3, Coa+Cob, C), masked by [m > 0] unless m is null.
cudaError_t dgrad(const float* da, const float* w, const float* m, float* ya,
                  float* yb, int Coa, int Cob, int B, int H, int W, int C,
                  cudaStream_t s) {
  return conv3x3_tc_layer<false>(da, nullptr, C, 0, w, m, ya, yb, Coa, Cob, B,
                                 H, W, s);
}

// da1 and da2 are (B, H, W, C) workspaces: da_3 goes to da1, da_2 to da2,
// da_1 to da1 again (da_3 is spent by then).
cudaError_t block_bwd(const float* xa, const float* xb, int Ca, int Cb,
                      const float* w1, const float* w2, const float* w3,
                      const float* h1, const float* h2, const float* h3,
                      const float* g, float* dxa, float* dxb, float* dw1,
                      float* db1, float* dw2, float* db2, float* dw3,
                      float* db3, float* da1, float* da2, float* work, int B,
                      int H, int W, int C, bool need_dx, cudaStream_t s) {
  const int slots = wgrad_slots();
  const long long n = static_cast<long long>(B) * H * W * C;
  relu_mask<<<grid_1d(n), 256, 0, s>>>(g, h3, da1, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = wgrad(h2, nullptr, C, 0, da1, dw3, db3, work, B, H, W, C, slots,
                   s)) != cudaSuccess)
    return err;
  if ((err = dgrad(da1, w3, h2, da2, nullptr, C, 0, B, H, W, C, s)) !=
      cudaSuccess)
    return err;
  if ((err = wgrad(h1, nullptr, C, 0, da2, dw2, db2, work, B, H, W, C, slots,
                   s)) != cudaSuccess)
    return err;
  if ((err = dgrad(da2, w2, h1, da1, nullptr, C, 0, B, H, W, C, s)) !=
      cudaSuccess)
    return err;
  if ((err = wgrad(xa, xb, Ca, Cb, da1, dw1, db1, work, B, H, W, C, slots,
                   s)) != cudaSuccess)
    return err;
  if (!need_dx) return cudaSuccess;
  return dgrad(da1, w1, nullptr, dxa, dxb, Ca, Cb, B, H, W, C, s);
}

const float* cf(const void* p) { return static_cast<const float*>(p); }
float* mf(void* p) { return static_cast<float*>(p); }

}  // namespace

// Floats of the `work` buffer the two entries need for a block with input
// channels Cin (= Ca + Cb) and width C at (B, H, W) on the current device.
extern "C" long long pda_conv_block_bwd_work(int B, int H, int W, int Cin,
                                             int C) {
  const int slots = wgrad_slots();
  const int tiles = wgrad_tiles(B, H, W);
  const long long inner = wgrad_work(C, C, tiles, slots);
  const long long first = wgrad_work(Cin, C, tiles, slots);
  return inner > first ? inner : first;
}

// Single-input block. x: (B, H, W, Cin); w1: (3, 3, Cin, C); w2, w3:
// (3, 3, C, C); h1, h2, h3, g: (B, H, W, C). Writes dW (HWIO) and db of the
// three layers and, with need_dx, dx (B, H, W, Cin) (dx may be null without).
// Workspaces: da1, da2 (B, H, W, C); work (pda_conv_block_bwd_work floats).
extern "C" int pda_conv_block_bwd(
    const void* x, int Cin, const void* w1, const void* w2, const void* w3,
    const void* h1, const void* h2, const void* h3, const void* g, void* dx,
    void* dw1, void* db1, void* dw2, void* db2, void* dw3, void* db3,
    void* da1, void* da2, void* work, int B, int H, int W, int C, int need_dx,
    void* stream) {
  return block_bwd(cf(x), nullptr, Cin, 0, cf(w1), cf(w2), cf(w3), cf(h1),
                   cf(h2), cf(h3), cf(g), mf(dx), nullptr, mf(dw1), mf(db1),
                   mf(dw2), mf(db2), mf(dw3), mf(db3), mf(da1), mf(da2),
                   mf(work), B, H, W, C, need_dx != 0,
                   static_cast<cudaStream_t>(stream));
}

// Dual-input block on [xa | xb] (Ca + Cb channels): as above, with dx written
// apart into dxa (B, H, W, Ca) and dxb (B, H, W, Cb).
extern "C" int pda_conv_block_bwd_dual(
    const void* xa, const void* xb, int Ca, int Cb, const void* w1,
    const void* w2, const void* w3, const void* h1, const void* h2,
    const void* h3, const void* g, void* dxa, void* dxb, void* dw1, void* db1,
    void* dw2, void* db2, void* dw3, void* db3, void* da1, void* da2,
    void* work, int B, int H, int W, int C, void* stream) {
  return block_bwd(cf(xa), cf(xb), Ca, Cb, cf(w1), cf(w2), cf(w3), cf(h1),
                   cf(h2), cf(h3), cf(g), mf(dxa), mf(dxb), mf(dw1), mf(db1),
                   mf(dw2), mf(db2), mf(dw3), mf(db3), mf(da1), mf(da2),
                   mf(work), B, H, W, C, true,
                   static_cast<cudaStream_t>(stream));
}
