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
// For layer k = 3, 2, 1, with da_k = dh_k * [h_k > 0] formed while loading:
//   wgrad  dW_k[ky,kx,ci,co] = sum_{b,y,x} in_k[b,y+ky-1,x+kx-1,ci] da_k[b,y,x,co]
//          db_k[co]          = sum_{b,y,x} da_k[b,y,x,co]
//   dgrad  dh_{k-1} = conv3x3(da_k, W_k flipped in space, in/out swapped):
//          the forward's layer kernel (conv3x3.cuh) in its dgrad mode.
// in_1 = x, whose border loads are zero-filled (the dense-image entry).
//
// What bounds it: both halves are float32 FMA work of the forward's size
// (18*Cin*C FLOPs per pixel each). The wgrad is a reduction over B*H*W
// (524,288 pixels at level 0), which on the TPU a sequential grid carries in
// VMEM. Here it is split into a fixed number of pixel chunks: one block owns a
// 9 x 32-input-channel x 64-output-channel slice of dW for one chunk, walks
// the chunk's 4x16-pixel tiles in order with the input tile (plus halo) and
// da in shared memory, and keeps 9x8 accumulators per thread (one input
// channel, 8 output channels, all nine taps), so one shared-memory load feeds
// about 8 FMAs. Each chunk writes its partial sums to a workspace, and a
// second pass adds the chunks in order: no float atomics, so the gradients are
// bit-equal from run to run.
//
// Not done yet (later work): tensor cores (TF32/bf16 with wgmma), keeping da
// on chip between wgrad and dgrad, and fusing the 2x2 pool's transpose.

#include "conv3x3.cuh"

namespace {

constexpr int WG_TH = 4;              // pixel tile rows
constexpr int WG_TW = 16;             // pixel tile columns
constexpr int WG_PIX = WG_TH * WG_TW;
constexpr int WG_CI = 32;             // input channels per block
constexpr int WG_CO = 64;             // output channels per block
constexpr int WG_IH = WG_TH + 2;
constexpr int WG_IW = WG_TW + 2;
constexpr int WG_THREADS = 256;       // = WG_CI * (WG_CO / 8)
constexpr int TARGET_BLOCKS = 264;    // two blocks for each of the 132 SMs

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

int pixel_tiles(int B, int H, int W) {
  return B * cdiv(H, WG_TH) * cdiv(W, WG_TW);
}

// Pixel tiles per chunk for a block with C output channels (the layers'
// width); one count serves all three layers of a call.
int tiles_per_chunk(int B, int H, int W, int C) {
  const int slices = cdiv(C, WG_CI) * cdiv(C, WG_CO);
  const int chunks = cdiv(TARGET_BLOCKS, slices);
  return cdiv(pixel_tiles(B, H, W), chunks);
}

// Partial dW and db of one layer over one chunk of pixel tiles.
// grid = (input-channel slices, output-channel slices, chunks).
// ws_w: [chunk][9][Cin][Cout]; ws_b: [chunk][Cout] (written by the blocks of
// input-channel slice 0).
__global__ void __launch_bounds__(WG_THREADS)
wgrad_partial(const float* __restrict__ xa, const float* __restrict__ xb,
              int Ca, int Cb, const float* __restrict__ dh,
              const float* __restrict__ h, float* __restrict__ ws_w,
              float* __restrict__ ws_b, int B, int H, int W, int Cout,
              int tiles_per_chunk) {
  __shared__ __align__(16) float s_in[WG_CI][WG_IH][WG_IW];
  __shared__ __align__(16) float s_da[WG_PIX][WG_CO];

  const int cin = Ca + Cb;
  const int tid = threadIdx.x;
  const int cg = tid & 7;
  const int ci_l = tid >> 3;
  const int ci0 = blockIdx.x * WG_CI;
  const int co0 = blockIdx.y * WG_CO;
  const int chunk = blockIdx.z;
  const bool has_ci = ci0 + ci_l < cin;
  const bool sums_bias = blockIdx.x == 0 && ci_l == 0;

  const int tiles_x = cdiv(W, WG_TW);
  const int tiles_img = cdiv(H, WG_TH) * tiles_x;
  const int t_begin = chunk * tiles_per_chunk;
  const int t_end = min(B * tiles_img, t_begin + tiles_per_chunk);

  float acc[9][8];
  float bacc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    bacc[k] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) acc[tap][k] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int b = t / tiles_img;
    const int r = t % tiles_img;
    const int y0 = (r / tiles_x) * WG_TH;
    const int x0 = (r % tiles_x) * WG_TW;
    const size_t img = static_cast<size_t>(b) * H * W;

    for (int e = tid; e < WG_CI * WG_IH * WG_IW; e += WG_THREADS) {
      const int ci = e % WG_CI;
      const int pix = e / WG_CI;
      const int iy = pix / WG_IW;
      const int ix = pix % WG_IW;
      const int gy = y0 - 1 + iy;
      const int gx = x0 - 1 + ix;
      const int c = ci0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin) {
        const size_t p = img + static_cast<size_t>(gy) * W + gx;
        v = c < Ca ? xa[p * Ca + c] : xb[p * Cb + (c - Ca)];
      }
      s_in[ci][iy][ix] = v;
    }
    for (int e = tid; e < WG_PIX * WG_CO; e += WG_THREADS) {
      const int co = e % WG_CO;
      const int pix = e / WG_CO;
      const int gy = y0 + pix / WG_TW;
      const int gx = x0 + pix % WG_TW;
      const int o = co0 + co;
      float v = 0.f;
      if (gy < H && gx < W && o < Cout) {
        const size_t q = (img + static_cast<size_t>(gy) * W + gx) * Cout + o;
        v = h[q] > 0.f ? dh[q] : 0.f;
      }
      s_da[pix][co] = v;
    }
    __syncthreads();

    if (has_ci) {
#pragma unroll 1
      for (int row = 0; row < WG_TH; ++row) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          float in[WG_IW];
#pragma unroll
          for (int q = 0; q < WG_IW; ++q) in[q] = s_in[ci_l][row + ky][q];
#pragma unroll
          for (int x = 0; x < WG_TW; ++x) {
            const float* d = s_da[row * WG_TW + x];
            const float4 da = *reinterpret_cast<const float4*>(d + cg * 4);
            const float4 db = *reinterpret_cast<const float4*>(d + 32 + cg * 4);
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const float a = in[x + kx];
              float* s = acc[ky * 3 + kx];
              s[0] = fmaf(a, da.x, s[0]);
              s[1] = fmaf(a, da.y, s[1]);
              s[2] = fmaf(a, da.z, s[2]);
              s[3] = fmaf(a, da.w, s[3]);
              s[4] = fmaf(a, db.x, s[4]);
              s[5] = fmaf(a, db.y, s[5]);
              s[6] = fmaf(a, db.z, s[6]);
              s[7] = fmaf(a, db.w, s[7]);
            }
          }
        }
      }
    }
    if (sums_bias) {
      for (int p = 0; p < WG_PIX; ++p) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          bacc[k] += s_da[p][k < 4 ? cg * 4 + k : 32 + cg * 4 + (k - 4)];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int o = co0 + (k < 4 ? cg * 4 + k : 32 + cg * 4 + (k - 4));
    if (o >= Cout) continue;
    if (has_ci) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const size_t m =
            (static_cast<size_t>(chunk) * 9 + tap) * cin + ci0 + ci_l;
        ws_w[m * Cout + o] = acc[tap][k];
      }
    }
    if (sums_bias) ws_b[static_cast<size_t>(chunk) * Cout + o] = bacc[k];
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

// wt[ky][kx][co][ci] = w[2-ky][2-kx][ci][co]: the dgrad's kernel.
__global__ void flip_swap(const float* __restrict__ w, float* __restrict__ wt,
                          int Cin, int Cout) {
  const int n = 9 * Cin * Cout;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    const int ci = e % Cin;
    const int co = (e / Cin) % Cout;
    const int tap = e / (Cin * Cout);
    wt[e] = w[(static_cast<size_t>(8 - tap) * Cin + ci) * Cout + co];
  }
}

int grid_1d(int n) { return cdiv(n, 256) < 4096 ? cdiv(n, 256) : 4096; }

// dW, db of one layer (input [xa | xb], output cotangent dh, output h).
cudaError_t wgrad(const float* xa, const float* xb, int Ca, int Cb,
                  const float* dh, const float* h, float* dw, float* db,
                  float* work, int B, int H, int W, int Cout, int tpc,
                  cudaStream_t s) {
  const int cin = Ca + Cb;
  const int chunks = cdiv(pixel_tiles(B, H, W), tpc);
  float* ws_w = work;
  float* ws_b = work + static_cast<size_t>(chunks) * 9 * cin * Cout;
  const dim3 grid(cdiv(cin, WG_CI), cdiv(Cout, WG_CO), chunks);
  wgrad_partial<<<grid, WG_THREADS, 0, s>>>(xa, xb, Ca, Cb, dh, h, ws_w, ws_b,
                                             B, H, W, Cout, tpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 9 * cin * Cout;
  sum_chunks<<<grid_1d(n), 256, 0, s>>>(ws_w, dw, n, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_chunks<<<grid_1d(Cout), 256, 0, s>>>(ws_b, db, Cout, chunks);
  return cudaGetLastError();
}

// dh_{k-1} (split into ya: Coa channels, yb: Cob) of one layer with kernel w
// (3, 3, Coa+Cob, Cout); wt is a workspace for the flipped kernel.
cudaError_t dgrad(const float* dh, const float* h, const float* w, float* wt,
                  float* ya, float* yb, int Coa, int Cob, int B, int H, int W,
                  int Cout, cudaStream_t s) {
  const int cin = Coa + Cob;
  flip_swap<<<grid_1d(9 * cin * Cout), 256, 0, s>>>(w, wt, cin, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return conv3x3<true>(dh, nullptr, h, Cout, 0, wt, nullptr, ya, yb, Coa, Cob,
                       B, H, W, s);
}

cudaError_t block_bwd(const float* xa, const float* xb, int Ca, int Cb,
                      const float* w1, const float* w2, const float* w3,
                      const float* h1, const float* h2, const float* h3,
                      const float* g, float* dxa, float* dxb, float* dw1,
                      float* db1, float* dw2, float* db2, float* dw3,
                      float* db3, float* dh2, float* dh1, float* wt,
                      float* work, int B, int H, int W, int C, bool need_dx,
                      cudaStream_t s) {
  const int tpc = tiles_per_chunk(B, H, W, C);
  cudaError_t err;
  if ((err = wgrad(h2, nullptr, C, 0, g, h3, dw3, db3, work, B, H, W, C, tpc,
                   s)) != cudaSuccess)
    return err;
  if ((err = dgrad(g, h3, w3, wt, dh2, nullptr, C, 0, B, H, W, C, s)) !=
      cudaSuccess)
    return err;
  if ((err = wgrad(h1, nullptr, C, 0, dh2, h2, dw2, db2, work, B, H, W, C, tpc,
                   s)) != cudaSuccess)
    return err;
  if ((err = dgrad(dh2, h2, w2, wt, dh1, nullptr, C, 0, B, H, W, C, s)) !=
      cudaSuccess)
    return err;
  if ((err = wgrad(xa, xb, Ca, Cb, dh1, h1, dw1, db1, work, B, H, W, C, tpc,
                   s)) != cudaSuccess)
    return err;
  if (!need_dx) return cudaSuccess;
  return dgrad(dh1, h1, w1, wt, dxa, dxb, Ca, Cb, B, H, W, C, s);
}

const float* cf(const void* p) { return static_cast<const float*>(p); }
float* mf(void* p) { return static_cast<float*>(p); }

}  // namespace

// Floats of the `work` buffer the two entries need for a block with input
// channels Cin (= Ca + Cb) and width C at (B, H, W).
extern "C" long long pda_conv_block_bwd_work(int B, int H, int W, int Cin,
                                             int C) {
  const long long chunks = cdiv(pixel_tiles(B, H, W), tiles_per_chunk(B, H, W, C));
  const long long cmax = Cin > C ? Cin : C;
  return chunks * (9 * cmax * C + C);
}

// Single-input block. x: (B, H, W, Cin); w1: (3, 3, Cin, C); w2, w3:
// (3, 3, C, C); h1, h2, h3, g: (B, H, W, C). Writes dW (HWIO) and db of the
// three layers and, with need_dx, dx (B, H, W, Cin) (dx may be null without).
// Workspaces: dh2, dh1 (B, H, W, C); wt (9 * max(Cin, C) * C floats); work
// (pda_conv_block_bwd_work floats).
extern "C" int pda_conv_block_bwd(
    const void* x, int Cin, const void* w1, const void* w2, const void* w3,
    const void* h1, const void* h2, const void* h3, const void* g, void* dx,
    void* dw1, void* db1, void* dw2, void* db2, void* dw3, void* db3,
    void* dh2, void* dh1, void* wt, void* work, int B, int H, int W, int C,
    int need_dx, void* stream) {
  return block_bwd(cf(x), nullptr, Cin, 0, cf(w1), cf(w2), cf(w3), cf(h1),
                   cf(h2), cf(h3), cf(g), mf(dx), nullptr, mf(dw1), mf(db1),
                   mf(dw2), mf(db2), mf(dw3), mf(db3), mf(dh2), mf(dh1),
                   mf(wt), mf(work), B, H, W, C, need_dx != 0,
                   static_cast<cudaStream_t>(stream));
}

// Dual-input block on [xa | xb] (Ca + Cb channels): as above, with dx written
// apart into dxa (B, H, W, Ca) and dxb (B, H, W, Cb).
extern "C" int pda_conv_block_bwd_dual(
    const void* xa, const void* xb, int Ca, int Cb, const void* w1,
    const void* w2, const void* w3, const void* h1, const void* h2,
    const void* h3, const void* g, void* dxa, void* dxb, void* dw1, void* db1,
    void* dw2, void* db2, void* dw3, void* db3, void* dh2, void* dh1, void* wt,
    void* work, int B, int H, int W, int C, void* stream) {
  return block_bwd(cf(xa), cf(xb), Ca, Cb, cf(w1), cf(w2), cf(w3), cf(h1),
                   cf(h2), cf(h3), cf(g), mf(dxa), mf(dxb), mf(dw1), mf(db1),
                   mf(dw2), mf(db2), mf(dw3), mf(db3), mf(dh2), mf(dh1),
                   mf(wt), mf(work), B, H, W, C, true,
                   static_cast<cudaStream_t>(stream));
}
