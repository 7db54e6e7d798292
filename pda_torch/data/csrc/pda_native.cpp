// pda_native: native host-side data-path kernels for the patch pipeline.
//
// The TPU compute path is JAX/XLA/Pallas; this library is the native runtime
// around it: the per-sample host work (random crop, standardize, gaussian
// blur, additive noise, contrast) that feeds the device. Called from Python
// via ctypes (pda/data/native.py); every entry point releases the GIL by
// construction (plain C ABI), so the thread-pool loader scales across cores.
//
// Replaces the role of the reference's torch/numpy per-sample transforms
// (torch_em transform.raw, SURVEY.md section 2.9) on the host side.
//
// Build: g++ -O3 -march=native -ffast-math -shared -fPIC pda_native.cpp -o libpda_native.so
// (-ffast-math enables libmvec-vectorized logf/sincosf in the noise path)

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// RNG: splitmix64 + Box-Muller normals (deterministic per seed)
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t &state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static inline double uniform01(uint64_t &state) {
  return (splitmix64(state) >> 11) * (1.0 / 9007199254740992.0);
}

// pure (counter-based) variant: independent per index, so bulk-generation
// loops have no serial state dependence and vectorize
static inline uint64_t splitmix64_at(uint64_t x) {
  uint64_t z = x + 0x9E3779B97F4A7C15ULL;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// ---------------------------------------------------------------------------
// standardize: x = (x - mean) / (std + eps), in place
// ---------------------------------------------------------------------------

void pda_standardize(float *data, int64_t n, float eps) {
  // 8 partial accumulators: breaks the serial FP dependence so the
  // reductions vectorize (a single double acc ran at ~190 MB/s)
  double s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int64_t i = 0;
  for (; i + 8 <= n; i += 8)
    for (int k = 0; k < 8; ++k) s[k] += data[i + k];
  for (; i < n; ++i) s[0] += data[i];
  const double mean =
      (s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7]) / (double)n;
  double v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (i = 0; i + 8 <= n; i += 8)
    for (int k = 0; k < 8; ++k) {
      const double d = data[i + k] - mean;
      v[k] += d * d;
    }
  for (; i < n; ++i) {
    const double d = data[i] - mean;
    v[0] += d * d;
  }
  const double var =
      (v[0] + v[1] + v[2] + v[3] + v[4] + v[5] + v[6] + v[7]) / (double)n;
  const float inv = 1.0f / (float)(std::sqrt(var) + eps);
  const float m = (float)mean;
  for (i = 0; i < n; ++i) data[i] = (data[i] - m) * inv;
}

// ---------------------------------------------------------------------------
// crop: copy a (h, w) window at (y0, x0) out of an (H, W) image
// ---------------------------------------------------------------------------

void pda_crop(const float *src, int64_t H, int64_t W, int64_t y0, int64_t x0,
              int64_t h, int64_t w, float *dst) {
  (void)H;
  for (int64_t r = 0; r < h; ++r)
    std::memcpy(dst + r * w, src + (y0 + r) * W + x0, (size_t)w * sizeof(float));
}

// ---------------------------------------------------------------------------
// separable gaussian blur (reflect border), matches cv2.GaussianBlur(ksize=0)
// on float images: automatic ksize = round(8*sigma + 1) | 1, i.e. kernel
// radius ~4*sigma — the same truncation the numpy fallback path
// (pda.data.transforms.GaussianBlur -> cv2) uses, so toggling
// PDA_NATIVE_AUGS does not change the augmentation distribution. Border
// taps reflect (BORDER_REFLECT_101) REPEATEDLY like cv2, so kernels wider
// than a thin image still match cv2 exactly.
// ---------------------------------------------------------------------------


static inline int64_t reflect101(int64_t i, int64_t n) {
  // cv2 BORDER_REFLECT_101, iterated for kernels wider than the axis
  if (n == 1) return 0;
  const int64_t period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

static void blur_axis(const float *src, float *dst, int64_t h, int64_t w,
                      const float *k, int radius, int axis) {
  // Separable pass restructured for SIMD: per output row, accumulate
  // kv * shifted-row (contiguous SAXPY-style loops, float accumulation in
  // dst) instead of a per-pixel tap loop with boundary branches.
  if (axis == 0) {
    for (int64_t y = 0; y < h; ++y) {
      float *out = dst + y * w;
      for (int64_t x = 0; x < w; ++x) out[x] = 0.0f;
      for (int t = -radius; t <= radius; ++t) {
        const int64_t yy = reflect101(y + t, h);
        const float kv = k[t + radius];
        const float *row = src + yy * w;
        for (int64_t x = 0; x < w; ++x) out[x] += kv * row[x];
      }
    }
    return;
  }
  const int64_t lo = radius < w ? radius : w;
  const int64_t hi = w - radius > lo ? w - radius : lo;
  for (int64_t y = 0; y < h; ++y) {
    const float *row = src + y * w;
    float *out = dst + y * w;
    // interior: branch-free shifted adds
    for (int64_t x = lo; x < hi; ++x) out[x] = 0.0f;
    for (int t = -radius; t <= radius; ++t) {
      const float kv = k[t + radius];
      const float *shifted = row + t;
      for (int64_t x = lo; x < hi; ++x) out[x] += kv * shifted[x];
    }
    // edges: reflected taps
    for (int64_t x = 0; x < w; ++x) {
      if (x == lo && hi > lo) {
        x = hi - 1;
        continue;
      }
      float acc = 0.0f;
      for (int t = -radius; t <= radius; ++t) {
        acc += k[t + radius] * row[reflect101(x + t, w)];
      }
      out[x] = acc;
    }
  }
}

static int make_gauss_kernel(float sigma, int max_radius, float *kern) {
  // cv2 automatic size for float depth: ksize = round(8*sigma + 1) | 1
  int ksize = (int)std::lround(8.0 * (double)sigma + 1.0);
  if ((ksize & 1) == 0) ksize += 1;
  int radius = ksize / 2;
  if (radius > 64) radius = 64;
  if (radius > max_radius) radius = max_radius;
  if (radius < 1) return 0;
  double ksum = 0.0;
  for (int t = -radius; t <= radius; ++t) {
    const double v = std::exp(-0.5 * (double)t * t / ((double)sigma * sigma));
    kern[t + radius] = (float)v;
    ksum += v;
  }
  for (int t = 0; t <= 2 * radius; ++t) kern[t] = (float)(kern[t] / ksum);
  return radius;
}

void pda_gaussian_blur(const float *src, float *dst, int64_t h, int64_t w,
                       float sigma, float *scratch) {
  if (sigma <= 0.0f) {
    std::memcpy(dst, src, (size_t)(h * w) * sizeof(float));
    return;
  }
  // reflect101 iterates, so the radius needs no clamping to the axis
  // extent (clamping would truncate the long-axis kernel on thin images,
  // breaking cv2 parity) — only degenerate 1-pixel axes skip their pass
  float ky[129], kx[129];
  const int ry = h > 1 ? make_gauss_kernel(sigma, 64, ky) : 0;
  const int rx = w > 1 ? make_gauss_kernel(sigma, 64, kx) : 0;
  if (ry < 1 && rx < 1) {
    std::memcpy(dst, src, (size_t)(h * w) * sizeof(float));
    return;
  }
  const float *cur = src;
  if (ry >= 1) {
    blur_axis(cur, scratch, h, w, ky, ry, 0);
    cur = scratch;
  }
  if (rx >= 1) {
    blur_axis(cur, dst, h, w, kx, rx, 1);
  } else {
    std::memcpy(dst, cur, (size_t)(h * w) * sizeof(float));
  }
}

// ---------------------------------------------------------------------------
// additive gaussian noise (Box-Muller), optional clip to [0, 1]
// ---------------------------------------------------------------------------

void pda_add_gaussian_noise(float *data, int64_t n, float std_, uint64_t seed,
                            int clip) {
  // Box-Muller restructured for SIMD: counter-based uniforms (no serial RNG
  // state) into chunk buffers, then a transform loop whose logf/sqrtf/
  // sincosf vectorize through libmvec (-ffast-math build). The old
  // state-threaded scalar loop ran at ~11.8 ms per 512^2 draw; this is ~20x.
  const uint64_t base = (seed ? seed : 1) * 0x9E3779B97F4A7C15ULL;
  enum { CH = 1024 };  // pairs per chunk
  float u1[CH], u2[CH], rr[CH];
  for (int64_t off = 0; off < n; off += 2 * CH) {
    const int64_t rem = (n - off + 1) / 2;
    const int64_t pairs = rem < CH ? rem : CH;
    const uint64_t p0 = base + (uint64_t)(off / 2);
    for (int64_t j = 0; j < pairs; ++j) {
      const uint64_t z = splitmix64_at(p0 + (uint64_t)j);
      // two 24-bit uniforms per draw; u1 in (0, 1] (never 0 for the log)
      u1[j] = (float)((z >> 40) + 1) * (1.0f / 16777216.0f);
      u2[j] = (float)(z & 0xFFFFFFULL) * (1.0f / 16777216.0f);
    }
    float cc[CH], ss[CH];
    for (int64_t j = 0; j < pairs; ++j)
      rr[j] = std::sqrt(-2.0f * std::log(u1[j])) * std_;
    for (int64_t j = 0; j < pairs; ++j)
      cc[j] = rr[j] * std::cos(6.2831853071795864f * u2[j]);
    for (int64_t j = 0; j < pairs; ++j)
      ss[j] = rr[j] * std::sin(6.2831853071795864f * u2[j]);
    float *d = data + off;
    const int64_t full = (off + 2 * pairs <= n) ? pairs : pairs - 1;
    for (int64_t j = 0; j < full; ++j) {
      d[2 * j] += cc[j];
      d[2 * j + 1] += ss[j];
    }
    if (full != pairs)  // odd tail element
      d[2 * full] += cc[full];
  }
  if (clip) {
    for (int64_t i = 0; i < n; ++i) {
      if (data[i] < 0.0f) data[i] = 0.0f;
      if (data[i] > 1.0f) data[i] = 1.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// contrast: x = mean + alpha * (x - mean)
// ---------------------------------------------------------------------------

void pda_random_contrast(float *data, int64_t n, float alpha) {
  double sum = 0.0;
  for (int64_t i = 0; i < n; ++i) sum += data[i];
  const float mean = (float)(sum / (double)n);
  for (int64_t i = 0; i < n; ++i) data[i] = mean + alpha * (data[i] - mean);
}

// ---------------------------------------------------------------------------
// fused weak augmentation: standardize -> p-gated blur -> p-gated noise.
// One call per sample replaces three Python-level transform dispatches
// (reference weak-aug recipe, LIVECell/livecell_mt.py:16-26).
// probabilities / parameter draws use the given seed, mirroring
// RandomApply(p) + uniform sigma/std draws.
// ---------------------------------------------------------------------------

void pda_weak_augment(float *data, int64_t h, int64_t w, float p,
                      float blur_sigma_lo, float blur_sigma_hi,
                      float noise_lo, float noise_hi, uint64_t seed,
                      float *scratch) {
  pda_standardize(data, h * w, 1e-7f);
  uint64_t st = seed ? seed : 1;
  if (uniform01(st) < (double)p) {
    const float sigma =
        blur_sigma_lo + (float)uniform01(st) * (blur_sigma_hi - blur_sigma_lo);
    pda_gaussian_blur(data, scratch, h, w, sigma, scratch + h * w);
    std::memcpy(data, scratch, (size_t)(h * w) * sizeof(float));
  }
  if (uniform01(st) < (double)p) {
    const float std_ =
        noise_lo + (float)uniform01(st) * (noise_hi - noise_lo);
    pda_add_gaussian_noise(data, h * w, std_, splitmix64(st), 0);
  }
}

// ---------------------------------------------------------------------------
// elastic warp: out(y, x) = in(y + dy(y,x), x + dx(y,x)) with reflect
// boundary handling; order = 1 (bilinear, raw channels) or 0 (nearest,
// label/mask channels). Replaces scipy.ndimage.map_coordinates on the loader
// hot path (measured ~110 ms per 512^2 warp in scipy; the generic N-d
// machinery dominates).
// ---------------------------------------------------------------------------

static inline float reflect_coord(float t, float n) {
  // scipy 'reflect' (a b c -> b a | a b c | c b): period 2n, mirror at -0.5
  if (n <= 1.0f) return 0.0f;
  const float period = 2.0f * n;
  t = std::fmod(t + 0.5f, period);
  if (t < 0) t += period;
  t = (t < n) ? t : period - t;
  t -= 0.5f;
  if (t < 0.0f) t = 0.0f;
  if (t > n - 1.0f) t = n - 1.0f;
  return t;
}

void pda_elastic_warp(const float *src, float *dst, int64_t h, int64_t w,
                      const float *dy, const float *dx, int order) {
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const int64_t i = y * w + x;
      float sy = (float)y + dy[i];
      float sx = (float)x + dx[i];
      // fast path: interior pixels skip the fmod-based reflection
      if (sy < 0.0f || sy > (float)(h - 1)) sy = reflect_coord(sy, (float)h);
      if (sx < 0.0f || sx > (float)(w - 1)) sx = reflect_coord(sx, (float)w);
      if (order == 0) {
        const int64_t yy = (int64_t)(sy + 0.5f);
        const int64_t xx = (int64_t)(sx + 0.5f);
        dst[i] = src[yy * w + xx];
      } else {
        const int64_t y0 = (int64_t)sy;
        const int64_t x0 = (int64_t)sx;
        const int64_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
        const int64_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
        const float fy = sy - (float)y0;
        const float fx = sx - (float)x0;
        const float v00 = src[y0 * w + x0], v01 = src[y0 * w + x1];
        const float v10 = src[y1 * w + x0], v11 = src[y1 * w + x1];
        dst[i] = v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
                 v10 * fy * (1 - fx) + v11 * fy * fx;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// displacement-field upsample: coarse (gh, gw) noise -> bilinear (h, w) field
// with grid step `step` (JointAugmentations._field, previously numpy
// fancy-indexing at ~9 ms per 512^2 field)
// ---------------------------------------------------------------------------

void pda_field_upsample(const float *coarse, int64_t gh, int64_t gw,
                        int64_t h, int64_t w, float *out) {
  // sample positions: ys = linspace(0, gh - 1.001, h), same for x
  const float sy = (float)((double)(gh - 1.001) / (double)(h > 1 ? h - 1 : 1));
  const float sx = (float)((double)(gw - 1.001) / (double)(w > 1 ? w - 1 : 1));
  for (int64_t y = 0; y < h; ++y) {
    const float fy_full = (float)y * sy;
    const int64_t y0 = (int64_t)fy_full;
    const float fy = fy_full - (float)y0;
    const float *r0 = coarse + y0 * gw;
    const float *r1 = coarse + (y0 + 1 < gh ? y0 + 1 : gh - 1) * gw;
    for (int64_t x = 0; x < w; ++x) {
      const float fx_full = (float)x * sx;
      const int64_t x0 = (int64_t)fx_full;
      const float fx = fx_full - (float)x0;
      const int64_t x1 = x0 + 1 < gw ? x0 + 1 : gw - 1;
      out[y * w + x] = r0[x0] * (1 - fy) * (1 - fx) + r0[x1] * (1 - fy) * fx +
                       r1[x0] * fy * (1 - fx) + r1[x1] * fy * fx;
    }
  }
}

}  // extern "C"
