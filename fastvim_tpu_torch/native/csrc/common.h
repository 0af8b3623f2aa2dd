// Shared helpers for the native host pipeline (augment.cpp, decode.cpp).
#pragma once

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

namespace fastvim {

struct Rect {
  int x, y, w, h;
};

// xorshift-based per-sample RNG: deterministic given (seed, index)
static inline uint64_t mix(uint64_t z) {
  z += 0x9e3779b97f4a7c15ULL;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(mix(seed)) {}
  uint64_t next() { return s = mix(s); }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  int randint(int lo, int hi) {  // inclusive lo, exclusive hi
    return lo + static_cast<int>(uniform() * (hi - lo));
  }
};

// Bilinear sample from HWC uint8 at fractional (fy, fx).
static inline float sample_bilinear(const uint8_t* img, int H, int W, int C,
                                    float fy, float fx, int c) {
  int y0 = static_cast<int>(fy);
  int x0 = static_cast<int>(fx);
  int y1 = std::min(y0 + 1, H - 1);
  int x1 = std::min(x0 + 1, W - 1);
  float wy = fy - y0, wx = fx - x0;
  float v00 = img[(y0 * W + x0) * C + c];
  float v01 = img[(y0 * W + x1) * C + c];
  float v10 = img[(y1 * W + x0) * C + c];
  float v11 = img[(y1 * W + x1) * C + c];
  return v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
         v10 * wy * (1 - wx) + v11 * wy * wx;
}

inline Rect random_resized_crop_rect(Rng& rng, int H, int W, double lo,
                                     double hi) {
  double area = static_cast<double>(H) * W;
  for (int attempt = 0; attempt < 10; ++attempt) {
    double target = (lo + rng.uniform() * (hi - lo)) * area;
    double log_r = std::log(3.0 / 4.0) +
                   rng.uniform() * (std::log(4.0 / 3.0) - std::log(3.0 / 4.0));
    double ar = std::exp(log_r);
    int w = static_cast<int>(std::lround(std::sqrt(target * ar)));
    int h = static_cast<int>(std::lround(std::sqrt(target / ar)));
    if (w <= W && h <= H && w > 0 && h > 0) {
      int x = rng.randint(0, W - w + 1);
      int y = rng.randint(0, H - h + 1);
      return {x, y, w, h};
    }
  }
  int s = std::min(H, W);
  return {(W - s) / 2, (H - s) / 2, s, s};
}

// Pick the crop window: RRC at train / 0.875 center-crop at eval, plus
// the horizontal-flip coin. Shared between the raw-array augment path and
// the crop-aware JPEG decode (which needs the rect BEFORE decoding).
inline Rect choose_crop(Rng& rng, int H, int W, int training,
                        float scale_lo, float scale_hi, bool* flip) {
  if (training) {
    Rect r = random_resized_crop_rect(rng, H, W, scale_lo, scale_hi);
    *flip = rng.uniform() < 0.5;
    return r;
  }
  *flip = false;
  int s = std::min(H, W);
  int crop = static_cast<int>(s * 0.875);
  return {(W - crop) / 2, (H - crop) / 2, crop, crop};
}

// Bilinear resize of crop rect `r` of an HWC uint8 image to (size,size),
// + optional hflip + /255 + normalize, into float32 dst. Separable-ish:
// the x-axis sample positions/weights are precomputed once, each output
// row touches exactly two source rows sequentially.
inline void resize_crop_normalize(const uint8_t* src, int H, int W, int C,
                                  const Rect& r, bool flip, float* dst,
                                  int size, const float* mean,
                                  const float* std_) {
  std::vector<int> xi0(size), xi1(size);
  std::vector<float> wxv(size);
  float sx = static_cast<float>(r.w) / size;
  float sy = static_cast<float>(r.h) / size;
  for (int x = 0; x < size; ++x) {
    int xo = flip ? (size - 1 - x) : x;
    float fx = r.x + (xo + 0.5f) * sx - 0.5f;
    fx = std::max(0.0f, std::min(fx, static_cast<float>(W - 1)));
    int x0 = static_cast<int>(fx);
    xi0[x] = x0 * C;
    xi1[x] = std::min(x0 + 1, W - 1) * C;
    wxv[x] = fx - x0;
  }
  float inv255 = 1.0f / 255.0f;
  std::vector<float> nm(C), ns(C);
  for (int c = 0; c < C; ++c) {
    ns[c] = inv255 / std_[c];
    nm[c] = mean[c] / std_[c];
  }
  for (int y = 0; y < size; ++y) {
    float fy = r.y + (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(H - 1)));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, H - 1);
    float wy = fy - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * W * C;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * W * C;
    float* drow = dst + static_cast<size_t>(y) * size * C;
    for (int x = 0; x < size; ++x) {
      const float wx = wxv[x];
      const int a = xi0[x], b = xi1[x];
      for (int c = 0; c < C; ++c) {
        float top = r0[a + c] + (r0[b + c] - r0[a + c]) * wx;
        float bot = r1[a + c] + (r1[b + c] - r1[a + c]) * wx;
        float v = top + (bot - top) * wy;
        drow[x * C + c] = v * ns[c] - nm[c];
      }
    }
  }
}

// Crop (RRC at train / center-crop at eval) + flip + bilinear resize to
// (size,size) + normalize, from an HWC uint8 image into float32 dst.
inline void process_one(const uint8_t* src, int H, int W, int C, float* dst,
                        int size, uint64_t seed, int training,
                        const float* mean, const float* std_,
                        float scale_lo, float scale_hi) {
  Rng rng(seed);
  bool flip = false;
  Rect r = choose_crop(rng, H, W, training, scale_lo, scale_hi, &flip);
  resize_crop_normalize(src, H, W, C, r, flip, dst, size, mean, std_);
}

inline void parallel_for(int n, int num_threads,
                         const std::function<void(int)>& fn) {
  if (num_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  int workers = std::min(n, num_threads);
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&]() {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace fastvim
