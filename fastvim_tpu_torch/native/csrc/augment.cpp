// Native (C++) host-side image pipeline feeding the GPU.
//
// The host pipeline's hot inner loops — bilinear random-resized-crop,
// flip, normalize, and multi-channel cell augmentation — run in C++ with a
// std::thread pool over the batch, filling NHWC float32 buffers that go
// straight to the device. Exposed through a plain C ABI consumed via ctypes
// (no pybind11 dependency). This file is the augment library and needs no
// libjpeg; JPEG decode fused with this pipeline is decode.cpp, a library of
// its own; the shared helpers are in common.h. The arithmetic and the RNG
// are those of fastvim_tpu/native/csrc, so both packages draw the same
// augmentations from the same seed.
//
// Build: g++ at first use, by fastvim_tpu_torch/native/_build.py.

#include <cstdint>

#include "common.h"

using fastvim::Rng;
using fastvim::parallel_for;
using fastvim::process_one;

extern "C" {

// Batch augment: src (B, H, W, C) uint8 → dst (B, size, size, C) float32.
// training: RandomResizedCrop(scale_lo..scale_hi)+flip; else center crop.
void fastvim_augment_batch(const uint8_t* src, int B, int H, int W, int C,
                           float* dst, int size, uint64_t seed, int training,
                           const float* mean, const float* std_,
                           float scale_lo, float scale_hi,
                           int num_threads) {
  const size_t in_stride = static_cast<size_t>(H) * W * C;
  const size_t out_stride = static_cast<size_t>(size) * size * C;
  parallel_for(B, num_threads, [&](int i) {
    process_one(src + i * in_stride, H, W, C, dst + i * out_stride, size,
                seed * 1000003ULL + i, training, mean, std_, scale_lo,
                scale_hi);
  });
}

// Multi-channel float augment (cells): flip/pad-crop/normalize in-place
// pipeline: src (B, H, W, C) float32 → dst same shape.
void fastvim_cell_augment_batch(const float* src, int B, int H, int W, int C,
                                float* dst, uint64_t seed, int training,
                                const float* mean, const float* std_,
                                int num_threads) {
  const size_t stride = static_cast<size_t>(H) * W * C;
  parallel_for(B, num_threads, [&](int i) {
    Rng rng(seed * 1000003ULL + i);
    const float* s = src + i * stride;
    float* d = dst + i * stride;
    bool fh = training && rng.uniform() < 0.5;
    bool fv = training && rng.uniform() < 0.5;
    int pad = training ? H / 16 : 0;
    int oy = pad ? rng.randint(-pad, pad + 1) : 0;
    int ox = pad ? rng.randint(-pad, pad + 1) : 0;
    for (int y = 0; y < H; ++y) {
      int sy = y + oy;
      sy = sy < 0 ? -sy : (sy >= H ? 2 * H - sy - 2 : sy);  // reflect
      int ry = fv ? H - 1 - sy : sy;
      for (int x = 0; x < W; ++x) {
        int sx = x + ox;
        sx = sx < 0 ? -sx : (sx >= W ? 2 * W - sx - 2 : sx);
        int rx = fh ? W - 1 - sx : sx;
        for (int c = 0; c < C; ++c) {
          float v = s[(ry * W + rx) * C + c];
          d[(y * W + x) * C + c] =
              mean ? (v - mean[c]) / std_[c] : v;
        }
      }
    }
  });
}

int fastvim_native_version() { return 2; }

}  // extern "C"
