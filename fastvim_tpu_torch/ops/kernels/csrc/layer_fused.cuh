// Device code shared by the fp32 backward (layer_fused_bwd.cu) and
// recompute (layer_fused_recompute.cu) passes of the fused FastVim mixer
// layer: the line a pass A adjoint block owns, the x-half GEMM of a line
// plus its halo into a shared fp32 tile, and the 32-token-tile FMA GEMMs
// of pass B. (The fp32 forward, layer_fused_fwd_tf32.cu, has its own
// tensor-core tiles.)
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 3;     // d_conv - 1
constexpr int kThreads = 256;  // 8 warps, both passes
using fv::kMaxSmem;

// ---------------------------------------------------------------------
// pass A: one line (+ 3 halo tokens each side) × 64 channels per block
// ---------------------------------------------------------------------
constexpr int kACh = 64;             // channels per block
constexpr int kAKc = 32;             // K chunk of the FMA GEMM
constexpr int kARows = 9;            // FMA: tokens per thread per pass
constexpr int kAPass = 16 * kARows;  // FMA: tokens per GEMM pass

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

struct Line {  // the line a pass A block owns
  int H, W, P, ln, p;
  bool transposed;
  size_t img;  // first token of the image
  // extended index j in [0, ln + 6): 3 halo tokens of line p-1, the line,
  // 3 halo tokens of line p+1. Returns the token's index in the image,
  // or -1 outside the sequence.
  __device__ long token(int j) const {
    int line = p, pos = j - kPad;
    if (j < kPad) {
      line = p - 1;
      pos = ln - kPad + j;
    } else if (j >= ln + kPad) {
      line = p + 1;
      pos = j - ln - kPad;
    }
    if (line < 0 || line >= P) return -1;
    return transposed ? static_cast<long>(pos) * W + line
                      : static_cast<long>(line) * W + pos;
  }
};

// xin = x̂·W_xᵀ + b_x for the extended line (L.ln + 6 tokens, halo rows
// outside the sequence set to 0 and never loaded) and channels c0..c0+63,
// into s_xin [ntok][kACh] fp32. FMA path (fp32 inputs); s_x
// [kAKc][kAPass+1] and s_w [kAKc][kACh+1] are staging. Ends with a
// barrier: s_xin is complete.
template <typename T>
__device__ __forceinline__ void xin_tile_fma(
    const T* __restrict__ x, const T* __restrict__ w_x,
    const float* __restrict__ b_x, const Line& L, int c0, int dm,
    float* s_xin, float* s_x, float* s_w) {
  constexpr int kVe = fv::kVec<T>;   // elements per 16-byte vector
  constexpr int kVpr = kAKc / kVe;   // vectors per row of a K chunk
  constexpr int kXIters = (kAPass * kVpr + kThreads - 1) / kThreads;
  constexpr int kWIters = kACh * kVpr / kThreads;
  const int tid = threadIdx.x;
  const int ntok = L.ln + 2 * kPad;
  const int tx = tid % 16;  // channels tx + 16q, q < 4
  const int ty = tid / 16;  // tokens ty + 16r, r < kARows
  for (int jp = 0; jp < ntok; jp += kAPass) {
    const int npt = min(kAPass, ntok - jp);
    const int rmax = (npt + 15) / 16;
    float acc[kARows][4];
#pragma unroll
    for (int r = 0; r < kARows; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    for (int k0 = 0; k0 < dm; k0 += kAKc) {
      // issue every 16-byte load of the chunk before storing any, so
      // their latencies overlap
      uint4 xv[kXIters], wv16[kWIters];
#pragma unroll
      for (int it = 0; it < kXIters; ++it) {
        const int i = tid + it * kThreads;
        const long t = i < npt * kVpr ? L.token(jp + i / kVpr) : -1;
        if (t >= 0)  // masked before the load
          xv[it] = fv::load16(x + (L.img + t) * dm + k0 + (i % kVpr) * kVe);
      }
#pragma unroll
      for (int it = 0; it < kWIters; ++it) {
        const int i = tid + it * kThreads;
        wv16[it] = fv::load16(w_x + static_cast<size_t>(c0 + i / kVpr) * dm +
                              k0 + (i % kVpr) * kVe);
      }
      __syncthreads();  // the previous chunk's readers are done
#pragma unroll
      for (int it = 0; it < kXIters; ++it) {
        const int i = tid + it * kThreads;
        if (i < npt * kVpr) {
          const int jj = i / kVpr, kv = i % kVpr;
          float f[kVe];
          if (L.token(jp + jj) >= 0) {
            fv::widen16<T>(xv[it], f);
          } else {
#pragma unroll
            for (int e = 0; e < kVe; ++e) f[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < kVe; ++e)
            s_x[(kv * kVe + e) * (kAPass + 1) + jj] = f[e];
        }
      }
#pragma unroll
      for (int it = 0; it < kWIters; ++it) {
        const int i = tid + it * kThreads;
        const int c = i / kVpr, kv = i % kVpr;
        float f[kVe];
        fv::widen16<T>(wv16[it], f);
#pragma unroll
        for (int e = 0; e < kVe; ++e)
          s_w[(kv * kVe + e) * (kACh + 1) + c] = f[e];
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kAKc; ++k) {
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = s_w[k * (kACh + 1) + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < kARows; ++r) {
          if (r < rmax) {
            const float xv = s_x[k * (kAPass + 1) + ty + 16 * r];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += xv * wv[q];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kARows; ++r) {
      const int jj = ty + 16 * r;
      if (r < rmax && jj < npt) {
        const bool valid = L.token(jp + jj) >= 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = tx + 16 * q;
          const float bias = b_x ? b_x[c0 + c] : 0.f;
          s_xin[(jp + jj) * kACh + c] = valid ? acc[r][q] + bias : 0.f;
        }
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------
// pass B: 32-token tiles with all d_inner channels
// ---------------------------------------------------------------------
constexpr int kBTok = 32;            // tokens per block (4 per warp)
constexpr int kBKc = 16;             // K chunk of the FMA GEMMs
constexpr int kBCols = 12;           // FMA: output channels per thread
constexpr int kBSlab = 32 * kBCols;  // output columns per slab: 384

// FMA: acc[r][j] = Σ_k sA[(kR·warp + r)·lda + k] · Wt[(n0 + lane + 32j)·ldw
// + k] for k < K, j < ncols: an (8·kR × K) fp32 tile in shared memory
// times the transpose of rows n0.. of a row-major (N × ldw) weight in T;
// lda and ldw are K unless given. With `accumulate` the products are added
// to acc instead.
template <typename T, int kR = 4>
__device__ __forceinline__ void gemm_rows(const float* sA,
                                          const T* __restrict__ Wt, int K,
                                          int n0, int ncols, float* s_w,
                                          float (*acc)[kBCols], int lda = 0,
                                          int ldw = 0,
                                          bool accumulate = false) {
  constexpr int kVe = fv::kVec<T>;  // elements per 16-byte vector
  constexpr int kVpr = kBKc / kVe;  // vectors per row of a K chunk
  constexpr int kIters = kBSlab * kVpr / kThreads;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nn = 32 * ncols;
  if (!lda) lda = K;
  if (!ldw) ldw = K;
  if (!accumulate) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kBCols; ++j) acc[r][j] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += kBKc) {
    // issue every 16-byte load of the chunk before storing any, so their
    // latencies overlap (and overlap the other block's compute)
    uint4 v[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (i / kVpr < nn)
        v[it] = fv::load16(Wt + static_cast<size_t>(n0 + i / kVpr) * ldw +
                           k0 + (i % kVpr) * kVe);
    }
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int n = i / kVpr, kv = i % kVpr;
      if (n < nn) {
        float f[kVe];
        fv::widen16<T>(v[it], f);
#pragma unroll
        for (int e = 0; e < kVe; ++e)
          s_w[(kv * kVe + e) * (kBSlab + 1) + n] = f[e];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBKc; ++k) {
      float wv[kBCols];
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        wv[j] = j < ncols ? s_w[k * (kBSlab + 1) + lane + 32 * j] : 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float a = sA[(kR * warp + r) * lda + k0 + k];
#pragma unroll
        for (int j = 0; j < kBCols; ++j) acc[r][j] += a * wv[j];
      }
    }
  }
}

}  // namespace
