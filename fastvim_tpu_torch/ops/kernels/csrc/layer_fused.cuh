// Device code of the fp32 recompute pass (layer_fused_recompute.cu) of
// the fused FastVim mixer layer: the 32-token-tile FMA GEMMs of pass B.
// (The fp32 forward and backward, layer_fused_fwd_tf32.cu and
// layer_fused_bwd_tf32.cu, have their own tensor-core tiles.)
#pragma once

#include "common.cuh"

namespace {

constexpr int kPad = 3;     // d_conv - 1
constexpr int kThreads = 256;  // 8 warps
using fv::kMaxSmem;

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
