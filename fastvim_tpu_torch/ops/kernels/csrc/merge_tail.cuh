// Device code shared by the merge kernels of the unfused mixer path, K9
// (fused_block.cu) and K10 (merge_gate.cu): channel pairs, warp sums, and
// the LayerNorm + gate that finishes one token.
//
// These kernels give one warp a whole token: a lane owns the channel pairs
// c = 2·(lane + 32j), c + 1 and walks them in a loop, so nothing is sized
// by d_inner (2560 for FastVim-H) but a d-float row of shared memory per
// warp, where the merged values wait between the statistics and the gate.
#pragma once

#include "common.cuh"

namespace fv {

constexpr int kMergeTok = 32;     // tokens per block: 4 per warp
constexpr int kMergeThreads = 256;

// 2 consecutive elements, widened to fp32, through the read-only path
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp finishes one token. s_m[0:d] holds the merged values m (each
// lane wrote, and reads back, only its own channel pairs) and `sum` this
// lane's share of Σ m. LayerNorm over the d channels with fp32 statistics,
// the variance as the mean of (m − μ)² (ln_w / ln_b null: 1 / 0), or m as
// it is without use_ln; × silu(z); one store of the row in T.
template <typename T>
__device__ __forceinline__ void ln_gate_store(
    const float* s_m, float sum, const T* __restrict__ z, T* __restrict__ out,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, int d,
    bool use_ln, float eps) {
  const int lane = threadIdx.x % 32;
  float mu = 0.f, rstd = 1.f;
  if (use_ln) {
    mu = warp_sum(sum) / static_cast<float>(d);
    float ss = 0.f;
    for (int c = 2 * lane; c < d; c += 64) {
      const float d0 = s_m[c] - mu, d1 = s_m[c + 1] - mu;
      ss += d0 * d0 + d1 * d1;
    }
    rstd = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  }
  for (int c = 2 * lane; c < d; c += 64) {
    float v0 = s_m[c], v1 = s_m[c + 1];
    if (use_ln) {
      v0 = (v0 - mu) * rstd;
      v1 = (v1 - mu) * rstd;
      if (ln_w) {
        v0 *= ln_w[c];
        v1 *= ln_w[c + 1];
      }
      if (ln_b) {
        v0 += ln_b[c];
        v1 += ln_b[c + 1];
      }
    }
    const float2 zz = load2(z + c);
    store2(out + c, v0 * silu(zz.x), v1 * silu(zz.y));
  }
}

}  // namespace fv
