// What the chunk-parallel scans share: K1's chunked forward
// (selective_scan_fwd_chunked.cu) and K2's chunked adjoint
// (selective_scan_bwd_chunked.cu). Both cut L into 64-step chunks, summarise
// each chunk on its own, pass a carry from chunk to chunk, and run the
// chunks again from their carries. The pass is the same linear recurrence
// in both: the forward state h, or the adjoint carry a·λ walked the other
// way, through a chunk decays by exp(A·S), S = Σ delta over the chunk.
#pragma once

#include "common.cuh"

namespace {

constexpr int kChunk = 64;         // steps per chunk (CHUNK in Python)
constexpr int kPassThreads = 64;   // (channel, state) pairs per block, pass
constexpr int kPassGroup = 32;     // chunks whose loads the pass starts together
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the MUFU unit, a result below 2^-126 flushed to 0: one
// instruction where exp2f adds the scaling for subnormal results, which
// a decaying state never needs
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The pass between the chunks. Grid (d · n / 64 rounded up, batch); thread
// = one (channel, state) pair, walking the chunks in scan order (chunk
// nchunks - 1 first for reverse). `states` holds each chunk's own summary
// on entry and its carry-in on return: h = exp(A·S[c])·h + summary[c],
// with h before the update stored in place. The next group's loads start
// before this group's chain and stores (other chunks, so the order is
// free), and the exponentials wait for nothing but them. `last`, where not
// null ((batch, d, n): K1's final state; K2 passes null), receives h
// carried past the last chunk.
__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(const float* __restrict__ A, float* __restrict__ states,
                  const float* __restrict__ dsum, float* __restrict__ last,
                  int nchunks, int d, int n, bool reverse) {
  const int i = blockIdx.x * kPassThreads + threadIdx.x;  // c · n + s
  if (i >= d * n) return;
  const size_t b = blockIdx.y;
  const size_t dn = static_cast<size_t>(d) * n;
  float* st = states + b * nchunks * dn + i;
  const float* sm = dsum + b * nchunks * d + i / n;
  const float a2 = A[i] * kLog2e;
  const auto chunk = [&](int k) -> size_t {  // k-th in scan order, clamped
    k = min(k, nchunks - 1);
    return reverse ? nchunks - 1 - k : k;
  };
  // the summary and the sum of delta of a group of chunks, a group ahead
  float hl[kPassGroup], S[kPassGroup];
  float hl_next[kPassGroup], S_next[kPassGroup];
  const auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kPassGroup; ++j) {
      const size_t cc = chunk(k0 + j);
      hl_next[j] = st[cc * dn];
      S_next[j] = sm[cc * d];
    }
  };
  fetch(0);
  float h = 0.f;
  for (int k0 = 0; k0 < nchunks; k0 += kPassGroup) {
#pragma unroll
    for (int j = 0; j < kPassGroup; ++j) {
      hl[j] = hl_next[j];
      S[j] = S_next[j];
    }
    fetch(k0 + kPassGroup);
#pragma unroll
    for (int j = 0; j < kPassGroup; ++j) {
      if (k0 + j < nchunks) {
        st[chunk(k0 + j) * dn] = h;  // the carry on entry to the chunk
        h = fmaf(ex2(a2 * S[j]), h, hl[j]);
      }
    }
  }
  if (last) last[b * dn + i] = h;
}

// Launch the pass on `stream` for (batch, nchunks, d, n) states; `last`
// (batch, d, n) or null.
inline cudaError_t state_pass(const void* A, void* states, const void* dsum,
                              int batch, int nchunks, int d, int n,
                              bool reverse, cudaStream_t stream,
                              void* last = nullptr) {
  const dim3 grid((d * n + kPassThreads - 1) / kPassThreads, batch);
  state_pass_kernel<<<grid, kPassThreads, 0, stream>>>(
      static_cast<const float*>(A), static_cast<float*>(states),
      static_cast<const float*>(dsum), static_cast<float*>(last), nchunks,
      d, n, reverse);
  return cudaGetLastError();
}

}  // namespace
