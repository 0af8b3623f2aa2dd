// K1: chunked selective-scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_kernel` (fastvim_tpu/ops/pallas/
// selective_scan.py, launched by `_pallas_fwd`): per (batch, channel d),
//   delta = softplus(delta + bias);  a = exp(delta * A[d, :]);
//   h = a * h + delta * u * B[t, :];  y[t] = <h, C[t, :]> (+ D * u)
// run left to right, or right to left for reverse=1 (the suffix scan of
// the pooled backward direction; the output stays in original order).
// With a `states` buffer it also writes h on entry to each chunk, as
// `_pallas_fwd(save_states=True)` does, for the backward (K2). For the
// language model's prefill (fastvim_tpu/ops/scan.py `selective_scan` with
// `z` and `return_last_state`, which the JAX package runs through XLA)
// it also gates y by silu(z) in fp32 before the one rounding, as
// `_finalize` does, and writes the state after the last step in scan
// order into `last`: the register h when the loop ends.
//
// What bounds it on the H100: the recurrence is sequential in t, so one
// (batch, channel) costs L dependent steps whatever the bandwidth. At the
// main-path shapes (L = 128 pooled rows, or 16,384 tokens for Vim-T, d =
// 384, n = 16) the bytes are small (u, delta, out: 3 * B * L * d values)
// and the time is the latency of the L-step chain times the number of
// chains one SM has to run.
//
// Design: one thread per (batch, channel, state): 16 lanes per channel
// (n is 8 or 16; lanes with s >= n hold a zero state), 4 channels per
// block, so blocks = d / 4 * batch spread the chains over all SMs. The TPU
// grid carried the (n, d-block) state in scratch across a sequential L
// axis; here each block loops over its own chunks of L and keeps h in a
// register, so nothing is carried between blocks. Each chunk of 64 steps
// of u, delta (softplus applied once per element), B and C is staged in
// shared memory; the next chunk's inputs are fetched into registers as
// vector loads while the current chunk is scanned, so global latency is
// off the chain (one dependent load per element measured ~2.2 ms at
// L = 16,384). The serial loop does only the recurrence and stores h·C
// per (step, channel, state) to shared memory; the contraction over the
// states runs after the loop, in parallel over the chunk's steps, so no
// reduction latency sits on the L-step chain either (a shuffle reduction
// inside the loop measured 4.2 ms). A tail chunk shorter than 64
// (L = 16,385 for the middle-cls-token Vim) only runs its valid steps.
// All math is fp32; y is written in u's dtype. Long scans (from
// CHUNKED_MIN_L steps, ops/kernels/selective_scan.py) take the
// chunk-parallel form in selective_scan_fwd_chunked.cu instead.

#include "common.cuh"

namespace {

constexpr int kLanes = 16;                    // threads per channel
constexpr int kChannels = 4;                  // channels per block
constexpr int kThreads = kLanes * kChannels;  // 64
constexpr int kChunk = 64;                    // steps staged per chunk

// kGate: z is given (a template argument, so that the vision callers'
// kernel, without it, carries no test of it)
template <typename T, bool kGate>
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ bias,
                const float* __restrict__ Dp, const T* __restrict__ z,
                T* __restrict__ out, float* __restrict__ states,
                float* __restrict__ last, int L, int d, int n, int ldz,
                bool softplus, bool reverse) {
  constexpr int kVe = fv::kVec<T>;  // elements per 16-byte vector
  // 16-byte vectors of B (and of C) per thread per chunk, at n = 16
  constexpr int kBCIters = kChunk * kLanes / (kVe * kThreads);
  static_assert(kThreads >= kChunk, "one thread fetches each step's u, dt");
  __shared__ float s_u[kChunk][kChannels];
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_B[kChunk][kLanes];
  __shared__ float s_C[kChunk][kLanes];
  // h·C per (step, channel, state); rows padded to 17 against bank
  // conflicts in the contraction
  __shared__ float s_p[kChunk][kChannels][kLanes + 1];

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;  // channel within the block
  const int s = tid % kLanes;   // state index
  const int d0 = blockIdx.x * kChannels;
  const size_t tok0 = static_cast<size_t>(blockIdx.y) * L;
  const float a_coef = s < n ? A[static_cast<size_t>(d0 + ch) * n + s] : 0.f;
  float4 bias4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias) bias4 = *reinterpret_cast<const float4*>(bias + d0);
  for (int i = tid; i < kChunk * kLanes; i += kThreads) {  // states >= n
    s_B[i / kLanes][i % kLanes] = 0.f;
    s_C[i / kLanes][i % kLanes] = 0.f;
  }
  float h = 0.f;

  const int nchunks = (L + kChunk - 1) / kChunk;
  auto chunk_start = [&](int ci) {
    return (reverse ? nchunks - 1 - ci : ci) * kChunk;
  };
  // one chunk's inputs in registers: this thread's step of u and delta
  // (4 channels), and its share of the contiguous B and C rows
  typename fv::Raw4<T>::type r_u, r_dt;
  uint4 r_B[kBCIters], r_C[kBCIters];
  auto fetch = [&](int ci) {
    const int t0 = chunk_start(ci);
    const int len = min(kChunk, L - t0);
    if (tid < len) {
      const size_t off = (tok0 + t0 + tid) * d + d0;
      r_u = fv::load4(u + off);
      r_dt = fv::load4(delta + off);
    }
    const int nvec = len * n / kVe;
#pragma unroll
    for (int it = 0; it < kBCIters; ++it) {
      const int i = tid + it * kThreads;
      if (i < nvec) {
        const size_t off = (tok0 + t0) * n + static_cast<size_t>(i) * kVe;
        r_B[it] = fv::load16(Bm + off);
        r_C[it] = fv::load16(Cm + off);
      }
    }
  };

  fetch(0);
  for (int ci = 0; ci < nchunks; ++ci) {
    const int len = min(kChunk, L - chunk_start(ci));
    __syncthreads();  // the previous chunk's readers are done
    if (tid < len) {
      float f[4], g[4];
      fv::widen4(r_u, f);
      fv::widen4(r_dt, g);
      const float bb[4] = {bias4.x, bias4.y, bias4.z, bias4.w};
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        s_u[tid][c] = f[c];
        const float dt = g[c] + bb[c];
        s_dt[tid][c] = softplus ? fv::softplus(dt) : dt;
      }
    }
    const int nvec = len * n / kVe;
#pragma unroll
    for (int it = 0; it < kBCIters; ++it) {
      const int i = tid + it * kThreads;
      if (i < nvec) {
        float fb[kVe], fc[kVe];
        fv::widen16<T>(r_B[it], fb);
        fv::widen16<T>(r_C[it], fc);
#pragma unroll
        for (int e = 0; e < kVe; ++e) {
          const int idx = i * kVe + e;
          s_B[idx / n][idx % n] = fb[e];
          s_C[idx / n][idx % n] = fc[e];
        }
      }
    }
    if (ci + 1 < nchunks) fetch(ci + 1);  // in flight during the scan
    if (states && s < n)  // h on entry to this chunk, for the backward
      states[((static_cast<size_t>(blockIdx.y) * nchunks +
               chunk_start(ci) / kChunk) * d + d0 + ch) * n + s] = h;
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < len; ++k) {
      const int t = reverse ? len - 1 - k : k;
      const float dt = s_dt[t][ch];
      h = expf(dt * a_coef) * h + dt * s_u[t][ch] * s_B[t][s];
      s_p[t][ch][s] = h * s_C[t][s];
    }
    __syncthreads();
    const int t0 = chunk_start(ci);
    for (int i = tid; i < len * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) y += s_p[t][c][j];
      if (Dp) y += Dp[d0 + c] * s_u[t][c];
      if constexpr (kGate)
        y *= fv::silu(fv::to_f32(z[(tok0 + t0 + t) * ldz + d0 + c]));
      out[(tok0 + t0 + t) * d + d0 + c] = fv::from_f32<T>(y);
    }
  }
  if (last && s < n)  // the state after the last step in scan order
    last[(static_cast<size_t>(blockIdx.y) * d + d0 + ch) * n + s] = h;
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* bias,
                   const void* D, const void* z, void* out, void* states,
                   void* last, int batch, int L, int d, int n, int ldz,
                   bool softplus, bool reverse, cudaStream_t stream) {
  dim3 grid(d / kChannels, batch);
  auto kernel = z ? scan_fwd_kernel<T, true> : scan_fwd_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(bias),
      static_cast<const float*>(D), static_cast<const T*>(z),
      static_cast<T*>(out), static_cast<float*>(states),
      static_cast<float*>(last), L, d, n, ldz, softplus, reverse);
  return cudaGetLastError();
}

}  // namespace

// u, delta: (batch, L, d) and B, C: (batch, L, n), all of `dtype`
// (0 fp32, 1 bf16), contiguous and 16-byte aligned; d % 4 == 0, n 8 or
// 16; A: (d, n) fp32; bias, D: (d,) fp32 or null; z: null, or (batch,
// L, d) of `dtype` with tokens `ldz` elements apart (>= d; a column slice
// of a wider array), the gate y · silu(z); out: (batch, L, d) of `dtype`;
// states: null, or (batch, ceil(L / 64), d, n) fp32, which receives the
// state h on entry to each 64-step chunk (what the backward kernel
// rebuilds h from); last: null, or (batch, d, n) fp32, which receives the
// state after the last step in scan order. Returns a cudaError_t.
extern "C" int fv_selective_scan_fwd(const void* u, const void* delta,
                                     const void* A, const void* B,
                                     const void* C, const void* bias,
                                     const void* D, const void* z, void* out,
                                     void* states, void* last, int batch,
                                     int L, int d, int n, int ldz, int dtype,
                                     int softplus, int reverse,
                                     void* stream) {
  if (batch < 1 || batch > 65535 || L < 0 || d % kChannels != 0 || d < 1 ||
      (n != 8 && n != kLanes) || (z && ldz < d))
    return cudaErrorInvalidValue;
  if (L == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fv::kF32:
      return launch<float>(u, delta, A, B, C, bias, D, z, out, states, last,
                           batch, L, d, n, ldz, softplus, reverse, st);
    case fv::kBF16:
      return launch<__nv_bfloat16>(u, delta, A, B, C, bias, D, z, out,
                                   states, last, batch, L, d, n, ldz,
                                   softplus, reverse, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* fv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
