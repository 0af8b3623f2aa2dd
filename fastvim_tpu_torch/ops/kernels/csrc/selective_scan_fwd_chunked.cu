// K1, chunk-parallel form: the selective-scan forward for long L on Hopper
// (sm_90a).
//
// Replaces, with selective_scan_fwd.cu (which keeps the short scans), the
// TPU kernel `_scan_kernel` (fastvim_tpu/ops/pallas/selective_scan.py,
// launched by `_pallas_fwd`): per (batch, channel d),
//   delta = softplus(delta + bias);  a = exp(delta * A[d, :]);
//   h = a * h + delta * u * B[t, :];  y[t] = <h, C[t, :]> (+ D * u)
// left to right, or right to left for reverse=1, and h on entry to each
// 64-step chunk into `states`, the contract K2 (selective_scan_bwd.cu,
// selective_scan_bwd_chunked.cu) reads: (batch, ceil(L / 64), d, n) fp32,
// indexed by the chunk's position in the original order, holding h on
// entry in scan order. With reverse the last chunk, which may be partial,
// is scanned first from h = 0. For the language model's prefill it takes
// the gate z (y · silu(z) in fp32 before the one rounding, in phase 3) and
// writes the final state into `last` (phase 2 carried one chunk further),
// as selective_scan_fwd.cu does.
//
// What bounds the sequential form on the H100 is the latency of its L-step
// chain: one thread per (batch, channel, state) walks all of L, 192 blocks
// of 64 threads at Vim-T's shapes (L = 16,384, batch 2, d 384), about 77
// ns a step. This form cuts L into its 64-step chunks and runs them all at
// once, in three launches on one stream:
//   1. chunk summaries: each (batch, chunk, channel) scans its chunk from
//      h = 0 in scan direction for all n states, writing the chunk's own
//      end state h_loc into `states` and S = Σ delta over the chunk into
//      the scratch `dsum` (batch, nchunks, d). The product of a over the
//      chunk is exp(A·S): exact up to rounding, and an underflow to 0 is
//      exact too (a decays, never grows).
//   2. state passing: each (batch, channel, state) walks the chunks in scan
//      order, h_in = exp(A·S[c])·h_in + h_loc[c], writing h_in into
//      states[c] in place before the update. A chain of nchunks
//      multiply-adds (256 at L = 16,384); the loads and the exponentials do
//      not depend on it and are started a group of chunks ahead. The
//      kernel lives in scan_chunked.cuh: K2's chunked adjoint runs it too.
//   3. outputs: each (batch, chunk, channel) starts from states[c] and
//      scans its chunk again, writing y with the D·u skip.
// At Vim-T's shapes phases 1 and 3 have 2 · 256 · 384 independent
// threads, each with n independent state chains in registers, so the
// chains are no longer what the card waits for. What is left is
// arithmetic: each phase takes B·L·d·n exponentials, one MUFU ex2 each
// (A scaled by log2 e), against 16 results per SM per clock, about
// 0.05 ms a phase at Vim-T's shapes; the bytes (u and delta twice, B, C,
// y, the states three times) are fewer than 0.2 GB.
//
// A thread owns one channel and all n states of it, so the contraction
// y = Σ_s h·C is a register sum off the state chain, with no shuffle and
// no second pass. A block of 64 channels stages its chunk's B (and C) in
// shared memory once (rows broadcast to every thread); each thread reads
// its channel's u and delta straight from device memory, a warp reading
// 32 adjacent channels of a step. Those loads go 8 steps at a time, a
// group ahead, at clamped steps, kept as loaded until used; the steps
// past a partial chunk are masked to the identity (delta = 0: a = 1,
// b = 0), so no load sits in a branch. A group's softplus runs side by
// side before its steps. All math is fp32; y is written in u's dtype.
//
// Versions (bf16, L = 16,384, batch 2, d 384, n 16; NVIDIA H100 80GB
// HBM3, 700 W; sequential kernel 1.216 ms in the same call): the first,
// exp2f and 16-step load groups waited for where they were used, 0.278
// ms; ex2.approx.ftz, the prefetch and the group's softplus ahead, 0.211
// ms, phases 1 + 3 taking 0.176 ms of it and phase 2 0.029 ms, which
// then got its loads a group ahead too.

#include "scan_chunked.cuh"

namespace {

constexpr int kThreads = 64;       // channels per block, phases 1 and 3
constexpr int kGroup = 8;          // steps whose u, delta loads go together

// Phases 1 (kOut = false) and 3 (kOut = true; kGate: z is given, a
// template argument so that the kernel without it tests nothing). Grid
// (d / 64 rounded up, nchunks, batch); thread = one channel of one chunk,
// n states.
template <typename T, int N, bool kOut, bool kGate>
__global__ void __launch_bounds__(kThreads)
scan_chunk_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ bias,
                  const float* __restrict__ Dp, const T* __restrict__ z,
                  T* __restrict__ out, float* __restrict__ states,
                  float* __restrict__ dsum, int L, int d, int ldz,
                  bool softplus, bool reverse) {
  constexpr int kVe = fv::kVec<T>;  // elements per 16-byte vector
  __shared__ __align__(16) float s_B[kChunk * N];
  __shared__ __align__(16) float s_C[kOut ? kChunk * N : 4];
  const int tid = threadIdx.x;
  const int ci = blockIdx.y;  // the chunk's position in the original order
  const int nchunks = gridDim.y;
  const size_t b = blockIdx.z;
  const int t0 = ci * kChunk;
  const int len = min(kChunk, L - t0);
  const size_t row0 = b * L + t0;  // the chunk's first token

  // the chunk's B (and C) rows are len · N contiguous elements
  const int nvec = len * N / kVe;
  for (int i = tid; i < nvec; i += kThreads) {
    float f[kVe];
    fv::widen16<T>(fv::load16(Bm + row0 * N + i * kVe), f);
#pragma unroll
    for (int e = 0; e < kVe; ++e) s_B[i * kVe + e] = f[e];
    if constexpr (kOut) {
      fv::widen16<T>(fv::load16(Cm + row0 * N + i * kVe), f);
#pragma unroll
      for (int e = 0; e < kVe; ++e) s_C[i * kVe + e] = f[e];
    }
  }
  __syncthreads();
  const int c = blockIdx.x * kThreads + tid;
  if (c >= d) return;

  float a2[N], h[N];
  float4* st = reinterpret_cast<float4*>(
      states + ((b * nchunks + ci) * d + c) * N);
#pragma unroll
  for (int s = 0; s < N; ++s)
    a2[s] = A[static_cast<size_t>(c) * N + s] * kLog2e;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {  // phase 3 starts from the entry state
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kOut) v = st[q];
    h[4 * q] = v.x;
    h[4 * q + 1] = v.y;
    h[4 * q + 2] = v.z;
    h[4 * q + 3] = v.w;
  }
  const float bi = bias ? bias[c] : 0.f;
  const float Dv = Dp ? Dp[c] : 0.f;
  const T* up = u + row0 * d + c;
  const T* dp = delta + row0 * d + c;
  T* yp = out + row0 * d + c;
  const T* zp = kGate ? z + row0 * ldz + c : nullptr;
  float dsum_c = 0.f;

  // a group of steps' u and delta as loaded, fetched a group ahead at
  // clamped steps, widened only where used so no load is waited for early
  T r_u[kGroup], r_dt[kGroup], r_z[kGroup];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = min(k0 + j, len - 1);
      const size_t t = reverse ? len - 1 - k : k;
      r_u[j] = up[t * d];
      r_dt[j] = dp[t * d];
      if constexpr (kGate) r_z[j] = zp[t * ldz];
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < len; k0 += kGroup) {
    float uu[kGroup], dt[kGroup], x[kGroup], gate[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {  // the group's softplus side by side
      uu[j] = fv::to_f32(r_u[j]);
      if constexpr (kGate) gate[j] = fv::silu(fv::to_f32(r_z[j]));
      float v = fv::to_f32(r_dt[j]) + bi;
      if (softplus) v = fv::softplus(v);
      dt[j] = k0 + j < len ? v : 0.f;  // past the end: a = 1, b = 0
      x[j] = dt[j] * uu[j];
    }
    fetch(k0 + kGroup);  // in flight during the group's steps
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = min(k0 + j, len - 1);
      const int t = reverse ? len - 1 - k : k;
      const float* Bt = s_B + t * N;
      if constexpr (kOut) {
        const float* Ct = s_C + t * N;
        float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < N; ++s) {
          h[s] = fmaf(ex2(dt[j] * a2[s]), h[s], x[j] * Bt[s]);
          y[s % 4] = fmaf(h[s], Ct[s], y[s % 4]);
        }
        if (k0 + j < len) {
          float yv = (y[0] + y[1]) + (y[2] + y[3]) + Dv * uu[j];
          if constexpr (kGate) yv *= gate[j];
          yp[static_cast<size_t>(t) * d] = fv::from_f32<T>(yv);
        }
      } else {
        dsum_c += dt[j];
#pragma unroll
        for (int s = 0; s < N; ++s)
          h[s] = fmaf(ex2(dt[j] * a2[s]), h[s], x[j] * Bt[s]);
      }
    }
  }
  if constexpr (!kOut) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      st[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    dsum[(b * nchunks + ci) * d + c] = dsum_c;
  }
}

template <typename T, int N, bool kOut, bool kGate = false>
cudaError_t launch_chunks(dim3 grid, const void* u, const void* delta,
                          const void* A, const void* B, const void* C,
                          const void* bias, const void* D, const void* z,
                          void* out, void* states, void* dsum, int L, int d,
                          int ldz, bool softplus, bool reverse,
                          cudaStream_t stream) {
  scan_chunk_kernel<T, N, kOut, kGate><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(bias),
      static_cast<const float*>(D), static_cast<const T*>(z),
      static_cast<T*>(out), static_cast<float*>(states),
      static_cast<float*>(dsum), L, d, ldz, softplus, reverse);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* bias,
                   const void* D, const void* z, void* out, void* states,
                   void* last, void* dsum, int batch, int L, int d, int ldz,
                   bool softplus, bool reverse, cudaStream_t stream) {
  const int nchunks = (L + kChunk - 1) / kChunk;
  const dim3 grid((d + kThreads - 1) / kThreads, nchunks, batch);
  cudaError_t err = launch_chunks<T, N, false>(
      grid, u, delta, A, B, C, bias, D, z, out, states, dsum, L, d, ldz,
      softplus, reverse, stream);
  if (err != cudaSuccess) return err;
  err = state_pass(A, states, dsum, batch, nchunks, d, N, reverse, stream,
                   last);
  if (err != cudaSuccess) return err;
  return (z ? launch_chunks<T, N, true, true>
            : launch_chunks<T, N, true, false>)(
      grid, u, delta, A, B, C, bias, D, z, out, states, dsum, L, d, ldz,
      softplus, reverse, stream);
}

template <typename T>
cudaError_t launch_n(int n, const void* u, const void* delta, const void* A,
                     const void* B, const void* C, const void* bias,
                     const void* D, const void* z, void* out, void* states,
                     void* last, void* dsum, int batch, int L, int d, int ldz,
                     bool softplus, bool reverse, cudaStream_t stream) {
  return n == 8 ? launch<T, 8>(u, delta, A, B, C, bias, D, z, out, states,
                               last, dsum, batch, L, d, ldz, softplus,
                               reverse, stream)
                : launch<T, 16>(u, delta, A, B, C, bias, D, z, out, states,
                                last, dsum, batch, L, d, ldz, softplus,
                                reverse, stream);
}

}  // namespace

// The arguments of fv_selective_scan_fwd (selective_scan_fwd.cu), with
// states required, and dsum: (batch, ceil(L / 64), d) fp32 scratch for the
// chunks' sums of delta. Three launches on `stream`. Returns a
// cudaError_t.
extern "C" int fv_selective_scan_fwd_chunked(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* bias, const void* D, const void* z, void* out,
    void* states, void* last, void* dsum, int batch, int L, int d, int n,
    int ldz, int dtype, int softplus, int reverse, void* stream) {
  if (batch < 1 || batch > 65535 || L < 0 || d % 4 != 0 || d < 1 ||
      (n != 8 && n != 16) || (L + kChunk - 1) / kChunk > 65535 || !states ||
      !dsum || (z && ldz < d))
    return cudaErrorInvalidValue;
  if (L == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fv::kF32:
      return launch_n<float>(n, u, delta, A, B, C, bias, D, z, out, states,
                             last, dsum, batch, L, d, ldz, softplus, reverse,
                             st);
    case fv::kBF16:
      return launch_n<__nv_bfloat16>(n, u, delta, A, B, C, bias, D, z, out,
                                     states, last, dsum, batch, L, d, ldz,
                                     softplus, reverse, st);
    default:
      return cudaErrorInvalidValue;
  }
}
