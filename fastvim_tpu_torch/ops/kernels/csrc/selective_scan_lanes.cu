// lanes: the selective-scan forward with time across the lanes of a warp,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_kernel_lanes` (fastvim_tpu/ops/pallas/
// selective_scan.py, launched by `_pallas_fwd_lanes`): K1's forward math,
// forward direction only,
//   delta = softplus(delta + bias);  a = exp(delta · A[d, s]);
//   b = delta · u · B[s, t];  h[t] = a[t]·h[t-1] + b[t];
//   y[t] = Σ_s h[s, t]·C[s, t] + D·u[t],
// with the recurrence inside a 128-step chunk taken as a log-depth
// doubling scan of the (a, b) pairs — (a, b)[t] ← (a[t]·a[t-k], b[t] +
// a[t]·b[t-k]) for k = 1, 2, 4, … — and the state carried from chunk to
// chunk. On the TPU time rides the 128 vector lanes and the shift is
// `pltpu.roll` with a mask. Here a warp's 32 lanes hold the 128 steps of
// a chunk, 4 consecutive steps each, and the shift is `__shfl_up_sync`.
// Inputs come in the layout the TPU launcher transposes to, u and delta
// (batch, d, L) and B and C (batch, n, L), padded to whole chunks as there
// (u = 0, so padded steps add nothing), so a lane's 4 steps are one
// aligned 8- or 16-byte load.
//
// What bounds it on the H100: K1 spends L dependent steps per (batch,
// channel); this form spends L / 128 dependent chunks, each 5 shuffle
// stages deep. The bytes are K1's and small; what it pays is arithmetic
// and, with only B·d warps to run (768 at batch 2, d 384), the latency of
// whatever a warp waits for alone.
//
// Design, and what the versions before it taught (NVIDIA H100 80GB HBM3,
// 700 W; L = 16,384, batch 2, d 384, bf16):
// - The first version gave every lane one step and ran the doubling scan
//   over all 32: 5 stages, so 10 shuffles and 10 multiply-adds per step
//   and state where K1's chain does one multiply-add. With its transposes
//   it measured slower than K1, 1.66 against 1.20 ms. This version is the
//   work-efficient form of the same scan: a lane first combines its own 4
//   steps serially (3 multiply-adds), the doubling scan runs over the 32
//   lane totals only (10 shuffles per 4 steps), and the state entering
//   the lane is applied back to its 4 steps.
// - One warp per (batch, channel), 4 channels per block as in K1, so
//   blocks = d / 4 · batch. The warp holds the n carried states in
//   registers (uniform across lanes). Per chunk it runs the n scans 8
//   states at a time, stage by stage: shuffles keep their program order,
//   so a state scanned on its own waits out each of its 5 stages alone,
//   while 8 side by side keep 16 shuffles in flight per stage. Giving a
//   channel's states to two warps instead measured slower.
// - h·C goes into y as each group finishes: the contraction over the
//   states needs no second pass.
// - Every channel reads all of B and C. The block stages each chunk of
//   them in shared memory once (two buffers, one barrier per chunk),
//   fetched into registers a chunk ahead like u and delta; with each warp
//   loading them for itself the kernel was bound by those reads (about
//   0.8 GB from L2 for 50 MB of u and delta).
// - a = exp2(delta·A·log2 e), A scaled once; the products underflow to 0
//   over long chunks, which is exact (a decays, never grows).

#include "common.cuh"

namespace {

constexpr int kChannels = 4;  // channels per block, one warp each
constexpr int kThreads = 32 * kChannels;
constexpr int kSteps = 4;     // consecutive steps per lane
constexpr int kChunk = 32 * kSteps;  // 128 steps per warp and iteration
constexpr int kGroup = 8;     // states scanned side by side
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan_lanes_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ bias,
                  const float* __restrict__ Dp, T* __restrict__ out, int L,
                  int d, bool softplus) {
  using Raw = typename fv::Raw4<T>::type;  // a lane's 4 steps
  constexpr int kVe = fv::kVec<T>;         // elements per 16-byte vector
  constexpr int kRowVec = kChunk / kVe;    // vectors per row of a chunk
  constexpr int kNVec = 2 * N * kRowVec;   // ... of B and C together
  constexpr int kIters = (kNVec + kThreads - 1) / kThreads;
  // a chunk of B (rows 0..N-1) and C (rows N..2N-1), shared by the block's
  // channels; two buffers, so one barrier per chunk is enough
  __shared__ uint4 s_bc[2][kNVec];
  const int tid = threadIdx.x, lane = tid % 32;
  const int ch = blockIdx.x * kChannels + tid / 32;
  const size_t b = blockIdx.y;
  const size_t row = (b * d + ch) * L + kSteps * lane;
  const T* ur = u + row;
  const T* dr = delta + row;
  T* yr = out + row;
  float a_coef[N], h[N];
#pragma unroll
  for (int s = 0; s < N; ++s) {
    a_coef[s] = A[static_cast<size_t>(ch) * N + s] * kLog2e;  // for exp2f
    h[s] = 0.f;
  }
  const float bi = bias ? bias[ch] : 0.f;
  const float Dv = Dp ? Dp[ch] : 0.f;

  // one chunk's inputs in registers, fetched a chunk ahead: this lane's
  // steps of u and delta, and this thread's share of the B and C rows
  Raw r_u, r_dt;
  uint4 r_bc[kIters];
  auto fetch = [&](int t0) {
    r_u = fv::load4(ur + t0);
    r_dt = fv::load4(dr + t0);
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kThreads;
      if (i < kNVec) {
        const int r = i / kRowVec, v = i % kRowVec;
        const T* src = (r < N ? Bm : Cm) + (b * N + r % N) * L + t0 + v * kVe;
        r_bc[it] = fv::load16(src);
      }
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < L; t0 += kChunk) {
    uint4* s_buf = s_bc[(t0 / kChunk) % 2];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kThreads;
      if (i < kNVec) s_buf[i] = r_bc[it];
    }
    float uu[kSteps], dt[kSteps], x[kSteps], y[kSteps];
    fv::widen4(r_u, uu);
    fv::widen4(r_dt, dt);
    __syncthreads();  // the chunk's B and C are in place
    if (t0 + kChunk < L) fetch(t0 + kChunk);  // in flight during the scan
    const Raw* s_B = reinterpret_cast<const Raw*>(s_buf) + lane;
    const Raw* s_C = s_B + N * 32;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      dt[k] += bi;
      if (softplus) dt[k] = fv::softplus(dt[k]);
      x[k] = dt[k] * uu[k];
      y[k] = Dv * uu[k];
    }
#pragma unroll
    for (int g0 = 0; g0 < N; g0 += kGroup) {
      // the lane's own steps, for kGroup states side by side: P[k] =
      // a[0]·…·a[k], S[k] = the state after step k from a zero state
      float P[kGroup][kSteps], S[kGroup][kSteps];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int s = g0 + j;
        float Bv[kSteps];
        fv::widen4(s_B[s * 32], Bv);
        P[j][0] = exp2f(dt[0] * a_coef[s]);
        S[j][0] = x[0] * Bv[0];
#pragma unroll
        for (int k = 1; k < kSteps; ++k) {
          const float a = exp2f(dt[k] * a_coef[s]);
          P[j][k] = a * P[j][k - 1];
          S[j][k] = a * S[j][k - 1] + x[k] * Bv[k];
        }
      }
      // doubling scan of the lane totals across the warp, stage by stage
      // for all kGroup states, so that a stage's shuffles are in flight
      // together
      float a[kGroup], bb[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        a[j] = P[j][kSteps - 1];
        bb[j] = S[j][kSteps - 1];
      }
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        float a_sh[kGroup], b_sh[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          a_sh[j] = __shfl_up_sync(0xffffffffu, a[j], k);
          b_sh[j] = __shfl_up_sync(0xffffffffu, bb[j], k);
        }
        if (lane >= k) {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            bb[j] += a[j] * b_sh[j];
            a[j] *= a_sh[j];
          }
        }
      }
      // the state entering this lane: the totals of the lanes before it
      // applied to the carried state
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int s = g0 + j;
        const float tot = bb[j] + a[j] * h[s];
        float h_in = __shfl_up_sync(0xffffffffu, tot, 1);
        if (lane == 0) h_in = h[s];
        h[s] = __shfl_sync(0xffffffffu, tot, 31);
        float Cv[kSteps];
        fv::widen4(s_C[s * 32], Cv);
#pragma unroll
        for (int k = 0; k < kSteps; ++k)
          y[k] += (S[j][k] + P[j][k] * h_in) * Cv[k];
      }
    }
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      uint2 v;
      v.x = *reinterpret_cast<unsigned*>(&lo);
      v.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(yr + t0) = v;
    } else {
      *reinterpret_cast<float4*>(yr + t0) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* bias,
                   const void* D, void* out, int batch, int L, int d, int n,
                   bool softplus, cudaStream_t stream) {
  dim3 grid(d / kChannels, batch);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const T*>(p); };
  if (n == 16)
    scan_lanes_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
        h(u), h(delta), f(A), h(B), h(C), f(bias), f(D),
        static_cast<T*>(out), L, d, softplus);
  else
    scan_lanes_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
        h(u), h(delta), f(A), h(B), h(C), f(bias), f(D),
        static_cast<T*>(out), L, d, softplus);
  return cudaGetLastError();
}

}  // namespace

// u, delta: (batch, d, L) and B, C: (batch, n, L), all of `dtype` (0 fp32,
// 1 bf16), contiguous and 16-byte aligned; L % 128 == 0 (padded by the
// caller with u = 0), d % 4 == 0, n 8 or 16; A: (d, n) fp32; bias, D: (d,)
// fp32 or null; out: (batch, d, L) of `dtype`. Forward direction only.
// Returns a cudaError_t.
extern "C" int fv_selective_scan_fwd_lanes(const void* u, const void* delta,
                                           const void* A, const void* B,
                                           const void* C, const void* bias,
                                           const void* D, void* out,
                                           int batch, int L, int d, int n,
                                           int dtype, int softplus,
                                           void* stream) {
  if (batch < 1 || batch > 65535 || L < 0 || L % kChunk != 0 || d < 1 ||
      d % kChannels != 0 || (n != 8 && n != 16))
    return cudaErrorInvalidValue;
  if (L == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fv::kF32:
      return launch<float>(u, delta, A, B, C, bias, D, out, batch, L, d, n,
                           softplus, st);
    case fv::kBF16:
      return launch<__nv_bfloat16>(u, delta, A, B, C, bias, D, out, batch, L,
                                   d, n, softplus, st);
    default:
      return cudaErrorInvalidValue;
  }
}
