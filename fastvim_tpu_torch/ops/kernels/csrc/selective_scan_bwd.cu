// K2: chunk-recompute selective-scan backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` (fastvim_tpu/ops/pallas/
// selective_scan.py, launched by `_pallas_bwd`). With
//   delta = softplus(delta_in + bias);  a[t] = exp(delta[t] * A[d, :]);
//   h[t] = a[t] * h[prev t] + delta[t] * u[t] * B[t, :];  y[t] = <h[t], C[t]>
// and g = dL/dy, the adjoint state runs against the scan:
//   lam[t] = C[t] * g[t] + a[next t] * lam[next t]
//   du = delta * <lam, B> + D * g            dC[t, :] = sum_d h[t] * g[t]
//   ddelta = <lam * h[prev t] * a, A> + u * <lam, B>   (times sigmoid(delta_in))
//   dB[t, :] = sum_d lam * delta * u         dA = sum_{b,t} lam * h[prev] * a * delta
//   dD = sum_{b,t} g * u                     dbias = sum_{b,t} ddelta
//
// What bounds it on the H100: as for K1, the two recurrences are
// sequential in t. A chunk costs 64 dependent steps forward (h rebuilt
// from the saved entry state) and 64 backward (lam), whatever the
// bandwidth; the bytes (u, delta, g read; du, ddelta written in fp32) are
// small beside that latency.
//
// Design: one thread per (batch, channel, state), 16 lanes per channel and
// 8 channels per block, so a block's 128 threads reduce dB and dC over 8
// channels before anything leaves the SM. The TPU grid visited the chunks
// in reverse scan order on a sequential axis and carried lam in scratch;
// here each block loops over its own chunks, backwards, with h rebuilt
// per chunk into shared memory and lam carried in a register. Per step
// the thread stores its four products (lam*B, lam*h_prev*a*A, lam*delta*u,
// h*g) to shared memory; the contractions over the states (du, ddelta) and
// over the channels (dB, dC) run after the loop, in parallel over the
// chunk's steps, so no reduction sits on the chain.
//
// Cross-block sums: dB and dC sum over all d (d / 8 blocks), dA, dD and
// dbias over the batch. Blocks run in any order, so each writes its
// partial to its own slot (dB/dC: (batch, d / 8, L, n); dA, dD, dbias:
// (batch, d * (n + 2))) and `sum_partials_kernel` adds the slots in a
// fixed order: no atomics, the same bits from run to run. All math is
// fp32 and every gradient leaves in fp32 (the caller casts), as on the TPU.

#include "common.cuh"

namespace {

constexpr int kLanes = 16;                       // threads per channel
constexpr int kBwdChannels = 8;                  // channels per block
constexpr int kThreads = kLanes * kBwdChannels;  // 128
constexpr int kChunk = 64;                       // steps per chunk, as K1
constexpr int kLp = kLanes + 1;                  // padded state row

// dynamic shared memory, in floats
constexpr int kInTile = kChunk * kBwdChannels;            // u, dt, sig, g
constexpr int kBcTile = kChunk * kLanes;                  // B, C
constexpr int kProdTile = kChunk * kBwdChannels * kLp;    // per product
constexpr size_t kSmemBytes =
    (4 * kInTile + 2 * kBcTile + 4 * kProdTile + kThreads) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ bias,
                const float* __restrict__ Dp, const T* __restrict__ g,
                const float* __restrict__ states, float* __restrict__ du,
                float* __restrict__ ddelta, float* __restrict__ dB_part,
                float* __restrict__ dC_part, float* __restrict__ vec_part,
                int L, int d, int n, bool softplus, bool reverse) {
  extern __shared__ float smem[];
  float* s_u = smem;                    // [kChunk][kBwdChannels]
  float* s_dt = s_u + kInTile;          // softplus applied
  float* s_sg = s_dt + kInTile;         // d softplus / d delta_in (or 1)
  float* s_g = s_sg + kInTile;
  float* s_B = s_g + kInTile;           // [kChunk][kLanes]
  float* s_C = s_B + kBcTile;
  float* s_h = s_C + kBcTile;           // [kChunk][kBwdChannels][kLp]: h, then h*g
  float* s_pu = s_h + kProdTile;        // lam * B
  float* s_pd = s_pu + kProdTile;       // lam * h_prev * a * A
  float* s_pb = s_pd + kProdTile;       // lam * delta * u
  float* s_red = s_pb + kProdTile;      // [kThreads]

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;  // channel within the block
  const int s = tid % kLanes;   // state index
  const int d0 = blockIdx.x * kBwdChannels;
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const size_t tok0 = static_cast<size_t>(b) * L;
  const int nchunks = (L + kChunk - 1) / kChunk;
  const float a_coef = s < n ? A[static_cast<size_t>(d0 + ch) * n + s] : 0.f;
  for (int i = tid; i < kBcTile; i += kThreads) {  // states >= n stay 0
    s_B[i] = 0.f;
    s_C[i] = 0.f;
  }
  const int pidx = ch * kLp + s;  // this thread's slot in a product row
  const int cc = tid % kBwdChannels;  // channel of the contraction phase
  float lam_carry = 0.f, dA_acc = 0.f, dD_acc = 0.f, dbias_acc = 0.f;

  for (int bi = 0; bi < nchunks; ++bi) {
    // chunks in reverse scan order
    const int cpos = reverse ? bi : nchunks - 1 - bi;
    const int t0 = cpos * kChunk;
    const int len = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk's contractions are done
    for (int i = tid; i < len * kBwdChannels; i += kThreads) {
      const int t = i / kBwdChannels, c = i % kBwdChannels;
      const size_t off = (tok0 + t0 + t) * d + d0 + c;
      const float din = fv::to_f32(delta[off]) + (bias ? bias[d0 + c] : 0.f);
      s_u[i] = fv::to_f32(u[off]);
      s_g[i] = fv::to_f32(g[off]);
      s_dt[i] = softplus ? fv::softplus(din) : din;
      s_sg[i] = softplus ? 1.f / (1.f + expf(-din)) : 1.f;
    }
    for (int i = tid; i < len * n; i += kThreads) {
      const size_t off = (tok0 + t0) * n + i;
      s_B[(i / n) * kLanes + i % n] = fv::to_f32(Bm[off]);
      s_C[(i / n) * kLanes + i % n] = fv::to_f32(Cm[off]);
    }
    const float h_in =
        s < n ? states[((static_cast<size_t>(b) * nchunks + cpos) * d + d0 +
                        ch) * n + s]
              : 0.f;
    __syncthreads();

    // rebuild h over the chunk, in scan order
    float h = h_in;
#pragma unroll 4
    for (int k = 0; k < len; ++k) {
      const int t = reverse ? len - 1 - k : k;
      const float dt = s_dt[t * kBwdChannels + ch];
      h = expf(dt * a_coef) * h +
          dt * s_u[t * kBwdChannels + ch] * s_B[t * kLanes + s];
      s_h[t * kBwdChannels * kLp + pidx] = h;
    }
    // the adjoint recurrence, against scan order; dA is summed per chunk
    // first, so that the long sum over L rounds less
    float h_t = h, dA_chunk = 0.f;
#pragma unroll 4
    for (int k = len - 1; k >= 0; --k) {
      const int t = reverse ? len - 1 - k : k;
      const int tp = reverse ? t + 1 : t - 1;  // predecessor in scan order
      const float h_prev = k == 0 ? h_in : s_h[tp * kBwdChannels * kLp + pidx];
      const float dt = s_dt[t * kBwdChannels + ch];
      const float a = expf(dt * a_coef);
      const float gg = s_g[t * kBwdChannels + ch];
      const float lam = s_C[t * kLanes + s] * gg + lam_carry;
      lam_carry = a * lam;
      const float daa = lam * h_prev * a;
      const int o = t * kBwdChannels * kLp + pidx;
      s_h[o] = h_t * gg;
      s_pu[o] = lam * s_B[t * kLanes + s];
      s_pd[o] = daa * a_coef;
      s_pb[o] = lam * dt * s_u[t * kBwdChannels + ch];
      dA_chunk += daa * dt;
      h_t = h_prev;
    }
    dA_acc += dA_chunk;
    __syncthreads();

    // contract over the states: du, ddelta (thread = one (step, channel))
    for (int i = tid; i < len * kBwdChannels; i += kThreads) {
      const int t = i / kBwdChannels;  // i % kBwdChannels == cc
      float su = 0.f, sd = 0.f;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        su += s_pu[i * kLp + j];
        sd += s_pd[i * kLp + j];
      }
      const float gg = s_g[i], uu = s_u[i];
      const float dd = (sd + su * uu) * s_sg[i];
      const size_t off = (tok0 + t0 + t) * d + d0 + cc;
      du[off] = su * s_dt[i] + (Dp ? Dp[d0 + cc] * gg : 0.f);
      ddelta[off] = dd;
      dD_acc += gg * uu;
      dbias_acc += dd;
    }
    // contract over the block's channels: partial dB, dC
    for (int i = tid; i < len * kLanes; i += kThreads) {
      const int t = i / kLanes, j = i % kLanes;
      if (j < n) {
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int c = 0; c < kBwdChannels; ++c) {
          sb += s_pb[(t * kBwdChannels + c) * kLp + j];
          sc += s_h[(t * kBwdChannels + c) * kLp + j];
        }
        const size_t off =
            ((static_cast<size_t>(b) * nblk + blockIdx.x) * L + t0 + t) * n + j;
        dB_part[off] = sb;
        dC_part[off] = sc;
      }
    }
  }

  // this batch element's partial of dA, dD, dbias: [d*n | d | d]
  float* vp = vec_part + static_cast<size_t>(b) * d * (n + 2);
  if (s < n) vp[static_cast<size_t>(d0 + ch) * n + s] = dA_acc;
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
    s_red[tid] = pass == 0 ? dD_acc : dbias_acc;
    __syncthreads();
    if (tid < kBwdChannels) {
      float acc = 0.f;
      for (int i = tid; i < kThreads; i += kBwdChannels) acc += s_red[i];
      vp[static_cast<size_t>(d) * (n + pass) + d0 + tid] = acc;
    }
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* bias,
                   const void* D, const void* g, const void* states, void* du,
                   void* ddelta, void* dbc_part, void* vec_part, void* dB,
                   void* dC, void* vec, int batch, int L, int d, int n,
                   bool softplus, bool reverse, cudaStream_t stream) {
  cudaError_t err = fv::allow_max_smem<scan_bwd_kernel<T>>();
  if (err != cudaSuccess) return err;
  const int nblk = d / kBwdChannels;
  const size_t part = static_cast<size_t>(batch) * nblk * L * n;
  auto* dbp = static_cast<float*>(dbc_part);
  dim3 grid(nblk, batch);
  scan_bwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(bias),
      static_cast<const float*>(D), static_cast<const T*>(g),
      static_cast<const float*>(states), static_cast<float*>(du),
      static_cast<float*>(ddelta), dbp, dbp + part,
      static_cast<float*>(vec_part), L, d, n, softplus, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long ln = static_cast<long>(L) * n;
  err = fv::sum_partials(dbp, static_cast<float*>(dB), ln, nblk, batch, stream);
  if (err != cudaSuccess) return err;
  err = fv::sum_partials(dbp + part, static_cast<float*>(dC), ln, nblk, batch,
                         stream);
  if (err != cudaSuccess) return err;
  return fv::sum_partials(static_cast<const float*>(vec_part),
                          static_cast<float*>(vec),
                          static_cast<long>(d) * (n + 2), batch, 1, stream);
}

}  // namespace

// u, delta, g: (batch, L, d) and B, C: (batch, L, n), all of `dtype`
// (0 fp32, 1 bf16), contiguous; d % 8 == 0, n 8 or 16; A: (d, n) fp32;
// bias, D: (d,) fp32 or null; states: (batch, ceil(L / 64), d, n) fp32 from
// fv_selective_scan_fwd. Outputs, all fp32: du, ddelta (batch, L, d);
// dB, dC (batch, L, n); vec = [dA (d, n) | dD (d,) | dbias (d,)]. Scratch:
// dbc_part (2, batch, d / 8, L, n) and vec_part (batch, d * (n + 2)).
// Returns a cudaError_t.
extern "C" int fv_selective_scan_bwd(const void* u, const void* delta,
                                     const void* A, const void* B,
                                     const void* C, const void* bias,
                                     const void* D, const void* g,
                                     const void* states, void* du,
                                     void* ddelta, void* dbc_part,
                                     void* vec_part, void* dB, void* dC,
                                     void* vec, int batch, int L, int d,
                                     int n, int dtype, int softplus,
                                     int reverse, void* stream) {
  if (batch < 1 || batch > 65535 || L < 0 || d % kBwdChannels != 0 || d < 1 ||
      (n != 8 && n != kLanes))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (L == 0)  // no steps: the sums over (batch, L) are zero
    return cudaMemsetAsync(vec, 0, sizeof(float) * d * (n + 2), st);
  switch (dtype) {
    case fv::kF32:
      return launch<float>(u, delta, A, B, C, bias, D, g, states, du, ddelta,
                           dbc_part, vec_part, dB, dC, vec, batch, L, d, n,
                           softplus, reverse, st);
    case fv::kBF16:
      return launch<__nv_bfloat16>(u, delta, A, B, C, bias, D, g, states, du,
                                   ddelta, dbc_part, vec_part, dB, dC, vec,
                                   batch, L, d, n, softplus, reverse, st);
    default:
      return cudaErrorInvalidValue;
  }
}
