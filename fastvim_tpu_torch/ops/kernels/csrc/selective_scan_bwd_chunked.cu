// K2, chunk-parallel form: the selective-scan adjoint for long L on Hopper
// (sm_90a).
//
// Replaces, with selective_scan_bwd.cu (which keeps the short scans), the
// TPU kernel `_bwd_kernel` (fastvim_tpu/ops/pallas/selective_scan.py,
// launched by `_pallas_bwd`). With
//   delta = softplus(delta_in + bias);  a[t] = exp(delta[t] * A[d, :]);
//   h[t] = a[t] * h[prev t] + delta[t] * u[t] * B[t, :];  y[t] = <h[t], C[t]>
// and g = dL/dy, the adjoint state runs against the scan:
//   lam[t] = C[t] * g[t] + a[next t] * lam[next t]
//   du = delta * <lam, B> + D * g            dC[t, :] = sum_d h[t] * g[t]
//   ddelta = <lam * h[prev t] * a, A> + u * <lam, B>   (times sigmoid(delta_in))
//   dB[t, :] = sum_d lam * delta * u         dA = sum_{b,t} lam * h[prev] * a * delta
//   dD = sum_{b,t} g * u                     dbias = sum_{b,t} ddelta
// It reads the chunk-entry states K1 saved: (batch, ceil(L / 64), d, n)
// fp32, indexed by the chunk's position, h on entry in scan order.
//
// The sequential form walks all of L per block, two dependent 64-step
// chains a chunk (h rebuilt, then lam), 96 blocks at Vim-T's shapes (L =
// 16,384, batch 2, d 384): about 13 µs a chunk, 3.4 ms a call, latency
// and nothing else. This form runs the chunks at once, in three phases on
// one stream, then the fixed-order sums:
//   1. lam summaries (bwd_lam_chunk_kernel): each (batch, chunk, channel)
//      runs lam through its chunk against scan order from a zero carry,
//      all n states in registers, and writes what flows out of the chunk's
//      first step, a·lam, into `carry` (batch, nchunks, d, n) and S = Σ
//      delta over the chunk into `dsum`. It needs delta, g and C, no h.
//   2. the carry pass (state_pass_kernel of scan_chunked.cuh, K1's phase
//      2): the chunks walked against scan order, carry_in[c] stored in
//      place and carry = exp(A·S[c])·carry + out[c] — lam is linear in its
//      carry, and a chunk passes it on scaled by the product of its a,
//      exp(A·S).
//   3. gradients (bwd_grad_chunk_kernel): each (batch, chunk, 32-channel
//      slot) rebuilds h from states[c] and runs lam from carry_in[c], and
//      writes du, ddelta, its slot's partial of dB and dC, and the
//      (batch, chunk) partials of dA, dD and dbias. fv::sum_partials adds
//      the dB, dC slots in a fixed order and sum_slots_kernel the dA, dD,
//      dbias ones (no atomics: the same bits every run).
// Steps past a partial chunk are the identity (delta = 0, so a = 1, and
// g = B = C = 0), as in K1: no load sits in a branch and no phase needs a
// special case for the tail.
//
// Phase 3 is laid out for residency. A thread owns one (channel, state):
// h for the whole chunk stays in registers (fully unrolled loops, so
// every index is a constant), a = 2^(delta·A·log2 e) is one MUFU ex2,
// taken again in the backward walk instead of kept, and lam·h_prev·a is
// the new carry times h_prev. The sums over the states (<lam, B>, <lam ·
// h_prev · a, A>) and over the warp's channels (dB, dC) are reduce-
// scatters across lanes, one shuffle per value and lane bit, started as
// soon as a pair of steps is ready (a few registers in flight, not a
// group's worth) and off the lam chain; each lane ends with the sum for
// one step. Only the dB and dC partials touch shared memory (a tile per
// warp, summed over the block's four warps once per chunk); a block walks
// its slot's 32 channels in passes of 128 / n, so the partial slots of dB
// and dC cover 32 channels (d / 32 slots, not d / 8: 50 MB at Vim-T's
// shapes, not 201). The next pass's u, delta and g rows are copied by
// cp.async during the walk.
//
// Residency (ptxas -v, cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// nvcc 12.8, sm_90a): phase 3 in bf16 with n 16 uses 128 registers (148
// bytes of spill stores), 55,552 bytes of shared memory and keeps 4
// blocks, 16 warps, on an SM; in fp32 58,624 bytes and 3 blocks. Phase 1:
// 96 registers, 4 KB, phase 2 168 registers.
//
// Versions (bf16, L = 16,384, batch 2, d 384, n 16, device time; NVIDIA
// H100 80GB HBM3, 700 W; the sequential form 3.36-3.39 ms in the same
// calls): v1, this layout, 0.711 ms, phase 3 0.56 of it, phase 1 0.078,
// the sums 0.057, phase 2 0.017. Slower, and dropped: 3 blocks an SM at
// 168 registers, 0.78; h half a chunk at a time, 0.76; four states a
// thread, 8 channels a warp (fewer state shuffles, more channel ones, 3
// blocks), 0.77. Kept: sum_slots_kernel for the 512 dA, dD, dbias slots,
// 0.69 (the sums 0.057 → 0.038 ms); the cp.async copy a pass ahead, 0.66
// (phase 3 0.56 → 0.53).

#include "scan_chunked.cuh"
#include "wgmma.cuh"  // fv::cp_async16

namespace {

constexpr int kLamThreads = 64;    // channels per block, phase 1
constexpr int kGroup = 8;          // steps whose delta, g loads go together
constexpr int kGradThreads = 128;  // threads per block, phase 3
constexpr int kWarps = kGradThreads / 32;
constexpr int kSlot = 32;          // channels per block and dB/dC partial slot

// Phase 3's layout for n = N states: N lanes per channel.
template <typename T, int N>
struct Grad {
  static_assert(N == 8 || N == 16, "n is 8 or 16");
  static constexpr int kCpw = 32 / N;                // channels per warp
  static constexpr int kCpp = kGradThreads / N;      // channels per pass
  static constexpr int kPasses = kSlot / kCpp;
  static constexpr int kRow = kCpp + 1;              // padded row of s_in
  static constexpr int kVe = fv::kVec<T>;            // elements a 16-byte copy
  static constexpr int kCopies = kCpp / kVe;         // copies a row
  static constexpr size_t kQBytes = 2 * kWarps * kChunk * N * sizeof(float);
  static constexpr size_t kSmem =
      kChunk * N * sizeof(float2)                    // s_bc: B, C
      + kChunk * kRow * sizeof(float4)               // s_in: dt, x, g, u
      + kChunk * kRow * sizeof(float)                // s_sig
      + kQBytes                                      // s_q: dB, dC per warp
      + 3 * kChunk * kCpp * sizeof(T);               // s_raw: u, delta, g
};

// One step of a reduce-scatter across the lanes that differ in `bit`: `lo`
// and `hi` are two values of every lane; the lane with the bit clear ends
// with Σ lo over the pair, the other with Σ hi. After one such step per
// lane bit of a group of 2^k lanes, each lane holds the group's sum of the
// value whose index is its own lane bits.
__device__ __forceinline__ float rs_pair(float lo, float hi, int lane,
                                         int bit) {
  const bool up = lane & bit;
  const float send = up ? lo : hi;
  const float keep = up ? hi : lo;
  return keep + __shfl_xor_sync(0xffffffffu, send, bit);
}

// Streaming reduce-scatter of one value per step j (taken in descending
// order) across the lanes of bits bit0, 2·bit0, ..., (K / 2)·bit0: a
// binary counter of partial pairs, at most log2 K values in flight. Push
// returns true at the step that completes the K steps; the lane whose
// bits read i then holds the sum for step j0 + i of the K.
template <int K>
struct Scatter {
  float lv[K > 1 ? 5 : 1];
  __device__ __forceinline__ bool push(float v, int j, int lane, int bit0) {
    int idx = j % K;
#pragma unroll
    for (int lvl = 0; (1 << lvl) < K; ++lvl) {
      if (idx & 1) {  // the higher of its pair: wait for the lower one
        lv[lvl] = v;
        return false;
      }
      v = rs_pair(v, lv[lvl], lane, bit0 << lvl);
      idx >>= 1;
    }
    lv[0] = v;
    return true;
  }
  __device__ __forceinline__ float result() const { return lv[0]; }
};

// Phase 1. Grid (d / 64 rounded up, nchunks, batch); thread = one channel
// of one chunk, n states. Walks the chunk against scan order from a zero
// carry: lam = C·g + carry, carry = a·lam.
template <typename T, int N>
__global__ void __launch_bounds__(kLamThreads)
bwd_lam_chunk_kernel(const T* __restrict__ delta, const float* __restrict__ A,
                     const T* __restrict__ Cm, const float* __restrict__ bias,
                     const T* __restrict__ g, float* __restrict__ carry,
                     float* __restrict__ dsum, int L, int d, bool softplus,
                     bool reverse) {
  constexpr int kVe = fv::kVec<T>;  // elements per 16-byte vector
  __shared__ __align__(16) float s_C[kChunk * N];
  const int tid = threadIdx.x;
  const int ci = blockIdx.y;  // the chunk's position in the original order
  const int nchunks = gridDim.y;
  const size_t b = blockIdx.z;
  const int t0 = ci * kChunk;
  const int len = min(kChunk, L - t0);
  const size_t row0 = b * L + t0;  // the chunk's first token

  const int nvec = len * N / kVe;  // the chunk's C rows, contiguous
  for (int i = tid; i < nvec; i += kLamThreads) {
    float f[kVe];
    fv::widen16<T>(fv::load16(Cm + row0 * N + i * kVe), f);
#pragma unroll
    for (int e = 0; e < kVe; ++e) s_C[i * kVe + e] = f[e];
  }
  __syncthreads();
  const int c = blockIdx.x * kLamThreads + tid;
  if (c >= d) return;

  float a2[N], lam_c[N];
#pragma unroll
  for (int s = 0; s < N; ++s) {
    a2[s] = A[static_cast<size_t>(c) * N + s] * kLog2e;
    lam_c[s] = 0.f;
  }
  const float bi = bias ? bias[c] : 0.f;
  const T* dp = delta + row0 * d + c;
  const T* gp = g + row0 * d + c;
  float dsum_c = 0.f;
  // the w-th step against scan order lies at reverse ? w : len - 1 - w
  const auto at = [&](int w) -> int {
    w = min(w, len - 1);
    return reverse ? w : len - 1 - w;
  };
  // a group of steps' delta and g as loaded, fetched a group ahead
  T r_dt[kGroup], r_g[kGroup];
  const auto fetch = [&](int w0) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const size_t t = at(w0 + j);
      r_dt[j] = dp[t * d];
      r_g[j] = gp[t * d];
    }
  };
  fetch(0);
  for (int w0 = 0; w0 < len; w0 += kGroup) {
    float dt[kGroup], gg[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {  // the group's softplus side by side
      float v = fv::to_f32(r_dt[j]) + bi;
      if (softplus) v = fv::softplus(v);
      const bool in = w0 + j < len;  // past the end: a = 1, nothing added
      dt[j] = in ? v : 0.f;
      gg[j] = in ? fv::to_f32(r_g[j]) : 0.f;
    }
    fetch(w0 + kGroup);  // in flight during the group's steps
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float* Ct = s_C + at(w0 + j) * N;
      dsum_c += dt[j];
#pragma unroll
      for (int s = 0; s < N; ++s)
        lam_c[s] = ex2(dt[j] * a2[s]) * fmaf(Ct[s], gg[j], lam_c[s]);
    }
  }
  float4* out = reinterpret_cast<float4*>(carry + ((b * nchunks + ci) * d +
                                                   c) * N);
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    out[q] = make_float4(lam_c[4 * q], lam_c[4 * q + 1], lam_c[4 * q + 2],
                         lam_c[4 * q + 3]);
  dsum[(b * nchunks + ci) * d + c] = dsum_c;
}

// Phase 3. Grid (d / 32 rounded up, nchunks, batch), 128 threads; thread =
// one (channel, state) of a pass of 128 / N channels, lane = channel ·
// N + state. Dynamic shared memory: Grad<T, N>::kSmem bytes.
template <typename T, int N>
__global__ void __launch_bounds__(kGradThreads, 4)
bwd_grad_chunk_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm,
                      const float* __restrict__ bias,
                      const float* __restrict__ Dp, const T* __restrict__ g,
                      const float* __restrict__ states,
                      const float* __restrict__ carry,
                      float* __restrict__ du, float* __restrict__ ddelta,
                      float* __restrict__ dB_part,
                      float* __restrict__ dC_part,
                      float* __restrict__ vec_part, int L, int d,
                      bool softplus, bool reverse) {
  using G = Grad<T, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_bc = reinterpret_cast<float2*>(smem_raw);    // [kChunk][N]
  float4* s_in = reinterpret_cast<float4*>(s_bc + kChunk * N);  // [kChunk][kRow]
  float* s_sig = reinterpret_cast<float*>(s_in + kChunk * G::kRow);
  float* s_q = s_sig + kChunk * G::kRow;  // [2][kWarps][kChunk][N]
  T* s_raw = reinterpret_cast<T*>(s_q + G::kQBytes / sizeof(float));

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int s = lane % N;                 // state
  const int cw = lane / N;                // channel within the warp
  const int cp = warp * G::kCpw + cw;     // channel within the pass
  const int ci = blockIdx.y;
  const int nchunks = gridDim.y;
  const size_t b = blockIdx.z;
  const int t0 = ci * kChunk;
  const int len = min(kChunk, L - t0);
  const size_t row0 = b * L + t0;
  const int d0 = blockIdx.x * kSlot;
  // the position of scan step k, clamped into the chunk
  const auto pos = [&](int k) -> int {
    k = min(k, len - 1);
    return reverse ? len - 1 - k : k;
  };

  // the chunk's B and C by scan step, 0 past the end
  for (int i = tid; i < kChunk * N; i += kGradThreads) {
    const int k = i / N;
    const size_t off = (row0 + pos(k)) * N + i % N;
    const float bv = fv::to_f32(Bm[off]), cv = fv::to_f32(Cm[off]);
    s_bc[i] = k < len ? make_float2(bv, cv) : make_float2(0.f, 0.f);
  }
  // this lane's rows of its warp's dB, dC tiles: steps k ≡ cw (mod kCpw)
  float* qB = s_q + warp * kChunk * N + s;
  float* qC = qB + kWarps * kChunk * N;
  for (int k = cw; k < kChunk; k += G::kCpw) {
    qB[k * N] = 0.f;
    qC[k * N] = 0.f;
  }
  const size_t vp = (b * nchunks + ci) * static_cast<size_t>(d) * (N + 2);
  // a pass's u, delta and g rows by scan step into s_raw [3][kChunk][kCpp],
  // copied a pass ahead; 16-byte pieces past d are zeros
  const auto fetch = [&](int cbase) {
    for (int i = tid; i < 3 * kChunk * G::kCopies; i += kGradThreads) {
      const int arr = i / (kChunk * G::kCopies), r = i % (kChunk * G::kCopies);
      const int k = r / G::kCopies, c0 = cbase + (r % G::kCopies) * G::kVe;
      const T* src = arr == 0 ? u : arr == 1 ? delta : g;
      fv::cp_async16(
          fv::smem_u32(s_raw + (arr * kChunk + k) * G::kCpp + c0 - cbase),
          src + (row0 + pos(k)) * d + min(c0, d - G::kVe), c0 < d);
    }
    fv::cp_async_commit();
  };
  fetch(d0);

#pragma unroll 1
  for (int p = 0; p < G::kPasses; ++p) {
    const int cbase = d0 + p * G::kCpp;
    if (cbase >= d) break;  // the same for the whole block
    fv::cp_async_wait<0>();
    __syncthreads();  // B, C and the rows staged; the pass before is done
    // the pass's channels, by scan step: dt, dt·u, g, u and sigmoid'
    for (int i = tid; i < kChunk * G::kCpp; i += kGradThreads) {
      const int k = i / G::kCpp, cc = i % G::kCpp;
      const int c = min(cbase + cc, d - 1);
      const T* raw = s_raw + k * G::kCpp + cc;
      const float din = fv::to_f32(raw[kChunk * G::kCpp]) +
                        (bias ? bias[c] : 0.f);
      const float uu = fv::to_f32(raw[0]);
      const float gg = fv::to_f32(raw[2 * kChunk * G::kCpp]);
      const float dt = softplus ? fv::softplus(din) : din;
      const float sg = softplus ? 1.f / (1.f + expf(-din)) : 1.f;
      const bool in = k < len && cbase + cc < d;
      s_in[k * G::kRow + cc] = in ? make_float4(dt, dt * uu, gg, uu)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      s_sig[k * G::kRow + cc] = in ? sg : 0.f;
    }
    __syncthreads();
    if (p + 1 < G::kPasses && cbase + G::kCpp < d)
      fetch(cbase + G::kCpp);  // in flight during this pass's walk

    const int c = cbase + cp;
    const bool cvalid = c < d;
    const int cl = min(c, d - 1);
    const float a_coef = A[static_cast<size_t>(cl) * N + s];
    const float a2 = a_coef * kLog2e;
    const float Dv = Dp ? Dp[cl] : 0.f;
    const size_t sidx = ((b * nchunks + ci) * d + cl) * N + s;
    const float4* in_c = s_in + cp;  // step k at in_c[k * kRow]
    const float2* bc_s = s_bc + s;   // step k at bc_s[k * N]

    // h over the chunk in scan order: h[k] on entry to step k
    float h[kChunk + 1];
    h[0] = states[sidx];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 v = in_c[k * G::kRow];
      h[k + 1] = fmaf(ex2(v.x * a2), h[k], v.y * bc_s[k * N].x);
    }

    // lam against scan order from the carry of the chunk after this one
    float lam_carry = carry[sidx];
    float dA_acc = 0.f, dD_acc = 0.f, dbias_acc = 0.f;
    Scatter<N> r_b, r_d;        // <lam, B>, <lam·h_prev·a, A>: over states
    Scatter<G::kCpw> r_qb, r_qc;  // dB, dC: over the warp's channels
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      const float4 v = in_c[k * G::kRow];  // dt, x, g, u
      const float2 bc = bc_s[k * N];
      const float a = ex2(v.x * a2);
      const float lam = fmaf(bc.y, v.z, lam_carry);
      lam_carry = a * lam;
      const float daa = lam_carry * h[k];  // lam · a · h_prev
      dA_acc = fmaf(daa, v.x, dA_acc);
      r_qb.push(lam * v.y, k, lane, N);
      if (r_qc.push(h[k + 1] * v.z, k, lane, N)) {
        const int kq = k + cw;  // this lane's step of the kCpw just done
        qB[kq * N] += r_qb.result();
        qC[kq * N] += r_qc.result();
      }
      r_b.push(lam * bc.x, k, lane, 1);
      if (r_d.push(daa * a_coef, k, lane, 1)) {
        // the N steps from k are reduced: this lane holds step k + s
        const int ks = k + s;
        const float4 w = in_c[ks * G::kRow];
        const float lam_b = r_b.result();
        const float dd = (r_d.result() + w.w * lam_b) *
                         s_sig[ks * G::kRow + cp];
        if (cvalid && ks < len) {
          const size_t off = (row0 + pos(ks)) * d + c;
          du[off] = fmaf(lam_b, w.x, Dv * w.z);
          ddelta[off] = dd;
        }
        dD_acc = fmaf(w.z, w.w, dD_acc);  // 0 past the end
        dbias_acc += dd;                  // sigmoid' is 0 past the end
      }
    }
#pragma unroll
    for (int o = N / 2; o > 0; o /= 2) {  // over the channel's states
      dD_acc += __shfl_xor_sync(0xffffffffu, dD_acc, o);
      dbias_acc += __shfl_xor_sync(0xffffffffu, dbias_acc, o);
    }
    if (cvalid) {  // this (batch, chunk)'s partials: [dA (d, n) | dD | dbias]
      vec_part[vp + static_cast<size_t>(c) * N + s] = dA_acc;
      if (s == 0) {
        vec_part[vp + static_cast<size_t>(d) * N + c] = dD_acc;
        vec_part[vp + static_cast<size_t>(d) * (N + 1) + c] = dbias_acc;
      }
    }
  }

  // the slot's dB, dC partial: the warps' tiles summed in order
  __syncthreads();
  const size_t slot = b * gridDim.x + blockIdx.x;
  for (int i = tid; i < kChunk * N; i += kGradThreads) {
    const int k = i / N;
    float sb = 0.f, sc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sb += s_q[w * kChunk * N + i];
      sc += s_q[(kWarps + w) * kChunk * N + i];
    }
    if (k < len) {
      const size_t off = (slot * L + t0 + pos(k)) * N + i % N;
      dB_part[off] = sb;
      dC_part[off] = sc;
    }
  }
}

// out[i] = Σ_s part[s][i], s < S, i < n, in a fixed order: thread (i, r)
// of a 32 × 8 block adds the slots s ≡ r (mod 8) in order, then the 8
// sums are added in order. The (batch, chunk) partials of dA, dD and
// dbias are 512 slots at Vim-T's shapes; fv::sum_partials, one thread a
// column walking them all, would wait on 512 loads in turn.
constexpr int kSumCols = 32, kSumRows = 8;
__global__ void __launch_bounds__(kSumCols * kSumRows)
sum_slots_kernel(const float* __restrict__ part, float* __restrict__ out,
                 long n, int S) {
  __shared__ float s_acc[kSumRows][kSumCols];
  const long i = static_cast<long>(blockIdx.x) * kSumCols + threadIdx.x;
  const int r = threadIdx.y;
  float acc = 0.f;
  if (i < n)
    for (int s = r; s < S; s += kSumRows)
      acc += part[static_cast<size_t>(s) * n + i];
  s_acc[r][threadIdx.x] = acc;
  __syncthreads();
  if (r == 0 && i < n) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSumRows; ++j) sum += s_acc[j][threadIdx.x];
    out[i] = sum;
  }
}

template <typename T, int N>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* bias,
                   const void* D, const void* g, const void* states, void* du,
                   void* ddelta, void* dbc_part, void* vec_part, void* dB,
                   void* dC, void* vec, void* carry, void* dsum, int batch,
                   int L, int d, bool softplus, bool reverse,
                   cudaStream_t stream) {
  const int nchunks = (L + kChunk - 1) / kChunk;
  const dim3 grid1((d + kLamThreads - 1) / kLamThreads, nchunks, batch);
  bwd_lam_chunk_kernel<T, N><<<grid1, kLamThreads, 0, stream>>>(
      static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(C), static_cast<const float*>(bias),
      static_cast<const T*>(g), static_cast<float*>(carry),
      static_cast<float*>(dsum), L, d, softplus, reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the carries walk the chunks against scan order
  err = state_pass(A, carry, dsum, batch, nchunks, d, N, !reverse, stream);
  if (err != cudaSuccess) return err;
  err = fv::allow_max_smem<bwd_grad_chunk_kernel<T, N>>();
  if (err != cudaSuccess) return err;
  const int nslots = (d + kSlot - 1) / kSlot;
  const size_t part = static_cast<size_t>(batch) * nslots * L * N;
  auto* dbp = static_cast<float*>(dbc_part);
  const dim3 grid3(nslots, nchunks, batch);
  bwd_grad_chunk_kernel<T, N><<<grid3, kGradThreads, Grad<T, N>::kSmem,
                                stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(bias),
      static_cast<const float*>(D), static_cast<const T*>(g),
      static_cast<const float*>(states), static_cast<const float*>(carry),
      static_cast<float*>(du), static_cast<float*>(ddelta), dbp, dbp + part,
      static_cast<float*>(vec_part), L, d, softplus, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long ln = static_cast<long>(L) * N;
  err = fv::sum_partials(dbp, static_cast<float*>(dB), ln, nslots, batch,
                         stream);
  if (err != cudaSuccess) return err;
  err = fv::sum_partials(dbp + part, static_cast<float*>(dC), ln, nslots,
                         batch, stream);
  if (err != cudaSuccess) return err;
  const long nvec = static_cast<long>(d) * (N + 2);
  sum_slots_kernel<<<static_cast<unsigned>((nvec + kSumCols - 1) / kSumCols),
                     dim3(kSumCols, kSumRows), 0, stream>>>(
      static_cast<const float*>(vec_part), static_cast<float*>(vec), nvec,
      batch * nchunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int n, const void* u, const void* delta, const void* A,
                     const void* B, const void* C, const void* bias,
                     const void* D, const void* g, const void* states,
                     void* du, void* ddelta, void* dbc_part, void* vec_part,
                     void* dB, void* dC, void* vec, void* carry, void* dsum,
                     int batch, int L, int d, bool softplus, bool reverse,
                     cudaStream_t stream) {
  return n == 8
             ? launch<T, 8>(u, delta, A, B, C, bias, D, g, states, du, ddelta,
                            dbc_part, vec_part, dB, dC, vec, carry, dsum,
                            batch, L, d, softplus, reverse, stream)
             : launch<T, 16>(u, delta, A, B, C, bias, D, g, states, du,
                             ddelta, dbc_part, vec_part, dB, dC, vec, carry,
                             dsum, batch, L, d, softplus, reverse, stream);
}

}  // namespace

// The arguments of fv_selective_scan_bwd (selective_scan_bwd.cu), with
// other scratch: dbc_part (2, batch, ceil(d / 32), L, n) and vec_part
// (batch, ceil(L / 64), d * (n + 2)), and carry (batch, ceil(L / 64), d,
// n) and dsum (batch, ceil(L / 64), d), all fp32. Three phase launches and
// three sums on `stream`. Returns a cudaError_t.
extern "C" int fv_selective_scan_bwd_chunked(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* bias, const void* D, const void* g,
    const void* states, void* du, void* ddelta, void* dbc_part,
    void* vec_part, void* dB, void* dC, void* vec, void* carry, void* dsum,
    int batch, int L, int d, int n, int dtype, int softplus, int reverse,
    void* stream) {
  if (batch < 1 || batch > 65535 || L < 0 || d % 8 != 0 || d < 1 ||
      (n != 8 && n != 16) || (L + kChunk - 1) / kChunk > 65535 || !states ||
      !carry || !dsum)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (L == 0)  // no steps: the sums over (batch, L) are zero
    return cudaMemsetAsync(vec, 0, sizeof(float) * d * (n + 2), st);
  switch (dtype) {
    case fv::kF32:
      return launch_n<float>(n, u, delta, A, B, C, bias, D, g, states, du,
                             ddelta, dbc_part, vec_part, dB, dC, vec, carry,
                             dsum, batch, L, d, softplus, reverse, st);
    case fv::kBF16:
      return launch_n<__nv_bfloat16>(n, u, delta, A, B, C, bias, D, g, states,
                                     du, ddelta, dbc_part, vec_part, dB, dC,
                                     vec, carry, dsum, batch, L, d, softplus,
                                     reverse, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// *blocks = phase 3's resident blocks per SM for dtype and n, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them.
extern "C" int fv_selective_scan_bwd_chunked_occupancy(void* blocks,
                                                       int dtype, int n) {
  auto* out = static_cast<int*>(blocks);
  const auto query = [&](auto kernel, size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(fv::kMaxSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, kGradThreads, smem));
  };
  if (n != 8 && n != 16) return cudaErrorInvalidValue;
  if (dtype == fv::kF32)
    return n == 8 ? query(bwd_grad_chunk_kernel<float, 8>,
                          Grad<float, 8>::kSmem)
                  : query(bwd_grad_chunk_kernel<float, 16>,
                          Grad<float, 16>::kSmem);
  if (dtype == fv::kBF16)
    return n == 8 ? query(bwd_grad_chunk_kernel<__nv_bfloat16, 8>,
                          Grad<__nv_bfloat16, 8>::kSmem)
                  : query(bwd_grad_chunk_kernel<__nv_bfloat16, 16>,
                          Grad<__nv_bfloat16, 16>::kSmem);
  return cudaErrorInvalidValue;
}
