// lanes: the selective-scan forward with time across the lanes of a warp,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_kernel_lanes` (fastvim_tpu/ops/pallas/
// selective_scan.py, launched by `_pallas_fwd_lanes`): K1's forward math,
// forward direction only,
//   delta = softplus(delta + bias);  a = exp(delta · A[d, s]);
//   b = delta · u · B[t, s];  h[t] = a[t]·h[t-1] + b[t];
//   y[t] = Σ_s h[s, t]·C[t, s] + D·u[t].
// On the TPU time rides the 128 vector lanes of a chunk and the chunk's
// recurrence is a log-depth doubling scan of the (a, b) pairs, (a, b)[t] ←
// (a[t]·a[t-k], b[t] + a[t]·b[t-k]) for k = 1, 2, 4, …, shifted with
// `pltpu.roll`; the state is carried from chunk to chunk along L.
//
// What bounds it on the H100: not the bytes (u, delta, B, C read once, y
// written once: about 0.1 GB) but the work an element. Each (b, t, d, s)
// takes one exponential (MUFU ex2, 16 a clock an SM: 0.05 ms at Vim-T's
// B = 2, L = 16,384, d 384, n 16), about ten fp32 operations, its own B
// and C from shared memory (a lane's steps are its own; chunked K1
// broadcasts them) and its share of the doubling's shuffles, which use
// the same pipe; and the registers that hold P·C for one exponential an
// element cap a block at 16 warps an SM.
//
// Design. A block owns a span of kSpan = 256 steps of one image and
// walks kGroups = 4 groups of kC = 4 channels of it in turn (fewer where
// the scan is too short for such blocks to fill the card). A warp takes
// one channel of the group and half its states over the whole span, a
// lane 8 consecutive steps.
// - Inputs as they lie: u and delta (batch, L, d), B and C (batch, L, n).
//   The block stages the span's B and C once for its 16 channels, a state
//   a row in their own type, and each group's u and delta time-last, a
//   thread a step: softplus(delta + bias) and dt · u (fp32) once for all
//   of the group's warps. Each staged row holds a lane's 8 steps as
//   16-byte pieces, piece by piece across the lanes (`staged`), so every
//   read of a warp is 512 contiguous bytes. The ragged last span is
//   masked: its missing steps are the identity (dt = 0), nothing is
//   padded and nothing stored for them.
// - A lane walks its 8 steps from h = 0 state by state: P[k] the product
//   of a up to step k, S[k] the state; y[k] takes Σ S[k]·C at once, and
//   P[k]·C stays in registers (64 floats a lane at n 16). The doubling
//   scan runs over the 32 lane totals, all of the warp's states side by
//   side, and leaves each lane its entering state as (Ae, Be), an affine
//   map of the state entering the span. Only the states' b halves are
//   shuffled: a window of lanes multiplies the state by exp(A·Σ dt) over
//   it, and that Σ dt, the same for every state, is doubled alongside.
// - Across spans, a chained carry: span i of a channel group waits for
//   span i − 1's inclusive state. Each (channel, state) of it is one
//   64-bit word of global scratch, the state's bits and a flag above
//   them, published with one release store and read by an acquire load
//   that repeats until the flag is set, a thread a word. Blocks take
//   spans in the order of a ticket counter (an atomic add at block
//   start), so the block a span waits for always holds an earlier ticket
//   and is resident or done; the counter orders scheduling only, never
//   arithmetic. A memset node zeroes the words and the counter before the
//   kernel. With the entering state h known, each lane adds
//   Σ_s P[k]·C·(Ae·h + Be) to y: one exponential per element, the inputs
//   read once.
// Every sum has one order (the lane walk, the doubling, the halves, the
// spans in order), so two calls give the same bits.
//
// Versions (bf16, L = 16,384, B = 2, d 384, n 16; NVIDIA H100 80GB HBM3,
// 700 W; device ms, timed by utils/profiling.py's graph_ms on copies of
// this file; PERF.md §6):
// - The other carry, three launches in K1's chunk-parallel pattern
//   (scan_chunked.cuh; spans for chunks): the kernel writing each span's
//   total from h = 0 and its Σ delta, `state_pass_kernel`, the kernel
//   again from the spans' entering states, each exponential taken twice;
//   slower at every length timed (PERF.md §6), so it went.
// - 4 steps a lane, a warp all 16 states of one channel over half the
//   span, a block one group: 0.405 (three launches 0.577: the output pass
//   0.366, the totals pass 0.209). Knocked out one at a time: the wait
//   0.398, the doubling 0.338, the exponentials 0.414, the softplus
//   0.389 (the output pass spilled at 128 registers).
// - 8 steps a lane, half the states a warp: 0.386; at 1 block an SM (255
//   registers) 0.587; a quarter of the states a warp and 2 channels a
//   group, 0.566 (0.512 at 3 blocks an SM).
// - Staged rows read as contiguous 16-byte pieces, B and C in their own
//   type (the rows above were read at a 32-byte lane stride, 2-way bank
//   conflicts, in fp32): 0.335.
// - 4 groups a block, B and C staged once: 0.304 with u and delta of the
//   next group loaded under this group's walk, 0.301 without (kept); 2
//   groups 0.319, 8 groups 0.314.
// - Spans carried in groups of 8 (each span folding its group-mates'
//   totals onto the group's entering state, the serial chain's own
//   operations): 0.375, 0.398 with the waits side by side (spills).
// - P·C not held but the lane's steps walked again from the entering
//   state: 0.350 (three launches 0.388, the fastest of that carry).
// - Fewer groups a block where the scan is short: L = 128 0.0183 → 0.0110
//   (48 blocks had left most SMs idle); the state and its flag in one
//   word (the flag had been a word of its own, polled by one thread, the
//   states read after a barrier and published behind a fence): 0.300 →
//   0.290, L = 128 0.0094.
// - The a halves of the doubling not shuffled but taken as ex2(A·Σ dt) of
//   the window (Σ dt doubled once for all states): 0.290 → 0.279, and no
//   spills left; softplus on the fast exp and log would take it to 0.269,
//   but that is another function than K1's and the plain version's.

#include "scan_chunked.cuh"  // ex2, kLog2e

namespace {

constexpr int kC = 4;                  // channels a group (fv::Raw4)
constexpr int kHalves = 2;             // warps a channel, a share of its states
constexpr int kGroups = 4;             // channel groups a block walks, at most
constexpr int kSteps = 8;              // consecutive steps a lane
constexpr int kSpan = 32 * kSteps;     // steps a block (and a warp)
constexpr int kWarps = kC * kHalves;
constexpr int kThreads = 32 * kWarps;  // one a step when staging
static_assert(kThreads == kSpan, "staging takes a thread a step");

struct LanesArgs {
  const void *u, *delta, *Bm, *Cm;
  const float *A, *bias, *D;
  void* out;
  // (batch, nspans, d, n) words: each span's inclusive state in the low
  // 32 bits, 1 above them once it is there; then the ticket counter
  unsigned long long* states;
  int L, d, nspans, batch;
  int per_block;  // channel groups a block walks: kGroups, fewer for
                  // short scans, so that the grid still fills the card
  bool softplus;
};

// Where step t of a span lies in a staged row of a type with kPer
// elements to 16 bytes: each lane's 8 steps as 16-byte pieces, piece p of
// every lane side by side, so that a warp reading one piece of each lane
// reads 512 contiguous bytes (no bank conflicts).
template <int kPer>
__device__ __forceinline__ int staged(int t) {
  const int lane = t / kSteps, k = t % kSteps;
  return (k / kPer) * (32 * kPer) + lane * kPer + k % kPer;
}

// A lane's 8 steps of a staged row, widened to fp32
__device__ __forceinline__ void lane_steps(const float* row, int lane,
                                           float* f) {
  const float4 a = reinterpret_cast<const float4*>(row)[lane];
  const float4 b = reinterpret_cast<const float4*>(row + 32 * 4)[lane];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void lane_steps(const __nv_bfloat16* row,
                                           int lane, float* f) {
  fv::widen16<__nv_bfloat16>(reinterpret_cast<const uint4*>(row)[lane], f);
}

template <typename T, int N>
struct LanesSmem {
  // a channel group's steps, two buffers: the next group's are staged
  // while this one's last reads finish
  T u[2][kC][kSpan];
  alignas(16) float dt[2][kC][kSpan];  // softplus(delta + bias), staged<4>
  alignas(16) float x[2][kC][kSpan];   // dt · u, staged<4>
  float a2[2][kC][N];                  // A · log2 e
  // the span's B and C, for every group
  alignas(16) T B[N][kSpan];           // staged<kVec<T>>
  alignas(16) T C[N][kSpan];
  float2 lane_in[kWarps][N / kHalves][32];  // (Ae, Be) of each lane
  float2 tot[kC][N];                   // the span's (Π a, h_end from 0)
  float h_in[kC][N];                   // the state entering the span
  alignas(16) float y[kHalves][kC][kSpan];  // each share's Σ h·C, staged<4>
  int ticket;
};

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
scan_lanes_kernel(const LanesArgs a) {
  using Raw = typename fv::Raw4<T>::type;  // a group's kC = 4 channels
  constexpr int kVe = fv::kVec<T>;         // elements a 16-byte vector
  constexpr int kBcVec = N / kVe;          // vectors a B or C row
  constexpr int kHN = N / kHalves;         // states a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<LanesSmem<T, N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int groups = a.d / kC;                           // of an image
  const int sets = (groups + a.per_block - 1) / a.per_block;  // a block's

  // which span of which (image, set of channel groups): the ticket's
  if (tid == 0)
    sm.ticket = atomicAdd(reinterpret_cast<unsigned*>(
        a.states + static_cast<size_t>(a.batch) * a.nspans * a.d * N), 1u);
  __syncthreads();
  const int per_span = a.batch * sets;
  const int span = sm.ticket / per_span;
  const int b = sm.ticket % per_span / sets, set = sm.ticket % sets;
  const int g0 = set * a.per_block, ng = min(a.per_block, groups - g0);
  const int t0 = span * kSpan;
  const int len = min(kSpan, a.L - t0);
  const size_t row0 = static_cast<size_t>(b) * a.L + t0;  // first token

  // the span's B and C, once for all groups: a state a row
  {
    const T* Bm = static_cast<const T*>(a.Bm);
    const T* Cm = static_cast<const T*>(a.Cm);
    for (int i = tid; i < 2 * kSpan * kBcVec; i += kThreads) {
      const int q = i % kBcVec, ts = (i / kBcVec) % kSpan;
      const bool is_c = i >= kSpan * kBcVec;
      const size_t tk = row0 + min(ts, len - 1);
      alignas(16) T f[kVe];
      *reinterpret_cast<uint4*>(f) =
          fv::load16((is_c ? Cm : Bm) + tk * N + q * kVe);
      T(*dst)[kSpan] = is_c ? sm.C : sm.B;
#pragma unroll
      for (int e = 0; e < kVe; ++e) dst[q * kVe + e][staged<kVe>(ts)] = f[e];
    }
  }

  // a thread a step: its token's u and delta
  const size_t tok = row0 + min(tid, len - 1);
  const T* u_tok = static_cast<const T*>(a.u) + tok * a.d;
  const T* d_tok = static_cast<const T*>(a.delta) + tok * a.d;

  const int ch = warp % kC, half = warp / kC;  // the warp's channel, share
  for (int gi = 0; gi < ng; ++gi) {
    const int c0 = (g0 + gi) * kC, buf = gi & 1;
    // stage the group, time-last: softplus and dt · u once for the states
    // of all warps (steps past L become the identity: dt = 0, x = 0)
    {
      alignas(16) T uv[kC], dv[kC];
      *reinterpret_cast<Raw*>(uv) = fv::load4(u_tok + c0);
      *reinterpret_cast<Raw*>(dv) = fv::load4(d_tok + c0);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float dt = fv::to_f32(dv[c]) + (a.bias ? __ldg(a.bias + c0 + c) : 0.f);
        if (a.softplus) dt = fv::softplus(dt);
        const float uu = tid < len ? fv::to_f32(uv[c]) : 0.f;
        dt = tid < len ? dt : 0.f;
        sm.u[buf][c][tid] = fv::from_f32<T>(uu);
        sm.dt[buf][c][staged<4>(tid)] = dt;
        sm.x[buf][c][staged<4>(tid)] = dt * uu;
      }
      for (int i = tid; i < kC * N; i += kThreads)
        sm.a2[buf][i / N][i % N] =
            a.A[static_cast<size_t>(c0) * N + i] * kLog2e;
    }
    __syncthreads();

    // the lane's walk: warp = (share, channel), lane = 8 steps, kHN states
    float dt[kSteps], x[kSteps], y[kSteps];
    lane_steps(sm.dt[buf][ch], lane, dt);
    lane_steps(sm.x[buf][ch], lane, x);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) y[k] = 0.f;
    float pc[kHN][kSteps];        // P[k]·C of each state
    float bt[kHN];  // the lane's state from 0, then its prefix's
#pragma unroll
    for (int j = 0; j < kHN; ++j) {
      const int s = half * kHN + j;
      const float a2 = sm.a2[buf][ch][s];
      float Bk[kSteps], Ck[kSteps];
      lane_steps(sm.B[s], lane, Bk);
      lane_steps(sm.C[s], lane, Ck);
      float P = 1.f, S = 0.f;
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const float ak = ex2(dt[k] * a2);
        P *= ak;
        S = fmaf(ak, S, x[k] * Bk[k]);
        y[k] = fmaf(S, Ck[k], y[k]);
        pc[j][k] = P * Ck[k];
      }
      bt[j] = S;
    }
    // doubling scan of the lane totals across the warp, all states side by
    // side: b of lane l becomes that of lanes ..l composed in order. The
    // product of a over a window of lanes is exp(A·Σ dt) over it, and the
    // window's Σ dt is the same for every state: one sum w, doubled
    // alongside, and an ex2 a state where the pair scan shuffled a
    float w = 0.f;  // Σ dt of the lanes the window holds: this lane's
#pragma unroll
    for (int k = 0; k < kSteps; ++k) w += dt[k];
    float a2s[kHN];
#pragma unroll
    for (int j = 0; j < kHN; ++j) a2s[j] = sm.a2[buf][ch][half * kHN + j];
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      float b_sh[kHN];
#pragma unroll
      for (int j = 0; j < kHN; ++j)
        b_sh[j] = __shfl_up_sync(0xffffffffu, bt[j], k);
      const float w_sh = __shfl_up_sync(0xffffffffu, w, k);
      if (lane >= k) {
#pragma unroll
        for (int j = 0; j < kHN; ++j)
          bt[j] = fmaf(ex2(a2s[j] * w), b_sh[j], bt[j]);
        w += w_sh;
      }
    }
    float w_in = __shfl_up_sync(0xffffffffu, w, 1);  // Σ dt before the lane
    if (lane == 0) w_in = 0.f;
#pragma unroll
    for (int j = 0; j < kHN; ++j) {
      const int s = half * kHN + j;
      float be = __shfl_up_sync(0xffffffffu, bt[j], 1);
      if (lane == 0) be = 0.f;
      sm.lane_in[warp][j][lane] = make_float2(ex2(a2s[j] * w_in), be);
      if (lane == 31) sm.tot[ch][s] = make_float2(ex2(a2s[j] * w), bt[j]);
    }
    __syncthreads();

    // the span: the state entering it, and the one it hands on
    const int cs = tid / N, s = tid % N;     // (channel, state) of the span
    const size_t carry = ((static_cast<size_t>(b) * a.nspans + span) * a.d +
                          c0 + cs) * N + s;
    if (tid < kC * N) {
      const float2 t = sm.tot[cs][s];
      float h = 0.f;
      if (span > 0) {
        unsigned long long w;
        while (((w = ld_acquire(a.states + carry - static_cast<size_t>(a.d) *
                                                       N)) >> 32) == 0) {
        }
        h = __uint_as_float(static_cast<unsigned>(w));
      }
      st_release(a.states + carry,
                 (1ull << 32) | __float_as_uint(fmaf(t.x, h, t.y)));
      sm.h_in[cs][s] = h;
    }
    __syncthreads();

    // y += Σ_s P[k]·C·(state entering the lane)
#pragma unroll
    for (int j = 0; j < kHN; ++j) {
      const float2 in = sm.lane_in[warp][j][lane];
      const float h = fmaf(in.x, sm.h_in[ch][half * kHN + j], in.y);
#pragma unroll
      for (int k = 0; k < kSteps; ++k) y[k] = fmaf(pc[j][k], h, y[k]);
    }
    float4* yh = reinterpret_cast<float4*>(sm.y[half][ch]);
    yh[lane] = make_float4(y[0], y[1], y[2], y[3]);
    yh[32 + lane] = make_float4(y[4], y[5], y[6], y[7]);
    __syncthreads();
    if (tid < len) {  // a thread a step: the shares' sums, the D·u skip
      alignas(16) T v[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float Dv = a.D ? __ldg(a.D + c0 + c) : 0.f;
        float yc = sm.y[0][c][staged<4>(tid)];
#pragma unroll
        for (int hf = 1; hf < kHalves; ++hf)
          yc += sm.y[hf][c][staged<4>(tid)];
        v[c] = fv::from_f32<T>(yc + Dv * fv::to_f32(sm.u[buf][c][tid]));
      }
      *reinterpret_cast<Raw*>(static_cast<T*>(a.out) + (row0 + tid) * a.d +
                              c0) = *reinterpret_cast<Raw*>(v);
    }
  }
}

template <typename T, int N>
cudaError_t launch(LanesArgs a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(LanesSmem<T, N>);
  static_assert(smem <= fv::kMaxSmem, "lanes: shared memory");
  // the most groups a block whose grid still gives each SM two blocks
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int groups = a.d / kC;
  const auto blocks = [&](int g) {
    return static_cast<long>(a.batch) * ((groups + g - 1) / g) * a.nspans;
  };
  a.per_block = kGroups;
  while (a.per_block > 1 && blocks(a.per_block) < 2L * sms) a.per_block /= 2;
  const int sets = (groups + a.per_block - 1) / a.per_block;
  err = cudaMemsetAsync(
      a.states, 0,
      (static_cast<size_t>(a.batch) * a.nspans * a.d * N + 1) *
          sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return err;
  err = fv::allow_max_smem<scan_lanes_kernel<T, N>>();
  if (err != cudaSuccess) return err;
  scan_lanes_kernel<T, N>
      <<<static_cast<unsigned>(a.batch * sets * a.nspans), kThreads, smem,
         stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// u, delta: (batch, L, d) and B, C: (batch, L, n), all of `dtype` (0 fp32,
// 1 bf16), contiguous and 16-byte aligned; d % 4 == 0, n 8 or 16; A: (d, n)
// fp32; bias, D: (d,) fp32 or null; out: (batch, L, d) of `dtype`. Forward
// direction only. Scratch: states, batch · ceil(L / 256) · d · n + 1
// 64-bit words; a memset of them and one kernel on `stream`. Returns a
// cudaError_t.
extern "C" int fv_selective_scan_fwd_lanes(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* bias, const void* D, void* out, void* states,
    int batch, int L, int d, int n, int dtype, int softplus, void* stream) {
  if (batch < 1 || batch > 65535 || L < 0 || d < kC || d % kC != 0 ||
      (n != 8 && n != 16) || !states)
    return cudaErrorInvalidValue;
  if (L == 0) return cudaSuccess;
  const long nspans = (static_cast<long>(L) + kSpan - 1) / kSpan;
  if (batch * (d / kC) * nspans >= (1L << 31))
    return cudaErrorInvalidValue;
  LanesArgs a{u, delta, B, C, static_cast<const float*>(A),
              static_cast<const float*>(bias), static_cast<const float*>(D),
              out, static_cast<unsigned long long*>(states), L,
              d, static_cast<int>(nspans), batch, kGroups, softplus != 0};
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (n == 16)) {
    case 0: return launch<float, 8>(a, st);
    case 1: return launch<float, 16>(a, st);
    case 2: return launch<__nv_bfloat16, 8>(a, st);
    case 3: return launch<__nv_bfloat16, 16>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
