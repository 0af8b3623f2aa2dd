// K10: broadcast + D-skip + merge + LayerNorm + gate of the unfused mixer
// path from materialized conv outputs, for Hopper (sm_90a).
//
// Replaces `_kernel` of fastvim_tpu/ops/pallas/merge_gate.py:
//   m = ½(yf + D_f·xc_f + yb + D_b·xc_b);  LayerNorm over d with fp32
//   statistics (or m as it is);  × silu(z);  written in xc_f's type.
// yf and yb are the pooled scan outputs, (batch, P, d): with `along_w`
// (pool_axes = (1,), even layers) token (h, w) reads pooled row h, without
// it (pool_axes = (0,), the odd layers' in-place orientation) pooled
// column w, so a row of W tokens lines up with the whole pooled sequence.
//
// What bounds it on the H100: bytes. It reads xc_f, xc_b and z and writes
// out once, 8 bytes an element in bf16 (about 101 MB at FastVim-T's
// 2048 px widths, B = 2, d 384: 0.030 ms at 3.35 TB/s), and does ~25 fp32
// operations an element. What reaches that rate is enough bytes in
// flight: tens of KB an SM.
//
// Design: a register-resident stream.
// - A team of G threads owns a token: each thread holds K 16-byte pieces
//   of its channels (8 bf16 or 4 fp32 values a piece), pieces tl + G·k.
//   K and G come from `ln_gate_plan` (ops/kernels/merge_gate.py): the
//   registry's widths fit exactly (bf16 d 384: K 3, G 16; 768: 3, 32;
//   1536: 3, 64; 2048: 2, 128; 2560: 2, 160; fp32 G twice that), any
//   other d % 32 up to kMaxD takes K = 1 (or 2 past 512 threads) with G
//   rounded up, its spare pieces read at a valid address and masked out.
// - The grid is persistent (one wave, from the occupancy API). A team
//   walks units: a segment of one line of tokens that share their pooled
//   row (a grid row along w, a grid column otherwise), so ½(yf + yb) is
//   loaded once a unit and kept in registers, and D_f, D_b, ln_w and ln_b
//   once for the whole kernel.
// - A token's xc_f, xc_b and z pieces are all issued before any is used,
//   and the next token's under this token's arithmetic.
// - LayerNorm takes Σm, then Σ(m − μ)² (the variance as the mean of
//   (m − μ)², as the plain version does; the TPU kernel takes E[m²] − μ²),
//   from registers: a butterfly of shuffles inside the warp, and where a
//   team spans warps (G > 32: the block is one team) the warps' sums from
//   shared memory in warp order. Every sum has one order: two calls give
//   the same bits.
// - One 16-byte store a piece. z may be a column slice of the
//   in-projection's output, `ldz` elements a token; where that leaves it
//   short of 16-byte alignment its pieces load as pairs (4 bytes of bf16,
//   8 of fp32).
// - silu(z): in bf16 v · sigmoid(v) on the fast exp and divide, in fp32
//   the exact v / (1 + e^-v) of the plain version (silu_k10).
//
// The design before this one: one warp a token, a lane walking channel
// pairs with 4-byte loads in a loop that waited on each pass's loads, the
// vectors fetched again for every token and m staged through shared
// memory.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxD = 4096;           // the widest d (merge_gate.MAX_D)
constexpr int kSmallTeamBlock = 256;  // threads a block where G <= 32

// Threads a block may have with K pieces a thread: the kernel's
// __launch_bounds__, which sets the registers a thread may take (ptxas:
// K 3 255 in bf16, 170 in fp32; K 2 spilled in bf16 at 512). Mirrored by
// merge_gate.ln_gate_max_threads.
template <typename T, int K>
constexpr int max_threads() {
  return K == 3 ? 256 : K == 2 ? (sizeof(T) == 4 ? 512 : 256) : 512;
}

struct MergeArgs {
  const void *xc_f, *xc_b, *z, *yf, *yb;
  const float *d_f, *d_b, *ln_w, *ln_b;
  void* out;
  long ldz;         // elements between z's tokens
  long L;           // tokens an image
  long line_step;   // token index between lines (W along w, else 1)
  long tok_step;    // ... between a line's tokens (1 along w, else W)
  long units;       // batch · lines · nseg
  int lines;        // P: lines an image, one pooled row each
  int line_len;     // tokens a line
  int seg, nseg;    // tokens a unit, units a line
  int d, pieces;    // channels, 16-byte pieces a token
  int team;         // G: threads a token
  bool use_ln;
  float eps;
};

// 16 bytes of T, as one vector or, where z is not 16-byte aligned, as
// pairs of elements
template <typename T, bool kVec16>
__device__ __forceinline__ uint4 load_piece(const T* p) {
  if constexpr (kVec16) {
    return fv::load16(p);
  } else if constexpr (sizeof(T) == 2) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    return make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
  } else {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 lo = __ldg(q), hi = __ldg(q + 1);
    return make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// silu(v): in bf16 as v · sigmoid(v) on the fast exp and divide (~2^-21
// relative error; the exact form's IEEE divide and expf took K10 from
// 0.040 to 0.046 ms at FastVim-T's widths on the H100), exact in fp32
template <typename T>
__device__ __forceinline__ float silu_k10(float v) {
  if constexpr (sizeof(T) == 2) return v * fv::sigmoid_fast(v);
  else return fv::silu(v);
}

__device__ __forceinline__ void store_piece(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_piece(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = fv::pack8(f);
}

// Σ v over a team of G threads in one order: a butterfly inside the warp
// (every lane ends with the same bits), then, where the team is the
// block (G > 32), the warps' sums from s_red in warp order. The caller
// alternates two s_red buffers, so one barrier a sum is enough.
__device__ __forceinline__ float team_sum(float v, int G, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < G) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (G > 32) {
    if (threadIdx.x % 32 == 0) s_red[threadIdx.x / 32] = v;
    __syncthreads();
    v = s_red[0];
    for (int w = 1; w < G / 32; ++w) v += s_red[w];
  }
  return v;
}

template <typename T, int K, bool kZVec>
__global__ void __launch_bounds__(max_threads<T, K>())
merge_ln_gate_kernel(const MergeArgs a) {
  constexpr int V = fv::kVec<T>;
  __shared__ float s_red[2][32];
  const T* xc_f = static_cast<const T*>(a.xc_f);
  const T* xc_b = static_cast<const T*>(a.xc_b);
  const T* z = static_cast<const T*>(a.z);
  const T* yf = static_cast<const T*>(a.yf);
  const T* yb = static_cast<const T*>(a.yb);
  T* out = static_cast<T*>(a.out);
  const int G = a.team, d = a.d;
  const int teams_block = blockDim.x / G;
  const int tl = threadIdx.x % G;
  const long nteams = static_cast<long>(gridDim.x) * teams_block;

  // this thread's channels for the whole kernel, and their vectors
  int c0[K];
  float live[K], hf[K][V], hb[K][V], lw[K][V], lb[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = tl + G * k;
    live[k] = p < a.pieces ? 1.f : 0.f;
    c0[k] = min(p, a.pieces - 1) * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = c0[k] + v;
      hf[k][v] = 0.5f * __ldg(a.d_f + c);
      hb[k][v] = 0.5f * __ldg(a.d_b + c);
      lw[k][v] = a.ln_w ? __ldg(a.ln_w + c) : 1.f;
      lb[k][v] = a.ln_b ? __ldg(a.ln_b + c) : 0.f;
    }
  }

  const long units_img = static_cast<long>(a.lines) * a.nseg;
  for (long unit = static_cast<long>(blockIdx.x) * teams_block +
                   threadIdx.x / G;
       unit < a.units; unit += nteams) {
    const long b = unit / units_img, r = unit % units_img;
    const int line = static_cast<int>(r / a.nseg);
    const int j0 = static_cast<int>(r % a.nseg) * a.seg;
    const int n = min(a.seg, a.line_len - j0);
    const size_t t0 = static_cast<size_t>(b) * a.L + line * a.line_step +
                      static_cast<size_t>(j0) * a.tok_step;
    const size_t prow = (static_cast<size_t>(b) * a.lines + line) * d;

    // the line's pooled rows: ½(yf + yb), kept for the unit
    float s[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float f[V], g[V];
      fv::widen16<T>(fv::load16(yf + prow + c0[k]), f);
      fv::widen16<T>(fv::load16(yb + prow + c0[k]), g);
#pragma unroll
      for (int v = 0; v < V; ++v) s[k][v] = 0.5f * (f[v] + g[v]);
    }

    // a token's pieces, the next token's loaded under this one's math
    uint4 nf[K], nb[K], nz[K];
    auto fetch = [&](int j) {
      const size_t t = t0 + static_cast<size_t>(j) * a.tok_step;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        nf[k] = fv::load16(xc_f + t * d + c0[k]);
        nb[k] = fv::load16(xc_b + t * d + c0[k]);
        nz[k] = load_piece<T, kZVec>(z + t * a.ldz + c0[k]);
      }
    };
    fetch(0);
    for (int j = 0; j < n; ++j) {
      uint4 rf[K], rb[K], rz[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        rf[k] = nf[k];
        rb[k] = nb[k];
        rz[k] = nz[k];
      }
      fetch(min(j + 1, n - 1));  // the last token loads itself again
      float m[K][V], sum = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float f[V], g[V];
        fv::widen16<T>(rf[k], f);
        fv::widen16<T>(rb[k], g);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          m[k][v] = live[k] * fmaf(hb[k][v], g[v],
                                   fmaf(hf[k][v], f[v], s[k][v]));
          sum += m[k][v];
        }
      }
      float mu = 0.f, rstd = 1.f;
      if (a.use_ln) {
        mu = team_sum(sum, G, s_red[0]) / static_cast<float>(d);
        float ss = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float e = live[k] * (m[k][v] - mu);
            ss = fmaf(e, e, ss);
          }
        rstd = rsqrtf(team_sum(ss, G, s_red[1]) / static_cast<float>(d) +
                      a.eps);
      }
      const size_t t = t0 + static_cast<size_t>(j) * a.tok_step;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float zz[V], o[V];
        fv::widen16<T>(rz[k], zz);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float y = a.use_ln
              ? fmaf((m[k][v] - mu) * rstd, lw[k][v], lb[k][v]) : m[k][v];
          o[v] = y * silu_k10<T>(zz[v]);
        }
        if (live[k] != 0.f) store_piece(out + t * d + c0[k], o);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int K, bool kZVec>
cudaError_t launch_k(MergeArgs a, long batch, cudaStream_t stream) {
  auto kernel = merge_ln_gate_kernel<T, K, kZVec>;
  const int threads = a.team <= 32 ? kSmallTeamBlock : a.team;
  if (threads > max_threads<T, K>()) return cudaErrorInvalidValue;
  int sms, blocks;
  cudaError_t err = fv::residency<merge_ln_gate_kernel<T, K, kZVec>>(
      threads, 0, &sms, &blocks);
  if (err != cudaSuccess) return err;
  // one unit a team where the tokens allow: segments of a line as long
  // as the tokens over the teams of one wave
  const int teams_block = threads / a.team;
  const long teams = static_cast<long>(sms) * blocks * teams_block;
  const long per_team = (batch * a.L + teams - 1) / teams;
  a.seg = static_cast<int>(std::min<long>(std::max<long>(per_team, 1),
                                          a.line_len));
  a.nseg = (a.line_len + a.seg - 1) / a.seg;
  a.units = batch * a.lines * a.nseg;
  const long grid = std::min<long>((a.units + teams_block - 1) / teams_block,
                                   static_cast<long>(sms) * blocks);
  kernel<<<static_cast<unsigned>(grid), threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(MergeArgs a, long batch, int K, cudaStream_t stream) {
  constexpr int V = fv::kVec<T>;
  if (a.d % V != 0 || static_cast<long>(K) * a.team * V < a.d ||
      !aligned16(a.xc_f) || !aligned16(a.xc_b) || !aligned16(a.yf) ||
      !aligned16(a.yb) || !aligned16(a.out))
    return cudaErrorInvalidValue;
  a.pieces = a.d / V;
  const bool zvec = aligned16(a.z) && (a.ldz * sizeof(T)) % 16 == 0;
  switch (K * 2 + zvec) {
    case 2: return launch_k<T, 1, false>(a, batch, stream);
    case 3: return launch_k<T, 1, true>(a, batch, stream);
    case 4: return launch_k<T, 2, false>(a, batch, stream);
    case 5: return launch_k<T, 2, true>(a, batch, stream);
    case 6: return launch_k<T, 3, false>(a, batch, stream);
    case 7: return launch_k<T, 3, true>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xc_f, xc_b: (batch, H·W, d) contiguous; z the same shape with tokens
// `ldz` elements apart (ldz >= d, even, z on a 2-element boundary); yf,
// yb: (batch, P, d), P = H with `along_w` else W, all of `dtype` (0 fp32,
// 1 bf16); xc_f, xc_b, yf, yb and out 16-byte aligned. d_f, d_b: (d,)
// fp32; ln_w, ln_b: (d,) fp32 or null (1 / 0). out: (batch, H·W, d) of
// `dtype`. d % 32 == 0, d <= 4096. `pieces` (K, 1 to 3) and `team` (G, a
// power of 2 up to 32 or a multiple of 32) are ln_gate_plan's: K·G
// 16-byte pieces must cover d. Returns a cudaError_t.
extern "C" int fv_merge_ln_gate_fwd(const void* xc_f, const void* xc_b,
                                    const void* z, const void* yf,
                                    const void* yb, const void* d_f,
                                    const void* d_b, const void* ln_w,
                                    const void* ln_b, void* out, int batch,
                                    int H, int W, int d, int ldz, int along_w,
                                    int dtype, int use_ln, int pieces,
                                    int team, float eps, void* stream) {
  if (batch < 1 || H < 1 || W < 1 || d < 32 || d % 32 != 0 || d > kMaxD ||
      ldz < d || ldz % 2 != 0 || team < 1 ||
      (team > 32 ? team % 32 != 0 : (team & (team - 1)) != 0))
    return cudaErrorInvalidValue;
  MergeArgs a{};
  a.xc_f = xc_f; a.xc_b = xc_b; a.z = z; a.yf = yf; a.yb = yb;
  a.d_f = static_cast<const float*>(d_f);
  a.d_b = static_cast<const float*>(d_b);
  a.ln_w = static_cast<const float*>(ln_w);
  a.ln_b = static_cast<const float*>(ln_b);
  a.out = out;
  a.ldz = ldz;
  a.L = static_cast<long>(H) * W;
  a.lines = along_w ? H : W;
  a.line_len = along_w ? W : H;
  a.line_step = along_w ? W : 1;
  a.tok_step = along_w ? 1 : W;
  a.d = d;
  a.team = team;
  a.use_ln = use_ln != 0;
  a.eps = eps;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fv::kF32:
      return launch<float>(a, batch, pieces, st);
    case fv::kBF16:
      return launch<__nv_bfloat16>(a, batch, pieces, st);
    default:
      return cudaErrorInvalidValue;
  }
}
