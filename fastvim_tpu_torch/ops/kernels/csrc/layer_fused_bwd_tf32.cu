// K5 and K6 in fp32, for Hopper (sm_90a): the adjoints of the two passes
// of the fused FastVim mixer layer with every product on the tensor cores
// in split precision (3xTF32, tf32.cuh: mma.sync m16n8k8, each k-step's
// three products summed in a fresh register tile that is added in fp32).
// What they compute and the TPU kernels they replace are set out at the
// head of layer_fused_bwd.cu; this file is how the fp32 path computes it.
//
// What bounds it: the products. At FastVim-B's widths (d_model 768,
// d_inner 1536) K5 does five GEMMs of T × 768 × 1536 (z again, dgated,
// dx̂'s z half, dW_out, dW_z) and K6 three (xin again, dxin·W_x, dW_x); in
// 3xTF32 each runs at a third of the TF32 rate. The elementwise parts
// (LayerNorm and gate backward, the dual-conv adjoint) move a few T ×
// d_inner arrays and are bound by bytes.
//
// The design. One hand-written product kernel (`gemm_tf32_kernel`: a
// 128 × 128 tile of C a block, K in stages of 32 through a ring of three
// cp.async stages, 8 warps of 32 × 64, the operands' fragments split in
// registers) serves every product but K6's xin, in three layouts: A
// row-major or K-major, B N-major or K-major, so that the weights and the
// activations are read as they lie (no transposed copies). The weight
// gradients contract over tokens: split-K over token slices, each block's
// partial kept in registers and written once, the slices added in a fixed
// order by `sum_segments_kernel` (layer_fused_bwd.cuh).
//
// K5, in six launches:
// 1. z = x̂·W_zᵀ into the dz scratch, 2. dgated = g·W_out into mg's;
// 3. `pass_b_bwd_mid_kernel`: a block owns a run of whole lines of one
//    image (or one longer line in segments) × all of d_inner; a warp a
//    token forms m0's LayerNorm statistics, then the gate's and the
//    LayerNorm's backward a channel at a time, writing dz over z and mg =
//    mln·silu(z) over dgated (the products' operands) and parking dmln in
//    dxc_f, and sums Σdm̂, Σdm̂·m̂ over the row; then a thread per 4
//    channels walks the run's tokens in order: dm0, dxc_f, dxc_b, the line
//    sums dy (which never leave the block; a line in segments carries its
//    sum from one segment to the next), and the block's column sums;
// 4. dx̂ (z half) = dz·W_z; 5. dW_outᵀ = mgᵀ·g and dW_z = dzᵀ·x̂ in one
//    launch; 6. the fixed-order sums.
// z and dgated go through device memory (the mg and dz scratch, which the
// weight gradients read anyway) so that one product kernel serves all
// five products and the LayerNorm's row sums are taken a warp a row.
//
// K6, in four launches:
// 1. `pass_a_bwd_tf32_kernel`, K3's fp32 form (layer_fused_fwd_tf32.cu)
//    run backwards: a block owns a run of whole lines (or a segment of a
//    longer line) with 3 halo tokens each side × 128 channels, recomputes
//    xin = x̂·W_xᵀ + b_x for them on the tensor cores into shared memory
//    (one flat conv-order index gives the halos, the odd layers' wrap and
//    the image boundary, masked before any load), then a thread a channel
//    walks half of the own rows with the 7 xin rows, 4 causal and 4
//    anticausal cotangents it needs in registers: the pool and SiLU
//    backward, dxin (written once), the conv weight and bias sums;
// 2. dx̂ = dx̂(K5) + dxin·W_x; 3. dW_x = dxinᵀ·x̂; 4. the fixed-order sums.
//
// No atomics anywhere: the results are the same from run to run.

#include <climits>
#include <cstdint>

#include "layer_fused_bwd.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"  // cp.async, the ring of stages

namespace {

using fv::cp_async16;
using fv::kMaxSmem;
using fv::smem_u32;
using fvb::kCVec;

constexpr int kThreads = 256;  // 8 warps
constexpr int kPad = 3;        // d_conv - 1

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <auto Kernel, typename... Args>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<Kernel>();
  if (err != cudaSuccess) return err;
  Kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// A block owns `nl` consecutive lines of one image (the last run of an
// image may hold fewer) and walks them in segments of `seg` own tokens:
// nl whole lines in one segment where a line fits `cap` tokens, else one
// line in balanced segments.
struct Runs {
  int nl, seg;
};
inline Runs runs_of(int P, int ln, int cap) {
  if (ln <= cap) {
    const int nl = imin(P, cap / ln);
    return {nl, nl * ln};
  }
  return {1, cdiv(ln, cdiv(ln, cap))};
}

// =====================================================================
// the products: C = A·B (+ add) in split precision
// =====================================================================
constexpr int kGM = 128;         // rows of C a block
constexpr int kGN = 128;         // columns of C a block
constexpr int kGK = 32;          // K of a stage
constexpr int kGLdR = kGK + 4;   // a staged row of K values, skewed
constexpr int kGLdK = kGM + 8;   // a staged K row of M or N values, skewed
constexpr int kGOp = kGM * kGLdR;  // floats of an operand's stage
constexpr int kGStages = 3;
constexpr size_t kGSmem =
    static_cast<size_t>(kGStages) * 2 * kGOp * sizeof(float);
static_assert(kGK * kGLdK <= kGOp, "either layout fits an operand's stage");
static_assert(kGN == kGM, "B's stage has A's layouts");

struct GemmJob {
  const float* a;    // (M, K), or K-major (K, M)
  const float* b;    // (N, K), or K-major (K, N)
  const float* add;  // (M, N) or null
  float* c;          // (M, N); with nsplit > 1, (nsplit, M, N) partials
};

// Copy rows [r0, r0 + 128) × K values [k0, k0 + 32) of an operand with R
// rows into a stage at shared address dst: K-major (kKM), src is (K, R)
// row-major and the stage [kGK][kGLdK]; else src is (R, K) and the stage
// [128][kGLdR]. Rows past R and K values past kend are zero-filled and not
// read. R % 4 == 0, and K % 4 == 0 where K is the contiguous axis.
template <bool kKM>
__device__ __forceinline__ void stage_operand(uint32_t dst, const float* src,
                                              int R, int K, int r0, int k0,
                                              int kend, int tid) {
  if (kKM) {
    const int ch = tid & 31;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int kr = (tid >> 5) + 8 * it;
      const bool ok = k0 + kr < kend && r0 + 4 * ch < R;
      cp_async16(dst + (kr * kGLdK + 4 * ch) * 4,
                 src + (ok ? static_cast<size_t>(k0 + kr) * R + r0 + 4 * ch
                           : 0),
                 ok);
    }
  } else {
    const int ch = tid & 7;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = (tid >> 3) + 32 * it;
      const bool ok = r0 + r < R && k0 + 4 * ch < kend;
      cp_async16(dst + (r * kGLdR + 4 * ch) * 4,
                 src + (ok ? static_cast<size_t>(r0 + r) * K + k0 + 4 * ch
                           : 0),
                 ok);
    }
  }
}

// A block computes a 128 × 128 tile of C over the K range of its split:
// grid (N tiles, M tiles, jobs × nsplit), the N tiles of an M tile
// neighbours in the launch order, so that they read its A rows from L2.
// Warp (wm, wn) = (warp % 4, warp / 4) owns rows 32wm.. and columns
// 64wn.. of the tile. N % 64 == 0.
template <bool kAKM, bool kBKM>
__global__ void __launch_bounds__(kThreads, 2)
gemm_tf32_kernel(GemmJob j0, GemmJob j1, int M, int N, int K, int nsplit,
                 int kper) {
  extern __shared__ __align__(16) float smem_g[];
  const uint32_t ring_base = smem_u32(smem_g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kGN, m0 = blockIdx.y * kGM;
  const GemmJob job = static_cast<int>(blockIdx.z) < nsplit ? j0 : j1;
  const int split = blockIdx.z % nsplit;
  const int kbeg = split * kper, kend = imin(K, kbeg + kper);
  const int nk = kend > kbeg ? cdiv(kend - kbeg, kGK) : 0;

  auto fetch = [&](int s, uint32_t dst) {
    if (s >= nk) return;
    const int k0 = kbeg + s * kGK;
    stage_operand<kAKM>(dst, job.a, M, K, m0, k0, kend, tid);
    stage_operand<kBKM>(dst + kGOp * 4, job.b, N, K, n0, k0, kend, tid);
  };
  fv::Ring<kGStages, 2 * kGOp * 4, decltype(fetch)> ring(ring_base, fetch);
  ring.start();

  const int wm = warp & 3, wn = warp >> 2;
  const bool n_on = n0 + 64 * wn < N;
  const bool m_on[2] = {m0 + 32 * wm < M, m0 + 32 * wm + 16 < M};
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    const float* sa = smem_g + (ring.acquire() - ring_base) / 4;
    const float* sb = sa + kGOp;
    if (n_on && m_on[0]) {
      // k-steps not unrolled: unrolled, the compiler hoists their
      // fragment loads and spills 232-240 bytes at 128 registers (5-7 %
      // slower at FastVim-B, 224 px)
#pragma unroll 1
      for (int kk = 0; kk < kGK / 8; ++kk) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!m_on[i]) continue;
          const int r = 32 * wm + 16 * i;
          if (kAKM)
            frag_a_k(sa + 8 * kk * kGLdK + r, kGLdK, lane, ah[i], al[i]);
          else
            frag_a(sa + r * kGLdR + 8 * kk, kGLdR, lane, ah[i], al[i]);
        }
#pragma unroll
        // n-tiles 2 at a time: the fewest live registers, for two blocks
        // an SM
        for (int jp = 0; jp < 8; jp += 2) {
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = 64 * wn + 8 * (jp + j);
            if (kBKM)
              frag_b_k(sb + 8 * kk * kGLdK + col, kGLdK, lane, bh[j], bl[j]);
            else
              frag_b(sb + col * kGLdR + 8 * kk, kGLdR, lane, bh[j], bl[j]);
          }
          mma3<2, 2>(&acc[0][jp][0], 8, m_on, ah, al, bh, bl);
        }
      }
    }
    ring.refill();
  }

  if (!n_on) return;
  float* out = job.c + static_cast<size_t>(split) * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 32 * wm + 16 * i + g + 8 * e;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t o = static_cast<size_t>(row) * N + n0 + 64 * wn +
                         8 * j + 2 * t;
        float2 v = make_float2(acc[i][j][2 * e], acc[i][j][2 * e + 1]);
        if (job.add) {
          const float2 a = fv::ld_f2(job.add + o);
          v = make_float2(a.x + v.x, a.y + v.y);
        }
        *reinterpret_cast<float2*>(out + o) = v;
      }
    }
}

// C (M × N) of each of njobs jobs = A·B (+ add) in split precision, K
// split into nsplit slices of whole stages (a slice past K writes zeros)
template <bool kAKM, bool kBKM>
cudaError_t gemm(const GemmJob& j0, const GemmJob& j1, int njobs, int M,
                 int N, int K, int nsplit, cudaStream_t stream) {
  const int kper = cdiv(cdiv(K, nsplit), kGK) * kGK;
  if (cdiv(M, kGM) > 65535 || njobs * nsplit > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(cdiv(N, kGN), cdiv(M, kGM), njobs * nsplit);
  return launch<gemm_tf32_kernel<kAKM, kBKM>>(grid, kGSmem, stream, j0, j1,
                                              M, N, K, nsplit, kper);
}

// =====================================================================
// K5: the elementwise middle of pass B's adjoint
// =====================================================================
constexpr int kMRun = 64;  // own tokens of a K5 segment at most

// shared memory: per token of a segment its index and [mu, rstd, Σdm̂,
// Σdm̂·m̂]; the block's column sums [6][di] (db_z, dln_w, dln_b, dd_f,
// dd_b, and the dy a line in segments carries to the next) and db_out [dm]
inline size_t mid_smem(int dm, int di) {
  return kMRun * (sizeof(long) + 4 * sizeof(float)) +
         (6 * static_cast<size_t>(di) + dm) * sizeof(float);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
// what this kernel writes over: read from L2, past the read-only path
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void unpack(const float4& v, float (&f)[4]) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// m0 = ½(yf + D_f·xc_f + yb + D_b·xc_b) of 4 channels at c of one token
__device__ __forceinline__ void merge4(
    const float* __restrict__ xc_f, const float* __restrict__ xc_b,
    const float* __restrict__ yf, const float* __restrict__ yb,
    const float* __restrict__ d_f, const float* __restrict__ d_b, size_t o,
    size_t po, int c, float (&m)[4], float (&xf)[4], float (&xb)[4]) {
  float pf[4], pb[4], df[4], db[4];
  unpack(ld4(xc_f + o), xf);
  unpack(ld4(xc_b + o), xb);
  unpack(ld4(yf + po), pf);
  unpack(ld4(yb + po), pb);
  unpack(ld4(d_f + c), df);
  unpack(ld4(d_b + c), db);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    m[e] = (pf[e] + df[e] * xf[e] + pb[e] + db[e] * xb[e]) * 0.5f;
}

// zdz holds z without b_z and gets dz; gmg holds dgated and gets mg =
// mln·silu(z); dxc_f holds dmln between the two phases. grid (runs of an
// image, batch); the block's sums go to slot b·runs + run of vec_part.
__global__ void __launch_bounds__(kThreads)
pass_b_bwd_mid_kernel(const float* __restrict__ g,
                      const float* __restrict__ xc_f,
                      const float* __restrict__ xc_b,
                      const float* __restrict__ yf,
                      const float* __restrict__ yb,
                      const float* __restrict__ b_z,
                      const float* __restrict__ d_f,
                      const float* __restrict__ d_b,
                      const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b, float* zdz, float* gmg,
                      float* dxc_f, float* __restrict__ dxc_b,
                      float* __restrict__ dy, float* __restrict__ vec_part,
                      int H, int W, int dm, int di, bool transposed,
                      bool use_ln, float eps, int nl, int seg) {
  extern __shared__ __align__(16) unsigned char smem_m[];
  long* s_tok = reinterpret_cast<long*>(smem_m);                  // [kMRun]
  float* s_row = reinterpret_cast<float*>(s_tok + kMRun);         // [kMRun][4]
  float* s_vec = s_row + 4 * kMRun;                               // [6][di]
  float* s_dbo = s_vec + 6 * static_cast<size_t>(di);             // [dm]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const int p0 = blockIdx.x * nl;
  const int f0 = p0 * ln, f1 = imin(P, p0 + nl) * ln;  // own flat range
  const size_t img = static_cast<size_t>(b) * H * W;
  const float inv_di = 1.f / static_cast<float>(di);
  for (int i = tid; i < 6 * di + dm; i += kThreads) s_vec[i] = 0.f;

  for (int s0 = f0; s0 < f1; s0 += seg) {
    const int n = imin(seg, f1 - s0);
    __syncthreads();  // the previous segment's readers are done
    if (tid < n) {    // flat index f = line·ln + position
      const int f = s0 + tid, line = f / ln;
      s_tok[tid] = static_cast<long>(img) +
                   (transposed ? static_cast<long>(f - line * ln) * W + line
                               : f);
    }
    __syncthreads();

    // 1. a warp a token: the LayerNorm statistics of m0, then the gate's
    // and the LayerNorm's backward, 4 channels a lane at a time
    for (int r = warp; r < n; r += kThreads / 32) {
      const size_t o0 = static_cast<size_t>(s_tok[r]) * di;
      const size_t po0 = (static_cast<size_t>(b) * P + (s0 + r) / ln) * di;
      float mu = 0.f, rstd = 1.f;
      float m[4], xf[4], xb[4];
      if (use_ln) {
        float sum = 0.f, sumsq = 0.f;
        for (int c = 4 * lane; c < di; c += 128) {
          merge4(xc_f, xc_b, yf, yb, d_f, d_b, o0 + c, po0 + c, c, m, xf, xb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum += m[e];
            sumsq += m[e] * m[e];
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
          sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
        }
        mu = sum * inv_di;  // variance E[m²] - μ², unclamped
        rstd = rsqrtf(sumsq * inv_di - mu * mu + eps);
      }
      float s1 = 0.f, s2 = 0.f;  // Σdm̂, Σdm̂·m̂ over the row
      for (int c = 4 * lane; c < di; c += 128) {
        const size_t o = o0 + c;
        merge4(xc_f, xc_b, yf, yb, d_f, d_b, o, po0 + c, c, m, xf, xb);
        float z[4], dg[4], bz[4] = {0.f, 0.f, 0.f, 0.f};
        float lw[4] = {1.f, 1.f, 1.f, 1.f}, lb[4] = {0.f, 0.f, 0.f, 0.f};
        unpack(ldcg4(zdz + o), z);  // written over below
        unpack(ldcg4(gmg + o), dg);
        if (b_z) unpack(ld4(b_z + c), bz);
        if (use_ln) {
          unpack(ld4(ln_w + c), lw);
          unpack(ld4(ln_b + c), lb);
        }
        float dz[4], mg[4], dmln[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float zz = z[e] + bz[e];
          const float sig = 1.f / (1.f + expf(-zz));
          const float sz = zz * sig;
          const float mhat = use_ln ? (m[e] - mu) * rstd : m[e];
          const float mln = use_ln ? mhat * lw[e] + lb[e] : mhat;
          dmln[e] = dg[e] * sz;
          dz[e] = dg[e] * mln * sig * (1.f + zz * (1.f - sig));
          mg[e] = mln * sz;
          const float dmh = dmln[e] * lw[e];
          s1 += dmh;
          s2 += dmh * mhat;
        }
        st4(zdz + o, dz);
        st4(gmg + o, mg);
        st4(dxc_f + o, dmln);  // parked until the row sums are whole
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane == 0) {
        s_row[4 * r] = mu;
        s_row[4 * r + 1] = rstd;
        s_row[4 * r + 2] = s1 * inv_di;
        s_row[4 * r + 3] = s2 * inv_di;
      }
    }
    __syncthreads();  // the row sums, and the parked dmln

    // 2. a thread per 4 channels walks the segment's tokens in order: dm0,
    // dxc_f, dxc_b, the line sums dy and the column sums
    for (int c = 4 * tid; c < di; c += 4 * kThreads) {
      float df[4], db[4], lw[4] = {1.f, 1.f, 1.f, 1.f};
      unpack(ld4(d_f + c), df);
      unpack(ld4(d_b + c), db);
      if (use_ln) unpack(ld4(ln_w + c), lw);
      float acc[5][4] = {}, line[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) line[e] = s_vec[5 * di + c + e];
      for (int r = 0; r < n; ++r) {
        const size_t o = static_cast<size_t>(s_tok[r]) * di + c;
        const size_t po = (static_cast<size_t>(b) * P + (s0 + r) / ln) * di;
        float m[4], xf[4], xb[4], dmln[4], dz[4];
        merge4(xc_f, xc_b, yf, yb, d_f, d_b, o, po + c, c, m, xf, xb);
        unpack(ldcg4(dxc_f + o), dmln);
        unpack(ldcg4(zdz + o), dz);
        const float mu = s_row[4 * r], rstd = s_row[4 * r + 1];
        const float t1 = s_row[4 * r + 2], t2 = s_row[4 * r + 3];
        float hf[4], hb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dm0 = dmln[e];
          if (use_ln) {
            const float mhat = (m[e] - mu) * rstd;
            acc[1][e] += dmln[e] * mhat;
            acc[2][e] += dmln[e];
            dm0 = rstd * (dmln[e] * lw[e] - t1 - mhat * t2);
          }
          const float h = 0.5f * dm0;
          hf[e] = h * df[e];
          hb[e] = h * db[e];
          acc[0][e] += dz[e];
          acc[3][e] += h * xf[e];
          acc[4][e] += h * xb[e];
          line[e] += h;
        }
        st4(dxc_f + o, hf);
        st4(dxc_b + o, hb);
        if ((s0 + r + 1) % ln == 0) {  // the line ends here
          st4(dy + po + c, line);
#pragma unroll
          for (int e = 0; e < 4; ++e) line[e] = 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int q = 0; q < 5; ++q) s_vec[q * di + c + e] += acc[q][e];
        s_vec[5 * di + c + e] = line[e];  // a line that goes on: its sum
      }
    }
    for (int c = tid; c < dm; c += kThreads) {  // db_out
      float sum = 0.f;
      for (int r = 0; r < n; ++r)
        sum += g[static_cast<size_t>(s_tok[r]) * dm + c];
      s_dbo[c] += sum;
    }
  }
  __syncthreads();
  float* vp = vec_part + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                             (5 * static_cast<size_t>(di) + dm);
  for (int i = tid; i < 5 * di; i += kThreads) vp[i] = s_vec[i];
  for (int i = tid; i < dm; i += kThreads) vp[5 * di + i] = s_dbo[i];
}

// =====================================================================
// K6: xin again and the dual-conv adjoint
// =====================================================================
constexpr int kAM = 128;               // extended rows of a segment's tile
constexpr int kASeg = kAM - 2 * kPad;  // own tokens of a segment: 122
constexpr int kAN = 128;               // d_inner channels of a block
constexpr int kAK = 32;                // K (d_model) chunk of a stage
constexpr int kALd = kAK + 4;          // fp32 row of a staged chunk, skewed
constexpr int kAStages = 3;
constexpr int kAStageFloats = (kAM + kAN) * kALd;  // x̂ rows, then W_x rows
constexpr int kAXLd = kAN + 4;         // fp32 row of the xin tile, skewed
constexpr size_t kASmem =
    static_cast<size_t>(kAStages) * kAStageFloats * sizeof(float);
static_assert(kAM * kAXLd + 2 * kCVec * kAN <= kAStages * kAStageFloats,
              "the xin tile and the halves' sums take the ring's place");

// grid (d_inner slabs, runs of lines, batch): the slabs of a run are
// neighbours in the launch order, so they read its x̂ rows from L2. The
// block's sums go to slot b·runs + run of c_part, rows dw_cf[0..3],
// dw_ab[0..3], db_cf, db_ab, db_x.
__global__ void __launch_bounds__(kThreads, 2)
pass_a_bwd_tf32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w_x,
                       const float* __restrict__ b_x,
                       const float* __restrict__ w_cf,
                       const float* __restrict__ b_cf,
                       const float* __restrict__ w_ab,
                       const float* __restrict__ b_ab,
                       const float* __restrict__ dxc_f,
                       const float* __restrict__ dxc_b,
                       const float* __restrict__ dpf,
                       const float* __restrict__ dpb,
                       float* __restrict__ dxin, float* __restrict__ c_part,
                       int H, int W, int dm, int di, bool transposed,
                       float scaling, int nl, int seg) {
  extern __shared__ __align__(16) float smem_a[];
  float* s_xin = smem_a;  // [kAM][kAXLd] after each segment's products
  float* s_part = smem_a + kAM * kAXLd;  // [2][kCVec][kAN] at the end
  const uint32_t ring_base = smem_u32(smem_a);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kAN;
  const int b = blockIdx.z;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const int p0 = blockIdx.y * nl;
  const int f0 = p0 * ln, f1 = imin(P, p0 + nl) * ln;  // own flat range
  const int flat_end = P * ln;
  const size_t img = static_cast<size_t>(b) * H * W;
  const int nk = dm / kAK;

  // the token (in the image) of flat conv-order index f, or -1 outside
  // the sequence: the flat conv's zero padding at the image's first and
  // last line, never read from the neighbouring image
  auto token = [&](int f) -> long {
    if (f < 0 || f >= flat_end) return -1;
    if (!transposed) return f;
    const int line = f / ln;
    return static_cast<long>(f - line * ln) * W + line;
  };

  const int wm = warp & 3, wn = warp >> 2;  // rows 32wm.., channels 64wn..
  const bool n_on = n0 + 64 * wn < di;      // di % 64 == 0
  const int c = tid % kAN, half = tid / kAN;  // conv stage: channel, half
  const bool c_on = n0 + c < di;
  const size_t cc = n0 + (c_on ? c : 0);
  const float sw = scaling / static_cast<float>(ln);
  float part[kCVec];  // this thread's share of the block's sums
#pragma unroll
  for (int q = 0; q < kCVec; ++q) part[q] = 0.f;

  for (int s0 = f0; s0 < f1; s0 += seg) {
    const int n = imin(seg, f1 - s0);  // own tokens; extended row j is
    const int R = n + 2 * kPad;        // flat index s0 - 3 + j
    // a thread copies the 16-byte column tid % 8 of rows tid / 8 + 32 it:
    // x̂ rows (masked outside the sequence and the tile), W_x rows
    const int ch = tid & 7;
    auto fetch = [&](int s, uint32_t dst) {
      if (s >= nk) return;
      const int k0 = s * kAK + 4 * ch;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int r = (tid >> 3) + 32 * it;
        const long tk = r < R ? token(s0 - kPad + r) : -1;
        const bool xok = tk >= 0;
        cp_async16(dst + (r * kALd + 4 * ch) * 4,
                   x + (xok ? (img + tk) * dm + k0 : 0), xok);
        const bool wok = n0 + r < di;
        cp_async16(dst + ((kAM + r) * kALd + 4 * ch) * 4,
                   w_x + (wok ? static_cast<size_t>(n0 + r) * dm + k0 : 0),
                   wok);
      }
    };
    fv::Ring<kAStages, kAStageFloats * 4, decltype(fetch)> ring(ring_base,
                                                                fetch);
    ring.start();

    // xin = x̂·W_x[slab]ᵀ: a warp owns 32 rows × 64 channels; row tiles
    // past the segment's extended rows are skipped
    const bool m_on[2] = {32 * wm < R, 32 * wm + 16 < R};
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      const float* st = smem_a + (ring.acquire() - ring_base) / 4;
      if (n_on && m_on[0]) {
        // k-steps not unrolled, as in gemm_tf32_kernel (unrolled: 344
        // bytes of spills, 5 % slower at FastVim-B, 224 px)
#pragma unroll 1
        for (int kk = 0; kk < kAK / 8; ++kk) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (m_on[i])
              frag_a(st + (32 * wm + 16 * i) * kALd + 8 * kk, kALd, lane,
                     ah[i], al[i]);
#pragma unroll
          for (int j0 = 0; j0 < 8; j0 += 2) {
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int j = 0; j < 2; ++j)
              frag_b(st + (kAM + 64 * wn + 8 * (j0 + j)) * kALd + 8 * kk,
                     kALd, lane, bh[j], bl[j]);
            mma3<2, 2>(&acc[0][j0][0], 8, m_on, ah, al, bh, bl);
          }
        }
      }
      ring.refill();
    }
    fv::cp_async_wait<0>();
    __syncthreads();  // every product has read the ring: xin takes its place

    // + b_x into the fp32 tile; rows outside the sequence 0
    if (n_on) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 32 * wm + 16 * i + g + 8 * e;
          if (!m_on[i] || row >= R) continue;
          const bool valid = token(s0 - kPad + row) >= 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * wn + 8 * j + 2 * t;
            const float2 bx =
                b_x ? fv::ld_f2(b_x + n0 + col) : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(s_xin + row * kAXLd + col) =
                valid ? make_float2(acc[i][j][2 * e] + bx.x,
                                    acc[i][j][2 * e + 1] + bx.y)
                      : make_float2(0.f, 0.f);
          }
        }
      }
    }
    __syncthreads();

    // the conv adjoint: a thread owns a channel and walks half of the
    // segment's own rows [3, 3 + n) with the xin rows j-3..j+3, the causal
    // cotangents of rows j..j+3 and the anticausal ones of rows j-3..j in
    // registers (the conv weights are read here, not held through the
    // products)
    const int hn = (n + 1) / 2;
    const int ja = kPad + (half ? hn : 0), jb = kPad + (half ? n : hn);
    if (c_on && ja < jb) {
      float wc[4], wa[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wc[k] = w_cf[cc * 4 + k];
        wa[k] = w_ab[cc * 4 + k];
      }
      const float bc = b_cf ? b_cf[cc] : 0.f;
      const float ba = b_ab ? b_ab[cc] : 0.f;
      // the cotangent of row r's causal (xin rows r-3..r at xw) or
      // anticausal (rows r..r+3) pre-activation: dxc and the pooled
      // cotangent of its line times silu' there; 0 outside the sequence,
      // where nothing is read
      auto cot = [&](int r, bool causal, const float* xw) -> float {
        const int f = s0 - kPad + r;
        const long tk = token(f);
        if (tk < 0) return 0.f;
        const float v = causal ? xw[0] * wc[0] + xw[1] * wc[1] +
                                     xw[2] * wc[2] + xw[3] * wc[3] + bc
                               : xw[0] * wa[3] + xw[1] * wa[2] +
                                     xw[2] * wa[1] + xw[3] * wa[0] + ba;
        const size_t o = (img + tk) * di + cc;
        const size_t po = (static_cast<size_t>(b) * P + f / ln) * di + cc;
        const float up = causal ? dxc_f[o] + dpf[po] * sw
                                : dxc_b[o] + dpb[po] * sw;
        return up * fv::dsilu(v);
      };
      float xw[7], dc[4], da[4];
#pragma unroll
      for (int k = 0; k < 6; ++k) xw[k] = s_xin[(ja - kPad + k) * kAXLd + c];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        da[k] = cot(ja - kPad + k, false, xw + k);
        dc[k] = cot(ja + k, true, xw + k);
      }
      for (int j = ja; j < jb; ++j) {
        xw[6] = s_xin[(j + kPad) * kAXLd + c];
        dc[3] = cot(j + kPad, true, xw + 3);
        da[3] = cot(j, false, xw + 3);
        // dxin[j] = Σ_k w_c[k]·dyc[j+3-k] + w_a[3-k]·dya[j-k]
        const float dx = wc[0] * dc[3] + wc[1] * dc[2] + wc[2] * dc[1] +
                         wc[3] * dc[0] + wa[3] * da[3] + wa[2] * da[2] +
                         wa[1] * da[1] + wa[0] * da[0];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          part[k] += xw[k] * dc[0];          // dw_c[k]: xin[j-3+k]·dyc[j]
          part[7 - k] += xw[kPad + k] * da[3];  // dw_a[3-k]: xin[j+k]·dya[j]
        }
        part[8] += dc[0];
        part[9] += da[3];
        part[10] += dx;
        dxin[(img + token(s0 - kPad + j)) * di + cc] = dx;
#pragma unroll
        for (int k = 0; k < 6; ++k) xw[k] = xw[k + 1];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          dc[k] = dc[k + 1];
          da[k] = da[k + 1];
        }
      }
    }
    __syncthreads();  // the next segment's copies overwrite the tile
  }
  // the two halves in a fixed order: results repeat
  if (c_on)
#pragma unroll
    for (int q = 0; q < kCVec; ++q) s_part[(half * kCVec + q) * kAN + c] =
        part[q];
  __syncthreads();
  if (half == 0 && c_on) {
    float* cp = c_part + (static_cast<size_t>(b) * gridDim.y + blockIdx.y) *
                             kCVec * di;
#pragma unroll
    for (int q = 0; q < kCVec; ++q)
      cp[static_cast<size_t>(q) * di + cc] =
          s_part[q * kAN + c] + s_part[(kCVec + q) * kAN + c];
  }
}

}  // namespace

namespace fvb {

cudaError_t pass_b_bwd_f32(
    const void* g, const void* x, const void* xc_f, const void* xc_b,
    const void* yf, const void* yb, const void* w_z, const void* b_z,
    const void* d_f, const void* d_b, const void* ln_w, const void* ln_b,
    const void* w_out, void* dx, void* dxc_f, void* dxc_b, void* dy, void* mg,
    void* dz, void* vec_part, void* vec, void* w_part, void* dw_out,
    void* dw_z, int batch, int H, int W, int dm, int di, bool transposed,
    bool use_ln, int nsplit, float eps, cudaStream_t stream) {
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const long ntokens = static_cast<long>(batch) * H * W;
  if (ntokens > INT_MAX / 2) return cudaErrorInvalidValue;
  const int T = static_cast<int>(ntokens);
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  auto mF = [](void* p) { return static_cast<float*>(p); };
  // z (without b_z) into dz's scratch, dgated into mg's
  const GemmJob z{cF(x), cF(w_z), nullptr, mF(dz)};
  cudaError_t err = gemm<false, false>(z, z, 1, T, di, dm, 1, stream);
  if (err != cudaSuccess) return err;
  const GemmJob dg{cF(g), cF(w_out), nullptr, mF(mg)};
  err = gemm<false, true>(dg, dg, 1, T, di, dm, 1, stream);
  if (err != cudaSuccess) return err;
  const Runs r = runs_of(P, ln, kMRun);
  const int nruns = cdiv(P, r.nl);
  err = launch<pass_b_bwd_mid_kernel>(
      dim3(nruns, batch), mid_smem(dm, di), stream, cF(g), cF(xc_f),
      cF(xc_b), cF(yf), cF(yb), cF(b_z), cF(d_f), cF(d_b), cF(ln_w),
      cF(ln_b), mF(dz), mF(mg), mF(dxc_f), mF(dxc_b), mF(dy), mF(vec_part),
      H, W, dm, di, transposed, use_ln, eps, r.nl, r.seg);
  if (err != cudaSuccess) return err;
  // dx̂ (z half) = dz·W_z
  const GemmJob dxz{cF(dz), cF(w_z), nullptr, mF(dx)};
  err = gemm<false, true>(dxz, dxz, 1, T, dm, di, 1, stream);
  if (err != cudaSuccess) return err;
  // dW_outᵀ (di, dm) = mgᵀ·g;  dW_z (di, dm) = dzᵀ·x̂
  const size_t wn = static_cast<size_t>(di) * dm;
  float* wp = mF(w_part);
  err = gemm<true, true>(GemmJob{cF(mg), cF(g), nullptr, wp},
                         GemmJob{cF(dz), cF(x), nullptr, wp + nsplit * wn},
                         2, di, dm, T, nsplit, stream);
  if (err != cudaSuccess) return err;
  return sum_segments(
      SumSegs{{{wp, mF(dw_out), static_cast<long>(wn), nsplit, dm},
               {wp + nsplit * wn, mF(dw_z), static_cast<long>(wn), nsplit, 0},
               {cF(vec_part), mF(vec), 5L * di + dm, batch * nruns, 0}},
              3},
      stream);
}

cudaError_t pass_a_bwd_f32(
    const void* x, const void* dx_b, const void* dxc_f, const void* dxc_b,
    const void* dpf, const void* dpb, const void* w_x, const void* b_x,
    const void* w_cf, const void* b_cf, const void* w_ab, const void* b_ab,
    void* dx, void* dxin, void* c_part, void* c_vec, void* w_part, void* dw_x,
    int batch, int H, int W, int dm, int di, bool transposed, int nsplit,
    float scaling, cudaStream_t stream) {
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const long ntokens = static_cast<long>(batch) * H * W;
  if (ntokens > INT_MAX / 2) return cudaErrorInvalidValue;
  const int T = static_cast<int>(ntokens);
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  auto mF = [](void* p) { return static_cast<float*>(p); };
  const Runs r = runs_of(P, ln, kASeg);
  const int nruns = cdiv(P, r.nl);
  cudaError_t err = launch<pass_a_bwd_tf32_kernel>(
      dim3(cdiv(di, kAN), nruns, batch), kASmem, stream, cF(x), cF(w_x),
      cF(b_x), cF(w_cf), cF(b_cf), cF(w_ab), cF(b_ab), cF(dxc_f), cF(dxc_b),
      cF(dpf), cF(dpb), mF(dxin), mF(c_part), H, W, dm, di, transposed,
      scaling, r.nl, r.seg);
  if (err != cudaSuccess) return err;
  // dx̂ = dx̂(K5) + dxin·W_x
  const GemmJob dxx{cF(dxin), cF(w_x), cF(dx_b), mF(dx)};
  err = gemm<false, true>(dxx, dxx, 1, T, dm, di, 1, stream);
  if (err != cudaSuccess) return err;
  // dW_x (di, dm) = dxinᵀ·x̂
  const GemmJob wx{cF(dxin), cF(x), nullptr, mF(w_part)};
  err = gemm<true, true>(wx, wx, 1, di, dm, T, nsplit, stream);
  if (err != cudaSuccess) return err;
  return sum_segments(
      SumSegs{{{cF(w_part), mF(dw_x), static_cast<long>(di) * dm, nsplit, 0},
               {cF(c_part), mF(c_vec), static_cast<long>(kCVec) * di,
                batch * nruns, 0},
               {nullptr, nullptr, 0, 0, 0}},
              2},
      stream);
}

}  // namespace fvb
