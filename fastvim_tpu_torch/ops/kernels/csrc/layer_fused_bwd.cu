// K5 and K6: the adjoints of the two passes of the fused FastVim mixer
// layer, for Hopper (sm_90a).
//
// K5 (pass B backward) replaces `_pass_b_bwd_kernel`
// (fastvim_tpu/ops/pallas/layer_fused.py). With g = dL/d(out) it recomputes
//   z = x̂·W_zᵀ + b_z;  m0 = ½(yf + D_f·xc_f + yb + D_b·xc_b);  LayerNorm
//   statistics, m̂, mln = m̂·w + b
// and emits
//   dgated = g·W_out;  dmln = dgated·silu(z);  dz = dgated·mln·silu'(z);
//   dm0 = LayerNorm backward of dmln·w;  dx̂ (z half, fp32) = dz·W_z;
//   dxc_f = ½dm0·D_f, dxc_b = ½dm0·D_b;  dyf = dyb = Σ_line ½dm0;
//   dW_out = gᵀ·(mln·silu(z)), db_out = Σg, dW_z = dzᵀ·x̂, db_z = Σdz,
//   dLN w/b, dD_f = Σ½dm0·xc_f, dD_b, all summed over every token.
// K6 (pass A backward) replaces `_pass_a_bwd_even_kernel` /
// `_pass_a_bwd_odd_kernel`: with the cotangents of xc_f, xc_b (from K5)
// and of the pooled pf, pb (from the scans' backward) it recomputes
// xin = x̂·W_xᵀ + b_x and the conv pre-activations yc, ya and emits
//   dyc = (dxc_f + dpf·scaling/ln)·silu'(yc), dya likewise;
//   dxin[t] = Σ_k w_c[k]·dyc[t+3−k] + w_a[3−k]·dya[t−k] along the (transposed)
//   raster, across line boundaries;  dx̂ = dx̂(K5) + dxin·W_x (fp32);
//   dW_x = dxinᵀ·x̂, db_x, conv weight and bias gradients over every token.
// GEMM operands (dz, mln·silu(z), dxin) are rounded to the working dtype,
// products accumulate in fp32, as the TPU kernels do.
//
// This file holds the C entry points and the fp32 path (FMA tiles, which
// is what holds the gradients to a CPU run within 1e-4); the bf16 path, on
// `wgmma`, is layer_fused_bwd_wgmma.cu, with its own design notes.
//
// What bounds the fp32 path on the H100: five GEMMs per token for K5 (z,
// dgated, dx̂ and the two weight gradients: 5 × 2 × 192 × 384 = 0.74 MFLOP)
// and four for K6 on FMA units, so it is FMA-bound.
//
// Widths: up to d_model 384 and d_inner 384 (FastVim-T) K5 holds d_inner
// / 32 values a lane and whole-width z and dgated tiles, and forms dx̂ in
// the block. Past them, up to fvb::kBwdMaxDm and kBwdMaxDi (FastVim-H),
// its wide form (`pass_b_bwd_wide_kernel`)
// walks d_inner in slabs of 384 channels with z and dgated of a slab in
// registers, reads x̂ and g a K chunk at a time (`gemm_rows_g`), parks dm̂
// in dxc_f until the LayerNorm's row sums are complete, as the bf16 path
// does, and leaves dx̂ = dz·W_z to `dx_rows_kernel` over the dz it stores
// for dW_z anyway. K6's kernels take every width: the conv adjoint reads
// x̂ a K chunk at a time, and `dx_rows_kernel` forms dx̂(K5) + dxin·W_x.
//
// The cross-block sums, which the TPU kernel got from a sequential grid
// that revisits one output block (`_acc`):
// - dW_out, dW_z, dW_x contract over all tokens. The main kernels write
//   their GEMM operands (mln·silu(z), dz, dxin: T × d_inner in the working
//   dtype) to device memory once, and `wgrad_kernel` computes Xᵀ·Y as a
//   split-K GEMM: a block owns a 64 × 64 tile of the weight gradient over
//   one slice of the tokens and keeps its partial in registers; one launch
//   does both of K5's weight gradients.
// - the vector sums (biases, LN, D, conv weights) are kept per block over
//   all its tokens and written once per block.
// - `sum_segments_kernel` (layer_fused_bwd.cuh) adds every partial of a
//   call, in one launch and in a fixed order.
// - dyf = dyb sums over a line: a K5 block owns one whole line (a row on
//   even layers, a strided column on odd ones) and walks it in tiles, so
//   the line sum never leaves the block.
// No atomics anywhere: the results are the same from run to run.
//
// K6's conv adjoint (fp32) needs the neighbouring lines' cotangents (the
// next line's first 3 causal outputs and the previous line's last 3
// anticausal ones read this line's xin). As in K3 a block owns one line ×
// 64 channels and computes xin for the line plus 3 halo tokens on each
// side; from that tile it recomputes yc at the next line's first 3 tokens
// and ya at the previous line's last 3, reads their cotangents, and has
// everything the adjoint needs. Halo tokens outside the sequence (before
// the first line, after the last) are masked BEFORE any load of x̂, dxc or
// dp: nothing is read there and their terms are 0.

#include "layer_fused.cuh"
#include "layer_fused_bwd.cuh"

namespace {

// =====================================================================
// weight-gradient GEMM (fp32): part[job][z] = X[t-slice]ᵀ · Y[t-slice]
// =====================================================================
constexpr int kGT = 64;  // output tile edge and tokens per step

struct WgradJobs {
  const float* X[2];  // (T, di): mg, dz or dxin
  const float* Y[2];  // (T, dm): g or x̂
  int count;
};

// part: (jobs, nsplit, di, dm) fp32. Block (x, y, z) owns rows 64y..,
// columns 64x.. of job z / nsplit over slice z % nsplit of T.
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(WgradJobs jobs, int M, int N, long T, int nsplit,
             float* __restrict__ part) {
  constexpr int kLd = kGT + 4;  // skewed row
  constexpr int kIters = kGT * kGT / 4 / kThreads;
  __shared__ __align__(16) float s_a[kGT * kLd];
  __shared__ __align__(16) float s_b[kGT * kLd];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kGT, m0 = blockIdx.y * kGT;
  const int job = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const float* A = jobs.X[job];
  const float* B = jobs.Y[job];
  const long per = ((T + nsplit - 1) / nsplit + kGT - 1) / kGT * kGT;
  const long t_begin = split * per;
  const long t_end = t_begin + per < T ? t_begin + per : T;
  float* out = part + (static_cast<size_t>(blockIdx.z) * M + m0) * N + n0;
  // thread → rows 4 ty.., columns 4 tx..
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long t0 = t_begin; t0 < t_end; t0 += kGT) {
    __syncthreads();  // the previous step's readers are done
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kGT / 4), v = i % (kGT / 4);
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (t0 + r < t_end) {
        va = fv::load16(A + (t0 + r) * M + m0 + v * 4);
        vb = fv::load16(B + (t0 + r) * N + n0 + v * 4);
      }
      *reinterpret_cast<uint4*>(s_a + r * kLd + v * 4) = va;
      *reinterpret_cast<uint4*>(s_b + r * kLd + v * 4) = vb;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kGT; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(s_a + k * kLd + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(s_b + k * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + static_cast<size_t>(4 * ty + i) * N +
                               4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

cudaError_t wgrad(const WgradJobs& jobs, int di, int dm, long T, int nsplit,
                  float* part, cudaStream_t stream) {
  dim3 grid(dm / kGT, di / kGT, jobs.count * nsplit);
  wgrad_kernel<<<grid, kThreads, 0, stream>>>(jobs, di, dm, T, nsplit, part);
  return cudaGetLastError();
}

// =====================================================================
// gemm_rows with the A tile read from device memory a K chunk at a time
// =====================================================================
// acc[r][j] = Σ_k A[tok[kR·warp + r]][k] · Wt[n0 + lane + 32j][k] for j <
// ncols, as gemm_rows computes it (the same products in the same order),
// but with row t of the (8·kR × K) A tile read from the row-major (rows ×
// K) array A one K chunk at a time into s_a [8·kR][kBKc]; rows with
// s_tok[t] < 0 are zeros and not read. Barriers inside.
template <typename T, int kR>
__device__ __forceinline__ void gemm_rows_g(const T* __restrict__ A,
                                            const long* s_tok,
                                            const T* __restrict__ Wt, int K,
                                            int n0, int ncols, float* s_a,
                                            float* s_w, float (*acc)[kBCols]) {
  constexpr int kVe = fv::kVec<T>;  // elements per 16-byte vector
  constexpr int kVpr = kBKc / kVe;  // vectors per row of a K chunk
  constexpr int kIters = kBSlab * kVpr / kThreads;
  constexpr int kAVecs = 8 * kR * kVpr;  // vectors of an A chunk
  static_assert(kAVecs <= kThreads, "one A vector a thread");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nn = 32 * ncols;
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < kBCols; ++j) acc[r][j] = 0.f;
  const int at = threadIdx.x / kVpr, av = threadIdx.x % kVpr;
  const long arow = threadIdx.x < kAVecs ? s_tok[at] : -1;
  for (int k0 = 0; k0 < K; k0 += kBKc) {
    uint4 v[kIters], a = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (i / kVpr < nn)
        v[it] = fv::load16(Wt + static_cast<size_t>(n0 + i / kVpr) * K + k0 +
                           (i % kVpr) * kVe);
    }
    if (arow >= 0)  // masked before the load
      a = fv::load16(A + static_cast<size_t>(arow) * K + k0 + av * kVe);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int n = i / kVpr, kv = i % kVpr;
      if (n < nn) {
        float f[kVe];
        fv::widen16<T>(v[it], f);
#pragma unroll
        for (int e = 0; e < kVe; ++e)
          s_w[(kv * kVe + e) * (kBSlab + 1) + n] = f[e];
      }
    }
    if (threadIdx.x < kAVecs) {
      float f[kVe];
      fv::widen16<T>(a, f);
#pragma unroll
      for (int e = 0; e < kVe; ++e) s_a[at * kBKc + av * kVe + e] = f[e];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBKc; ++k) {
      float wv[kBCols];
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        wv[j] = j < ncols ? s_w[k * (kBSlab + 1) + lane + 32 * j] : 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float x = s_a[(kR * warp + r) * kBKc + k];
#pragma unroll
        for (int j = 0; j < kBCols; ++j) acc[r][j] += x * wv[j];
      }
    }
  }
}

// out = add + A·Wtᵀ over 32-token tiles of consecutive rows: A (ntokens,
// K) of T, Wt (N, K) of T (w_z_t or w_x_t), add (ntokens, N) fp32 or
// null. dx̂ of K6 (dx̂(K5) + dxin·W_x) and of K5's wide form (dz·W_z).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dx_rows_kernel(const T* __restrict__ A, const T* __restrict__ Wt,
               const float* __restrict__ add, float* __restrict__ out,
               long ntokens, int N, int K) {
  __shared__ __align__(16) float s_a[kBTok * kBKc];
  __shared__ __align__(16) float s_w[kBKc * (kBSlab + 1)];
  __shared__ long s_tok[kBTok];
  const long tok0 = static_cast<long>(blockIdx.x) * kBTok;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x < kBTok)
    s_tok[threadIdx.x] = tok0 + threadIdx.x < ntokens ? tok0 + threadIdx.x : -1;
  __syncthreads();
  float acc[4][kBCols];
  for (int n0 = 0; n0 < N; n0 += kBSlab) {
    const int ncols = min(kBCols, (N - n0) / 32);
    gemm_rows_g<T, 4>(A, s_tok, Wt, K, n0, ncols, s_a, s_w, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long t = s_tok[4 * warp + r];
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        if (j < ncols && t >= 0) {
          const size_t o = static_cast<size_t>(t) * N + n0 + lane + 32 * j;
          out[o] = add ? add[o] + acc[r][j] : acc[r][j];
        }
    }
  }
}

cudaError_t dx_rows(const float* A, const float* Wt, const float* add,
                    float* out, long ntokens, int N, int K,
                    cudaStream_t stream) {
  const long blocks = (ntokens + kBTok - 1) / kBTok;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  dx_rows_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(A, Wt, add, out, ntokens, N, K);
  return cudaGetLastError();
}

// =====================================================================
// K5: pass B backward
// =====================================================================
// The narrow fp32 kernel keeps d_inner / 32 values per lane in registers
// and z and dgated as whole-width fp32 tiles in shared memory, in
// 32-token tiles (kR = 4 rows a warp, kJ = 12), up to kF32NarrowDi = 384
// (FastVim-T). Wider, the wide form below, which at FastVim-S's widths
// beats a 16-token form of this kernel, whose per-lane arrays spill
// (PERF.md §6).
using fvb::kCVec;
using fvb::kNVec;

constexpr int kF32NarrowDi = 384;

// shared memory of the K5 main kernel with 8·kR-token tiles, in bytes
__host__ __device__ inline size_t pass_b_bwd_smem(int dm, int di, int kR) {
  const size_t ntok = 8 * static_cast<size_t>(kR);
  const size_t tiles = (2 * ntok * dm + 2 * ntok * imax(di, dm) +  // x̂, g, z, dg
                        static_cast<size_t>(kBKc) * (kBSlab + 1)) *
                       sizeof(float);
  // at the end the 8 warps' vector sums reuse the buffer from its start
  const size_t red = 8 * static_cast<size_t>(kNVec) * di * sizeof(float);
  return tiles > red ? tiles : red;
}

// the tile `seg` of the line a K5 block owns
struct Seg {
  int H, W, ln, p, i0;  // i0: position of the tile's first token in the line
  bool transposed;
  size_t img;
  __device__ bool valid(int t) const { return i0 + t < ln; }
  __device__ size_t token(int t) const {  // global token index
    const long i = i0 + t;
    return img + (transposed ? i * W + p : static_cast<long>(p) * W + i);
  }
};

// The elementwise middle of K5 for the tile's tokens (one warp per kR
// tokens, a lane per channel c = lane + 32 j, j < kJ): merge, LayerNorm forward
// and backward, gate backward. Reads z (without bias) from s_z and dgated
// from s_dg (row stride ld); writes dz into s_dz (row stride ldz; may
// alias s_z: same element, same thread), mg and dz (rounded to T) to
// device memory, dxc_f / dxc_b, and adds this tile into acc.
template <typename T, typename G, int kR, int kJ>
__device__ __forceinline__ void merge_bwd(
    const float* s_z, const float* s_dg, int ld, G* s_dz, int ldz,
    const Seg& sg, size_t prow, const T* __restrict__ xc_f,
    const T* __restrict__ xc_b, const T* __restrict__ yf,
    const T* __restrict__ yb, const float* __restrict__ b_z,
    const float* __restrict__ d_f, const float* __restrict__ d_b,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    T* __restrict__ dxc_f, T* __restrict__ dxc_b, T* __restrict__ mg,
    T* __restrict__ dzs, int di, bool use_ln, float eps,
    float (&acc)[kNVec][kJ]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nj = di / 32;
  const float inv_di = 1.f / static_cast<float>(di);
  for (int r = 0; r < kR; ++r) {
    const int t = kR * warp + r;
    if (!sg.valid(t)) {  // past the line's end: a zero row for the dx̂ GEMM
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (j < nj) {
          if constexpr (std::is_same<G, float>::value)
            s_dz[t * ldz + lane + 32 * j] = 0.f;
          else
            s_dz[t * ldz + lane + 32 * j] = fv::from_f32<G>(0.f);
        }
      continue;
    }
    const size_t tok = sg.token(t);
    float m[kJ], dmh[kJ];
    float sum = 0.f, sumsq = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
        const float v = (fv::to_f32(yf[prow * di + c]) +
                         d_f[c] * fv::to_f32(xc_f[tok * di + c]) +
                         fv::to_f32(yb[prow * di + c]) +
                         d_b[c] * fv::to_f32(xc_b[tok * di + c])) *
                        0.5f;
        m[j] = v;
        sum += v;
        sumsq += v * v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
    }
    const float mu = sum * inv_di;
    const float rstd = rsqrtf(sumsq * inv_di - mu * mu + eps);
    float s1 = 0.f, s2 = 0.f;  // Σ dm̂, Σ dm̂·m̂ over the channels
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
        const float z = s_z[t * ld + c] + (b_z ? b_z[c] : 0.f);
        const float sig = 1.f / (1.f + expf(-z));
        const float sz = z * sig;
        const float mhat = use_ln ? (m[j] - mu) * rstd : m[j];
        const float mln = use_ln ? mhat * ln_w[c] + ln_b[c] : mhat;
        const float dgt = s_dg[t * ld + c];
        const float dmln = dgt * sz;
        const float dz = dgt * mln * sig * (1.f + z * (1.f - sig));
        mg[tok * di + c] = fv::from_f32<T>(mln * sz);
        dzs[tok * di + c] = fv::from_f32<T>(dz);
        if constexpr (std::is_same<G, float>::value)
          s_dz[t * ldz + c] = fv::round_to<T>(dz);
        else
          s_dz[t * ldz + c] = fv::from_f32<G>(dz);
        acc[0][j] += dz;
        if (use_ln) {
          acc[1][j] += dmln * mhat;
          acc[2][j] += dmln;
          const float dmhat = dmln * ln_w[c];
          s1 += dmhat;
          s2 += dmhat * mhat;
          m[j] = mhat;
          dmh[j] = dmhat;
        } else {
          dmh[j] = dmln;
        }
      }
    }
    if (use_ln) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
        const float dm0 =
            use_ln ? rstd * (dmh[j] - s1 * inv_di - m[j] * s2 * inv_di)
                   : dmh[j];
        const float h = 0.5f * dm0;
        const float xf = fv::to_f32(xc_f[tok * di + c]);
        const float xb = fv::to_f32(xc_b[tok * di + c]);
        dxc_f[tok * di + c] = fv::from_f32<T>(h * d_f[c]);
        dxc_b[tok * di + c] = fv::from_f32<T>(h * d_b[c]);
        acc[3][j] += h * xf;
        acc[4][j] += h * xb;
        acc[5][j] += h;
      }
    }
  }
}

// The end of a K5 block: add the 8 warps' vector sums through shared
// memory (s_red: [8][kNVec][di]) and write them: rows 0-4 and db_out to
// this block's slot of vec_part ([5·di | dm]), row 5 (the line sum) to dy.
template <typename T, int kJ>
__device__ __forceinline__ void finish_b_bwd(
    float* s_red, const float (&acc)[kNVec][kJ], const float (&dbo)[2], int dm,
    int di,
    size_t prow, float* __restrict__ vec_part, T* __restrict__ dy) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nj = di / 32;
  __syncthreads();  // the tile buffers are free
#pragma unroll
  for (int q = 0; q < kNVec; ++q)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      if (j < nj) s_red[(warp * kNVec + q) * di + lane + 32 * j] = acc[q][j];
  __syncthreads();
  float* vp = vec_part + prow * (5 * di + dm);
  for (int i = threadIdx.x; i < kNVec * di; i += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sum += s_red[w * kNVec * di + i];
    if (i < 5 * di)
      vp[i] = sum;
    else
      dy[prow * di + i - 5 * di] = fv::from_f32<T>(sum);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (threadIdx.x + k * kThreads < dm)
      vp[5 * di + threadIdx.x + k * kThreads] = dbo[k];
}

// FMA GEMM path (fp32), tiles of 8·kR tokens
template <typename T, int kR, int kJ>
__global__ void __launch_bounds__(kThreads, 1)
pass_b_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                  const T* __restrict__ xc_f, const T* __restrict__ xc_b,
                  const T* __restrict__ yf, const T* __restrict__ yb,
                  const T* __restrict__ w_z, const T* __restrict__ w_z_t,
                  const float* __restrict__ b_z, const float* __restrict__ d_f,
                  const float* __restrict__ d_b, const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b, const T* __restrict__ w_out_t,
                  float* __restrict__ dx, T* __restrict__ dxc_f,
                  T* __restrict__ dxc_b, T* __restrict__ dy,
                  T* __restrict__ mg, T* __restrict__ dzs,
                  float* __restrict__ vec_part, int H, int W, int dm, int di,
                  bool transposed, bool use_ln, float eps) {
  constexpr int kTok = 8 * kR;
  extern __shared__ float smem_f[];
  const int ldz = imax(di, dm);
  float* s_x = smem_f;                                  // [kTok][dm]
  float* s_g = s_x + static_cast<size_t>(kTok) * dm;   // [kTok][dm]
  float* s_z = s_g + static_cast<size_t>(kTok) * dm;   // [kTok][ldz]
  float* s_dg = s_z + static_cast<size_t>(kTok) * ldz;  // [kTok][ldz]
  float* s_w = s_dg + static_cast<size_t>(kTok) * ldz;  // [kBKc][kBSlab+1]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  Seg sg{H, W, ln, static_cast<int>(blockIdx.x), 0, transposed,
         static_cast<size_t>(b) * H * W};
  const size_t prow = static_cast<size_t>(b) * P + blockIdx.x;
  float acc[kNVec][kJ];
#pragma unroll
  for (int q = 0; q < kNVec; ++q)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[q][j] = 0.f;
  float dbo[2] = {0.f, 0.f};  // db_out of columns tid, tid + 256
  float gacc[kR][kBCols];

  for (sg.i0 = 0; sg.i0 < ln; sg.i0 += kTok) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kTok * dm; i += kThreads) {
      const int t = i / dm, k = i % dm;
      const bool ok = sg.valid(t);  // masked before the load
      s_x[i] = ok ? fv::to_f32(x[sg.token(t) * dm + k]) : 0.f;
      s_g[i] = ok ? fv::to_f32(g[sg.token(t) * dm + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c < dm)
        for (int t = 0; t < kTok; ++t) dbo[k] += s_g[t * dm + c];
    }
    // z = x̂·W_zᵀ and dgated = g·W_out, per 384-column slab
    for (int n0 = 0; n0 < di; n0 += kBSlab) {
      const int ncols = min(kBCols, (di - n0) / 32);
      for (int which = 0; which < 2; ++which) {
        gemm_rows<T, kR>(which ? s_g : s_x, which ? w_out_t : w_z, dm, n0, ncols,
                     s_w, gacc);
        float* dst = which ? s_dg : s_z;
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int j = 0; j < kBCols; ++j)
            if (j < ncols)
              dst[(kR * warp + r) * ldz + n0 + lane + 32 * j] = gacc[r][j];
      }
    }
    __syncthreads();
    merge_bwd<T, float, kR, kJ>(s_z, s_dg, ldz, s_z, ldz, sg, prow, xc_f, xc_b, yf, yb,
                        b_z, d_f, d_b, ln_w, ln_b, dxc_f, dxc_b, mg, dzs, di,
                        use_ln, eps, acc);
    // dx̂ (z half) = dz·W_z
    for (int n0 = 0; n0 < dm; n0 += kBSlab) {
      const int ncols = min(kBCols, (dm - n0) / 32);
      gemm_rows<T, kR>(s_z, w_z_t, di, n0, ncols, s_w, gacc);  // barriers inside
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int t = kR * warp + r;
#pragma unroll
        for (int j = 0; j < kBCols; ++j)
          if (j < ncols && sg.valid(t))
            dx[sg.token(t) * dm + n0 + lane + 32 * j] = gacc[r][j];
      }
    }
  }
  finish_b_bwd<T, kJ>(smem_f, acc, dbo, dm, di, prow, vec_part, dy);
}

// K5's wide form (fp32). A block owns one line and walks it in tiles of
// 8·kR tokens; per tile:
// 1. the LayerNorm statistics of m0 over all of d_inner, a warp per row;
// 2. per slab of 384 channels, z = x̂·W_zᵀ and dgated = g·W_out for the
//    warp's kR rows in registers (gemm_rows_g), the gate and LayerNorm
//    backward on them (a lane per channel lane + 32j), mg and dz to device
//    memory, dm̂ parked in dxc_f, the row sums Σdm̂, Σdm̂·m̂ kept a lane, and
//    the slab's column sums (db_z, dln_w, dln_b) added over the 8 warps in
//    order into s_vec;
// 3. a second pass, a thread per 4 channels: dm0 from the parked dm̂,
//    dxc_f, dxc_b and the column sums dd_f, dd_b, dy into s_vec.
// Shared memory, in this order: s_tok [8·kR] (tokens, -1 past the
// line), s_a [8·kR][kBKc] and s_w [kBKc][kBSlab+1] (gemm_rows_g's
// staging), s_vec [6][di] (db_z, dln_w, dln_b, dd_f, dd_b, dy), s_red
// [8][3][kBSlab], s_row [8·kR][4] (mu, rstd, Σdm̂, Σdm̂·m̂); fp32 but s_tok.
__host__ __device__ inline size_t pass_b_bwd_wide_smem(int di, int kR) {
  return 8 * kR * sizeof(long) +
         (8 * kR * kBKc + kBKc * (kBSlab + 1) +
          static_cast<size_t>(kNVec) * di + 8 * 3 * kBSlab + 8 * kR * 4) *
             sizeof(float);
}

template <int kR>
__global__ void __launch_bounds__(kThreads, 1)
pass_b_bwd_wide_kernel(const float* __restrict__ g,
                       const float* __restrict__ x,
                       const float* __restrict__ xc_f,
                       const float* __restrict__ xc_b,
                       const float* __restrict__ yf,
                       const float* __restrict__ yb,
                       const float* __restrict__ w_z,
                       const float* __restrict__ b_z,
                       const float* __restrict__ d_f,
                       const float* __restrict__ d_b,
                       const float* __restrict__ ln_w,
                       const float* __restrict__ ln_b,
                       const float* __restrict__ w_out_t, float* dxc_f,
                       float* __restrict__ dxc_b, float* __restrict__ dy,
                       float* __restrict__ mg, float* __restrict__ dzs,
                       float* __restrict__ vec_part, int H, int W, int dm,
                       int di, bool transposed, bool use_ln, float eps) {
  constexpr int kTok = 8 * kR;
  constexpr int kDbo = (fvb::kBwdMaxDm + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) long smem_w[];
  long* s_tok = smem_w;                                       // [kTok]
  float* s_a = reinterpret_cast<float*>(s_tok + kTok);        // [kTok][16]
  float* s_w = s_a + kTok * kBKc;                             // [16][385]
  float* s_vec = s_w + kBKc * (kBSlab + 1);                   // [6][di]
  float* s_red = s_vec + static_cast<size_t>(kNVec) * di;     // [8][3][384]
  float* s_row = s_red + 8 * 3 * kBSlab;                      // [kTok][4]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.y;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  Seg sg{H, W, ln, static_cast<int>(blockIdx.x), 0, transposed,
         static_cast<size_t>(b) * H * W};
  const size_t prow = static_cast<size_t>(b) * P + blockIdx.x;
  const float inv_di = 1.f / static_cast<float>(di);
  const float* yfr = yf + prow * di;
  const float* ybr = yb + prow * di;
  // m0 of channel c of token tok, in merge_bwd's order
  auto merge = [&](size_t tok, int c) {
    return (yfr[c] + d_f[c] * xc_f[tok * di + c] + ybr[c] +
            d_b[c] * xc_b[tok * di + c]) *
           0.5f;
  };
  for (int i = tid; i < kNVec * di; i += kThreads) s_vec[i] = 0.f;
  float dbo[kDbo] = {};  // db_out of columns tid, tid + 256, ...

  for (sg.i0 = 0; sg.i0 < ln; sg.i0 += kTok) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < kTok) s_tok[tid] = sg.valid(tid) ? sg.token(tid) : -1;
    // 1. LayerNorm statistics, a warp per row
    for (int r = 0; r < kR; ++r) {
      const int t = kR * warp + r;
      if (!sg.valid(t)) continue;  // the same for the whole warp
      const size_t tok = sg.token(t);
      float sum = 0.f, sumsq = 0.f;
      for (int c = lane; c < di; c += 32) {
        const float v = merge(tok, c);
        sum += v;
        sumsq += v * v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
      }
      if (lane == 0) {
        const float mu = sum * inv_di;
        s_row[t * 4] = mu;
        s_row[t * 4 + 1] = rsqrtf(sumsq * inv_di - mu * mu + eps);
      }
    }
    // db_out += Σ_rows g
#pragma unroll
    for (int k = 0; k < kDbo; ++k) {
      const int c = tid + k * kThreads;
      if (c < dm)
        for (int t = 0; t < kTok; ++t)
          if (sg.valid(t)) dbo[k] += g[sg.token(t) * dm + c];
    }
    __syncthreads();  // s_tok and s_row

    // 2. the slabs
    float s1[kR] = {}, s2[kR] = {};  // a lane's share of Σdm̂, Σdm̂·m̂
    for (int n0 = 0; n0 < di; n0 += kBSlab) {
      const int ncols = min(kBCols, (di - n0) / 32);
      float z[kR][kBCols], dg[kR][kBCols];
      gemm_rows_g<float, kR>(x, s_tok, w_z, dm, n0, ncols, s_a, s_w, z);
      gemm_rows_g<float, kR>(g, s_tok, w_out_t, dm, n0, ncols, s_a, s_w, dg);
      float cs[3][kBCols] = {};  // column sums over the warp's rows
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int t = kR * warp + r;
        const long tok = s_tok[t];
        if (tok < 0) continue;
        const float mu = s_row[t * 4], rstd = s_row[t * 4 + 1];
#pragma unroll
        for (int j = 0; j < kBCols; ++j) {
          if (j >= ncols) continue;
          const int c = n0 + lane + 32 * j;
          const size_t o = static_cast<size_t>(tok) * di + c;
          const float zz = z[r][j] + (b_z ? b_z[c] : 0.f);
          const float sig = 1.f / (1.f + expf(-zz));
          const float sz = zz * sig;
          const float m = merge(tok, c);
          const float mhat = use_ln ? (m - mu) * rstd : m;
          const float mln = use_ln ? mhat * ln_w[c] + ln_b[c] : mhat;
          const float dgt = dg[r][j];
          const float dmln = dgt * sz;
          const float dz = dgt * mln * sig * (1.f + zz * (1.f - sig));
          mg[o] = mln * sz;
          dzs[o] = dz;
          cs[0][j] += dz;
          float dmh = dmln;
          if (use_ln) {
            cs[1][j] += dmln * mhat;
            cs[2][j] += dmln;
            dmh = dmln * ln_w[c];
            s1[r] += dmh;
            s2[r] += dmh * mhat;
          }
          dxc_f[o] = dmh;  // dm̂ waits here for the second pass
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int j = 0; j < kBCols; ++j)
          if (j < ncols)
            s_red[(warp * 3 + q) * kBSlab + lane + 32 * j] = cs[q][j];
      __syncthreads();
      for (int i = tid; i < 3 * 32 * ncols; i += kThreads) {
        const int q = i / (32 * ncols), c = i % (32 * ncols);
        float sum = 0.f;
        for (int w = 0; w < kThreads / 32; ++w)
          sum += s_red[(w * 3 + q) * kBSlab + c];
        s_vec[q * di + n0 + c] += sum;
      }
      // (the next slab's GEMMs pass two barriers before s_red is written)
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], o);
        s2[r] += __shfl_xor_sync(0xffffffffu, s2[r], o);
      }
      if (lane == 0) {
        s_row[(kR * warp + r) * 4 + 2] = s1[r];
        s_row[(kR * warp + r) * 4 + 3] = s2[r];
      }
    }
    __syncthreads();  // s_row, and the parked dm̂ in device memory

    // 3. the second pass, a thread per 4 channels
    for (int c0 = 4 * tid; c0 < di; c0 += 4 * kThreads) {
      float af[4] = {}, ab[4] = {}, ay[4] = {};
      for (int t = 0; t < kTok; ++t) {
        const long tok = s_tok[t];
        if (tok < 0) continue;
        const float mu = s_row[t * 4], rstd = s_row[t * 4 + 1];
        const float t1 = s_row[t * 4 + 2] * inv_di;
        const float t2 = s_row[t * 4 + 3] * inv_di;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + e;
          const size_t o = static_cast<size_t>(tok) * di + c;
          const float dmh = __ldcg(dxc_f + o);
          const float m = merge(tok, c);
          const float dm0 =
              use_ln ? rstd * (dmh - t1 - (m - mu) * rstd * t2) : dmh;
          const float h = 0.5f * dm0;
          dxc_f[o] = h * d_f[c];
          dxc_b[o] = h * d_b[c];
          af[e] += h * xc_f[o];
          ab[e] += h * xc_b[o];
          ay[e] += h;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_vec[3 * di + c0 + e] += af[e];
        s_vec[4 * di + c0 + e] += ab[e];
        s_vec[5 * di + c0 + e] += ay[e];
      }
    }
  }
  __syncthreads();
  // rows 0-4 and db_out to this block's slot of vec_part ([5·di | dm]),
  // row 5 (the line sum) to dy
  float* vp = vec_part + prow * (5 * static_cast<size_t>(di) + dm);
  for (int i = tid; i < kNVec * di; i += kThreads) {
    if (i < 5 * di)
      vp[i] = s_vec[i];
    else
      dy[prow * di + i - 5 * di] = s_vec[i];
  }
#pragma unroll
  for (int k = 0; k < kDbo; ++k)
    if (tid + k * kThreads < dm) vp[5 * di + tid + k * kThreads] = dbo[k];
}

// =====================================================================
// K6: pass A backward
// =====================================================================
// shared memory of the K6 conv-adjoint kernel, in bytes
__host__ __device__ inline size_t pass_a_bwd_smem(int ln) {
  const int ntok = ln + 2 * kPad;
  const size_t xin = static_cast<size_t>(ntok) * kACh * sizeof(float);
  const size_t stage = (static_cast<size_t>(kAKc) * (kAPass + 1) +
                        static_cast<size_t>(kAKc) * (kACh + 1)) * sizeof(float);
  const size_t dy = 2 * static_cast<size_t>(ntok) * kACh * sizeof(float);
  // at the end the block's partial sums reuse the buffer from its start
  const size_t red = 4 * kCVec * kACh * sizeof(float);
  const size_t total = xin + (stage > dy ? stage : dy);
  return total > red ? total : red;
}

// A block owns one line × 64 channels: recompute xin for the line and its
// halo, the cotangents of the conv pre-activations there, and from them
// dxin (written in T for the GEMMs that follow) and the block's partial of
// the conv weight / bias gradients and of db_x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pass_a_bwd_conv_kernel(const T* __restrict__ x, const T* __restrict__ w_x,
                       const float* __restrict__ b_x,
                       const float* __restrict__ w_cf,
                       const float* __restrict__ b_cf,
                       const float* __restrict__ w_ab,
                       const float* __restrict__ b_ab,
                       const T* __restrict__ dxc_f, const T* __restrict__ dxc_b,
                       const T* __restrict__ dpf, const T* __restrict__ dpb,
                       T* __restrict__ dxin, float* __restrict__ c_part, int H,
                       int W, int dm, int di, bool transposed, float scaling) {
  extern __shared__ __align__(128) unsigned char smem_c[];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kACh;
  const int b = blockIdx.z;
  const Line L{H, W, transposed ? W : H, transposed ? H : W,
               static_cast<int>(blockIdx.y), transposed,
               static_cast<size_t>(b) * H * W};
  const int ntok = L.ln + 2 * kPad;
  float* s_xin = reinterpret_cast<float*>(smem_c);  // [ntok][kACh]
  unsigned char* rest = smem_c + static_cast<size_t>(ntok) * kACh * sizeof(float);
  // the GEMM's staging buffers, then (after its last barrier) dyc and dya
  float* s_dyc = reinterpret_cast<float*>(rest);            // [ntok][kACh]
  float* s_dya = s_dyc + static_cast<size_t>(ntok) * kACh;  // [ntok][kACh]
  // the partial sums reuse the buffer from its start once s_xin, s_dyc
  // and s_dya have been read (pass_a_bwd_smem keeps it large enough);
  // a buffer of their own would leave one block per SM at 128-token lines
  float* s_red = s_xin;                                     // [4][kCVec][kACh]
  float* s_x = reinterpret_cast<float*>(rest);
  xin_tile_fma<T>(x, w_x, b_x, L, c0, dm, s_xin, s_x,
                  s_x + kAKc * (kAPass + 1));

  const int c = tid % kACh, g4 = tid / kACh;
  const int cc = c0 + c;
  float wc[4], wa[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wc[k] = w_cf[cc * 4 + k];
    wa[k] = w_ab[cc * 4 + k];
  }
  const float bc = b_cf ? b_cf[cc] : 0.f;
  const float ba = b_ab ? b_ab[cc] : 0.f;
  const float sw = scaling / static_cast<float>(L.ln);
  // cotangents of the pre-activations over the extended line: dyc where
  // the causal conv's inputs lie in the tile (j >= 3: the line and the
  // next line's first 3 tokens), dya likewise (j < ln + 3: the previous
  // line's last 3 tokens and the line)
  for (int j = g4; j < ntok; j += 4) {
    const long tok = L.token(j);
    float dyc = 0.f, dya = 0.f;
    if (tok >= 0) {  // masked before any load
      const int line = j < kPad ? L.p - 1 : (j >= L.ln + kPad ? L.p + 1 : L.p);
      const size_t off = (L.img + tok) * di + cc;
      const size_t poff = (static_cast<size_t>(b) * L.P + line) * di + cc;
      const float* col = s_xin + static_cast<size_t>(j) * kACh + c;
      if (j >= kPad) {
        float yc = bc;
#pragma unroll
        for (int k = 0; k < 4; ++k) yc += col[(k - kPad) * kACh] * wc[k];
        dyc = (fv::to_f32(dxc_f[off]) + fv::to_f32(dpf[poff]) * sw) *
              fv::dsilu(yc);
      }
      if (j < L.ln + kPad) {
        float ya = ba;
#pragma unroll
        for (int k = 0; k < 4; ++k) ya += col[k * kACh] * wa[kPad - k];
        dya = (fv::to_f32(dxc_b[off]) + fv::to_f32(dpb[poff]) * sw) *
              fv::dsilu(ya);
      }
    }
    s_dyc[j * kACh + c] = dyc;
    s_dya[j * kACh + c] = dya;
  }
  __syncthreads();

  float part[kCVec];
#pragma unroll
  for (int q = 0; q < kCVec; ++q) part[q] = 0.f;
  for (int i = g4; i < L.ln; i += 4) {
    const int j = i + kPad;
    const float* xcol = s_xin + static_cast<size_t>(j) * kACh + c;
    const float* ccol = s_dyc + static_cast<size_t>(j) * kACh + c;
    const float* acol = s_dya + static_cast<size_t>(j) * kACh + c;
    const float dyc = ccol[0], dya = acol[0];
    float dxi = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      part[k] += xcol[(k - kPad) * kACh] * dyc;  // dw_c[k]: x[t-3+k]·dyc[t]
      part[4 + kPad - k] += xcol[k * kACh] * dya;  // dw_a[3-k]: x[t+k]·dya[t]
      dxi += wc[k] * ccol[(kPad - k) * kACh]       // w_c[k]·dyc[t+3-k]
             + wa[kPad - k] * acol[-k * kACh];     // w_a[3-k]·dya[t-k]
    }
    part[8] += dyc;
    part[9] += dya;
    part[10] += dxi;
    dxin[(L.img + L.token(j)) * di + cc] = fv::from_f32<T>(dxi);
  }
  __syncthreads();  // the tiles' readers are done: they hold the partials now
#pragma unroll
  for (int q = 0; q < kCVec; ++q) s_red[(g4 * kCVec + q) * kACh + c] = part[q];
  __syncthreads();
  if (g4 == 0) {
    float* cp = c_part + (static_cast<size_t>(b) * L.P + L.p) * kCVec * di;
#pragma unroll
    for (int q = 0; q < kCVec; ++q) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) sum += s_red[(k * kCVec + q) * kACh + c];
      cp[q * di + cc] = sum;
    }
  }
}

// ---------------------------------------------------------------------
// launchers (fp32)
// ---------------------------------------------------------------------
template <int kR, int kJ>
cudaError_t launch_b_main(const void* g, const void* x, const void* xc_f,
                          const void* xc_b, const void* yf, const void* yb,
                          const void* w_z, const void* w_z_t, const void* b_z,
                          const void* d_f, const void* d_b, const void* ln_w,
                          const void* ln_b, const void* w_out_t, void* dx,
                          void* dxc_f, void* dxc_b, void* dy, void* mg,
                          void* dz, void* vec_part, int batch, int H, int W,
                          int dm, int di, bool transposed, bool use_ln,
                          float eps, cudaStream_t stream) {
  const size_t smem = pass_b_bwd_smem(dm, di, kR);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<pass_b_bwd_kernel<float, kR, kJ>>();
  if (err != cudaSuccess) return err;
  auto cT = [](const void* p) { return static_cast<const float*>(p); };
  auto mT = [](void* p) { return static_cast<float*>(p); };
  dim3 grid(transposed ? W : H, batch);
  pass_b_bwd_kernel<float, kR, kJ><<<grid, kThreads, smem, stream>>>(
      cT(g), cT(x), cT(xc_f), cT(xc_b), cT(yf), cT(yb), cT(w_z), cT(w_z_t),
      cT(b_z), cT(d_f), cT(d_b), cT(ln_w), cT(ln_b), cT(w_out_t), mT(dx),
      mT(dxc_f), mT(dxc_b), mT(dy), mT(mg), mT(dz), mT(vec_part), H, W, dm,
      di, transposed, use_ln, eps);
  return cudaGetLastError();
}

template <int kR>
cudaError_t launch_b_wide(const void* g, const void* x, const void* xc_f,
                          const void* xc_b, const void* yf, const void* yb,
                          const void* w_z, const void* b_z, const void* d_f,
                          const void* d_b, const void* ln_w, const void* ln_b,
                          const void* w_out_t, void* dxc_f, void* dxc_b,
                          void* dy, void* mg, void* dz, void* vec_part,
                          int batch, int H, int W, int dm, int di,
                          bool transposed, bool use_ln, float eps,
                          cudaStream_t stream) {
  const size_t smem = pass_b_bwd_wide_smem(di, kR);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<pass_b_bwd_wide_kernel<kR>>();
  if (err != cudaSuccess) return err;
  auto cT = [](const void* p) { return static_cast<const float*>(p); };
  auto mT = [](void* p) { return static_cast<float*>(p); };
  dim3 grid(transposed ? W : H, batch);
  pass_b_bwd_wide_kernel<kR><<<grid, kThreads, smem, stream>>>(
      cT(g), cT(x), cT(xc_f), cT(xc_b), cT(yf), cT(yb), cT(w_z), cT(b_z),
      cT(d_f), cT(d_b), cT(ln_w), cT(ln_b), cT(w_out_t), mT(dxc_f),
      mT(dxc_b), mT(dy), mT(mg), mT(dz), mT(vec_part), H, W, dm, di,
      transposed, use_ln, eps);
  return cudaGetLastError();
}

}  // namespace

// Pass B backward. g, x: (batch, H, W, dm); xc_f, xc_b: (batch, H, W, di);
// yf, yb: (batch, P, di); w_z: (di, dm); w_out: (dm, di), out_proj.weight;
// all of `dtype` (0 fp32, 1 bf16). The fp32 path also reads w_z_t (dm, di)
// and w_out_t (di, dm), their transposes; the bf16 path ignores them (may
// be null). b_z (may be null), d_f, d_b, ln_w, ln_b (read only with
// use_ln): (di,) fp32. Outputs: dx (batch, H, W, dm) fp32; dxc_f, dxc_b,
// dy (batch, P, di) of `dtype`; dw_out (dm, di), dw_z (di, dm) and vec =
// [db_z | dln_w | dln_b | dd_f | dd_b | db_out] (5·di + dm) fp32. Scratch:
// mg, dz (tokens, di) of `dtype`; vec_part (batch·P, 5·di + dm) and w_part
// (2, nsplit, di·dm) fp32. dm, di % 64 == 0, dm <= di, dm <=
// fvb::kBwdMaxDm, di <= fvb::kBwdMaxDi. Three launches up to d_model 384
// and d_inner 768 (fp32: d_inner 384), else four (the wide forms' dx̂
// product). Returns a cudaError_t.
extern "C" int fv_pass_b_bwd(const void* g, const void* x, const void* xc_f,
                             const void* xc_b, const void* yf, const void* yb,
                             const void* w_z, const void* w_z_t,
                             const void* b_z, const void* d_f, const void* d_b,
                             const void* ln_w, const void* ln_b,
                             const void* w_out, const void* w_out_t, void* dx,
                             void* dxc_f, void* dxc_b, void* dy, void* mg,
                             void* dz, void* vec_part, void* vec, void* w_part,
                             void* dw_out, void* dw_z, int batch, int H, int W,
                             int dm, int di, int transposed, int dtype,
                             int use_ln, int nsplit, float eps, void* stream) {
  const int P = transposed ? W : H;
  if ((dtype != fv::kF32 && dtype != fv::kBF16) || batch < 1 ||
      batch > 65535 || H < 1 || W < 1 || dm < kGT || dm % kGT != 0 ||
      dm > fvb::kBwdMaxDm || di < dm || di % kGT != 0 ||
      di > fvb::kBwdMaxDi || nsplit < 1 || 2 * nsplit > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == fv::kBF16)
    return fvb::pass_b_bwd_bf16(g, x, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b,
                                ln_w, ln_b, w_out, dx, dxc_f, dxc_b, dy, mg,
                                dz, vec_part, vec, w_part, dw_out, dw_z, batch,
                                H, W, dm, di, transposed, use_ln, nsplit, eps,
                                st);
  const long T = static_cast<long>(batch) * H * W;
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err;
  if (fvb::wide_form(dm, di) || di > kF32NarrowDi) {
    // 16-token tiles on short lines (a 14-token line of 224 px)
    err = (transposed ? H : W) <= 16
              ? launch_b_wide<2>(g, x, xc_f, xc_b, yf, yb, w_z, b_z, d_f,
                                 d_b, ln_w, ln_b, w_out_t, dxc_f, dxc_b, dy,
                                 mg, dz, vec_part, batch, H, W, dm, di,
                                 transposed, use_ln, eps, st)
              : launch_b_wide<4>(g, x, xc_f, xc_b, yf, yb, w_z, b_z, d_f,
                                 d_b, ln_w, ln_b, w_out_t, dxc_f, dxc_b, dy,
                                 mg, dz, vec_part, batch, H, W, dm, di,
                                 transposed, use_ln, eps, st);
    if (err != cudaSuccess) return err;
    // dx̂ (z half) = dz·W_z
    err = dx_rows(cF(dz), cF(w_z_t), nullptr, static_cast<float*>(dx), T, dm,
                  di, st);
  } else {
    err = launch_b_main<4, 12>(g, x, xc_f, xc_b, yf, yb, w_z, w_z_t, b_z,
                               d_f, d_b, ln_w, ln_b, w_out_t, dx, dxc_f,
                               dxc_b, dy, mg, dz, vec_part, batch, H, W, dm,
                               di, transposed, use_ln, eps, st);
  }
  if (err != cudaSuccess) return err;
  const size_t wn = static_cast<size_t>(di) * dm;
  auto* wp = static_cast<float*>(w_part);
  // dW_outᵀ (di, dm) = mgᵀ·g;  dW_z (di, dm) = dzᵀ·x̂
  err = wgrad(WgradJobs{{cF(mg), cF(dz)}, {cF(g), cF(x)}, 2}, di, dm, T,
              nsplit, wp, st);
  if (err != cudaSuccess) return err;
  return fvb::sum_segments(
      fvb::SumSegs{{{wp, static_cast<float*>(dw_out), static_cast<long>(wn),
                     nsplit, dm},
                    {wp + nsplit * wn, static_cast<float*>(dw_z),
                     static_cast<long>(wn), nsplit, 0},
                    {cF(vec_part), static_cast<float*>(vec), 5L * di + dm,
                     batch * P, 0}},
                   3},
      st);
}

// Pass A backward. x: (batch, H, W, dm); dxc_f, dxc_b: (batch, H, W, di);
// dpf, dpb: (batch, P, di); w_x: (di, dm); all of `dtype`. The fp32 path
// also reads w_x_t (dm, di), its transpose (bf16: ignored, may be null).
// dx_b: (batch, H, W, dm) fp32 from fv_pass_b_bwd. b_x, b_cf, b_ab: (di,)
// fp32 or null; w_cf, w_ab: (di, 4) fp32. Outputs: dx (batch, H, W, dm)
// fp32 = dx_b + dxin·W_x; dw_x (di, dm) fp32; c_vec (11, di) fp32 = rows
// dw_cf[:, 0..3], dw_ab[:, 0..3], db_cf, db_ab, db_x. Scratch: dxin (tokens,
// di) of `dtype`; c_part (batch·nblk, 11·di) with nblk = P lines in fp32
// and ceil(H·W / 58) windows in bf16; w_part (nsplit, di·dm) fp32. dm, di %
// 64 == 0, dm <= di, dm <= fvb::kBwdMaxDm, di <= fvb::kBwdMaxDi, lines of
// >= 4 tokens. Three launches in bf16 up to d_model 384 and d_inner 768,
// else four. Returns a cudaError_t.
extern "C" int fv_pass_a_bwd(const void* x, const void* dx_b,
                             const void* dxc_f, const void* dxc_b,
                             const void* dpf, const void* dpb, const void* w_x,
                             const void* w_x_t, const void* b_x,
                             const void* w_cf, const void* b_cf,
                             const void* w_ab, const void* b_ab, void* dx,
                             void* dxin, void* c_part, void* c_vec,
                             void* w_part, void* dw_x, int batch, int H, int W,
                             int dm, int di, int transposed, int dtype,
                             int nsplit, float scaling, void* stream) {
  const int ln = transposed ? H : W;
  const int P = transposed ? W : H;
  if ((dtype != fv::kF32 && dtype != fv::kBF16) || batch < 1 ||
      batch > 65535 || P < 1 || P > 65535 || ln < kPad + 1 || dm < kGT ||
      dm % kGT != 0 || dm > fvb::kBwdMaxDm || di < dm || di % kGT != 0 ||
      di > fvb::kBwdMaxDi || nsplit < 1 || nsplit > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == fv::kBF16)
    return fvb::pass_a_bwd_bf16(x, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x,
                                w_cf, b_cf, w_ab, b_ab, dx, dxin, c_part,
                                c_vec, w_part, dw_x, batch, H, W, dm, di,
                                transposed, nsplit, scaling, st);
  if (pass_a_bwd_smem(ln) > kMaxSmem) return cudaErrorInvalidValue;
  const long ntokens = static_cast<long>(batch) * H * W;
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = fv::allow_max_smem<pass_a_bwd_conv_kernel<float>>();
  if (err != cudaSuccess) return err;
  dim3 grid(di / kACh, P, batch);
  pass_a_bwd_conv_kernel<float><<<grid, kThreads, pass_a_bwd_smem(ln), st>>>(
      cF(x), cF(w_x), cF(b_x), cF(w_cf), cF(b_cf), cF(w_ab), cF(b_ab),
      cF(dxc_f), cF(dxc_b), cF(dpf), cF(dpb), static_cast<float*>(dxin),
      static_cast<float*>(c_part), H, W, dm, di, transposed, scaling);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dx̂ = dx̂(K5) + dxin·W_x
  err = dx_rows(cF(dxin), cF(w_x_t), cF(dx_b), static_cast<float*>(dx),
                ntokens, dm, di, st);
  if (err != cudaSuccess) return err;
  // dW_x (di, dm) = dxinᵀ·x̂
  err = wgrad(WgradJobs{{cF(dxin), nullptr}, {cF(x), nullptr}, 1}, di, dm,
              ntokens, nsplit, static_cast<float*>(w_part), st);
  if (err != cudaSuccess) return err;
  return fvb::sum_segments(
      fvb::SumSegs{{{cF(w_part), static_cast<float*>(dw_x),
                     static_cast<long>(di) * dm, nsplit, 0},
                    {cF(c_part), static_cast<float*>(c_vec),
                     static_cast<long>(kCVec) * di, batch * P, 0},
                    {nullptr, nullptr, 0, 0, 0}},
                   2},
      st);
}
