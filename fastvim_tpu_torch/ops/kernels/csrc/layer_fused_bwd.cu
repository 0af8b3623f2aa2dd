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
// What bounds them on the H100: five GEMMs per token for K5 (z, dgated, dx̂
// and the two weight gradients: 5 × 2 × 192 × 384 = 0.74 MFLOP) and four
// for K6 against ~5 KB (K5) and ~4 KB (K6) of bf16/fp32 traffic per token,
// so about 150 FLOP/byte: below the ~295 at which bf16 tensor cores are
// the limit, so memory traffic bounds the bf16 path; the fp32 path runs
// FMA tiles and is FMA-bound.
//
// The cross-block sums, which the TPU kernel got from a sequential grid
// that revisits one output block (`_acc`):
// - dW_out, dW_z, dW_x contract over all tokens; the partial of one
//   32-token tile would be 295 KB, so no block keeps one. The main kernels
//   write their GEMM operands (mln·silu(z), dz, dxin: T × d_inner in the
//   working dtype) to device memory once, and `wgrad_kernel` computes
//   Aᵀ·B as a split-K GEMM: a block owns a 64 × 64 tile of the weight
//   gradient over one slice of the tokens and keeps its partial in
//   registers; `sum_partials_kernel` adds the slices in a fixed order.
// - the vector sums (biases, LN, D, conv weights) are kept in registers
//   per block over all its tokens, written once per block, and added by
//   `sum_partials_kernel`.
// - dyf = dyb sums over a line: a K5 block owns one whole line (a row on
//   even layers, a strided column on odd ones) and walks it in 32-token
//   tiles, so the line sum never leaves the block.
// No atomics anywhere: the results are the same from run to run.
//
// K6's conv adjoint needs the neighbouring lines' cotangents (the next
// line's first 3 causal outputs and the previous line's last 3 anticausal
// ones read this line's xin). As in K3 a block owns one line × 64 channels
// and computes xin for the line plus 3 halo tokens on each side; from that
// tile it recomputes yc at the next line's first 3 tokens and ya at the
// previous line's last 3, reads their cotangents, and has everything the
// adjoint needs. Halo tokens outside the sequence (before the first line,
// after the last) are masked BEFORE any load of x̂, dxc or dp: nothing is
// read there and their terms are 0.

#include "layer_fused.cuh"

namespace {

// =====================================================================
// weight-gradient GEMM: part[z] = A[t-slice]ᵀ · B[t-slice]
// =====================================================================
constexpr int kGT = 64;  // output tile edge and tokens per step

// A: (T, M), B: (T, N) row-major in Tt; part: (nsplit, M, N) fp32. Block
// (x, y, z) owns rows 64y.., columns 64x.. over the z-th slice of T.
template <typename Tt>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const Tt* __restrict__ A, int M, const Tt* __restrict__ B, int N,
             long T, float* __restrict__ part) {
  constexpr int kVe = fv::kVec<Tt>;
  constexpr int kLd = kGT + 16 / static_cast<int>(sizeof(Tt));  // skewed row
  constexpr int kIters = kGT * kGT / kVe / kThreads;
  __shared__ __align__(32) Tt s_a[kGT * kLd];
  __shared__ __align__(32) Tt s_b[kGT * kLd];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kGT, m0 = blockIdx.y * kGT;
  const long per = ((T + gridDim.z - 1) / gridDim.z + kGT - 1) / kGT * kGT;
  const long t_begin = blockIdx.z * per;
  const long t_end = t_begin + per < T ? t_begin + per : T;
  float* out = part + (static_cast<size_t>(blockIdx.z) * M + m0) * N + n0;

  auto load_tiles = [&](long t0) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kGT / kVe), v = i % (kGT / kVe);
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (t0 + r < t_end) {
        va = fv::load16(A + (t0 + r) * M + m0 + v * kVe);
        vb = fv::load16(B + (t0 + r) * N + n0 + v * kVe);
      }
      *reinterpret_cast<uint4*>(s_a + r * kLd + v * kVe) = va;
      *reinterpret_cast<uint4*>(s_b + r * kLd + v * kVe) = vb;
    }
  };

  if constexpr (std::is_same<Tt, bf16>::value) {
    // warp → row tile w / 2, column tiles 2 (w % 2) + {0, 1}
    const int warp = tid / 32;
    const int mt = warp / 2, nt = (warp % 2) * 2;
    wmma::fragment<wmma::accumulator, kWm, kWm, kWm, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (long t0 = t_begin; t0 < t_end; t0 += kGT) {
      __syncthreads();  // the previous step's readers are done
      load_tiles(t0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kGT / kWm; ++kk) {
        // element (m, k) of Aᵀ is s_a[k][m]: column-major with stride kLd
        wmma::fragment<wmma::matrix_a, kWm, kWm, kWm, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, s_a + kk * kWm * kLd + mt * kWm, kLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, kWm, kWm, kWm, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, s_b + kk * kWm * kLd + (nt + j) * kWm,
                                 kLd);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          out + static_cast<size_t>(mt) * kWm * N + (nt + j) * kWm, acc[j], N,
          wmma::mem_row_major);
  } else {
    // thread → rows 4 ty.., columns 4 tx..
    const int tx = tid % 16, ty = tid / 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (long t0 = t_begin; t0 < t_end; t0 += kGT) {
      __syncthreads();
      load_tiles(t0);
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
}

// dW (M, N) fp32 = Aᵀ·B over all T tokens, through `part` (nsplit, M, N)
template <typename Tt>
cudaError_t wgrad(const void* A, int M, const void* B, int N, long T,
                  int nsplit, float* part, float* dW, cudaStream_t stream) {
  dim3 grid(N / kGT, M / kGT, nsplit);
  wgrad_kernel<Tt><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tt*>(A), M, static_cast<const Tt*>(B), N, T, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fv::sum_partials(part, dW, static_cast<long>(M) * N, nsplit, 1,
                          stream);
}

// =====================================================================
// K5: pass B backward
// =====================================================================
constexpr int kBwdMaxDi = 384;          // per-lane registers: di / 32 <= 12
constexpr int kBwdJ = kBwdMaxDi / 32;
constexpr int kNVec = 6;                // db_z, dln_w, dln_b, dd_f, dd_b, dy

// shared memory of the K5 main kernel, in bytes
__host__ __device__ inline size_t pass_b_bwd_smem(int dm, int di, bool tc) {
  const size_t zdg = 2 * static_cast<size_t>(kBTok) * imax(di, dm) *
                     sizeof(float);  // z (later dx̂) and dgated
  if (tc)
    return 2 * static_cast<size_t>(kBTok) * (dm + 8) * sizeof(bf16)  // x̂, g
           + zdg + static_cast<size_t>(kBTok) * (di + 8) * sizeof(bf16);  // dz
  return (2 * static_cast<size_t>(kBTok) * dm +
          static_cast<size_t>(kBKc) * (kBSlab + 1)) * sizeof(float) + zdg;
}

// the 32-token tile `seg` of the line a K5 block owns
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

// The elementwise middle of K5 for the tile's tokens (one warp per 4
// tokens, a lane per channel c = lane + 32 j): merge, LayerNorm forward
// and backward, gate backward. Reads z (without bias) from s_z and dgated
// from s_dg (row stride ld); writes dz into s_dz (row stride ldz; may
// alias s_z: same element, same thread), mg and dz (rounded to T) to
// device memory, dxc_f / dxc_b, and adds this tile into acc.
template <typename T, typename G>
__device__ __forceinline__ void merge_bwd(
    const float* s_z, const float* s_dg, int ld, G* s_dz, int ldz,
    const Seg& sg, size_t prow, const T* __restrict__ xc_f,
    const T* __restrict__ xc_b, const T* __restrict__ yf,
    const T* __restrict__ yb, const float* __restrict__ b_z,
    const float* __restrict__ d_f, const float* __restrict__ d_b,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    T* __restrict__ dxc_f, T* __restrict__ dxc_b, T* __restrict__ mg,
    T* __restrict__ dzs, int di, bool use_ln, float eps,
    float (&acc)[kNVec][kBwdJ]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nj = di / 32;
  const float inv_di = 1.f / static_cast<float>(di);
  for (int r = 0; r < 4; ++r) {
    const int t = 4 * warp + r;
    if (!sg.valid(t)) {  // past the line's end: a zero row for the dx̂ GEMM
#pragma unroll
      for (int j = 0; j < kBwdJ; ++j)
        if (j < nj) {
          if constexpr (std::is_same<G, float>::value)
            s_dz[t * ldz + lane + 32 * j] = 0.f;
          else
            s_dz[t * ldz + lane + 32 * j] = fv::from_f32<G>(0.f);
        }
      continue;
    }
    const size_t tok = sg.token(t);
    float m[kBwdJ], dmh[kBwdJ];
    float sum = 0.f, sumsq = 0.f;
#pragma unroll
    for (int j = 0; j < kBwdJ; ++j) {
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
    for (int j = 0; j < kBwdJ; ++j) {
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
    for (int j = 0; j < kBwdJ; ++j) {
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
template <typename T>
__device__ __forceinline__ void finish_b_bwd(
    float* s_red, const float (&acc)[kNVec][kBwdJ], float dbo, int dm, int di,
    size_t prow, float* __restrict__ vec_part, T* __restrict__ dy) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nj = di / 32;
  __syncthreads();  // the tile buffers are free
#pragma unroll
  for (int q = 0; q < kNVec; ++q)
#pragma unroll
    for (int j = 0; j < kBwdJ; ++j)
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
  if (threadIdx.x < dm) vp[5 * di + threadIdx.x] = dbo;
}

// FMA GEMM path (fp32)
template <typename T>
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
  extern __shared__ float smem_f[];
  const int ldz = imax(di, dm);
  float* s_x = smem_f;                                  // [kBTok][dm]
  float* s_g = s_x + static_cast<size_t>(kBTok) * dm;   // [kBTok][dm]
  float* s_z = s_g + static_cast<size_t>(kBTok) * dm;   // [kBTok][ldz]
  float* s_dg = s_z + static_cast<size_t>(kBTok) * ldz;  // [kBTok][ldz]
  float* s_w = s_dg + static_cast<size_t>(kBTok) * ldz;  // [kBKc][kBSlab+1]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  Seg sg{H, W, ln, static_cast<int>(blockIdx.x), 0, transposed,
         static_cast<size_t>(b) * H * W};
  const size_t prow = static_cast<size_t>(b) * P + blockIdx.x;
  float acc[kNVec][kBwdJ];
#pragma unroll
  for (int q = 0; q < kNVec; ++q)
#pragma unroll
    for (int j = 0; j < kBwdJ; ++j) acc[q][j] = 0.f;
  float dbo = 0.f;
  float gacc[4][kBCols];

  for (sg.i0 = 0; sg.i0 < ln; sg.i0 += kBTok) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBTok * dm; i += kThreads) {
      const int t = i / dm, k = i % dm;
      const bool ok = sg.valid(t);  // masked before the load
      s_x[i] = ok ? fv::to_f32(x[sg.token(t) * dm + k]) : 0.f;
      s_g[i] = ok ? fv::to_f32(g[sg.token(t) * dm + k]) : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < dm)
      for (int t = 0; t < kBTok; ++t) dbo += s_g[t * dm + threadIdx.x];
    // z = x̂·W_zᵀ and dgated = g·W_out, per 384-column slab
    for (int n0 = 0; n0 < di; n0 += kBSlab) {
      const int ncols = min(kBCols, (di - n0) / 32);
      for (int which = 0; which < 2; ++which) {
        gemm_rows<T>(which ? s_g : s_x, which ? w_out_t : w_z, dm, n0, ncols,
                     s_w, gacc);
        float* dst = which ? s_dg : s_z;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < kBCols; ++j)
            if (j < ncols)
              dst[(4 * warp + r) * ldz + n0 + lane + 32 * j] = gacc[r][j];
      }
    }
    __syncthreads();
    merge_bwd<T, float>(s_z, s_dg, ldz, s_z, ldz, sg, prow, xc_f, xc_b, yf, yb,
                        b_z, d_f, d_b, ln_w, ln_b, dxc_f, dxc_b, mg, dzs, di,
                        use_ln, eps, acc);
    // dx̂ (z half) = dz·W_z
    for (int n0 = 0; n0 < dm; n0 += kBSlab) {
      const int ncols = min(kBCols, (dm - n0) / 32);
      gemm_rows<T>(s_z, w_z_t, di, n0, ncols, s_w, gacc);  // barriers inside
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * warp + r;
#pragma unroll
        for (int j = 0; j < kBCols; ++j)
          if (j < ncols && sg.valid(t))
            dx[sg.token(t) * dm + n0 + lane + 32 * j] = gacc[r][j];
      }
    }
  }
  finish_b_bwd<T>(s_z, acc, dbo, dm, di, prow, vec_part, dy);
}

// WMMA GEMM path (bf16)
__global__ void __launch_bounds__(kThreads, 1)
pass_b_bwd_wmma_kernel(
    const bf16* __restrict__ g, const bf16* __restrict__ x,
    const bf16* __restrict__ xc_f, const bf16* __restrict__ xc_b,
    const bf16* __restrict__ yf, const bf16* __restrict__ yb,
    const bf16* __restrict__ w_z, const bf16* __restrict__ w_z_t,
    const float* __restrict__ b_z, const float* __restrict__ d_f,
    const float* __restrict__ d_b, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const bf16* __restrict__ w_out_t,
    float* __restrict__ dx, bf16* __restrict__ dxc_f, bf16* __restrict__ dxc_b,
    bf16* __restrict__ dy, bf16* __restrict__ mg, bf16* __restrict__ dzs,
    float* __restrict__ vec_part, int H, int W, int dm, int di,
    bool transposed, bool use_ln, float eps) {
  extern __shared__ __align__(128) unsigned char smem_w[];
  const int ldx = dm + 8, ldd = di + 8;  // 16 bytes of skew per row
  const int ldz = imax(di, dm);
  bf16* s_xb = reinterpret_cast<bf16*>(smem_w);              // [kBTok][ldx]
  bf16* s_gb = s_xb + static_cast<size_t>(kBTok) * ldx;      // [kBTok][ldx]
  float* s_z = reinterpret_cast<float*>(
      s_gb + static_cast<size_t>(kBTok) * ldx);              // [kBTok][ldz]
  float* s_dg = s_z + static_cast<size_t>(kBTok) * ldz;      // [kBTok][ldz]
  bf16* s_dzb = reinterpret_cast<bf16*>(
      s_dg + static_cast<size_t>(kBTok) * ldz);              // [kBTok][ldd]
  const int b = blockIdx.y;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  Seg sg{H, W, ln, static_cast<int>(blockIdx.x), 0, transposed,
         static_cast<size_t>(b) * H * W};
  const size_t prow = static_cast<size_t>(b) * P + blockIdx.x;
  float acc[kNVec][kBwdJ];
#pragma unroll
  for (int q = 0; q < kNVec; ++q)
#pragma unroll
    for (int j = 0; j < kBwdJ; ++j) acc[q][j] = 0.f;
  float dbo = 0.f;
  const int vpr = dm / 8;  // 16-byte vectors per row of x̂ and g

  for (sg.i0 = 0; sg.i0 < ln; sg.i0 += kBTok) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBTok * vpr; i += kThreads) {
      const int t = i / vpr, v = i % vpr;
      uint4 vx = make_uint4(0u, 0u, 0u, 0u), vg = vx;
      if (sg.valid(t)) {  // masked before the load
        vx = fv::load16(x + sg.token(t) * dm + v * 8);
        vg = fv::load16(g + sg.token(t) * dm + v * 8);
      }
      *reinterpret_cast<uint4*>(s_xb + static_cast<size_t>(t) * ldx + v * 8) =
          vx;
      *reinterpret_cast<uint4*>(s_gb + static_cast<size_t>(t) * ldx + v * 8) =
          vg;
    }
    __syncthreads();
    if (threadIdx.x < dm)
      for (int t = 0; t < kBTok; ++t)
        dbo += fv::to_f32(s_gb[t * ldx + threadIdx.x]);
    wmma_rows(s_xb, ldx, w_z, dm, di, s_z, ldz);       // z = x̂·W_zᵀ
    wmma_rows(s_gb, ldx, w_out_t, dm, di, s_dg, ldz);  // dgated = g·W_out
    __syncthreads();
    merge_bwd<bf16, bf16>(s_z, s_dg, ldz, s_dzb, ldd, sg, prow, xc_f, xc_b, yf,
                          yb, b_z, d_f, d_b, ln_w, ln_b, dxc_f, dxc_b, mg, dzs,
                          di, use_ln, eps, acc);
    __syncthreads();
    wmma_rows(s_dzb, ldd, w_z_t, di, dm, s_z, dm);  // dx̂ (z half) = dz·W_z
    __syncthreads();
    for (int i = threadIdx.x; i < kBTok * dm; i += kThreads) {
      const int t = i / dm;
      if (sg.valid(t)) dx[sg.token(t) * dm + i % dm] = s_z[i];
    }
  }
  finish_b_bwd<bf16>(s_z, acc, dbo, dm, di, prow, vec_part, dy);
}

// =====================================================================
// K6: pass A backward
// =====================================================================
constexpr int kCVec = 11;  // dw_cf[4], dw_ab[4], db_cf, db_ab, db_x

// shared memory of the K6 conv-adjoint kernel, in bytes
__host__ __device__ inline size_t pass_a_bwd_smem(int ln, int dm, bool tc) {
  const int ntok = ln + 2 * kPad;
  const size_t xin = static_cast<size_t>(tc ? round16(ntok) : ntok) * kACh *
                     sizeof(float);
  const size_t stage =
      tc ? static_cast<size_t>(imin(kAWRows, round16(ntok))) * (dm + 8) *
               sizeof(bf16)
         : (static_cast<size_t>(kAKc) * (kAPass + 1) +
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
  constexpr bool kTc = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem_c[];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kACh;
  const int b = blockIdx.z;
  const Line L{H, W, transposed ? W : H, transposed ? H : W,
               static_cast<int>(blockIdx.y), transposed,
               static_cast<size_t>(b) * H * W};
  const int ntok = L.ln + 2 * kPad;
  float* s_xin = reinterpret_cast<float*>(smem_c);  // [ntok(16)][kACh]
  unsigned char* rest =
      smem_c + static_cast<size_t>(kTc ? round16(ntok) : ntok) * kACh *
                   sizeof(float);
  // the GEMM's staging buffers, then (after its last barrier) dyc and dya
  float* s_dyc = reinterpret_cast<float*>(rest);            // [ntok][kACh]
  float* s_dya = s_dyc + static_cast<size_t>(ntok) * kACh;  // [ntok][kACh]
  // the partial sums reuse the buffer from its start once s_xin, s_dyc
  // and s_dya have been read (pass_a_bwd_smem keeps it large enough);
  // a buffer of their own would leave one block per SM at 128-token lines
  float* s_red = s_xin;                                     // [4][kCVec][kACh]
  if constexpr (kTc) {
    xin_tile_wmma(x, w_x, b_x, L, c0, dm, s_xin,
                  reinterpret_cast<bf16*>(rest));
  } else {
    float* s_x = reinterpret_cast<float*>(rest);
    xin_tile_fma<T>(x, w_x, b_x, L, c0, dm, s_xin, s_x,
                    s_x + kAKc * (kAPass + 1));
  }

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

// dx̂ = dx̂(K5) + dxin·W_x over 32-token tiles; w_x_t: (dm, di).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
pass_a_bwd_dx_kernel(const T* __restrict__ dxin, const T* __restrict__ w_x_t,
                     const float* __restrict__ dx_b, float* __restrict__ dx,
                     long ntokens, int dm, int di) {
  extern __shared__ __align__(128) unsigned char smem_d[];
  const long tok0 = static_cast<long>(blockIdx.x) * kBTok;
  const int ntile = ntokens - tok0 < kBTok ? static_cast<int>(ntokens - tok0)
                                           : kBTok;
  if constexpr (std::is_same<T, bf16>::value) {
    const int ldd = di + 8;
    bf16* s_a = reinterpret_cast<bf16*>(smem_d);  // [kBTok][ldd]
    float* s_o = reinterpret_cast<float*>(
        s_a + static_cast<size_t>(kBTok) * ldd);  // [kBTok][dm]
    const int vpr = di / 8;
    for (int i = threadIdx.x; i < kBTok * vpr; i += kThreads) {
      const int t = i / vpr, v = i % vpr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (t < ntile) val = fv::load16(dxin + (tok0 + t) * di + v * 8);
      *reinterpret_cast<uint4*>(s_a + static_cast<size_t>(t) * ldd + v * 8) =
          val;
    }
    __syncthreads();
    wmma_rows(s_a, ldd, w_x_t, di, dm, s_o, dm);
    __syncthreads();
    for (int i = threadIdx.x; i < ntile * dm; i += kThreads)
      dx[tok0 * dm + i] = dx_b[tok0 * dm + i] + s_o[i];
  } else {
    float* s_a = reinterpret_cast<float*>(smem_d);          // [kBTok][di]
    float* s_w = s_a + static_cast<size_t>(kBTok) * di;     // [kBKc][kBSlab+1]
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int i = threadIdx.x; i < kBTok * di; i += kThreads)
      s_a[i] = i < ntile * di ? fv::to_f32(dxin[tok0 * di + i]) : 0.f;
    float acc[4][kBCols];
    for (int n0 = 0; n0 < dm; n0 += kBSlab) {
      const int ncols = min(kBCols, (dm - n0) / 32);
      gemm_rows<T>(s_a, w_x_t, di, n0, ncols, s_w, acc);  // barriers inside
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * warp + r;
#pragma unroll
        for (int j = 0; j < kBCols; ++j)
          if (j < ncols && t < ntile) {
            const size_t o = (tok0 + t) * dm + n0 + lane + 32 * j;
            dx[o] = dx_b[o] + acc[r][j];
          }
      }
    }
  }
}

__host__ inline size_t pass_a_bwd_dx_smem(int dm, int di, bool tc) {
  if (tc)
    return static_cast<size_t>(kBTok) * (di + 8) * sizeof(bf16) +
           static_cast<size_t>(kBTok) * dm * sizeof(float);
  return (static_cast<size_t>(kBTok) * di +
          static_cast<size_t>(kBKc) * (kBSlab + 1)) * sizeof(float);
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------
template <typename T>
cudaError_t launch_b_bwd(const void* g, const void* x, const void* xc_f,
                         const void* xc_b, const void* yf, const void* yb,
                         const void* w_z, const void* w_z_t, const void* b_z,
                         const void* d_f, const void* d_b, const void* ln_w,
                         const void* ln_b, const void* w_out_t, void* dx,
                         void* dxc_f, void* dxc_b, void* dy, void* mg, void* dz,
                         void* vec_part, void* vec, void* w_part, void* dw_out,
                         void* dw_z, int batch, int H, int W, int dm, int di,
                         bool transposed, bool use_ln, int nsplit, float eps,
                         cudaStream_t stream) {
  constexpr bool kTc = std::is_same<T, bf16>::value;
  const int P = transposed ? W : H;
  const long ntokens = static_cast<long>(batch) * H * W;
  const size_t smem = pass_b_bwd_smem(dm, di, kTc);
  auto cT = [](const void* p) { return static_cast<const T*>(p); };
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  auto mT = [](void* p) { return static_cast<T*>(p); };
  dim3 grid(P, batch);
  cudaError_t err;
  if constexpr (kTc) {
    err = fv::allow_max_smem<pass_b_bwd_wmma_kernel>();
    if (err != cudaSuccess) return err;
    pass_b_bwd_wmma_kernel<<<grid, kThreads, smem, stream>>>(
        cT(g), cT(x), cT(xc_f), cT(xc_b), cT(yf), cT(yb), cT(w_z), cT(w_z_t),
        cF(b_z), cF(d_f), cF(d_b), cF(ln_w), cF(ln_b), cT(w_out_t),
        static_cast<float*>(dx), mT(dxc_f), mT(dxc_b), mT(dy), mT(mg), mT(dz),
        static_cast<float*>(vec_part), H, W, dm, di, transposed, use_ln, eps);
  } else {
    err = fv::allow_max_smem<pass_b_bwd_kernel<T>>();
    if (err != cudaSuccess) return err;
    pass_b_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
        cT(g), cT(x), cT(xc_f), cT(xc_b), cT(yf), cT(yb), cT(w_z), cT(w_z_t),
        cF(b_z), cF(d_f), cF(d_b), cF(ln_w), cF(ln_b), cT(w_out_t),
        static_cast<float*>(dx), mT(dxc_f), mT(dxc_b), mT(dy), mT(mg), mT(dz),
        static_cast<float*>(vec_part), H, W, dm, di, transposed, use_ln, eps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* wp = static_cast<float*>(w_part);
  // dW_out (dm, di) = gᵀ·(mln·silu(z));  dW_z (di, dm) = dzᵀ·x̂
  err = wgrad<T>(g, dm, mg, di, ntokens, nsplit, wp,
                 static_cast<float*>(dw_out), stream);
  if (err != cudaSuccess) return err;
  err = wgrad<T>(dz, di, x, dm, ntokens, nsplit, wp,
                 static_cast<float*>(dw_z), stream);
  if (err != cudaSuccess) return err;
  return fv::sum_partials(static_cast<const float*>(vec_part),
                          static_cast<float*>(vec), 5L * di + dm, batch * P, 1,
                          stream);
}

template <typename T>
cudaError_t launch_a_bwd(const void* x, const void* dx_b, const void* dxc_f,
                         const void* dxc_b, const void* dpf, const void* dpb,
                         const void* w_x, const void* w_x_t, const void* b_x,
                         const void* w_cf, const void* b_cf, const void* w_ab,
                         const void* b_ab, void* dx, void* dxin, void* c_part,
                         void* c_vec, void* w_part, void* dw_x, int batch,
                         int H, int W, int dm, int di, bool transposed,
                         int nsplit, float scaling, cudaStream_t stream) {
  constexpr bool kTc = std::is_same<T, bf16>::value;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const long ntokens = static_cast<long>(batch) * H * W;
  auto cT = [](const void* p) { return static_cast<const T*>(p); };
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = fv::allow_max_smem<pass_a_bwd_conv_kernel<T>>();
  if (err != cudaSuccess) return err;
  err = fv::allow_max_smem<pass_a_bwd_dx_kernel<T>>();
  if (err != cudaSuccess) return err;
  dim3 grid(di / kACh, P, batch);
  pass_a_bwd_conv_kernel<T>
      <<<grid, kThreads, pass_a_bwd_smem(ln, dm, kTc), stream>>>(
          cT(x), cT(w_x), cF(b_x), cF(w_cf), cF(b_cf), cF(w_ab), cF(b_ab),
          cT(dxc_f), cT(dxc_b), cT(dpf), cT(dpb), static_cast<T*>(dxin),
          static_cast<float*>(c_part), H, W, dm, di, transposed, scaling);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((ntokens + kBTok - 1) / kBTok);
  pass_a_bwd_dx_kernel<T>
      <<<blocks, kThreads, pass_a_bwd_dx_smem(dm, di, kTc), stream>>>(
          cT(dxin), cT(w_x_t), cF(dx_b), static_cast<float*>(dx), ntokens, dm,
          di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dW_x (di, dm) = dxinᵀ·x̂
  err = wgrad<T>(dxin, di, x, dm, ntokens, nsplit,
                 static_cast<float*>(w_part), static_cast<float*>(dw_x),
                 stream);
  if (err != cudaSuccess) return err;
  return fv::sum_partials(static_cast<const float*>(c_part),
                          static_cast<float*>(c_vec),
                          static_cast<long>(kCVec) * di, batch * P, 1, stream);
}

}  // namespace

// Pass B backward. g, x: (batch, H, W, dm); xc_f, xc_b: (batch, H, W, di);
// yf, yb: (batch, P, di); w_z: (di, dm), w_z_t: (dm, di) its transpose,
// w_out_t: (di, dm) the transpose of out_proj.weight; all of `dtype`
// (0 fp32, 1 bf16). b_z (may be null), d_f, d_b, ln_w, ln_b (read only
// with use_ln): (di,) fp32. Outputs: dx (batch, H, W, dm) fp32; dxc_f,
// dxc_b, dy (batch, P, di) of `dtype`; dw_out (dm, di), dw_z (di, dm) and
// vec = [db_z | dln_w | dln_b | dd_f | dd_b | db_out] (5·di + dm) fp32.
// Scratch: mg, dz (tokens, di) of `dtype`; vec_part (batch·P, 5·di + dm) and
// w_part (nsplit, dm·di) fp32. dm, di % 64 == 0, dm <= di <= 384. Returns
// a cudaError_t.
extern "C" int fv_pass_b_bwd(const void* g, const void* x, const void* xc_f,
                             const void* xc_b, const void* yf, const void* yb,
                             const void* w_z, const void* w_z_t,
                             const void* b_z, const void* d_f, const void* d_b,
                             const void* ln_w, const void* ln_b,
                             const void* w_out_t, void* dx, void* dxc_f,
                             void* dxc_b, void* dy, void* mg, void* dz,
                             void* vec_part, void* vec, void* w_part,
                             void* dw_out, void* dw_z, int batch, int H, int W,
                             int dm, int di, int transposed, int dtype,
                             int use_ln, int nsplit, float eps, void* stream) {
  const int P = transposed ? W : H;
  if ((dtype != fv::kF32 && dtype != fv::kBF16) || batch < 1 ||
      batch > 65535 || H < 1 || W < 1 || P > 65535 || dm < kGT ||
      dm % kGT != 0 || di < dm || di % kGT != 0 || di > kBwdMaxDi ||
      nsplit < 1 || nsplit > 65535 ||
      pass_b_bwd_smem(dm, di, dtype == fv::kBF16) > kMaxSmem)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == fv::kBF16)
    return launch_b_bwd<bf16>(g, x, xc_f, xc_b, yf, yb, w_z, w_z_t, b_z, d_f,
                              d_b, ln_w, ln_b, w_out_t, dx, dxc_f, dxc_b, dy,
                              mg, dz, vec_part, vec, w_part, dw_out, dw_z,
                              batch, H, W, dm, di, transposed, use_ln, nsplit,
                              eps, st);
  return launch_b_bwd<float>(g, x, xc_f, xc_b, yf, yb, w_z, w_z_t, b_z, d_f,
                             d_b, ln_w, ln_b, w_out_t, dx, dxc_f, dxc_b, dy,
                             mg, dz, vec_part, vec, w_part, dw_out, dw_z,
                             batch, H, W, dm, di, transposed, use_ln, nsplit,
                             eps, st);
}

// Pass A backward. x: (batch, H, W, dm); dxc_f, dxc_b: (batch, H, W, di);
// dpf, dpb: (batch, P, di); w_x: (di, dm), w_x_t: (dm, di) its transpose;
// all of `dtype`. dx_b: (batch, H, W, dm) fp32 from fv_pass_b_bwd. b_x,
// b_cf, b_ab: (di,) fp32 or null; w_cf, w_ab: (di, 4) fp32. Outputs: dx
// (batch, H, W, dm) fp32 = dx_b + dxin·W_x; dw_x (di, dm) fp32; c_vec
// (11, di) fp32 = rows dw_cf[:, 0..3], dw_ab[:, 0..3], db_cf, db_ab, db_x.
// Scratch: dxin (tokens, di) of `dtype`; c_part (batch·P, 11·di) and w_part
// (nsplit, di·dm) fp32. dm, di % 64 == 0, dm <= di, lines of >= 4 tokens.
// Returns a cudaError_t.
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
      dm % kGT != 0 || di < dm || di % kGT != 0 || nsplit < 1 ||
      nsplit > 65535 ||
      pass_a_bwd_smem(ln, dm, dtype == fv::kBF16) > kMaxSmem ||
      pass_a_bwd_dx_smem(dm, di, dtype == fv::kBF16) > kMaxSmem)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == fv::kBF16)
    return launch_a_bwd<bf16>(x, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, w_x_t, b_x,
                              w_cf, b_cf, w_ab, b_ab, dx, dxin, c_part, c_vec,
                              w_part, dw_x, batch, H, W, dm, di, transposed,
                              nsplit, scaling, st);
  return launch_a_bwd<float>(x, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, w_x_t, b_x,
                             w_cf, b_cf, w_ab, b_ab, dx, dxin, c_part, c_vec,
                             w_part, dw_x, batch, H, W, dm, di, transposed,
                             nsplit, scaling, st);
}
