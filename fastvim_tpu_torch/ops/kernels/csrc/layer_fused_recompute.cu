// K7: pass B of the fused FastVim mixer layer in its recompute form, for
// Hopper (sm_90a): the C entry point and the fp32 path; the bf16 path is
// layer_fused_recompute_wgmma.cu.
//
// Replaces `_pass_b_even_kernel` / `_pass_b_odd_kernel`
// (fastvim_tpu/ops/pallas/layer_fused.py; conv stage `_conv_stage_even` /
// `_conv_stage_odd`, tail `_merge_tail`): pass A wrote only the pooled
// means, so this pass computes the conv stage again from x̂
//   xin = x̂·W_x + b_x;  xc_f, xc_b = silu(causal / anticausal width-4
//   conv of xin along the raster (even layers) or the column-major raster
//   (odd layers)), kept in fp32,
// and then pass B's tail
//   z = x̂·W_z + b_z;  m = ½(yf + D_f·xc_f + yb + D_b·xc_b), yf and yb
//   broadcast from the pooled line;  LayerNorm (fp32 statistics, variance
//   E[m²]−μ², as K4 takes it);  × silu(z);  out = ·W_out + b_out.
//
// What bounds it on the H100: the function reads x̂ and writes out (768
// bytes per token in bf16 at d_model 192) against three GEMMs of d_model ×
// d_inner per token (0.44 MFLOP): ~580 FLOP/byte, above the ~295 at which
// bf16 tensor cores become the limit. So unlike K3 + K4, which move xc_f
// and xc_b through device memory, this pass is bound by operations; it
// trades the xc round trip (3 KB per token) for a second x-half GEMM.
//
// The fp32 path is a plain form for the checks, with FMA tiles
// (`gemm_rows`): a block owns 32 consecutive tokens of one image in conv
// order (the raster on even layers; the column-major raster on odd ones,
// where neighbours lie a whole row apart in memory) plus 3 halo tokens on
// each side, which cross line boundaries exactly as the flat conv does;
// tokens outside the sequence are masked before the load and count as 0.
// The 38 rows of x̂ are stored permuted, the 32 centre tokens first. d_inner
// is walked in slabs of 128 channels (xin of the 38 rows, the conv and
// the merge into the tile's m), then the LayerNorm statistics, then z in
// slabs of 384 with the gate in place of m, then out. Shared memory at
// FastVim-S's widths (d_model 384, d_inner 768): x̂ 57 KB, an xin slab 19
// KB, m 96 KB, weight staging 24 KB.
//
// Past those widths (FastVim-B/L/H, up to kRcMaxDm and kRcMaxDi) m of a
// tile no longer fits, nor out's accumulators, so the fp32 wide form: a
// block owns 16 tokens and a group of at most 384 d_model columns of out
// (a grid of column groups × token tiles). Its 22 rows of x̂ stay on chip
// (113 KB at d_model 1280); d_inner is walked twice in slabs of 128
// channels, each slab's xin, conv and merge computed both times: the
// first walk keeps each token's Σm and Σm² (skipped without LayerNorm),
// the second forms z and the gate in the slab's m tile and adds g·W_out
// of the slab into out's registers. Each call is one launch in either
// form.

#include "layer_fused.cuh"
#include "layer_fused_fwd.cuh"

namespace {

constexpr int kRcMaxDi = 2560;             // FastVim-H's widths, in both
constexpr int kRcMaxDm = 1280;             // dtypes
constexpr int kRcNarrowDi = 768;           // the narrow fp32 form: x̂ and m
constexpr int kRcNarrowDm = 384;           // of a tile stay on chip
constexpr int kRcRows = kBTok + 2 * kPad;  // 38 rows of x̂ and xin
constexpr int kRcSlab = 128;               // d_inner channels of an xin slab
constexpr int kWideR = 2;                  // the wide form: rows a warp,
constexpr int kWideTok = 8 * kWideR;       // tokens a block
constexpr int kWideRows = kWideTok + 2 * kPad;  // rows of x̂ and xin: 22

// Row of the permuted tile of kTok tokens holding the token at offset i
// in [-3, kTok + 3) from the block's first token: centre tokens first,
// then the halo before, then the halo after.
template <int kTok = kBTok>
__device__ __forceinline__ int rc_row(int i) {
  return i < 0 ? kTok + kPad + i : (i < kTok ? i : i + kPad);
}
// ... and the offset held by row r < kTok + 6
template <int kTok = kBTok>
__device__ __forceinline__ int rc_offset(int r) {
  return r < kTok ? r : (r < kTok + kPad ? r - kTok - kPad : r - kPad);
}

struct Tile {  // the 32 tokens a block owns
  int H, W, ln;  // ln: tokens per pooled line
  long L, q0;    // tokens per image; the block's first token, conv order
  bool transposed;
  size_t img;  // first token of the image
  // token at offset i from q0 in conv order as its index in the image, or
  // -1 outside the sequence
  __device__ long token(int i) const {
    const long q = q0 + i;
    if (!inside(i)) return -1;
    return transposed ? (q % H) * W + q / H : q;
  }
  __device__ bool inside(int i) const { return q0 + i >= 0 && q0 + i < L; }
};

// shared memory of the fp32 kernel in bytes
__host__ __device__ inline size_t pass_b_rc_smem(int dm, int di) {
  return (static_cast<size_t>(kRcRows) * dm +
          static_cast<size_t>(kRcRows) * kRcSlab +
          static_cast<size_t>(kBTok) * di +
          static_cast<size_t>(kBKc) * (kBSlab + 1) + 2 * kBTok) *
         sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
pass_b_rc_kernel(const float* __restrict__ x, const float* __restrict__ yf,
                 const float* __restrict__ yb, const float* __restrict__ w_x,
                 const float* __restrict__ b_x,
                 const float* __restrict__ w_cf,
                 const float* __restrict__ b_cf,
                 const float* __restrict__ w_ab,
                 const float* __restrict__ b_ab,
                 const float* __restrict__ w_z, const float* __restrict__ b_z,
                 const float* __restrict__ d_f, const float* __restrict__ d_b,
                 const float* __restrict__ ln_w,
                 const float* __restrict__ ln_b,
                 const float* __restrict__ w_out,
                 const float* __restrict__ b_out, float* __restrict__ out,
                 int H, int W, int dm, int di, bool transposed, bool use_ln,
                 float eps) {
  extern __shared__ float smem_rc[];
  float* s_x = smem_rc;                                     // [38][dm]
  float* s_xin = s_x + static_cast<size_t>(kRcRows) * dm;   // [38][kRcSlab]
  float* s_m = s_xin + kRcRows * kRcSlab;                   // [32][di]
  float* s_w = s_m + static_cast<size_t>(kBTok) * di;  // [kBKc][kBSlab+1]
  float* s_mu = s_w + kBKc * (kBSlab + 1);                  // [32]
  float* s_rstd = s_mu + kBTok;                             // [32]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const long L = static_cast<long>(H) * W;
  const Tile tl{H, W, transposed ? H : W, L,
                static_cast<long>(blockIdx.x) * kBTok, transposed,
                static_cast<size_t>(b) * L};
  const int ntile = tl.L - tl.q0 < kBTok ? static_cast<int>(tl.L - tl.q0)
                                         : kBTok;
  const int P = transposed ? W : H;
  const int vpr = dm / 4;  // 16-byte vectors per row of x̂
  for (int i = threadIdx.x; i < kRcRows * vpr; i += kThreads) {
    const int r = i / vpr, v = i % vpr;
    const long t = tl.token(rc_offset(r));
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (t >= 0)  // masked before the load
      fv::widen16<float>(fv::load16(x + (tl.img + t) * dm + v * 4), f);
#pragma unroll
    for (int e = 0; e < 4; ++e) s_x[r * dm + v * 4 + e] = f[e];
  }

  // per slab of d_inner: xin of the 38 rows, then the dual conv, SiLU and
  // the merge into m; tokens past the sequence get m = 0
  float acc[4][kBCols];
  for (int n0 = 0; n0 < di; n0 += kRcSlab) {
    const int ncols = min(kRcSlab, di - n0) / 32;
    gemm_rows<float>(s_x, w_x, dm, n0, ncols, s_w, acc);  // rows 0..31
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kRcSlab / 32; ++j)
        if (j < ncols)
          s_xin[(4 * warp + r) * kRcSlab + lane + 32 * j] = acc[r][j];
    gemm_rows<float>(s_x + 2 * kPad * dm, w_x, dm, n0, ncols, s_w, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // rows 6..37: keep the halo rows 32..37
      const int row = 2 * kPad + 4 * warp + r;
#pragma unroll
      for (int j = 0; j < kRcSlab / 32; ++j)
        if (j < ncols && row >= kBTok)
          s_xin[row * kRcSlab + lane + 32 * j] = acc[r][j];
    }
    __syncthreads();
    // + b_x on the rows of tokens inside the sequence; the others stay 0
    // (their x̂ rows were 0), the zero padding of the flat conv
    const int nc = 32 * ncols;
    if (b_x) {
      for (int i = threadIdx.x; i < kRcRows * nc; i += kThreads) {
        const int r = i / nc, c = i % nc;
        if (tl.inside(rc_offset(r))) s_xin[r * kRcSlab + c] += b_x[n0 + c];
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < kBTok * nc; i += kThreads) {
      const int t = i / nc, cl = i % nc, c = n0 + cl;
      float v = 0.f;
      if (t < ntile) {
        float yc = 0.f, ya = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // x[t-3+k]·w_c[k], x[t+k]·w_a[3-k]
          yc += s_xin[rc_row(t - kPad + k) * kRcSlab + cl] * w_cf[c * 4 + k];
          ya += s_xin[rc_row(t + k) * kRcSlab + cl] * w_ab[c * 4 + kPad - k];
        }
        const float xf = fv::silu(yc + (b_cf ? b_cf[c] : 0.f));
        const float xb = fv::silu(ya + (b_ab ? b_ab[c] : 0.f));
        const size_t prow =
            (static_cast<size_t>(b) * P + (tl.q0 + t) / tl.ln) * di + c;
        v = (yf[prow] + d_f[c] * xf + yb[prow] + d_b[c] * xb) * 0.5f;
      }
      s_m[t * di + c] = v;
    }
    // the next slab's GEMM writes s_xin only after its barriers
  }
  __syncthreads();

  // LayerNorm statistics, a warp per 4 tokens
  for (int r = 0; r < 4; ++r) {
    const int t = 4 * warp + r;
    float sum = 0.f, sumsq = 0.f;
    for (int c = lane; c < di; c += 32) {
      const float v = s_m[t * di + c];
      sum += v;
      sumsq += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
    }
    if (lane == 0) {
      const float mu = sum / static_cast<float>(di);
      s_mu[t] = mu;
      s_rstd[t] = rsqrtf(sumsq / static_cast<float>(di) - mu * mu + eps);
    }
  }
  __syncthreads();

  // z = x̂·W_z + b_z by slabs; the gated value LN(m)·silu(z) in place of m
  for (int n0 = 0; n0 < di; n0 += kBSlab) {
    const int ncols = min(kBCols, (di - n0) / 32);
    gemm_rows<float>(s_x, w_z, dm, n0, ncols, s_w, acc);  // barriers inside
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * warp + r;
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        if (j < ncols) {
          const int c = n0 + lane + 32 * j;
          float v = s_m[t * di + c];
          if (use_ln) v = (v - s_mu[t]) * s_rstd[t] * ln_w[c] + ln_b[c];
          s_m[t * di + c] = v * fv::silu(acc[r][j] + (b_z ? b_z[c] : 0.f));
        }
    }
  }
  for (int n0 = 0; n0 < dm; n0 += kBSlab) {  // out = g·W_out + b_out
    const int ncols = min(kBCols, (dm - n0) / 32);
    gemm_rows<float>(s_m, w_out, di, n0, ncols, s_w, acc);  // barriers inside
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * warp + r;
      if (t < ntile) {
        const size_t o = (tl.img + tl.token(t)) * dm;
#pragma unroll
        for (int j = 0; j < kBCols; ++j)
          if (j < ncols) {
            const int n = n0 + lane + 32 * j;
            out[o + n] = acc[r][j] + (b_out ? b_out[n] : 0.f);
          }
      }
    }
  }
}

// shared memory of the fp32 wide form in bytes
__host__ __device__ inline size_t pass_b_rc_wide_smem(int dm) {
  return (static_cast<size_t>(kWideRows) * dm + kWideRows * kRcSlab +
          kWideTok * kRcSlab + kBKc * (kBSlab + 1) + 2 * kWideTok) *
         sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
pass_b_rc_wide_kernel(const float* __restrict__ x,
                      const float* __restrict__ yf,
                      const float* __restrict__ yb,
                      const float* __restrict__ w_x,
                      const float* __restrict__ b_x,
                      const float* __restrict__ w_cf,
                      const float* __restrict__ b_cf,
                      const float* __restrict__ w_ab,
                      const float* __restrict__ b_ab,
                      const float* __restrict__ w_z,
                      const float* __restrict__ b_z,
                      const float* __restrict__ d_f,
                      const float* __restrict__ d_b,
                      const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b,
                      const float* __restrict__ w_out,
                      const float* __restrict__ b_out,
                      float* __restrict__ out, int H, int W, int dm, int di,
                      bool transposed, bool use_ln, float eps, int ngroups) {
  constexpr int kT = kWideTok, kR = kWideR;
  extern __shared__ float smem_rc[];
  float* s_x = smem_rc;                                      // [22][dm]
  float* s_xin = s_x + static_cast<size_t>(kWideRows) * dm;  // [22][slab]
  float* s_m = s_xin + kWideRows * kRcSlab;                  // [16][slab]
  float* s_w = s_m + kT * kRcSlab;                 // [kBKc][kBSlab+1]
  float* s_mu = s_w + kBKc * (kBSlab + 1);         // [16]
  float* s_rstd = s_mu + kT;                       // [16]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int c0 = static_cast<int>(blockIdx.x) % ngroups * kBSlab;
  const int ocols = min(kBSlab, dm - c0) / 32;  // this block's out / 32
  const long L = static_cast<long>(H) * W;
  const Tile tl{H, W, transposed ? H : W, L,
                static_cast<long>(blockIdx.x) / ngroups * kT, transposed,
                static_cast<size_t>(b) * L};
  const int ntile = tl.L - tl.q0 < kT ? static_cast<int>(tl.L - tl.q0) : kT;
  const int P = transposed ? W : H;
  const int vpr = dm / 4;  // 16-byte vectors per row of x̂
  for (int i = threadIdx.x; i < kWideRows * vpr; i += kThreads) {
    const int r = i / vpr, v = i % vpr;
    const long t = tl.token(rc_offset<kT>(r));
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (t >= 0)  // masked before the load
      fv::widen16<float>(fv::load16(x + (tl.img + t) * dm + v * 4), f);
#pragma unroll
    for (int e = 0; e < 4; ++e) s_x[r * dm + v * 4 + e] = f[e];
  }

  // m of the tile's tokens over the slab at n0 into s_m: xin of the 22
  // rows (+ b_x inside the sequence), the dual conv, SiLU and the merge;
  // tokens past the sequence get m = 0. Ends with a barrier.
  float acc[kR][kBCols];
  auto m_slab = [&](int n0) {
    const int ncols = min(kRcSlab, di - n0) / 32, nc = 32 * ncols;
    gemm_rows<float, kR>(s_x, w_x, dm, n0, ncols, s_w, acc);  // rows 0..15
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kRcSlab / 32; ++j)
        if (j < ncols)
          s_xin[(kR * warp + r) * kRcSlab + lane + 32 * j] = acc[r][j];
    gemm_rows<float, kR>(s_x + 2 * kPad * dm, w_x, dm, n0, ncols, s_w, acc);
#pragma unroll
    for (int r = 0; r < kR; ++r) {  // rows 6..21: keep the halo rows 16..21
      const int row = 2 * kPad + kR * warp + r;
#pragma unroll
      for (int j = 0; j < kRcSlab / 32; ++j)
        if (j < ncols && row >= kT)
          s_xin[row * kRcSlab + lane + 32 * j] = acc[r][j];
    }
    __syncthreads();
    if (b_x) {
      for (int i = threadIdx.x; i < kWideRows * nc; i += kThreads) {
        const int r = i / nc, c = i % nc;
        if (tl.inside(rc_offset<kT>(r))) s_xin[r * kRcSlab + c] += b_x[n0 + c];
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < kT * nc; i += kThreads) {
      const int t = i / nc, cl = i % nc, c = n0 + cl;
      float v = 0.f;
      if (t < ntile) {
        float yc = 0.f, ya = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          yc += s_xin[rc_row<kT>(t - kPad + k) * kRcSlab + cl] *
                w_cf[c * 4 + k];
          ya += s_xin[rc_row<kT>(t + k) * kRcSlab + cl] *
                w_ab[c * 4 + kPad - k];
        }
        const float xf = fv::silu(yc + (b_cf ? b_cf[c] : 0.f));
        const float xb = fv::silu(ya + (b_ab ? b_ab[c] : 0.f));
        const size_t prow =
            (static_cast<size_t>(b) * P + (tl.q0 + t) / tl.ln) * di + c;
        v = (yf[prow] + d_f[c] * xf + yb[prow] + d_b[c] * xb) * 0.5f;
      }
      s_m[t * kRcSlab + cl] = v;
    }
    __syncthreads();
  };

  // first walk: the LayerNorm statistics, a warp per 2 tokens (the next
  // slab's GEMM barriers come before its m is written)
  if (use_ln) {
    float sum[kR] = {}, sumsq[kR] = {};
    for (int n0 = 0; n0 < di; n0 += kRcSlab) {
      m_slab(n0);
      const int nc = min(kRcSlab, di - n0);
#pragma unroll
      for (int r = 0; r < kR; ++r)
        for (int c = lane; c < nc; c += 32) {
          const float v = s_m[(kR * warp + r) * kRcSlab + c];
          sum[r] += v;
          sumsq[r] += v * v;
        }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
        sumsq[r] += __shfl_xor_sync(0xffffffffu, sumsq[r], o);
      }
      if (lane == 0) {  // published by the next slab's barriers
        const float mu = sum[r] / static_cast<float>(di);
        s_mu[kR * warp + r] = mu;
        s_rstd[kR * warp + r] =
            rsqrtf(sumsq[r] / static_cast<float>(di) - mu * mu + eps);
      }
    }
  }

  // second walk: z, the gate LN(m)·silu(z) in place of the slab's m, and
  // out += g·W_out[c0.., slab]ᵀ in registers
  float oacc[kR][kBCols];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int j = 0; j < kBCols; ++j) oacc[r][j] = 0.f;
  for (int n0 = 0; n0 < di; n0 += kRcSlab) {
    m_slab(n0);
    const int ncols = min(kRcSlab, di - n0) / 32;
    gemm_rows<float, kR>(s_x, w_z, dm, n0, ncols, s_w, acc);  // own rows
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int t = kR * warp + r;
#pragma unroll
      for (int j = 0; j < kRcSlab / 32; ++j)
        if (j < ncols) {
          const int cl = lane + 32 * j, c = n0 + cl;
          float v = s_m[t * kRcSlab + cl];
          if (use_ln) v = (v - s_mu[t]) * s_rstd[t] * ln_w[c] + ln_b[c];
          s_m[t * kRcSlab + cl] =
              v * fv::silu(acc[r][j] + (b_z ? b_z[c] : 0.f));
        }
    }
    // barriers inside, before the gated slab is read
    gemm_rows<float, kR>(s_m, w_out + static_cast<size_t>(c0) * di + n0,
                         32 * ncols, 0, ocols, s_w, oacc, kRcSlab, di, true);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int t = kR * warp + r;
    if (t < ntile) {
      const size_t o = (tl.img + tl.token(t)) * dm + c0;
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        if (j < ocols) {
          const int n = lane + 32 * j;
          out[o + n] = oacc[r][j] + (b_out ? b_out[c0 + n] : 0.f);
        }
    }
  }
}

}  // namespace

// x: (batch, H, W, dm); yf, yb: (batch, P, di), P = W if transposed else H;
// w_x, w_z: (di, dm) (the x and z rows of in_proj.weight); w_out: (dm, di),
// all of `dtype` (0 fp32, 1 bf16). b_x, b_cf, b_ab, b_z, d_f, d_b, ln_w,
// ln_b: (di,), w_cf, w_ab: (di, 4) and b_out: (dm,) fp32; the biases may be
// null, ln_w/ln_b are read only with use_ln. out: (batch, H, W, dm) of
// `dtype`. dm, di % 32 == 0, dm <= kRcMaxDm, di <= kRcMaxDi, H, W >= 4;
// x, yf, yb, w_x, w_z, w_out 32-byte aligned. One launch. Returns a
// cudaError_t.
extern "C" int fv_pass_b_recompute_fwd(
    const void* x, const void* yf, const void* yb, const void* w_x,
    const void* b_x, const void* w_cf, const void* b_cf, const void* w_ab,
    const void* b_ab, const void* w_z, const void* b_z, const void* d_f,
    const void* d_b, const void* ln_w, const void* ln_b, const void* w_out,
    const void* b_out, void* out, int batch, int H, int W, int dm, int di,
    int transposed, int dtype, int use_ln, float eps, void* stream) {
  if ((dtype != fv::kF32 && dtype != fv::kBF16) || batch < 1 ||
      batch > 65535 || H < 4 || W < 4 || dm < 32 || dm % 32 != 0 ||
      dm > kRcMaxDm || di < 32 || di % 32 != 0 || di > kRcMaxDi)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == fv::kBF16)
    return fvf::pass_b_recompute_fwd_bf16(
        x, yf, yb, w_x, b_x, w_cf, b_cf, w_ab, b_ab, w_z, b_z, d_f, d_b,
        ln_w, ln_b, w_out, b_out, out, batch, H, W, dm, di, transposed,
        use_ln, eps, st);
  const long L = static_cast<long>(H) * W;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err;
  if (dm <= kRcNarrowDm && di <= kRcNarrowDi) {
    dim3 grid(static_cast<unsigned>((L + kBTok - 1) / kBTok), batch);
    const size_t smem = pass_b_rc_smem(dm, di);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    err = fv::allow_max_smem<pass_b_rc_kernel>();
    if (err != cudaSuccess) return err;
    pass_b_rc_kernel<<<grid, kThreads, smem, st>>>(
        f(x), f(yf), f(yb), f(w_x), f(b_x), f(w_cf), f(b_cf), f(w_ab),
        f(b_ab), f(w_z), f(b_z), f(d_f), f(d_b), f(ln_w), f(ln_b), f(w_out),
        f(b_out), static_cast<float*>(out), H, W, dm, di, transposed, use_ln,
        eps);
  } else {
    const int ngroups = (dm + kBSlab - 1) / kBSlab;
    const long blocks = (L + kWideTok - 1) / kWideTok * ngroups;
    if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
    dim3 grid(static_cast<unsigned>(blocks), batch);
    const size_t smem = pass_b_rc_wide_smem(dm);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    err = fv::allow_max_smem<pass_b_rc_wide_kernel>();
    if (err != cudaSuccess) return err;
    pass_b_rc_wide_kernel<<<grid, kThreads, smem, st>>>(
        f(x), f(yf), f(yb), f(w_x), f(b_x), f(w_cf), f(b_cf), f(w_ab),
        f(b_ab), f(w_z), f(b_z), f(d_f), f(d_b), f(ln_w), f(ln_b), f(w_out),
        f(b_out), static_cast<float*>(out), H, W, dm, di, transposed, use_ln,
        eps, ngroups);
  }
  return cudaGetLastError();
}
