// K7: pass B of the fused FastVim mixer layer in its recompute form, for
// Hopper (sm_90a).
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
// d_inner per token (0.44 MFLOP, plus 19 % for the halo rows): ~680
// FLOP/byte, above the ~295 at which bf16 tensor cores become the limit.
// So unlike K3 + K4, which move xc_f and xc_b through device memory, this
// pass is bound by operations; it trades the xc round trip (3 KB per
// token) for a second x-half GEMM.
//
// Design: K3 owns a line × 64 channels and K4 owns 32 tokens × all
// channels; the two tilings do not compose, so this kernel takes K4's.
// A block owns 32 consecutive tokens of one image in conv order (the
// raster on even layers; the column-major raster on odd ones, where
// neighbours in conv order lie a whole row apart in memory) with all
// d_inner channels, plus 3 halo tokens on each side. The halo crosses line
// boundaries exactly as the flat conv does; tokens before the first or
// after the last of the sequence are masked before the load and count as
// 0. The 38 rows of x̂ are stored permuted — the 32 centre tokens first,
// then the 3 + 3 halo rows — so that the z GEMM's operand (the centre
// rows) starts on the 32-byte boundary WMMA loads need. Shared memory at
// FastVim-T's widths in bf16: x̂ 19 KB, xin (48 × 384 fp32) 74 KB, z
// (32 × 384 fp32, reused for the out tile) 49 KB, the gated value in bf16
// 25 KB: 167 KB, one block per SM, which is what limits it. d_inner is
// capped at 384: one lane holds d_inner / 32 merged values, and xin and z
// for 768 channels would not fit beside each other.
//
// GEMMs as in K3/K4: WMMA 16×16×16 for bf16 (3 row tiles for xin, 2 for z
// and out), FMA tiles for fp32 (`gemm_rows`; the 6 halo rows cost a second
// call over rows 6..37, of which only the last 6 are kept).

#include "layer_fused.cuh"

namespace {

constexpr int kRcMaxDi = 384;               // per-lane merge registers: / 32
constexpr int kRcRows = kBTok + 2 * kPad;   // 38 rows of x̂ and xin
constexpr int kRcRows16 = 48;               // ... rounded up to WMMA tiles

// Row of the permuted tile holding the token at offset i in [-3, 35) from
// the block's first token: centre tokens 0..31, then the halo before, then
// the halo after.
__device__ __forceinline__ int rc_row(int i) {
  return i < 0 ? kBTok + kPad + i : (i < kBTok ? i : i + kPad);
}
// ... and the offset held by row r < 38
__device__ __forceinline__ int rc_offset(int r) {
  return r < kBTok ? r : (r < kBTok + kPad ? r - kBTok - kPad : r - kPad);
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

// shared memory in bytes
__host__ __device__ inline size_t pass_b_rc_smem(int dm, int di, bool tc) {
  if (tc)
    return static_cast<size_t>(kRcRows16) * (dm + 8) * sizeof(bf16)      // x̂
           + static_cast<size_t>(kRcRows16) * di * sizeof(float)         // xin
           + static_cast<size_t>(kBTok) * imax(di, dm) * sizeof(float)   // z
           + static_cast<size_t>(kBTok) * (di + 8) * sizeof(bf16);       // g
  return (static_cast<size_t>(kRcRows) * dm + static_cast<size_t>(kRcRows) * di +
          static_cast<size_t>(kBTok) * di +
          static_cast<size_t>(kBKc) * (kBSlab + 1)) * sizeof(float);
}

// xin rows of tokens inside the sequence get b_x; the others stay 0 (their
// x̂ rows were 0), the zero padding of the flat conv
__device__ __forceinline__ void add_xin_bias(float* s_xin,
                                             const float* __restrict__ b_x,
                                             const Tile& tl, int di) {
  if (b_x) {
    for (int i = threadIdx.x; i < kRcRows * di; i += kThreads)
      if (tl.inside(rc_offset(i / di))) s_xin[i] += b_x[i % di];
  }
  __syncthreads();
}

// dual conv + SiLU from the xin tile, merge, LayerNorm and gate for the
// block's tokens: z (without bias) from s_z (row stride ldz); the gated
// value, rounded to T, into g (row stride ldg). One warp per 4 tokens; g
// may alias s_z (same element, same thread).
template <typename T, typename G>
__device__ __forceinline__ void conv_merge_ln_gate(
    const float* s_xin, const float* s_z, int ldz, G* g, int ldg,
    const Tile& tl, int b, int ntile, const T* __restrict__ yf,
    const T* __restrict__ yb, const float* __restrict__ w_cf,
    const float* __restrict__ b_cf, const float* __restrict__ w_ab,
    const float* __restrict__ b_ab, const float* __restrict__ b_z,
    const float* __restrict__ d_f, const float* __restrict__ d_b,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, int di,
    bool use_ln, float eps) {
  constexpr int kMaxJ = kRcMaxDi / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nj = di / 32;
  const int P = tl.transposed ? tl.W : tl.H;
  for (int r = 0; r < 4; ++r) {
    const int t = 4 * warp + r;
    if (t >= ntile) break;
    const size_t prow =
        (static_cast<size_t>(b) * P + (tl.q0 + t) / tl.ln) * di;
    const float* rows[2 * kPad + 1];  // xin of tokens t-3 .. t+3
#pragma unroll
    for (int k = 0; k <= 2 * kPad; ++k)
      rows[k] = s_xin + static_cast<size_t>(rc_row(t - kPad + k)) * di;
    float m[kMaxJ];
    float sum = 0.f, sumsq = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
        float yc = 0.f, ya = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          yc += rows[k][c] * w_cf[c * 4 + k];                // x[t-3+k]·w_c[k]
          ya += rows[kPad + k][c] * w_ab[c * 4 + kPad - k];  // x[t+k]·w_a[3-k]
        }
        const float xf = fv::silu(yc + (b_cf ? b_cf[c] : 0.f));
        const float xb = fv::silu(ya + (b_ab ? b_ab[c] : 0.f));
        const float v = (fv::to_f32(yf[prow + c]) + d_f[c] * xf +
                         fv::to_f32(yb[prow + c]) + d_b[c] * xb) *
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
    const float mu = sum / static_cast<float>(di);
    const float rstd = rsqrtf(sumsq / static_cast<float>(di) - mu * mu + eps);
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
        float v = m[j];
        if (use_ln) v = (v - mu) * rstd * ln_w[c] + ln_b[c];
        const float z = s_z[t * ldz + c] + (b_z ? b_z[c] : 0.f);
        const float gated = v * fv::silu(z);
        if constexpr (std::is_same<G, float>::value)
          g[t * ldg + c] = fv::round_to<T>(gated);
        else
          g[t * ldg + c] = fv::from_f32<G>(gated);
      }
    }
  }
}

#define FV_RC_PARAMS(T)                                                       \
  const T *__restrict__ x, const T *__restrict__ yf, const T *__restrict__ yb, \
      const T *__restrict__ w_x, const float *__restrict__ b_x,                \
      const float *__restrict__ w_cf, const float *__restrict__ b_cf,          \
      const float *__restrict__ w_ab, const float *__restrict__ b_ab,          \
      const T *__restrict__ w_z, const float *__restrict__ b_z,                \
      const float *__restrict__ d_f, const float *__restrict__ d_b,            \
      const float *__restrict__ ln_w, const float *__restrict__ ln_b,          \
      const T *__restrict__ w_out, const float *__restrict__ b_out,            \
      T *__restrict__ out, int H, int W, int dm, int di, bool transposed,      \
      bool use_ln, float eps

__device__ __forceinline__ Tile block_tile(int H, int W, bool transposed) {
  const long L = static_cast<long>(H) * W;
  return Tile{H, W, transposed ? H : W, L,
              static_cast<long>(blockIdx.x) * kBTok, transposed,
              static_cast<size_t>(blockIdx.y) * L};
}

// FMA GEMM path (fp32)
template <typename T>
__global__ void __launch_bounds__(kThreads)
pass_b_rc_kernel(FV_RC_PARAMS(T)) {
  constexpr int kVe = fv::kVec<T>;
  extern __shared__ float smem_rc[];
  float* s_x = smem_rc;                                    // [38][dm]
  float* s_xin = s_x + static_cast<size_t>(kRcRows) * dm;  // [38][di]
  float* s_g = s_xin + static_cast<size_t>(kRcRows) * di;  // [32][di]
  float* s_w = s_g + static_cast<size_t>(kBTok) * di;      // [kBKc][kBSlab+1]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const Tile tl = block_tile(H, W, transposed);
  const int ntile = tl.L - tl.q0 < kBTok ? static_cast<int>(tl.L - tl.q0)
                                         : kBTok;
  const int vpr = dm / kVe;  // 16-byte vectors per row of x̂
  for (int i = threadIdx.x; i < kRcRows * vpr; i += kThreads) {
    const int r = i / vpr, v = i % vpr;
    const long t = tl.token(rc_offset(r));
    float f[kVe];
    if (t >= 0) {  // masked before the load
      fv::widen16<T>(fv::load16(x + (tl.img + t) * dm + v * kVe), f);
    } else {
#pragma unroll
      for (int e = 0; e < kVe; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVe; ++e) s_x[r * dm + v * kVe + e] = f[e];
  }

  float acc[4][kBCols];
  for (int n0 = 0; n0 < di; n0 += kBSlab) {
    const int ncols = min(kBCols, (di - n0) / 32);
    gemm_rows<T>(s_x, w_x, dm, n0, ncols, s_w, acc);  // xin, rows 0..31
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        if (j < ncols)
          s_xin[(4 * warp + r) * di + n0 + lane + 32 * j] = acc[r][j];
    gemm_rows<T>(s_x + 2 * kPad * dm, w_x, dm, n0, ncols, s_w, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // rows 6..37: keep the halo rows 32..37
      const int row = 2 * kPad + 4 * warp + r;
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        if (j < ncols && row >= kBTok)
          s_xin[row * di + n0 + lane + 32 * j] = acc[r][j];
    }
    gemm_rows<T>(s_x, w_z, dm, n0, ncols, s_w, acc);  // z (bias in merge)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        if (j < ncols) s_g[(4 * warp + r) * di + n0 + lane + 32 * j] = acc[r][j];
  }
  __syncthreads();
  add_xin_bias(s_xin, b_x, tl, di);
  conv_merge_ln_gate<T, float>(s_xin, s_g, di, s_g, di, tl, b, ntile, yf, yb,
                               w_cf, b_cf, w_ab, b_ab, b_z, d_f, d_b, ln_w,
                               ln_b, di, use_ln, eps);
  for (int n0 = 0; n0 < dm; n0 += kBSlab) {  // out = g·W_out + b_out
    const int ncols = min(kBCols, (dm - n0) / 32);
    gemm_rows<T>(s_g, w_out, di, n0, ncols, s_w, acc);  // barriers inside
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * warp + r;
      if (t < ntile) {
        const size_t o = (tl.img + tl.token(t)) * dm;
#pragma unroll
        for (int j = 0; j < kBCols; ++j)
          if (j < ncols) {
            const int n = n0 + lane + 32 * j;
            out[o + n] = fv::from_f32<T>(acc[r][j] + (b_out ? b_out[n] : 0.f));
          }
      }
    }
  }
}

// WMMA GEMM path (bf16)
__global__ void __launch_bounds__(kThreads)
pass_b_rc_wmma_kernel(FV_RC_PARAMS(bf16)) {
  extern __shared__ __align__(128) unsigned char smem_rcw[];
  const int ldx = dm + 8, ldg = di + 8;  // 16 bytes of skew per row
  bf16* s_xb = reinterpret_cast<bf16*>(smem_rcw);  // [48][ldx]
  float* s_xin = reinterpret_cast<float*>(
      s_xb + static_cast<size_t>(kRcRows16) * ldx);  // [48][di]
  float* s_z = s_xin + static_cast<size_t>(kRcRows16) * di;  // [32][max]
  bf16* s_gb = reinterpret_cast<bf16*>(
      s_z + static_cast<size_t>(kBTok) * imax(di, dm));  // [32][ldg]
  const int b = blockIdx.y;
  const Tile tl = block_tile(H, W, transposed);
  const int ntile = tl.L - tl.q0 < kBTok ? static_cast<int>(tl.L - tl.q0)
                                         : kBTok;
  const int vpr = dm / 8;  // 16-byte vectors per row of x̂
  for (int i = threadIdx.x; i < kRcRows16 * vpr; i += kThreads) {
    const int r = i / vpr, v = i % vpr;
    const long t = r < kRcRows ? tl.token(rc_offset(r)) : -1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0)  // masked before the load
      val = fv::load16(x + (tl.img + t) * dm + v * 8);
    *reinterpret_cast<uint4*>(s_xb + static_cast<size_t>(r) * ldx + v * 8) =
        val;
  }
  __syncthreads();
  wmma_rows<3>(s_xb, ldx, w_x, dm, di, s_xin, di);  // xin = x̂·W_x, 48 rows
  wmma_rows<2>(s_xb, ldx, w_z, dm, di, s_z, di);    // z = x̂·W_z, centre rows
  __syncthreads();
  add_xin_bias(s_xin, b_x, tl, di);
  conv_merge_ln_gate<bf16, bf16>(s_xin, s_z, di, s_gb, ldg, tl, b, ntile, yf,
                                 yb, w_cf, b_cf, w_ab, b_ab, b_z, d_f, d_b,
                                 ln_w, ln_b, di, use_ln, eps);
  __syncthreads();
  wmma_rows<2>(s_gb, ldg, w_out, di, dm, s_z, dm);  // g·W_out
  __syncthreads();
  for (int i = threadIdx.x; i < ntile * dm; i += kThreads) {
    const int t = i / dm, n = i % dm;
    out[(tl.img + tl.token(t)) * dm + n] =
        fv::from_f32<bf16>(s_z[i] + (b_out ? b_out[n] : 0.f));
  }
}

}  // namespace

// x: (batch, H, W, dm); yf, yb: (batch, P, di), P = W if transposed else H;
// w_x, w_z: (di, dm) (the x and z rows of in_proj.weight); w_out: (dm, di),
// all of `dtype` (0 fp32, 1 bf16). b_x, b_cf, b_ab, b_z, d_f, d_b, ln_w,
// ln_b: (di,), w_cf, w_ab: (di, 4) and b_out: (dm,) fp32; the biases may be
// null, ln_w/ln_b are read only with use_ln. out: (batch, H, W, dm) of
// `dtype`. dm, di % 32 == 0, di <= 384; x, w_x, w_z, w_out 32-byte
// aligned. Returns a cudaError_t.
extern "C" int fv_pass_b_recompute_fwd(
    const void* x, const void* yf, const void* yb, const void* w_x,
    const void* b_x, const void* w_cf, const void* b_cf, const void* w_ab,
    const void* b_ab, const void* w_z, const void* b_z, const void* d_f,
    const void* d_b, const void* ln_w, const void* ln_b, const void* w_out,
    const void* b_out, void* out, int batch, int H, int W, int dm, int di,
    int transposed, int dtype, int use_ln, float eps, void* stream) {
  const bool tc = dtype == fv::kBF16;
  if ((dtype != fv::kF32 && !tc) || batch < 1 || batch > 65535 || H < 1 ||
      W < 1 || dm < 32 || dm % 32 != 0 || di < 32 || di % 32 != 0 ||
      di > kRcMaxDi || pass_b_rc_smem(dm, di, tc) > kMaxSmem)
    return cudaErrorInvalidValue;
  const long L = static_cast<long>(H) * W;
  dim3 grid(static_cast<unsigned>((L + kBTok - 1) / kBTok), batch);
  const size_t smem = pass_b_rc_smem(dm, di, tc);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err;
  if (tc) {
    auto h = [](const void* p) { return static_cast<const bf16*>(p); };
    err = fv::allow_max_smem<pass_b_rc_wmma_kernel>();
    if (err != cudaSuccess) return err;
    pass_b_rc_wmma_kernel<<<grid, kThreads, smem, st>>>(
        h(x), h(yf), h(yb), h(w_x), f(b_x), f(w_cf), f(b_cf), f(w_ab),
        f(b_ab), h(w_z), f(b_z), f(d_f), f(d_b), f(ln_w), f(ln_b), h(w_out),
        f(b_out), static_cast<bf16*>(out), H, W, dm, di, transposed, use_ln,
        eps);
  } else {
    err = fv::allow_max_smem<pass_b_rc_kernel<float>>();
    if (err != cudaSuccess) return err;
    pass_b_rc_kernel<float><<<grid, kThreads, smem, st>>>(
        f(x), f(yf), f(yb), f(w_x), f(b_x), f(w_cf), f(b_cf), f(w_ab),
        f(b_ab), f(w_z), f(b_z), f(d_f), f(d_b), f(ln_w), f(ln_b), f(w_out),
        f(b_out), static_cast<float*>(out), H, W, dm, di, transposed, use_ln,
        eps);
  }
  return cudaGetLastError();
}
