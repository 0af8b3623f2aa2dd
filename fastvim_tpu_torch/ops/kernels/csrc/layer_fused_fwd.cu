// K3 and K4: the two passes of the fused FastVim mixer layer, forward,
// for Hopper (sm_90a).
//
// K3 (pass A) replaces `_pass_a_even_kernel` / `_pass_a_odd_kernel`
// (fastvim_tpu/ops/pallas/layer_fused.py, conv stage `_conv_stage_even` /
// `_conv_stage_odd`, boundary terms `_conv_corrections`):
//   xin = x̂·W_x + b_x;  causal and anticausal width-4 depthwise convs of
//   xin along the raster (even layers) or the transposed raster (odd);
//   SiLU; write xc_f, xc_b; pf, pb = mean over each line · scaling.
// K4 (pass B) replaces `_pass_b_mat_kernel` (tail `_merge_tail`):
//   z = x̂·W_z + b_z;  m = ½(yf + D_f·xc_f + yb + D_b·xc_b) with yf, yb
//   broadcast from the pooled line; LayerNorm with fp32 statistics
//   (variance E[m²]−μ², unclamped, as the TPU kernel takes it; ops/norms
//   clamps at 0); × silu(z); out = ·W_out + b_out.
//
// A "line" is a row (even layer: the conv runs along the flat raster and
// pools over columns) or a column (odd layer: the conv runs down the
// columns in column-major order and pools over rows). Token (line p,
// position i) is p·W + i on even layers and i·W + p on odd ones.
//
// This file holds the C entry points and the fp32 path; the bf16 path,
// the main path's, is layer_fused_fwd_wgmma.cu (wgmma, weights staged
// through a cp.async ring, channel slabs), where its design and what
// bounds it are set out.
//
// fp32 (the 224 px checks against the CPU): there are no tensor cores to
// use without TF32 rounding, so both passes run FMA tiles streamed
// through shared memory in K chunks, every 16-byte load of a chunk issued
// before any is stored (67 TFLOP/s peak, ~52 FLOP/byte of fp32 traffic:
// FMA-bound). Both keep every intermediate except xc (which pass B needs
// after the pooled scans) out of device memory.
//
// K3 (fp32): a block owns one line of one image and a 64-channel slice,
// so the pooled mean needs no cross-block reduction. It computes the
// x-half GEMM for the line's tokens plus 3 halo tokens on each side (the
// previous line's tail for the causal taps, the next line's head for the
// anticausal ones) into a (line + 6) × 64 fp32 tile in shared memory.
// Halo tokens outside the sequence (before the first line, after the
// last) are never loaded: they are masked before the read and set to 0,
// the zero padding of the flat conv. The conv, SiLU, the xc stores and
// the pooled sums run from that tile; pf/pb are taken from xc before any
// cast.
//
// K4 (fp32): a block owns 32 consecutive tokens with all d_inner
// channels, so LayerNorm statistics are a warp reduction over a full row.
// z goes to a shared (32 × d_inner) tile, the merge/LN/gate runs over it
// (one warp per 4 tokens), and the out projection reads the gated value
// from shared memory. Past d_inner 768 (a lane's m no longer fits its
// registers) a first pass over d_inner takes the LayerNorm sums and the
// second forms m again from xc_f, xc_b, yf, yb (from L1 / L2), in the
// same order; where the (tokens × (d_model + d_inner)) tiles do not fit
// at 32 tokens, the block owns 16 or 8 (FastVim-B/L: 16, -H: 8).

#include "layer_fused.cuh"
#include "layer_fused_fwd.cuh"

namespace {

// =====================================================================
// K3: pass A
// =====================================================================
// dual conv + SiLU + xc stores + pooled means of one line, from the
// (ln + 6) × kACh fp32 tile s_xin (halo rows included, 0 outside the
// sequence); thread = (channel, group of 4 striding over the line)
template <typename T>
__device__ __forceinline__ void conv_pool_line(
    const float* s_xin, float* s_red, const Line& L, int b, int c0, int di,
    const float* __restrict__ w_cf, const float* __restrict__ b_cf,
    const float* __restrict__ w_ab, const float* __restrict__ b_ab,
    T* __restrict__ xc_f, T* __restrict__ xc_b, T* __restrict__ pf,
    T* __restrict__ pb, float scaling) {
  const int c = threadIdx.x % kACh;
  const int g = threadIdx.x / kACh;
  const int cc = c0 + c;
  float wc[4], wa[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wc[k] = w_cf[cc * 4 + k];
    wa[k] = w_ab[cc * 4 + k];
  }
  const float bc = b_cf ? b_cf[cc] : 0.f;
  const float ba = b_ab ? b_ab[cc] : 0.f;
  float sum_f = 0.f, sum_b = 0.f;
  for (int i = g; i < L.ln; i += 4) {
    const float* col = s_xin + static_cast<size_t>(i + kPad) * kACh + c;
    float yc = 0.f, ya = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      yc += col[(k - kPad) * kACh] * wc[k];  // x[t-3+k] · w_c[k]
      ya += col[k * kACh] * wa[kPad - k];    // x[t+k] · w_a[3-k]
    }
    const float xf = fv::silu(yc + bc);
    const float xb = fv::silu(ya + ba);
    const long t = L.transposed ? static_cast<long>(i) * L.W + L.p
                                : static_cast<long>(L.p) * L.W + i;
    const size_t off = (L.img + t) * di + cc;
    if (xc_f) {  // null in the pools-only form (the recompute mode's pass A)
      xc_f[off] = fv::from_f32<T>(xf);
      xc_b[off] = fv::from_f32<T>(xb);
    }
    sum_f += xf;
    sum_b += xb;
  }
  s_red[g * kACh + c] = sum_f;
  s_red[(4 + g) * kACh + c] = sum_b;
  __syncthreads();
  if (g == 0) {
    float sf = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sf += s_red[k * kACh + c];
      sb += s_red[(4 + k) * kACh + c];
    }
    const float s = scaling / static_cast<float>(L.ln);
    const size_t off = (static_cast<size_t>(b) * L.P + L.p) * di + cc;
    pf[off] = fv::from_f32<T>(sf * s);
    pb[off] = fv::from_f32<T>(sb * s);
  }
}

// FMA GEMM path (fp32)
template <typename T>
__global__ void __launch_bounds__(kThreads)
pass_a_kernel(const T* __restrict__ x, const T* __restrict__ w_x,
              const float* __restrict__ b_x, const float* __restrict__ w_cf,
              const float* __restrict__ b_cf, const float* __restrict__ w_ab,
              const float* __restrict__ b_ab, T* __restrict__ xc_f,
              T* __restrict__ xc_b, T* __restrict__ pf, T* __restrict__ pb,
              int H, int W, int dm, int di, bool transposed, float scaling) {
  extern __shared__ float smem_a[];
  const int c0 = blockIdx.x * kACh;
  const int b = blockIdx.z;
  const Line L{H, W, transposed ? W : H, transposed ? H : W,
               static_cast<int>(blockIdx.y), transposed,
               static_cast<size_t>(b) * H * W};
  const int ntok = L.ln + 2 * kPad;
  float* s_xin = smem_a;                                   // [ntok][kACh]
  float* s_x = s_xin + static_cast<size_t>(ntok) * kACh;   // [kAKc][kAPass+1]
  float* s_w = s_x + kAKc * (kAPass + 1);                  // [kAKc][kACh+1]
  float* s_red = s_w + kAKc * (kACh + 1);                  // [2][4][kACh]

  xin_tile_fma<T>(x, w_x, b_x, L, c0, dm, s_xin, s_x, s_w);
  conv_pool_line<T>(s_xin, s_red, L, b, c0, di, w_cf, b_cf, w_ab, b_ab,
                    xc_f, xc_b, pf, pb, scaling);
}

// =====================================================================
// K4: pass B
// =====================================================================
// shared memory of pass B's fp32 kernel for tiles of `tok` tokens, in
// bytes
__host__ __device__ inline size_t pass_b_smem(int dm, int di,
                                              int tok = kBTok) {
  return (static_cast<size_t>(tok) * dm + static_cast<size_t>(tok) * di +
          static_cast<size_t>(kBKc) * (kBSlab + 1)) * sizeof(float);
}

// merge + LayerNorm + gate for the block's tokens: z (without bias) from
// s_z (row stride ldz); the gated value, rounded to T, into g (row stride
// ldg). One warp per kR tokens; g may alias s_z (same element, same
// thread). kRegM: a lane keeps its m in registers between the LayerNorm
// sums and the gate (d_inner <= kBMaxDi); else it forms m again.
template <typename T, int kR, bool kRegM>
__device__ __forceinline__ void merge_ln_gate(
    const float* s_z, int ldz, float* g, int ldg, long tok0, int ntile,
    const T* __restrict__ xc_f, const T* __restrict__ xc_b,
    const T* __restrict__ yf, const T* __restrict__ yb,
    const float* __restrict__ b_z, const float* __restrict__ d_f,
    const float* __restrict__ d_b, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, int H, int W, int di, bool transposed,
    bool use_ln, float eps) {
  constexpr int kMaxJ = kRegM ? kBMaxDi / 32 : 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nj = di / 32;
  const int kj = kRegM ? kMaxJ : nj;  // the loops' bound
  for (int r = 0; r < kR; ++r) {
    const int t = kR * warp + r;
    if (t >= ntile) break;
    const long tok = tok0 + t;
    const long pix = tok % (static_cast<long>(H) * W);
    const long line = transposed ? pix % W : pix / W;  // pooled index
    const long prow =
        (tok / (static_cast<long>(H) * W)) * (transposed ? W : H) + line;
    auto merge = [&](int c) {
      return (fv::to_f32(yf[prow * di + c]) +
              d_f[c] * fv::to_f32(xc_f[tok * di + c]) +
              fv::to_f32(yb[prow * di + c]) +
              d_b[c] * fv::to_f32(xc_b[tok * di + c])) *
             0.5f;
    };
    float m[kMaxJ];
    float sum = 0.f, sumsq = 0.f;
#pragma unroll
    for (int j = 0; j < kj; ++j) {
      if (j < nj) {
        const float v = merge(lane + 32 * j);
        if (kRegM) m[j] = v;
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
    for (int j = 0; j < kj; ++j) {
      if (j < nj) {
        const int c = lane + 32 * j;
        float v = kRegM ? m[j] : merge(c);
        if (use_ln) v = (v - mu) * rstd * ln_w[c] + ln_b[c];
        const float z = s_z[t * ldz + c] + (b_z ? b_z[c] : 0.f);
        g[t * ldg + c] = fv::round_to<T>(v * fv::silu(z));
      }
    }
  }
}

// FMA GEMM path (fp32): tiles of 8·kR tokens (kR of them a warp)
template <typename T, int kR, bool kRegM>
__global__ void __launch_bounds__(kThreads, 2)
pass_b_kernel(const T* __restrict__ x, const T* __restrict__ xc_f,
              const T* __restrict__ xc_b, const T* __restrict__ yf,
              const T* __restrict__ yb, const T* __restrict__ w_z,
              const float* __restrict__ b_z, const float* __restrict__ d_f,
              const float* __restrict__ d_b, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, const T* __restrict__ w_out,
              const float* __restrict__ b_out, T* __restrict__ out,
              long ntokens, int H, int W, int dm, int di, bool transposed,
              bool use_ln, float eps) {
  constexpr int kVe = fv::kVec<T>;
  constexpr int kTok = 8 * kR;
  extern __shared__ float smem_b[];
  float* s_x = smem_b;                                  // [kTok][dm]
  float* s_g = s_x + static_cast<size_t>(kTok) * dm;    // [kTok][di]
  float* s_w = s_g + static_cast<size_t>(kTok) * di;    // [kBKc][kBSlab+1]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long tok0 = static_cast<long>(blockIdx.x) * kTok;
  const int ntile = ntokens - tok0 < kTok ? static_cast<int>(ntokens - tok0)
                                          : kTok;
  // the tile's x̂ rows are one contiguous run of ntile·dm values
  const int nvalid = ntile * dm / kVe;
  for (int i = threadIdx.x; i < kTok * dm / kVe; i += kThreads) {
    float f[kVe];
    if (i < nvalid) {
      fv::widen16<T>(fv::load16(x + tok0 * dm + i * kVe), f);
    } else {
#pragma unroll
      for (int e = 0; e < kVe; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVe; ++e) s_x[i * kVe + e] = f[e];
  }

  float acc[kR][kBCols];
  for (int n0 = 0; n0 < di; n0 += kBSlab) {  // z = x̂·W_z (bias in merge)
    const int ncols = min(kBCols, (di - n0) / 32);
    gemm_rows<T, kR>(s_x, w_z, dm, n0, ncols, s_w, acc);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        if (j < ncols)
          s_g[(kR * warp + r) * di + n0 + lane + 32 * j] = acc[r][j];
  }
  __syncthreads();
  merge_ln_gate<T, kR, kRegM>(s_g, di, s_g, di, tok0, ntile, xc_f, xc_b, yf,
                              yb, b_z, d_f, d_b, ln_w, ln_b, H, W, di,
                              transposed, use_ln, eps);
  for (int n0 = 0; n0 < dm; n0 += kBSlab) {  // out = g·W_out + b_out
    const int ncols = min(kBCols, (dm - n0) / 32);
    gemm_rows<T, kR>(s_g, w_out, di, n0, ncols, s_w, acc);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int t = kR * warp + r;
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        if (j < ncols && t < ntile) {
          const int n = n0 + lane + 32 * j;
          out[(tok0 + t) * dm + n] =
              fv::from_f32<T>(acc[r][j] + (b_out ? b_out[n] : 0.f));
        }
    }
  }
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------
template <int R, bool RegM>
struct BTile {  // pass B's fp32 tile: 8·kR tokens, m in registers or not
  static constexpr int kR = R;
  static constexpr bool kRegM = RegM;
};

cudaError_t launch_a(const void* x, const void* w_x, const void* b_x,
                     const void* w_cf, const void* b_cf, const void* w_ab,
                     const void* b_ab, void* xc_f, void* xc_b, void* pf,
                     void* pb, int batch, int H, int W, int dm, int di,
                     bool transposed, float scaling, cudaStream_t stream) {
  const int P = transposed ? W : H;
  const int ln = transposed ? H : W;
  const size_t smem = pass_a_smem(ln, dm);
  dim3 grid(di / kACh, P, batch);
  cudaError_t err = fv::allow_max_smem<pass_a_kernel<float>>();
  if (err != cudaSuccess) return err;
  pass_a_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_x),
      static_cast<const float*>(b_x), static_cast<const float*>(w_cf),
      static_cast<const float*>(b_cf), static_cast<const float*>(w_ab),
      static_cast<const float*>(b_ab), static_cast<float*>(xc_f),
      static_cast<float*>(xc_b), static_cast<float*>(pf),
      static_cast<float*>(pb), H, W, dm, di, transposed, scaling);
  return cudaGetLastError();
}

cudaError_t launch_b(const void* x, const void* xc_f, const void* xc_b,
                     const void* yf, const void* yb, const void* w_z,
                     const void* b_z, const void* d_f, const void* d_b,
                     const void* ln_w, const void* ln_b, const void* w_out,
                     const void* b_out, void* out, int batch, int H, int W,
                     int dm, int di, bool transposed, bool use_ln, float eps,
                     cudaStream_t stream) {
  const long ntokens = static_cast<long>(batch) * H * W;
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  // 32-token tiles with m in registers up to d_inner 768 (FastVim-T/S);
  // wider, the largest tile that fits, m formed again
  auto run = [&](auto kind) -> cudaError_t {
    constexpr int kR = decltype(kind)::kR;
    constexpr bool kRegM = decltype(kind)::kRegM;
    cudaError_t err = fv::allow_max_smem<pass_b_kernel<float, kR, kRegM>>();
    if (err != cudaSuccess) return err;
    const unsigned blocks =
        static_cast<unsigned>((ntokens + 8 * kR - 1) / (8 * kR));
    pass_b_kernel<float, kR, kRegM>
        <<<blocks, kThreads, pass_b_smem(dm, di, 8 * kR), stream>>>(
        cF(x), cF(xc_f), cF(xc_b), cF(yf), cF(yb), cF(w_z), cF(b_z), cF(d_f),
        cF(d_b), cF(ln_w), cF(ln_b), cF(w_out), cF(b_out),
        static_cast<float*>(out), ntokens, H, W, dm, di, transposed, use_ln,
        eps);
    return cudaGetLastError();
  };
  const bool tok32 = pass_b_smem(dm, di, 32) <= kMaxSmem;
  if (tok32 && di <= kBMaxDi) return run(BTile<4, true>{});
  if (tok32) return run(BTile<4, false>{});
  if (pass_b_smem(dm, di, 16) <= kMaxSmem) return run(BTile<2, false>{});
  return run(BTile<1, false>{});
}

}  // namespace

// x: (batch, H, W, dm) of `dtype` (0 fp32, 1 bf16); w_x: (di, dm) of
// `dtype` (the x rows of in_proj.weight); b_x, b_cf, b_ab: (di,) fp32 or
// null; w_cf, w_ab: (di, 4) fp32. Outputs xc_f, xc_b: (batch, H, W, di);
// pf, pb: (batch, P, di), P = W if transposed else H; all of `dtype`. With
// xc_f and xc_b both null only the pools are written.
// dm % 32 == 0, dm <= fvf::kFwdMaxDm, di % 64 == 0, di <= fvf::kFwdMaxDi,
// lines of >= 4 tokens; x and w_x 32-byte aligned. Returns a cudaError_t.
extern "C" int fv_pass_a_fwd(const void* x, const void* w_x, const void* b_x,
                             const void* w_cf, const void* b_cf,
                             const void* w_ab, const void* b_ab, void* xc_f,
                             void* xc_b, void* pf, void* pb, int batch, int H,
                             int W, int dm, int di, int transposed,
                             int dtype, float scaling, void* stream) {
  const int ln = transposed ? H : W;
  const int P = transposed ? W : H;
  const bool bf = dtype == fv::kBF16;
  if ((dtype != fv::kF32 && !bf) || batch < 1 || batch > 65535 || P < 1 ||
      P > 65535 || ln < kPad + 1 || dm < kAKc || dm % kAKc != 0 ||
      dm > fvf::kFwdMaxDm || di < kACh || di % kACh != 0 ||
      di > fvf::kFwdMaxDi || (!bf && pass_a_smem(ln, dm) > kMaxSmem))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf)
    return fvf::pass_a_fwd_bf16(x, w_x, b_x, w_cf, b_cf, w_ab, b_ab, xc_f,
                                xc_b, pf, pb, batch, H, W, dm, di, transposed,
                                scaling, s);
  return launch_a(x, w_x, b_x, w_cf, b_cf, w_ab, b_ab, xc_f, xc_b, pf, pb,
                  batch, H, W, dm, di, transposed, scaling, s);
}

// x: (batch, H, W, dm); xc_f, xc_b: (batch, H, W, di); yf, yb: (batch, P,
// di); w_z: (di, dm) (the z rows of in_proj.weight); w_out: (dm, di), all
// of `dtype`. b_z, d_f, d_b, ln_w, ln_b: (di,) and b_out: (dm,) fp32; b_z,
// b_out may be null, ln_w/ln_b are read only with use_ln. out: (batch, H,
// W, dm) of `dtype`. dm, di % 32 == 0, dm <= fvf::kFwdMaxDm, di <=
// fvf::kFwdMaxDi; x, w_z, w_out 32-byte aligned. Returns a cudaError_t.
extern "C" int fv_pass_b_fwd(const void* x, const void* xc_f,
                             const void* xc_b, const void* yf, const void* yb,
                             const void* w_z, const void* b_z,
                             const void* d_f, const void* d_b,
                             const void* ln_w, const void* ln_b,
                             const void* w_out, const void* b_out, void* out,
                             int batch, int H, int W, int dm, int di,
                             int transposed, int dtype, int use_ln, float eps,
                             void* stream) {
  const bool bf = dtype == fv::kBF16;
  if ((dtype != fv::kF32 && !bf) || batch < 1 || H < 1 || W < 1 || dm < 32 ||
      dm % 32 != 0 || dm > fvf::kFwdMaxDm || di < 32 || di % 32 != 0 ||
      di > fvf::kFwdMaxDi)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf)
    return fvf::pass_b_fwd_bf16(x, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b,
                                ln_w, ln_b, w_out, b_out, out, batch, H, W,
                                dm, di, transposed, use_ln, eps, s);
  return launch_b(x, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b,
                  w_out, b_out, out, batch, H, W, dm, di, transposed, use_ln,
                  eps, s);
}
