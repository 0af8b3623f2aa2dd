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
// What bounds them on the H100: the three GEMMs (d_model 192 × d_inner
// 384 per token, for x̂·W_x, x̂·W_z and the out projection) are ~0.44
// MFLOP per token against ~4.2 KB of bf16 traffic per token (x̂ read
// twice, xc_f and xc_b written and read back, out written): ~105
// FLOP/byte, below the ~295 at which bf16 tensor cores become the limit.
// So with tensor-core GEMMs the passes are bound by memory traffic,
// mostly the xc round trip. In fp32 there are no tensor cores to use
// without TF32 rounding, so the fp32 path runs FMA tiles (67 TFLOP/s
// peak, ~52 FLOP/byte of fp32 traffic) and is FMA-bound. Both paths keep
// every intermediate except xc (which pass B needs after the pooled
// scans) out of device memory.
//
// GEMMs: fp32 inputs use FMA tiles streamed through shared memory in K
// chunks, every 16-byte load of a chunk issued before any is stored.
// bf16 inputs use WMMA 16×16×16 tiles (bf16 products, fp32 accumulation,
// the TPU kernel's `preferred_element_type=f32`): A from shared memory,
// the weight tile straight from global memory (L2-resident, read once per
// block). Measured on the main path at 2048 px: one dependent load per
// element, FMA only, took 0.37 ms (K3) and 1.34 ms (K4).
//
// K3 design: a block owns one line of one image and a 64-channel slice,
// so the pooled mean needs no cross-block reduction. It computes the
// x-half GEMM for the line's tokens plus 3 halo tokens on each side (the
// previous line's tail for the causal taps, the next line's head for the
// anticausal ones) into a (line + 6) × 64 fp32 tile in shared memory.
// Halo tokens outside the sequence (before the first line, after the
// last) are never loaded: they are masked before the read and set to 0,
// the zero padding of the flat conv. The conv, SiLU, the xc stores and
// the pooled sums run from that tile in fp32; pf/pb are taken from the
// fp32 xc before its cast.
//
// K4 design: a block owns 32 consecutive tokens with all d_inner
// channels, so LayerNorm statistics are a warp reduction over a full row.
// z goes to a shared (32 × d_inner) fp32 tile, the merge/LN/gate runs
// over it (one warp per 4 tokens), the gated value is rounded to the
// working dtype (the TPU kernel casts it before the out GEMM), and the
// out projection reads it from shared memory. Registers are capped so
// that two blocks share an SM.

#include "layer_fused.cuh"

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
    xc_f[off] = fv::from_f32<T>(xf);
    xc_b[off] = fv::from_f32<T>(xb);
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

// WMMA GEMM path (bf16)
__global__ void __launch_bounds__(kThreads)
pass_a_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_x,
                   const float* __restrict__ b_x,
                   const float* __restrict__ w_cf,
                   const float* __restrict__ b_cf,
                   const float* __restrict__ w_ab,
                   const float* __restrict__ b_ab, bf16* __restrict__ xc_f,
                   bf16* __restrict__ xc_b, bf16* __restrict__ pf,
                   bf16* __restrict__ pb, int H, int W, int dm, int di,
                   bool transposed, float scaling) {
  extern __shared__ __align__(128) unsigned char smem_aw[];
  const int c0 = blockIdx.x * kACh;
  const int b = blockIdx.z;
  const Line L{H, W, transposed ? W : H, transposed ? H : W,
               static_cast<int>(blockIdx.y), transposed,
               static_cast<size_t>(b) * H * W};
  const int ntok16 = round16(L.ln + 2 * kPad);
  const int ldx = dm + 8;  // padded row: 16 bytes of skew per row
  float* s_xin = reinterpret_cast<float*>(smem_aw);  // [ntok16][kACh]
  bf16* s_xb = reinterpret_cast<bf16*>(s_xin + static_cast<size_t>(ntok16) *
                                                   kACh);  // [rows][ldx]
  float* s_red = reinterpret_cast<float*>(
      s_xb + static_cast<size_t>(imin(kAWRows, ntok16)) * ldx);

  xin_tile_wmma(x, w_x, b_x, L, c0, dm, s_xin, s_xb);
  conv_pool_line<bf16>(s_xin, s_red, L, b, c0, di, w_cf, b_cf, w_ab, b_ab,
                       xc_f, xc_b, pf, pb, scaling);
}

// =====================================================================
// K4: pass B
// =====================================================================
// shared memory of pass B, in bytes
__host__ __device__ inline size_t pass_b_smem(int dm, int di, bool tc) {
  if (tc)
    return static_cast<size_t>(kBTok) * (dm + 8) * sizeof(bf16)   // x̂
           + static_cast<size_t>(kBTok) * imax(di, dm) * sizeof(float)  // z, out
           + static_cast<size_t>(kBTok) * (di + 8) * sizeof(bf16);  // gated
  return (static_cast<size_t>(kBTok) * dm + static_cast<size_t>(kBTok) * di +
          static_cast<size_t>(kBKc) * (kBSlab + 1)) * sizeof(float);
}

// merge + LayerNorm + gate for the block's tokens: z (without bias) from
// s_z (row stride ldz); the gated value, rounded to T, into g (row stride
// ldg). One warp per 4 tokens; g may alias s_z (same element, same
// thread).
template <typename T, typename G>
__device__ __forceinline__ void merge_ln_gate(
    const float* s_z, int ldz, G* g, int ldg, long tok0, int ntile,
    const T* __restrict__ xc_f, const T* __restrict__ xc_b,
    const T* __restrict__ yf, const T* __restrict__ yb,
    const float* __restrict__ b_z, const float* __restrict__ d_f,
    const float* __restrict__ d_b, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, int H, int W, int di, bool transposed,
    bool use_ln, float eps) {
  constexpr int kMaxJ = kBMaxDi / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nj = di / 32;
  for (int r = 0; r < 4; ++r) {
    const int t = 4 * warp + r;
    if (t >= ntile) break;
    const long tok = tok0 + t;
    const long pix = tok % (static_cast<long>(H) * W);
    const long line = transposed ? pix % W : pix / W;  // pooled index
    const long prow =
        (tok / (static_cast<long>(H) * W)) * (transposed ? W : H) + line;
    float m[kMaxJ];
    float sum = 0.f, sumsq = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
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

// FMA GEMM path (fp32)
template <typename T>
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
  extern __shared__ float smem_b[];
  float* s_x = smem_b;                                  // [kBTok][dm]
  float* s_g = s_x + static_cast<size_t>(kBTok) * dm;   // [kBTok][di]
  float* s_w = s_g + static_cast<size_t>(kBTok) * di;   // [kBKc][kBSlab+1]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long tok0 = static_cast<long>(blockIdx.x) * kBTok;
  const int ntile = ntokens - tok0 < kBTok ? static_cast<int>(ntokens - tok0)
                                           : kBTok;
  // the tile's x̂ rows are one contiguous run of ntile·dm values
  const int nvalid = ntile * dm / kVe;
  for (int i = threadIdx.x; i < kBTok * dm / kVe; i += kThreads) {
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

  float acc[4][kBCols];
  for (int n0 = 0; n0 < di; n0 += kBSlab) {  // z = x̂·W_z (bias in merge)
    const int ncols = min(kBCols, (di - n0) / 32);
    gemm_rows<T>(s_x, w_z, dm, n0, ncols, s_w, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        if (j < ncols) s_g[(4 * warp + r) * di + n0 + lane + 32 * j] = acc[r][j];
  }
  __syncthreads();
  merge_ln_gate<T, float>(s_g, di, s_g, di, tok0, ntile, xc_f, xc_b, yf, yb,
                          b_z, d_f, d_b, ln_w, ln_b, H, W, di, transposed,
                          use_ln, eps);
  for (int n0 = 0; n0 < dm; n0 += kBSlab) {  // out = g·W_out + b_out
    const int ncols = min(kBCols, (dm - n0) / 32);
    gemm_rows<T>(s_g, w_out, di, n0, ncols, s_w, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * warp + r;
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

// WMMA GEMM path (bf16)
__global__ void __launch_bounds__(kThreads, 2)
pass_b_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xc_f,
                   const bf16* __restrict__ xc_b, const bf16* __restrict__ yf,
                   const bf16* __restrict__ yb, const bf16* __restrict__ w_z,
                   const float* __restrict__ b_z,
                   const float* __restrict__ d_f,
                   const float* __restrict__ d_b,
                   const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b,
                   const bf16* __restrict__ w_out,
                   const float* __restrict__ b_out, bf16* __restrict__ out,
                   long ntokens, int H, int W, int dm, int di,
                   bool transposed, bool use_ln, float eps) {
  extern __shared__ __align__(128) unsigned char smem_bw[];
  const int ldx = dm + 8, ldg = di + 8;  // 16 bytes of skew per row
  bf16* s_xb = reinterpret_cast<bf16*>(smem_bw);  // [kBTok][ldx]
  float* s_z = reinterpret_cast<float*>(
      s_xb + static_cast<size_t>(kBTok) * ldx);   // [kBTok][imax(di, dm)]
  bf16* s_gb = reinterpret_cast<bf16*>(
      s_z + static_cast<size_t>(kBTok) * imax(di, dm));  // [kBTok][ldg]
  const long tok0 = static_cast<long>(blockIdx.x) * kBTok;
  const int ntile = ntokens - tok0 < kBTok ? static_cast<int>(ntokens - tok0)
                                           : kBTok;
  const int vpr = dm / 8;  // 16-byte vectors per row of x̂
  for (int i = threadIdx.x; i < kBTok * vpr; i += kThreads) {
    const int t = i / vpr, v = i % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < ntile) val = fv::load16(x + (tok0 + t) * dm + v * 8);
    *reinterpret_cast<uint4*>(s_xb + static_cast<size_t>(t) * ldx + v * 8) =
        val;
  }
  __syncthreads();
  wmma_rows(s_xb, ldx, w_z, dm, di, s_z, di);  // z = x̂·W_z
  __syncthreads();
  merge_ln_gate<bf16, bf16>(s_z, di, s_gb, ldg, tok0, ntile, xc_f, xc_b, yf,
                            yb, b_z, d_f, d_b, ln_w, ln_b, H, W, di,
                            transposed, use_ln, eps);
  __syncthreads();
  wmma_rows(s_gb, ldg, w_out, di, dm, s_z, dm);  // g·W_out
  __syncthreads();
  for (int i = threadIdx.x; i < ntile * dm; i += kThreads) {
    const int n = i % dm;
    out[tok0 * dm + i] = fv::from_f32<bf16>(s_z[i] + (b_out ? b_out[n] : 0.f));
  }
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------
cudaError_t launch_a(int dtype, const void* x, const void* w_x,
                     const void* b_x, const void* w_cf, const void* b_cf,
                     const void* w_ab, const void* b_ab, void* xc_f,
                     void* xc_b, void* pf, void* pb, int batch, int H, int W,
                     int dm, int di, bool transposed, float scaling,
                     cudaStream_t stream) {
  const int P = transposed ? W : H;
  const int ln = transposed ? H : W;
  const bool tc = dtype == fv::kBF16;
  const size_t smem = pass_a_smem(ln, dm, tc);
  dim3 grid(di / kACh, P, batch);
  const auto* bx = static_cast<const float*>(b_x);
  const auto* wcf = static_cast<const float*>(w_cf);
  const auto* bcf = static_cast<const float*>(b_cf);
  const auto* wab = static_cast<const float*>(w_ab);
  const auto* bab = static_cast<const float*>(b_ab);
  cudaError_t err;
  if (tc) {
    err = fv::allow_max_smem<pass_a_wmma_kernel>();
    if (err != cudaSuccess) return err;
    pass_a_wmma_kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w_x), bx, wcf,
        bcf, wab, bab, static_cast<bf16*>(xc_f), static_cast<bf16*>(xc_b),
        static_cast<bf16*>(pf), static_cast<bf16*>(pb), H, W, dm, di,
        transposed, scaling);
  } else {
    err = fv::allow_max_smem<pass_a_kernel<float>>();
    if (err != cudaSuccess) return err;
    pass_a_kernel<float><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w_x), bx, wcf,
        bcf, wab, bab, static_cast<float*>(xc_f), static_cast<float*>(xc_b),
        static_cast<float*>(pf), static_cast<float*>(pb), H, W, dm, di,
        transposed, scaling);
  }
  return cudaGetLastError();
}

cudaError_t launch_b(int dtype, const void* x, const void* xc_f,
                     const void* xc_b, const void* yf, const void* yb,
                     const void* w_z, const void* b_z, const void* d_f,
                     const void* d_b, const void* ln_w, const void* ln_b,
                     const void* w_out, const void* b_out, void* out,
                     int batch, int H, int W, int dm, int di, bool transposed,
                     bool use_ln, float eps, cudaStream_t stream) {
  const long ntokens = static_cast<long>(batch) * H * W;
  const bool tc = dtype == fv::kBF16;
  const size_t smem = pass_b_smem(dm, di, tc);
  const unsigned blocks = static_cast<unsigned>((ntokens + kBTok - 1) / kBTok);
  const auto* bz = static_cast<const float*>(b_z);
  const auto* df = static_cast<const float*>(d_f);
  const auto* db = static_cast<const float*>(d_b);
  const auto* lw = static_cast<const float*>(ln_w);
  const auto* lb = static_cast<const float*>(ln_b);
  const auto* bo = static_cast<const float*>(b_out);
  cudaError_t err;
  if (tc) {
    err = fv::allow_max_smem<pass_b_wmma_kernel>();
    if (err != cudaSuccess) return err;
    pass_b_wmma_kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(xc_f),
        static_cast<const bf16*>(xc_b), static_cast<const bf16*>(yf),
        static_cast<const bf16*>(yb), static_cast<const bf16*>(w_z), bz, df,
        db, lw, lb, static_cast<const bf16*>(w_out), bo,
        static_cast<bf16*>(out), ntokens, H, W, dm, di, transposed, use_ln,
        eps);
  } else {
    err = fv::allow_max_smem<pass_b_kernel<float>>();
    if (err != cudaSuccess) return err;
    pass_b_kernel<float><<<blocks, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(xc_f),
        static_cast<const float*>(xc_b), static_cast<const float*>(yf),
        static_cast<const float*>(yb), static_cast<const float*>(w_z), bz, df,
        db, lw, lb, static_cast<const float*>(w_out), bo,
        static_cast<float*>(out), ntokens, H, W, dm, di, transposed, use_ln,
        eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (batch, H, W, dm) of `dtype` (0 fp32, 1 bf16); w_x: (di, dm) of
// `dtype` (the x rows of in_proj.weight); b_x, b_cf, b_ab: (di,) fp32 or
// null; w_cf, w_ab: (di, 4) fp32. Outputs xc_f, xc_b: (batch, H, W, di);
// pf, pb: (batch, P, di), P = W if transposed else H; all of `dtype`.
// dm % 32 == 0, di % 64 == 0, lines of >= 4 tokens; x and w_x 32-byte
// aligned. Returns a cudaError_t.
extern "C" int fv_pass_a_fwd(const void* x, const void* w_x, const void* b_x,
                             const void* w_cf, const void* b_cf,
                             const void* w_ab, const void* b_ab, void* xc_f,
                             void* xc_b, void* pf, void* pb, int batch, int H,
                             int W, int dm, int di, int transposed,
                             int dtype, float scaling, void* stream) {
  const int ln = transposed ? H : W;
  const int P = transposed ? W : H;
  if ((dtype != fv::kF32 && dtype != fv::kBF16) || batch < 1 ||
      batch > 65535 || P < 1 || P > 65535 || ln < kPad + 1 || dm < kAKc ||
      dm % kAKc != 0 || di < kACh || di % kACh != 0 ||
      pass_a_smem(ln, dm, dtype == fv::kBF16) > kMaxSmem)
    return cudaErrorInvalidValue;
  return launch_a(dtype, x, w_x, b_x, w_cf, b_cf, w_ab, b_ab, xc_f, xc_b, pf,
                  pb, batch, H, W, dm, di, transposed, scaling,
                  static_cast<cudaStream_t>(stream));
}

// x: (batch, H, W, dm); xc_f, xc_b: (batch, H, W, di); yf, yb: (batch, P,
// di); w_z: (di, dm) (the z rows of in_proj.weight); w_out: (dm, di), all
// of `dtype`. b_z, d_f, d_b, ln_w, ln_b: (di,) and b_out: (dm,) fp32; b_z,
// b_out may be null, ln_w/ln_b are read only with use_ln. out: (batch, H,
// W, dm) of `dtype`. dm, di % 32 == 0, di <= 768; x, w_z, w_out 32-byte
// aligned. Returns a cudaError_t.
extern "C" int fv_pass_b_fwd(const void* x, const void* xc_f,
                             const void* xc_b, const void* yf, const void* yb,
                             const void* w_z, const void* b_z,
                             const void* d_f, const void* d_b,
                             const void* ln_w, const void* ln_b,
                             const void* w_out, const void* b_out, void* out,
                             int batch, int H, int W, int dm, int di,
                             int transposed, int dtype, int use_ln, float eps,
                             void* stream) {
  if ((dtype != fv::kF32 && dtype != fv::kBF16) || batch < 1 || H < 1 ||
      W < 1 || dm < 32 || dm % 32 != 0 || di < 32 || di % 32 != 0 ||
      di > kBMaxDi || pass_b_smem(dm, di, dtype == fv::kBF16) > kMaxSmem)
    return cudaErrorInvalidValue;
  return launch_b(dtype, x, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w,
                  ln_b, w_out, b_out, out, batch, H, W, dm, di, transposed,
                  use_ln, eps, static_cast<cudaStream_t>(stream));
}
