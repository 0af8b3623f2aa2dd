// K8 and K9: the two fused block kernels of the unfused mixer path, for
// Hopper (sm_90a).
//
// K8 (conv_pool) replaces `_conv_pool_kernel` and K9 (merge_gate)
// `_merge_kernel` (fastvim_tpu/ops/pallas/fused_block.py). x is the x half
// of the in-projection, (batch, L, d) with L = rows·cols tokens in raster
// order:
//   cf = silu(causal width-4 conv of x + b_cf), cb = silu(anticausal ...),
//   both along the flat raster, rounded to x's type (the type the unfused
//   path holds them in);
//   K8: pf, pb = mean over each row of cf, cb (fp32 sum) × scaling, or the
//       max over each row, in fp32. cf and cb never reach device memory.
//   K9: cf and cb computed again from x; m = ½(yf + D_f·cf + yb + D_b·cb)
//       with yf, yb broadcast over their row; LayerNorm over d with fp32
//       statistics (or m as it is); × silu(z); written in x's type.
//
// What bounds them on the H100: bytes. K8 reads x once and writes two
// pooled arrays 1/cols of its size; K9 reads x and z and writes out, and
// does ~40 fp32 operations per element beside 6 bytes of bf16 traffic.
//
// The TPU kernels were handed 8-token halo arrays built outside, because a
// Pallas block cannot read its neighbour; here a thread reads the 3 tokens
// before and after its own straight from x. The conv runs along the flat
// raster, so a row's first tokens take taps from the end of the previous
// row; only tokens outside the sequence are 0, and they are masked before
// the load. x and z may be column slices of one wider array (the in-
// projection's output): tokens are `ldx` / `ldz` elements apart.
//
// K8 design: a block owns one row of one image and 64 channels; warp w
// walks the w-th eighth of the row with a 7-token window in registers, a
// lane holding 2 neighbouring channels, so every token of x is loaded once
// per warp (plus 6 halo tokens per segment). The 8 partial sums (or
// maxima) meet in shared memory; no reduction crosses blocks.
// K9 design: one warp per token, 32 consecutive tokens per block (see
// merge_tail.cuh). A token's 7 conv inputs come from global memory; its
// neighbours in the block read the same rows, so all but the first read
// hit L1. The TPU kernel normalizes 2·m with 4·eps to save a multiply;
// this one computes the plain form, LayerNorm of m with eps.

#include <cmath>

#include "merge_tail.cuh"

namespace {

constexpr int kPad = 3;          // d_conv - 1
constexpr int kPoolWarps = 8;    // segments a row is split into
constexpr int kPoolCh = 64;      // channels per K8 block: 2 per lane

// =====================================================================
// K8: conv + pool
// =====================================================================
template <typename T>
__global__ void __launch_bounds__(32 * kPoolWarps)
conv_pool_kernel(const T* __restrict__ x, long ldx,
                 const float* __restrict__ w_cf,
                 const float* __restrict__ b_cf,
                 const float* __restrict__ w_ab,
                 const float* __restrict__ b_ab, float* __restrict__ pf,
                 float* __restrict__ pb, int rows, int cols, int d,
                 bool is_max, float scale) {
  __shared__ float s_red[kPoolWarps][4][32];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int c = (blockIdx.x * 32 + lane) * 2;
  const int row = blockIdx.y, b = blockIdx.z;
  const long L = static_cast<long>(rows) * cols;
  const int seg = (cols + kPoolWarps - 1) / kPoolWarps;
  const int i0 = w * seg, i1 = min(cols, i0 + seg);
  const float init = is_max ? -INFINITY : 0.f;
  float acc[4] = {init, init, init, init};  // f: c, c+1; b: c, c+1
  if (c < d && i0 < i1) {
    float wc[2][4], wa[2][4], bc[2], ba[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wc[e][k] = w_cf[(c + e) * 4 + k];
        wa[e][k] = w_ab[(c + e) * 4 + k];
      }
      bc[e] = b_cf ? b_cf[c + e] : 0.f;
      ba[e] = b_ab ? b_ab[c + e] : 0.f;
    }
    const T* xb = x + static_cast<size_t>(b) * L * ldx + c;
    const long t0 = static_cast<long>(row) * cols + i0;
    auto token = [&](long t) {  // masked before the load
      return t >= 0 && t < L ? fv::load2(xb + t * ldx) : make_float2(0.f, 0.f);
    };
    float2 win[2 * kPad + 1];  // x[t-3 .. t+3]
#pragma unroll
    for (int k = 0; k < 2 * kPad; ++k) win[k + 1] = token(t0 - kPad + k);
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const long t = t0 + (i - i0);
#pragma unroll
      for (int k = 0; k < 2 * kPad; ++k) win[k] = win[k + 1];
      win[2 * kPad] = token(t + kPad);
      float yc[2] = {0.f, 0.f}, ya[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        yc[0] += win[k].x * wc[0][k];  // x[t-3+k]·w_c[k]
        yc[1] += win[k].y * wc[1][k];
        ya[0] += win[kPad + k].x * wa[0][kPad - k];  // x[t+k]·w_a[3-k]
        ya[1] += win[kPad + k].y * wa[1][kPad - k];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float cf = fv::round_to<T>(fv::silu(yc[e] + bc[e]));
        const float cb = fv::round_to<T>(fv::silu(ya[e] + ba[e]));
        acc[e] = is_max ? fmaxf(acc[e], cf) : acc[e] + cf;
        acc[2 + e] = is_max ? fmaxf(acc[2 + e], cb) : acc[2 + e] + cb;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) s_red[w][q][lane] = acc[q];
  __syncthreads();
  if (w == 0 && c < d) {
    float tot[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = s_red[0][q][lane];
      for (int k = 1; k < kPoolWarps; ++k)
        v = is_max ? fmaxf(v, s_red[k][q][lane]) : v + s_red[k][q][lane];
      tot[q] = is_max ? v : v * scale;
    }
    const size_t o = (static_cast<size_t>(b) * rows + row) * d + c;
    fv::store2(pf + o, tot[0], tot[1]);
    fv::store2(pb + o, tot[2], tot[3]);
  }
}

// =====================================================================
// K9: conv again + merge + LayerNorm + gate
// =====================================================================
template <typename T>
__global__ void __launch_bounds__(fv::kMergeThreads)
merge_gate_kernel(const T* __restrict__ x, long ldx, const T* __restrict__ z,
                  long ldz, const float* __restrict__ yf,
                  const float* __restrict__ yb,
                  const float* __restrict__ w_cf,
                  const float* __restrict__ b_cf,
                  const float* __restrict__ w_ab,
                  const float* __restrict__ b_ab,
                  const float* __restrict__ d_f,
                  const float* __restrict__ d_b,
                  const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b, T* __restrict__ out,
                  int rows, int cols, int d, bool use_ln, float eps) {
  extern __shared__ float s_rows[];  // [8 warps][d]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const long L = static_cast<long>(rows) * cols;
  float* s_m = s_rows + static_cast<size_t>(warp) * d;
  for (int r = 0; r < 4; ++r) {
    const long t = static_cast<long>(blockIdx.x) * fv::kMergeTok + 4 * warp + r;
    if (t >= L) break;
    const size_t tok = static_cast<size_t>(b) * L + t;
    const T* xt = x + tok * ldx;
    const size_t prow = (static_cast<size_t>(b) * rows + t / cols) * d;
    float sum = 0.f;
    for (int c = 2 * lane; c < d; c += 64) {
      float yc[2] = {0.f, 0.f}, ya[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k <= 2 * kPad; ++k) {
        const long tt = t - kPad + k;
        if (tt < 0 || tt >= L) continue;  // masked before the load
        const float2 v = fv::load2(xt + (k - kPad) * ldx + c);
        if (k <= kPad) {  // x[t-3+k]·w_c[k]
          yc[0] += v.x * w_cf[c * 4 + k];
          yc[1] += v.y * w_cf[(c + 1) * 4 + k];
        }
        if (k >= kPad) {  // x[t+j]·w_a[3-j], j = k - 3
          ya[0] += v.x * w_ab[c * 4 + 2 * kPad - k];
          ya[1] += v.y * w_ab[(c + 1) * 4 + 2 * kPad - k];
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float cf = fv::round_to<T>(
            fv::silu(yc[e] + (b_cf ? b_cf[c + e] : 0.f)));
        const float cb = fv::round_to<T>(
            fv::silu(ya[e] + (b_ab ? b_ab[c + e] : 0.f)));
        const float m = (yf[prow + c + e] + d_f[c + e] * cf +
                         yb[prow + c + e] + d_b[c + e] * cb) *
                        0.5f;
        s_m[c + e] = m;
        sum += m;
      }
    }
    fv::ln_gate_store<T>(s_m, sum, z + tok * ldz, out + tok * d, ln_w, ln_b,
                         d, use_ln, eps);
  }
}

template <typename T>
cudaError_t launch_conv_pool(const void* x, long ldx, const void* w_cf,
                             const void* b_cf, const void* w_ab,
                             const void* b_ab, void* pf, void* pb, int batch,
                             int rows, int cols, int d, bool is_max,
                             float scaling, cudaStream_t stream) {
  dim3 grid((d + kPoolCh - 1) / kPoolCh, rows, batch);
  dim3 block(32, kPoolWarps);
  conv_pool_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const float*>(w_cf),
      static_cast<const float*>(b_cf), static_cast<const float*>(w_ab),
      static_cast<const float*>(b_ab), static_cast<float*>(pf),
      static_cast<float*>(pb), rows, cols, d, is_max,
      scaling / static_cast<float>(cols));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_merge_gate(const void* x, long ldx, const void* z, long ldz,
                              const void* yf, const void* yb,
                              const void* w_cf, const void* b_cf,
                              const void* w_ab, const void* b_ab,
                              const void* d_f, const void* d_b,
                              const void* ln_w, const void* ln_b, void* out,
                              int batch, int rows, int cols, int d,
                              bool use_ln, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(fv::kMergeThreads / 32) * d *
                      sizeof(float);
  if (smem > fv::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<merge_gate_kernel<T>>();
  if (err != cudaSuccess) return err;
  const long L = static_cast<long>(rows) * cols;
  dim3 grid(static_cast<unsigned>((L + fv::kMergeTok - 1) / fv::kMergeTok),
            batch);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  merge_gate_kernel<T><<<grid, fv::kMergeThreads, smem, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(z), ldz, f(yf),
      f(yb), f(w_cf), f(b_cf), f(w_ab), f(b_ab), f(d_f), f(d_b), f(ln_w),
      f(ln_b), static_cast<T*>(out), rows, cols, d, use_ln, eps);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, rows·cols, d) of `dtype` (0 fp32, 1 bf16), tokens `ldx`
// elements apart (ldx >= d, even), channel pairs 4- (bf16) or 8-byte (fp32)
// aligned; w_cf, w_ab: (d, 4) fp32; b_cf, b_ab: (d,) fp32 or null. pf, pb:
// (batch, rows, d) fp32, the mean × scaling of each row, or with `is_max`
// its maximum. d even. Returns a cudaError_t.
extern "C" int fv_conv_pool_fwd(const void* x, const void* w_cf,
                                const void* b_cf, const void* w_ab,
                                const void* b_ab, void* pf, void* pb,
                                int batch, int rows, int cols, int d, int ldx,
                                int is_max, int dtype, float scaling,
                                void* stream) {
  if (batch < 1 || batch > 65535 || rows < 1 || rows > 65535 || cols < 1 ||
      d < 2 || d % 2 != 0 || ldx < d || ldx % 2 != 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fv::kF32:
      return launch_conv_pool<float>(x, ldx, w_cf, b_cf, w_ab, b_ab, pf, pb,
                                     batch, rows, cols, d, is_max, scaling,
                                     st);
    case fv::kBF16:
      return launch_conv_pool<__nv_bfloat16>(x, ldx, w_cf, b_cf, w_ab, b_ab,
                                             pf, pb, batch, rows, cols, d,
                                             is_max, scaling, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// x, z: (batch, rows·cols, d) of `dtype`, tokens `ldx` / `ldz` elements
// apart, aligned as for fv_conv_pool_fwd; yf, yb: (batch, rows, d) fp32;
// w_cf, w_ab: (d, 4), d_f, d_b: (d,) fp32; b_cf, b_ab, ln_w, ln_b: (d,) fp32
// or null (ln_w / ln_b null: 1 / 0). out: (batch, rows·cols, d) of `dtype`,
// contiguous. d even, 8·d floats of shared memory. Returns a cudaError_t.
extern "C" int fv_merge_gate_fwd(const void* x, const void* z, const void* yf,
                                 const void* yb, const void* w_cf,
                                 const void* b_cf, const void* w_ab,
                                 const void* b_ab, const void* d_f,
                                 const void* d_b, const void* ln_w,
                                 const void* ln_b, void* out, int batch,
                                 int rows, int cols, int d, int ldx, int ldz,
                                 int dtype, int use_ln, float eps,
                                 void* stream) {
  if (batch < 1 || batch > 65535 || rows < 1 || cols < 1 || d < 2 ||
      d % 2 != 0 || ldx < d || ldx % 2 != 0 || ldz < d || ldz % 2 != 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fv::kF32:
      return launch_merge_gate<float>(x, ldx, z, ldz, yf, yb, w_cf, b_cf,
                                      w_ab, b_ab, d_f, d_b, ln_w, ln_b, out,
                                      batch, rows, cols, d, use_ln, eps, st);
    case fv::kBF16:
      return launch_merge_gate<__nv_bfloat16>(x, ldx, z, ldz, yf, yb, w_cf,
                                              b_cf, w_ab, b_ab, d_f, d_b,
                                              ln_w, ln_b, out, batch, rows,
                                              cols, d, use_ln, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}
