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
// out once, 8 bytes per element in bf16, and does ~15 fp32 operations per
// element.
//
// Design: one warp per token, 32 consecutive tokens per block, a lane
// walking channel pairs (merge_tail.cuh), so the width is bounded only by
// the 8·d floats of shared memory. The TPU kernel asked for W % 8 == 0 and
// d % 128 == 0 (its block rules); neither holds here. z may be a column
// slice of the in-projection's output: tokens are `ldz` elements apart.

#include "merge_tail.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(fv::kMergeThreads)
merge_ln_gate_kernel(const T* __restrict__ xc_f, const T* __restrict__ xc_b,
                     const T* __restrict__ z, long ldz,
                     const T* __restrict__ yf, const T* __restrict__ yb,
                     const float* __restrict__ d_f,
                     const float* __restrict__ d_b,
                     const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, T* __restrict__ out,
                     int H, int W, int d, bool along_w, bool use_ln,
                     float eps) {
  extern __shared__ float s_rows[];  // [8 warps][d]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y;
  const long L = static_cast<long>(H) * W;
  const int P = along_w ? H : W;
  float* s_m = s_rows + static_cast<size_t>(warp) * d;
  for (int r = 0; r < 4; ++r) {
    const long t = static_cast<long>(blockIdx.x) * fv::kMergeTok + 4 * warp + r;
    if (t >= L) break;
    const size_t tok = static_cast<size_t>(b) * L + t;
    const size_t prow =
        (static_cast<size_t>(b) * P + (along_w ? t / W : t % W)) * d;
    float sum = 0.f;
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 f = fv::load2(xc_f + tok * d + c);
      const float2 g = fv::load2(xc_b + tok * d + c);
      const float2 pf = fv::load2(yf + prow + c);
      const float2 pb = fv::load2(yb + prow + c);
      const float m0 = (pf.x + d_f[c] * f.x + pb.x + d_b[c] * g.x) * 0.5f;
      const float m1 =
          (pf.y + d_f[c + 1] * f.y + pb.y + d_b[c + 1] * g.y) * 0.5f;
      s_m[c] = m0;
      s_m[c + 1] = m1;
      sum += m0 + m1;
    }
    fv::ln_gate_store<T>(s_m, sum, z + tok * ldz, out + tok * d, ln_w, ln_b,
                         d, use_ln, eps);
  }
}

template <typename T>
cudaError_t launch(const void* xc_f, const void* xc_b, const void* z, long ldz,
                   const void* yf, const void* yb, const void* d_f,
                   const void* d_b, const void* ln_w, const void* ln_b,
                   void* out, int batch, int H, int W, int d, bool along_w,
                   bool use_ln, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(fv::kMergeThreads / 32) * d *
                      sizeof(float);
  if (smem > fv::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<merge_ln_gate_kernel<T>>();
  if (err != cudaSuccess) return err;
  const long L = static_cast<long>(H) * W;
  dim3 grid(static_cast<unsigned>((L + fv::kMergeTok - 1) / fv::kMergeTok),
            batch);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const T*>(p); };
  merge_ln_gate_kernel<T><<<grid, fv::kMergeThreads, smem, stream>>>(
      h(xc_f), h(xc_b), h(z), ldz, h(yf), h(yb), f(d_f), f(d_b), f(ln_w),
      f(ln_b), static_cast<T*>(out), H, W, d, along_w, use_ln, eps);
  return cudaGetLastError();
}

}  // namespace

// xc_f, xc_b: (batch, H·W, d) contiguous; z the same shape with tokens
// `ldz` elements apart (ldz >= d, even); yf, yb: (batch, P, d), P = H with
// `along_w` else W, all of `dtype` (0 fp32, 1 bf16). d_f, d_b: (d,) fp32;
// ln_w, ln_b: (d,) fp32 or null (1 / 0). out: (batch, H·W, d) of `dtype`.
// d even, 8·d floats of shared memory. Returns a cudaError_t.
extern "C" int fv_merge_ln_gate_fwd(const void* xc_f, const void* xc_b,
                                    const void* z, const void* yf,
                                    const void* yb, const void* d_f,
                                    const void* d_b, const void* ln_w,
                                    const void* ln_b, void* out, int batch,
                                    int H, int W, int d, int ldz, int along_w,
                                    int dtype, int use_ln, float eps,
                                    void* stream) {
  if (batch < 1 || batch > 65535 || H < 1 || W < 1 || d < 2 || d % 2 != 0 ||
      ldz < d || ldz % 2 != 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fv::kF32:
      return launch<float>(xc_f, xc_b, z, ldz, yf, yb, d_f, d_b, ln_w, ln_b,
                           out, batch, H, W, d, along_w, use_ln, eps, st);
    case fv::kBF16:
      return launch<__nv_bfloat16>(xc_f, xc_b, z, ldz, yf, yb, d_f, d_b, ln_w,
                                   ln_b, out, batch, H, W, d, along_w, use_ln,
                                   eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}
