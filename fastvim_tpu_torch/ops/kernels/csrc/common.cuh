// Helpers shared by the fastvim_tpu_torch kernels: element types, the
// fp32 math the kernels do, and opting a kernel into large dynamic shared
// memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fv {

// dtype codes passed from Python (ops/kernels/_build.py callers)
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and widened back: the value a GEMM operand stored in T
// holds.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// 16-byte vectors of T: kVec<T> elements, loaded through the read-only
// path and widened to fp32 (bf16 → fp32 is exact: the top 16 bits).
template <typename T> constexpr int kVec = 16 / static_cast<int>(sizeof(T));

template <typename T> __device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void widen16(const uint4& v, float* f);
template <>
__device__ __forceinline__ void widen16<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& v,
                                                       float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);             // element 2i (low)
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // element 2i + 1
  }
}

// 4 consecutive elements of T as raw bits: 16 bytes of fp32, 8 of bf16.
template <typename T> struct Raw4 { using type = uint4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };

template <typename T>
__device__ __forceinline__ typename Raw4<T>::type load4(const T* p) {
  return __ldg(reinterpret_cast<const typename Raw4<T>::type*>(p));
}
__device__ __forceinline__ void widen4(const uint4& v, float* f) {  // fp32
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen4(const uint2& v, float* f) {  // bf16
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// log(1 + exp(v)) in the overflow-free form jax.nn.softplus uses
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// d/dv [v · sigmoid(v)]
__device__ __forceinline__ float dsilu(float v) {
  const float s = 1.f / (1.f + expf(-v));
  return s * (1.f + v * (1.f - s));
}

// out[b][i] = Σ_s part[b][s][i], s < S, i < n: the second pass of every
// cross-block sum of the backward kernels. Each block of the first pass
// writes its partial to its own slot, and this adds the slots in a fixed
// order, so the sums are the same from run to run (no atomics).
static __global__ void sum_partials_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, long n,
                                           int S) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = part + static_cast<size_t>(blockIdx.y) * S * n + i;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += p[static_cast<size_t>(s) * n];
  out[static_cast<size_t>(blockIdx.y) * n + i] = acc;
}

inline cudaError_t sum_partials(const float* part, float* out, long n, int S,
                                int batch, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>((n + 255) / 256), batch);
  sum_partials_kernel<<<grid, 256, 0, stream>>>(part, out, n, S);
  return cudaGetLastError();
}

// Bytes of shared memory a block may use on sm_90.
constexpr size_t kMaxSmem = 232448;

// Allow `Kernel` all of it as dynamic shared memory (needed above 48 KB).
// Done once per kernel, so that launches stay legal inside CUDA graph
// capture; every thread that asks gets the first call's result.
template <auto Kernel>
cudaError_t allow_max_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  return err;
}

}  // namespace fv
