// fp32 products on the tensor cores in split precision (3xTF32), shared by
// the fp32 forward passes (layer_fused_fwd_tf32.cu) and the fp32 adjoints
// (layer_fused_bwd_tf32.cu) of the fused FastVim mixer layer.
//
// Each fp32 operand v is split into hi = tf32(v) and lo = tf32(v - hi),
// both rounded to nearest (cvt.rna), and a product accumulates lo·hi +
// hi·lo + hi·hi in fp32 on the tensor cores. lo·lo (about 2^-22 of the
// product) is dropped, and each k-step's sum is added to the running one
// in fp32 (mma3). One TF32 product alone (hi·hi) keeps 11 bits and misses
// the fp32 contract's 1e-4 at these depths
// (tests/test_torch_port_tf32_split.py and test_torch_port_bwd_tf32.py
// hold both on the CPU). The split is done in registers as each fragment
// is read from shared memory, so the operands stay fp32 everywhere else.
//
// mma.sync m16n8k8 and not wgmma: TF32 wgmma reads both operands from
// shared memory in its swizzled layout, so a hi and a lo copy of every
// tile would have to be written there before each product. mma.sync
// takes its fragments from registers: one fp32 tile in shared memory,
// read once a fragment, split on the way.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));  // v - hi is exact in fp32
}

// d (16 × 8) += a (16 × 8) · b (8 × 8), TF32 operands, fp32 sums. Lane
// l = 4g + t holds a[0..3] = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b[0..1] = B[t][g], B[t+4][g]; d[0..3] = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i][j] += a_i · b_j for kI × kJ tiles in split precision (d[i][j] at
// d + (i·ldi + j)·4); on[i] false skips row tile i. The three products of
// a k-step go term by term over all the tiles (lo·hi, hi·lo, then hi·hi),
// so that consecutive products are independent (a warp issues in order,
// and each product waits for the one before on its accumulator), into a
// fresh tile t that is then added to d in fp32. The tensor cores round
// each product's sum toward zero, an error of up to an ulp of the
// accumulator, and in the same direction every time: accumulated in d,
// three such roundings a k-step of the whole running sum; in t, of the
// k-step's own 8-term sum, and d takes one round-to-nearest add.
template <int kI, int kJ>
__device__ __forceinline__ void mma3(float* d, int ldi, const bool* on,
                                     uint32_t (*ah)[4], uint32_t (*al)[4],
                                     uint32_t (*bh)[2], uint32_t (*bl)[2]) {
  float t[kI][kJ][4];
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[i][j][e] = 0.f;
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int i = 0; i < kI; ++i)
        if (on[i])
          mma_tf32(t[i][j], term == 0 ? al[i] : ah[i],
                   term == 1 ? bl[j] : bh[j]);
#pragma unroll
  for (int i = 0; i < kI; ++i)
    if (on[i])
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[(i * ldi + j) * 4 + e] += t[i][j][e];
}

// The A fragment of the 16 × 8 block at s (row-major, ld floats a row),
// split. With ld ≡ 4 (mod 32) the 32 lanes read 32 banks.
__device__ __forceinline__ void frag_a(const float* s, int ld, int lane,
                                       uint32_t* hi, uint32_t* lo) {
  const float* p = s + (lane >> 2) * ld + (lane & 3);
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

// The same block stored K-major (a row is one K index, ld floats, its M
// values consecutive: how a (tokens, d) activation lies when the product
// contracts over its tokens), split. With ld ≡ 8 (mod 32) the 32 lanes
// read 32 banks.
__device__ __forceinline__ void frag_a_k(const float* s, int ld, int lane,
                                         uint32_t* hi, uint32_t* lo) {
  const float* p = s + (lane & 3) * ld + (lane >> 2);
  split(p[0], hi[0], lo[0]);
  split(p[8], hi[1], lo[1]);
  split(p[4 * ld], hi[2], lo[2]);
  split(p[4 * ld + 8], hi[3], lo[3]);
}

// The B fragment of the 8 (K) × 8 (N) block at s, stored N-major (a row
// is one N index, ld floats, its K values consecutive: how W_x and W_z
// lie in device memory when the product contracts over d_model), split.
__device__ __forceinline__ void frag_b(const float* s, int ld, int lane,
                                       uint32_t* hi, uint32_t* lo) {
  const float* p = s + (lane >> 2) * ld + (lane & 3);
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// The same block stored K-major (a row is one K index, ld floats, its N
// values consecutive: W_out for g·W_out, W_x and W_z for the products
// that contract over d_inner, x̂ and g over tokens), split. With ld ≡ 8
// (mod 32) the 32 lanes read 32 banks.
__device__ __forceinline__ void frag_b_k(const float* s, int ld, int lane,
                                         uint32_t* hi, uint32_t* lo) {
  const float* p = s + (lane & 3) * ld + (lane >> 2);
  split(p[0], hi[0], lo[0]);
  split(p[4 * ld], hi[1], lo[1]);
}

}  // namespace
