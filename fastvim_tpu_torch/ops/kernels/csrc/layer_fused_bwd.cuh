// What the two translation units of the fused layer's backward share:
// layer_fused_bwd.cu (the C entry points and the fp32 kernels on FMA
// tiles) and layer_fused_bwd_wgmma.cu (the bf16 kernels on `wgmma`).
#pragma once

#include "common.cuh"

namespace fvb {

constexpr int kNVec = 6;   // K5 vector sums: db_z, dln_w, dln_b, dd_f, dd_b, dy
constexpr int kCVec = 11;  // K6: dw_cf[4], dw_ab[4], db_cf, db_ab, db_x

// The widths K5 and K6 take, in both dtypes: FastVim-H's (the widest
// registry model), d_model <= d_inner, both multiples of 64.
// ops/kernels/layer_fused.py's BWD_MAX_DM and BWD_MAX_DI state the same
// limits.
constexpr int kBwdMaxDm = 1280;
constexpr int kBwdMaxDi = 2560;

// Up to these widths (FastVim-T/S) the kernels keep a tile's dx̂ on chip
// and add dz·W_z (K5) or dxin·W_x (K6) to it slab by slab. Past them
// (FastVim-B/L/H) the wide forms store dz and dxin, which the weight
// gradients read anyway, and one more launch forms dx̂ from them.
constexpr int kNarrowDm = 384;
constexpr int kNarrowDi = 768;
inline bool wide_form(int dm, int di) {
  return dm > kNarrowDm || di > kNarrowDi;
}

// One call's cross-block sums, all added by one launch in a fixed order
// (no atomics): out[i] = Σ_s part[s·n + i], s < S (as 8 interleaved
// partial sums). With cols > 0 the
// partial is a row-major (n / cols, cols) matrix and `out` receives its
// transpose.
struct SumSeg {
  const float* part;
  float* out;
  long n;
  int S, cols;
};
constexpr int kMaxSegs = 3;
struct SumSegs {
  SumSeg seg[kMaxSegs];
  int count;
};

// A block adds 32 neighbouring entries of one segment: 8 warps take
// every 8th partial each, then warp 0 adds the 8 sums in order.
static __global__ void sum_segments_kernel(SumSegs segs) {
  __shared__ float red[8][32];
  const int o = threadIdx.x % 32, sl = threadIdx.x / 32;
  long blk = blockIdx.x;
  int k = 0;
  while (k < segs.count - 1 && blk >= (segs.seg[k].n + 31) / 32)
    blk -= (segs.seg[k++].n + 31) / 32;
  const SumSeg& sg = segs.seg[k];
  const long i = blk * 32 + o;
  float acc = 0.f;
  if (i < sg.n)
    for (int s = sl; s < sg.S; s += 8)
      acc += sg.part[static_cast<size_t>(s) * sg.n + i];
  red[sl][o] = acc;
  __syncthreads();
  if (sl == 0 && i < sg.n) {
#pragma unroll
    for (int w = 1; w < 8; ++w) acc += red[w][o];
    long dst = i;
    if (sg.cols > 0) dst = (i % sg.cols) * (sg.n / sg.cols) + i / sg.cols;
    sg.out[dst] = acc;
  }
}

inline cudaError_t sum_segments(const SumSegs& segs, cudaStream_t stream) {
  long blocks = 0;
  for (int k = 0; k < segs.count; ++k) blocks += (segs.seg[k].n + 31) / 32;
  sum_segments_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(segs);
  return cudaGetLastError();
}

// Windows of the conv order a K6 block of the bf16 path owns: 64 rows of
// which the first and last 3 are halo.
constexpr int kAWin = 58;

// the bf16 paths (layer_fused_bwd_wgmma.cu); arguments as in the C entry
// points of layer_fused_bwd.cu. Three launches a call, four in the wide
// forms.
cudaError_t pass_b_bwd_bf16(
    const void* g, const void* x, const void* xc_f, const void* xc_b,
    const void* yf, const void* yb, const void* w_z, const void* b_z,
    const void* d_f, const void* d_b, const void* ln_w, const void* ln_b,
    const void* w_out, void* dx, void* dxc_f, void* dxc_b, void* dy, void* mg,
    void* dz, void* vec_part, void* vec, void* w_part, void* dw_out,
    void* dw_z, int batch, int H, int W, int dm, int di, bool transposed,
    bool use_ln, int nsplit, float eps, cudaStream_t stream);

cudaError_t pass_a_bwd_bf16(
    const void* x, const void* dx_b, const void* dxc_f, const void* dxc_b,
    const void* dpf, const void* dpb, const void* w_x, const void* b_x,
    const void* w_cf, const void* b_cf, const void* w_ab, const void* b_ab,
    void* dx, void* dxin, void* c_part, void* c_vec, void* w_part, void* dw_x,
    int batch, int H, int W, int dm, int di, bool transposed, int nsplit,
    float scaling, cudaStream_t stream);

}  // namespace fvb
