// Device code shared by the forward (layer_fused_fwd.cu) and backward
// (layer_fused_bwd.cu) passes of the fused FastVim mixer layer: the line
// a pass A block owns, the x-half GEMM of a line plus its halo into a
// shared fp32 tile, and the 32-token-tile GEMMs of pass B (FMA tiles for
// fp32, WMMA 16×16×16 for bf16). See layer_fused_fwd.cu for the design
// notes and the measurements behind them.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kPad = 3;     // d_conv - 1
constexpr int kThreads = 256;  // 8 warps, both passes
constexpr int kWm = 16;     // WMMA tile edge
using fv::kMaxSmem;

// ---------------------------------------------------------------------
// pass A: one line (+ 3 halo tokens each side) × 64 channels per block
// ---------------------------------------------------------------------
constexpr int kACh = 64;             // channels per block
constexpr int kAKc = 32;             // K chunk of the FMA GEMM
constexpr int kARows = 9;            // FMA: tokens per thread per pass
constexpr int kAPass = 16 * kARows;  // FMA: tokens per GEMM pass
constexpr int kAWRows = 160;         // WMMA: tokens per GEMM pass

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// shared memory of pass A for a line of `ln` tokens, in bytes
__host__ __device__ inline size_t pass_a_smem(int ln, int dm, bool tc) {
  const int ntok = ln + 2 * kPad;
  const size_t red = 2 * 4 * kACh * sizeof(float);  // pooled partials
  if (tc)
    return static_cast<size_t>(round16(ntok)) * kACh * sizeof(float) +
           static_cast<size_t>(imin(kAWRows, round16(ntok))) * (dm + 8) *
               sizeof(bf16) +
           red;
  return (static_cast<size_t>(ntok) * kACh +
          static_cast<size_t>(kAKc) * (kAPass + 1) +
          static_cast<size_t>(kAKc) * (kACh + 1)) * sizeof(float) +
         red;
}

struct Line {  // the line a pass A block owns
  int H, W, P, ln, p;
  bool transposed;
  size_t img;  // first token of the image
  // extended index j in [0, ln + 6): 3 halo tokens of line p-1, the line,
  // 3 halo tokens of line p+1. Returns the token's index in the image,
  // or -1 outside the sequence.
  __device__ long token(int j) const {
    int line = p, pos = j - kPad;
    if (j < kPad) {
      line = p - 1;
      pos = ln - kPad + j;
    } else if (j >= ln + kPad) {
      line = p + 1;
      pos = j - ln - kPad;
    }
    if (line < 0 || line >= P) return -1;
    return transposed ? static_cast<long>(pos) * W + line
                      : static_cast<long>(line) * W + pos;
  }
};

// xin = x̂·W_xᵀ + b_x for the extended line (L.ln + 6 tokens, halo rows
// outside the sequence set to 0 and never loaded) and channels c0..c0+63,
// into s_xin [ntok][kACh] fp32. FMA path (fp32 inputs); s_x
// [kAKc][kAPass+1] and s_w [kAKc][kACh+1] are staging. Ends with a
// barrier: s_xin is complete.
template <typename T>
__device__ __forceinline__ void xin_tile_fma(
    const T* __restrict__ x, const T* __restrict__ w_x,
    const float* __restrict__ b_x, const Line& L, int c0, int dm,
    float* s_xin, float* s_x, float* s_w) {
  constexpr int kVe = fv::kVec<T>;   // elements per 16-byte vector
  constexpr int kVpr = kAKc / kVe;   // vectors per row of a K chunk
  constexpr int kXIters = (kAPass * kVpr + kThreads - 1) / kThreads;
  constexpr int kWIters = kACh * kVpr / kThreads;
  const int tid = threadIdx.x;
  const int ntok = L.ln + 2 * kPad;
  const int tx = tid % 16;  // channels tx + 16q, q < 4
  const int ty = tid / 16;  // tokens ty + 16r, r < kARows
  for (int jp = 0; jp < ntok; jp += kAPass) {
    const int npt = min(kAPass, ntok - jp);
    const int rmax = (npt + 15) / 16;
    float acc[kARows][4];
#pragma unroll
    for (int r = 0; r < kARows; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    for (int k0 = 0; k0 < dm; k0 += kAKc) {
      // issue every 16-byte load of the chunk before storing any, so
      // their latencies overlap
      uint4 xv[kXIters], wv16[kWIters];
#pragma unroll
      for (int it = 0; it < kXIters; ++it) {
        const int i = tid + it * kThreads;
        const long t = i < npt * kVpr ? L.token(jp + i / kVpr) : -1;
        if (t >= 0)  // masked before the load
          xv[it] = fv::load16(x + (L.img + t) * dm + k0 + (i % kVpr) * kVe);
      }
#pragma unroll
      for (int it = 0; it < kWIters; ++it) {
        const int i = tid + it * kThreads;
        wv16[it] = fv::load16(w_x + static_cast<size_t>(c0 + i / kVpr) * dm +
                              k0 + (i % kVpr) * kVe);
      }
      __syncthreads();  // the previous chunk's readers are done
#pragma unroll
      for (int it = 0; it < kXIters; ++it) {
        const int i = tid + it * kThreads;
        if (i < npt * kVpr) {
          const int jj = i / kVpr, kv = i % kVpr;
          float f[kVe];
          if (L.token(jp + jj) >= 0) {
            fv::widen16<T>(xv[it], f);
          } else {
#pragma unroll
            for (int e = 0; e < kVe; ++e) f[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < kVe; ++e)
            s_x[(kv * kVe + e) * (kAPass + 1) + jj] = f[e];
        }
      }
#pragma unroll
      for (int it = 0; it < kWIters; ++it) {
        const int i = tid + it * kThreads;
        const int c = i / kVpr, kv = i % kVpr;
        float f[kVe];
        fv::widen16<T>(wv16[it], f);
#pragma unroll
        for (int e = 0; e < kVe; ++e)
          s_w[(kv * kVe + e) * (kACh + 1) + c] = f[e];
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kAKc; ++k) {
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = s_w[k * (kACh + 1) + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < kARows; ++r) {
          if (r < rmax) {
            const float xv = s_x[k * (kAPass + 1) + ty + 16 * r];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += xv * wv[q];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kARows; ++r) {
      const int jj = ty + 16 * r;
      if (r < rmax && jj < npt) {
        const bool valid = L.token(jp + jj) >= 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = tx + 16 * q;
          const float bias = b_x ? b_x[c0 + c] : 0.f;
          s_xin[(jp + jj) * kACh + c] = valid ? acc[r][q] + bias : 0.f;
        }
      }
    }
  }
  __syncthreads();
}

// The same for bf16 inputs on tensor cores (WMMA); s_xin is
// [round16(ntok)][kACh] and s_xb [min(kAWRows, round16(ntok))][dm + 8]
// bf16 is staging. Ends with a barrier.
__device__ __forceinline__ void xin_tile_wmma(
    const bf16* __restrict__ x, const bf16* __restrict__ w_x,
    const float* __restrict__ b_x, const Line& L, int c0, int dm,
    float* s_xin, bf16* s_xb) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int ntok = L.ln + 2 * kPad;
  const int ntok16 = round16(ntok);
  const int ldx = dm + 8;  // padded row: 16 bytes of skew per row
  // warp → column tile w % 4 and row tiles w / 4 + 2i; its W_x tile is
  // read straight from global memory (L2-resident). Staging the 64-row
  // slice in shared memory instead measured slower (0.222 vs 0.151 ms at
  // 2048 px): the extra 25 KB left one block per SM.
  const int nt = warp % 4;
  const bf16* wtile = w_x + static_cast<size_t>(c0 + nt * kWm) * dm;
  const int vpr = dm / 8;  // 16-byte vectors per row of x̂
  for (int jp = 0; jp < ntok16; jp += kAWRows) {
    const int rows = min(kAWRows, ntok16 - jp);
    __syncthreads();  // the previous pass's readers are done
    for (int i = tid; i < rows * vpr; i += kThreads) {
      const int r = i / vpr, v = i % vpr;
      const long t = jp + r < ntok ? L.token(jp + r) : -1;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 0)  // masked before the load
        val = fv::load16(x + (L.img + t) * dm + v * 8);
      *reinterpret_cast<uint4*>(s_xb + static_cast<size_t>(r) * ldx +
                                v * 8) = val;
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, kWm, kWm, kWm, float> acc[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k = 0; k < dm; k += kWm) {
      wmma::fragment<wmma::matrix_b, kWm, kWm, kWm, bf16, wmma::col_major> wb;
      wmma::load_matrix_sync(wb, wtile + k, dm);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int mt = warp / 4 + 2 * i;
        if (mt * kWm < rows) {
          wmma::fragment<wmma::matrix_a, kWm, kWm, kWm, bf16, wmma::row_major>
              xa;
          wmma::load_matrix_sync(xa, s_xb + static_cast<size_t>(mt) * kWm *
                                                ldx + k, ldx);
          wmma::mma_sync(acc[i], xa, wb, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int mt = warp / 4 + 2 * i;
      if (mt * kWm < rows)
        wmma::store_matrix_sync(
            s_xin + static_cast<size_t>(jp + mt * kWm) * kACh + nt * kWm,
            acc[i], kACh, wmma::mem_row_major);
    }
  }
  __syncthreads();
  if (b_x) {  // rows outside the sequence stay 0 (their x̂ rows were 0)
    for (int i = tid; i < ntok * kACh; i += kThreads)
      if (L.token(i / kACh) >= 0) s_xin[i] += b_x[c0 + i % kACh];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// pass B: 32-token tiles with all d_inner channels
// ---------------------------------------------------------------------
constexpr int kBTok = 32;            // tokens per block (4 per warp)
constexpr int kBKc = 16;             // K chunk of the FMA GEMMs
constexpr int kBCols = 12;           // FMA: output channels per thread
constexpr int kBSlab = 32 * kBCols;  // output columns per slab: 384
constexpr int kBMaxDi = 768;         // per-lane merge registers: / 32

// FMA: acc[r][j] = Σ_k sA[(4·warp + r)·K + k] · Wt[(n0 + lane + 32j)·K +
// k] for j < ncols: a (32 × K) fp32 tile in shared memory times the
// transpose of rows n0.. of a row-major (N × K) weight in T.
template <typename T>
__device__ __forceinline__ void gemm_rows(const float* sA,
                                          const T* __restrict__ Wt, int K,
                                          int n0, int ncols, float* s_w,
                                          float acc[4][kBCols]) {
  constexpr int kVe = fv::kVec<T>;  // elements per 16-byte vector
  constexpr int kVpr = kBKc / kVe;  // vectors per row of a K chunk
  constexpr int kIters = kBSlab * kVpr / kThreads;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nn = 32 * ncols;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kBCols; ++j) acc[r][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBKc) {
    // issue every 16-byte load of the chunk before storing any, so their
    // latencies overlap (and overlap the other block's compute)
    uint4 v[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (i / kVpr < nn)
        v[it] = fv::load16(Wt + static_cast<size_t>(n0 + i / kVpr) * K + k0 +
                           (i % kVpr) * kVe);
    }
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int n = i / kVpr, kv = i % kVpr;
      if (n < nn) {
        float f[kVe];
        fv::widen16<T>(v[it], f);
#pragma unroll
        for (int e = 0; e < kVe; ++e)
          s_w[(kv * kVe + e) * (kBSlab + 1) + n] = f[e];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBKc; ++k) {
      float wv[kBCols];
#pragma unroll
      for (int j = 0; j < kBCols; ++j)
        wv[j] = j < ncols ? s_w[k * (kBSlab + 1) + lane + 32 * j] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = sA[(4 * warp + r) * K + k0 + k];
#pragma unroll
        for (int j = 0; j < kBCols; ++j) acc[r][j] += a * wv[j];
      }
    }
  }
}

// WMMA: s_out[0:32, :N] = sA (32 × K bf16, row stride lda) · Wtᵀ, Wt a
// row-major (N × K) bf16 weight read from global memory (L2-resident);
// in slabs of 384 columns, warp w taking column tiles w, w + 8, w + 16
// for both row tiles (each weight tile is loaded once per block).
// Staging the weights through shared memory in K chunks of 32 instead
// measured slower (0.352 vs 0.287 ms at 2048 px).
__device__ __forceinline__ void wmma_rows(const bf16* sA, int lda,
                                          const bf16* __restrict__ Wt, int K,
                                          int N, float* s_out, int ldo) {
  const int warp = threadIdx.x / 32;
  for (int n0 = 0; n0 < N; n0 += kBSlab) {
    const int ntiles = min(kBSlab, N - n0) / kWm;
    wmma::fragment<wmma::accumulator, kWm, kWm, kWm, float> acc[2][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      wmma::fill_fragment(acc[0][j], 0.f);
      wmma::fill_fragment(acc[1][j], 0.f);
    }
    for (int k = 0; k < K; k += kWm) {
      wmma::fragment<wmma::matrix_a, kWm, kWm, kWm, bf16, wmma::row_major> a0,
          a1;
      wmma::load_matrix_sync(a0, sA + k, lda);
      wmma::load_matrix_sync(a1, sA + kWm * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int nt = warp + 8 * j;
        if (nt < ntiles) {
          wmma::fragment<wmma::matrix_b, kWm, kWm, kWm, bf16, wmma::col_major>
              wb;
          wmma::load_matrix_sync(
              wb, Wt + static_cast<size_t>(n0 + nt * kWm) * K + k, K);
          wmma::mma_sync(acc[0][j], a0, wb, acc[0][j]);
          wmma::mma_sync(acc[1][j], a1, wb, acc[1][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int nt = warp + 8 * j;
      if (nt < ntiles) {
        float* o = s_out + n0 + nt * kWm;
        wmma::store_matrix_sync(o, acc[0][j], ldo, wmma::mem_row_major);
        wmma::store_matrix_sync(o + kWm * ldo, acc[1][j], ldo,
                                wmma::mem_row_major);
      }
    }
  }
}

}  // namespace
