// K5 and K6 in bf16, for Hopper (sm_90a): the adjoints of pass B and pass
// A of the fused FastVim mixer layer on warpgroup matrix products. What
// they compute is set out at the head of layer_fused_bwd.cu; this file is
// how the bf16 path computes it.
//
// What bounds them: about 150 FLOP per byte of device memory, below the
// ~295 at which the tensor cores limit, so the bytes do. The design moves
// each token's data once and keeps the rest on chip:
// - A block of two warpgroups owns a 64-token tile (K5: of one line, so
//   the line sum dy stays in the block; K6: a 58-token window of the
//   conv's 1-D order plus 3 halo tokens each side, whatever line its
//   tokens lie in; one block per SM walks the windows, and the next
//   window's x̂ is copied under the current one's last slab). x̂ (and g)
//   are brought once by cp.async into 128-byte-swizzled shared memory and
//   are the A operands of every product.
// - d_inner is walked in slabs of 128 channels, 64 per warpgroup. Per
//   slab the products z = x̂·W_zᵀ and dgated = g·W_out (K6: xin = x̂·W_xᵀ)
//   accumulate in registers, the gate / LayerNorm / conv adjoint runs on
//   the slab, its bf16 result (dz, dxin) goes to a swizzled tile, and
//   dx̂ += dz·W_z (K6: dxin·W_x) accumulates in registers across slabs
//   (the warpgroups split d_model). Nothing of d_inner's whole width lives
//   in registers, so d_inner <= 768 with d_model <= 384 fits (FastVim-S).
// - Past those widths (fvb::wide_form: FastVim-B/L/H, up to fvb::kBwdMaxDm
//   and kBwdMaxDi) the wide forms, template argument 0. The tile's x̂ and
//   g (2 × 160 KB at d_model 1280) and a d_model-wide dx̂ accumulator (320
//   floats a thread) no longer fit, so: x̂'s and g's K blocks come through
//   the ring beside the weight blocks of the same K step, once a slab
//   (from L2: the tile's rows are 64 × d_model), as K3's streamed form
//   takes x̂; and the dx̂ products leave the kernel. K5 stores dz and K6
//   dxin for the weight gradients anyway, so `dx_wgmma_kernel` forms dx̂ =
//   dz·W_z (K6: dx̂(K5) + dxin·W_x) from them in one more launch, a
//   128-token × 192-column tile a block with the weight read MN-major as
//   it lies: no d_model-wide state on chip and nothing computed twice,
//   for 2·d_inner bytes a token more through device memory. The
//   LayerNorm's second pass walks channel groups in turn where d_inner/8
//   exceeds the block's threads.
// - Weights stream through a ring of four 16 KB stages filled by cp.async
//   three stages ahead of the products that read them. The transposed
//   operands (W_out, and W_z / W_x in the dx̂ product) are read MN-major
//   through the wgmma descriptor: no transposed copy exists anywhere.
// - K5's LayerNorm needs two row sums (Σdm̂, Σdm̂·m̂) over all slabs before
//   dm0 can be formed, so dm̂ is parked in bf16 in the dxc_f output (the
//   block reads its own rows back from L2) and a second pass over the
//   tile, in 16-byte vectors, forms dm0, dxc_f, dxc_b, dD_f, dD_b and dy.
// - The weight gradients contract over all tokens: `wgrad_wgmma_kernel`
//   computes Xᵀ·Y for X in {mg, dz, dxin} (tokens × d_inner) and Y in {g,
//   x̂} (tokens × d_model) with both operands MN-major straight from their
//   row-major arrays, 128 × 192 output tiles per block, split over token
//   slices; one launch does both of K5's. One `sum_segments` launch adds
//   every partial of a call in a fixed order. No atomics anywhere.
// A K5 or K6 call is three launches, four in the wide forms.

#include "layer_fused_bwd.cuh"
#include "wgmma.cuh"

// Built with -DFV_PROFILE, thread 0 of each block adds the cycles it spent
// between the PROF marks of the two main kernels to its own row of
// fv_prof, and fv_bwd_phase_cycles sums the rows (utils/profiling.py
// --bwd-phases). Without the flag the marks are empty and the sums 0.
constexpr int kProfBlocks = 1024, kProfMarks = 32;
#ifdef FV_PROFILE
__device__ unsigned long long fv_prof[kProfBlocks][kProfMarks];
#define PROF_INIT long long prof_t = clock64();
#define PROF(k)                                                         \
  if (threadIdx.x == 0) {                                               \
    const long long prof_n = clock64();                                 \
    fv_prof[(blockIdx.y * gridDim.x + blockIdx.x) % kProfBlocks][k] +=  \
        static_cast<unsigned long long>(prof_n - prof_t);               \
    prof_t = prof_n;                                                    \
  }
#else
#define PROF_INIT
#define PROF(k)
#endif

// out: 32 × uint64, the cycles per mark summed over the blocks since the
// last call, which it sets back to 0. Synchronizes the device.
extern "C" int fv_bwd_phase_cycles(void* out) {
  auto* sums = static_cast<unsigned long long*>(out);
  for (int k = 0; k < kProfMarks; ++k) sums[k] = 0;
#ifdef FV_PROFILE
  static unsigned long long host[kProfBlocks][kProfMarks];
  cudaError_t err = cudaMemcpyFromSymbol(host, fv_prof, sizeof(host));
  if (err != cudaSuccess) return err;
  for (int b = 0; b < kProfBlocks; ++b)
    for (int k = 0; k < kProfMarks; ++k) sums[k] += host[b][k];
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, fv_prof);
  if (err != cudaSuccess) return err;
  return cudaMemset(dev, 0, sizeof(host));
#else
  return cudaSuccess;
#endif
}

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using fv::cp_async16;
using fv::gmma_desc;
using fv::kMaxSmem;
using fv::ld_f2;
using fv::lds_f8;
using fv::pack8;
using fv::sigmoid_fast;
using fv::smem_u32;
using fv::swz;
using fvb::kAWin;
using fvb::kCVec;

constexpr int kThreads = 256;      // two warpgroups
constexpr int kTM = 64;            // tokens per tile (wgmma's M)
constexpr int kSlab = 128;         // d_inner channels per slab
constexpr int kStages = 4;
constexpr int kBlkBytes = 8192;    // a 64 × 64 bf16 tile block
constexpr int kStageBytes = 2 * kBlkBytes;
// the wide forms' stages also carry the x̂ (or g) block of their K step
constexpr int kWideStageBytes = kStageBytes + kBlkBytes;
// db_out columns a thread sums: d_model / 256, rounded up
constexpr int kDbo = (fvb::kBwdMaxDm + kThreads - 1) / kThreads;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float dsilu_fast(float v) {
  const float s = sigmoid_fast(v);
  return s * (1.f + v * (1.f - s));
}
template <typename Fetch>
using Ring = fv::Ring<kStages, kStageBytes, Fetch>;
using fv::slab_gemm;

// slab_gemm for the wide forms: the A operand of each K step is the block
// kStageBytes into its stage, which the fetch filled beside the weight's
template <int kTb, typename R>
__device__ __forceinline__ void slab_gemm_streamed(float* acc, int nblk,
                                                   R& ring, uint32_t boff,
                                                   bool active) {
  for (int b = 0; b < nblk; ++b) {
    const uint32_t st = ring.acquire();
    if (active) {
      fv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        fv::wgmma_n64<0, kTb>(acc, gmma_desc(st + kStageBytes + 32 * kk),
                              gmma_desc(st + boff + (kTb ? 2048 : 32) * kk),
                              (b | kk) != 0);
      fv::wgmma_commit();
    }
    ring.refill();
    if (active) fv::wgmma_wait();
  }
}

// Copy the 64 × 64 block of rows `row(r)` (r < 64; < 0: zero-filled, not
// read) × columns [c0, c0 + 64) of a row-major bf16 array with `ld`
// elements a row into a swizzled tile block, by all threads
template <typename Row>
__device__ __forceinline__ void cp_rows(uint32_t sblk, const bf16* src,
                                        size_t ld, int c0, Row row) {
  for (int i = threadIdx.x; i < kTM * 8; i += kThreads) {
    const int r = i >> 3, ch = i & 7;
    const long t = row(r);
    cp_async16(sblk + swz(r, 8 * ch),
               src + (t >= 0 ? static_cast<size_t>(t) * ld + c0 + 8 * ch : 0),
               t >= 0);
  }
}

// dxa (64 × d_model/2 of this warpgroup, kNU units of 32 columns) +=
// A (64 × sw, K-major blocks at `sa`) · W[slab rows, :] over the next kNU
// stages, each a (sw × 64) block of W read MN-major. Warpgroup 0 owns
// columns [0, 32 kNU), warpgroup 1 the rest. The caller zeroes dxa before
// a tile's first slab (which also tells the compiler that it is dead
// between tiles).
template <int kNU, typename R>
__device__ __forceinline__ void dx_gemm(float* dxa, uint32_t sa, int sw,
                                        R& ring, int wg) {
#pragma unroll
  for (int b = 0; b < kNU; ++b) {
    const uint32_t st = ring.acquire();
    // this block's columns [64 b, 64 b + 64) against the warpgroup's
    constexpr int kHalf = 32 * kNU;
    const bool full0 = 64 * b + 64 <= kHalf, half0 = 64 * b < kHalf;
    const bool full1 = 64 * b >= kHalf, half1 = 64 * b + 32 >= kHalf;
    fv::wgmma_fence();
    for (int kk = 0; kk < sw / 16; ++kk) {
      const uint64_t da =
          gmma_desc(sa + (kk / 4) * kBlkBytes + 32 * (kk % 4));
      constexpr int acc = 1;
      if (wg == 0) {
        if (full0)
          fv::wgmma_n64<0, 1>(dxa + 32 * b, da, gmma_desc(st + 2048 * kk),
                              acc);
        else if (half0)
          fv::wgmma_n32<0, 1>(dxa + 32 * b, da, gmma_desc(st + 2048 * kk),
                              acc);
      } else {
        if (full1)
          fv::wgmma_n64<0, 1>(dxa + (64 * b - kHalf) / 2, da,
                              gmma_desc(st + 2048 * kk), acc);
        else if (half1)
          fv::wgmma_n32<0, 1>(dxa, da, gmma_desc(st + 2048 * kk + 64), acc);
      }
    }
    fv::wgmma_commit();
    ring.refill();
    fv::wgmma_wait();
  }
}

// copy the valid rows of a (64 × sw) swizzled bf16 slab to rows of a
// (tokens × di) array at column n0; tok(r) < 0 skips the row
template <typename Tok>
__device__ __forceinline__ void slab_to_global(const unsigned char* s, int sw,
                                               bf16* dst, int di, int n0,
                                               Tok tok) {
  const int cpr = sw / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTM * cpr; i += kThreads) {
    const int r = i / cpr, ch = i % cpr;
    const long t = tok(r);
    if (t >= 0)
      *reinterpret_cast<uint4*>(dst + t * di + n0 + ch * 8) =
          *reinterpret_cast<const uint4*>(s + (ch / 8) * kBlkBytes +
                                          swz(r, (ch % 8) * 8));
  }
}

// =====================================================================
// K5: pass B backward
// =====================================================================
struct BBwdSmem {  // byte offsets from the 1024-aligned base
  size_t x, g, dz, ring, colred, vec, acc2, stats, col, total;
};
// row lanes of K5's second pass: threads a group of 8 channels, at least 1
__host__ __device__ inline int b_bwd_row_lanes(int di) {
  const int r = kThreads / (di / 8);
  return r > 1 ? r : 1;
}
// wide: the wide form, whose x̂ and g come through the ring
__host__ __device__ inline BBwdSmem b_bwd_smem(int dm, int di, bool wide) {
  BBwdSmem L;
  const size_t xg = wide ? 0 : static_cast<size_t>(dm / 64) * kBlkBytes;
  L.x = 0;
  L.g = xg;
  L.dz = 2 * xg;
  L.ring = L.dz + 2 * kBlkBytes;
  L.colred = L.ring + kStages * (wide ? kWideStageBytes : kStageBytes);
  L.vec = L.colred + 8 * 3 * 64 * sizeof(float);
  L.acc2 = L.vec + 3 * static_cast<size_t>(di) * sizeof(float);
  const int nrl = b_bwd_row_lanes(di);  // row lanes of the second pass
  L.stats = L.acc2 + static_cast<size_t>(nrl) * 3 * di * sizeof(float);
  // mu, rstd [64]; s1, s2 of both warpgroups [2][64][2]
  L.col = L.stats + (2 * kTM + 4 * kTM) * sizeof(float);
  // per channel: ½(yf + yb), ½D_f, ½D_b of the block's line
  L.total = L.col + 3 * static_cast<size_t>(di) * sizeof(float) + 1024;
  return L;
}

// kNU: d_model / 64 (the narrow form), or 0: the wide form, which takes
// d_model from dm_arg
template <int kNU>
__global__ void __launch_bounds__(kThreads, 1)
pass_b_bwd_wgmma_kernel(
    const bf16* __restrict__ g, const bf16* __restrict__ x,
    const bf16* __restrict__ xc_f, const bf16* __restrict__ xc_b,
    const bf16* __restrict__ yf, const bf16* __restrict__ yb,
    const bf16* __restrict__ w_z, const float* __restrict__ b_z,
    const float* __restrict__ d_f, const float* __restrict__ d_b,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const bf16* __restrict__ w_out, float* __restrict__ dx,
    bf16* dxc_f, bf16* __restrict__ dxc_b, bf16* __restrict__ dy,
    bf16* __restrict__ mg, bf16* __restrict__ dzs,
    float* __restrict__ vec_part, int H, int W, int dm_arg, int di,
    bool transposed, bool use_ln, float eps) {
  constexpr bool kWide = kNU == 0;
  const int dm = kWide ? dm_arg : 64 * kNU;
  const int nu = kWide ? dm / 64 : kNU;  // K blocks of d_model
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const BBwdSmem L = b_bwd_smem(dm, di, kWide);
  const uint32_t sx = smem_u32(sm + L.x), sgm = smem_u32(sm + L.g);
  unsigned char* s_dz = sm + L.dz;
  float* s_colred = reinterpret_cast<float*>(sm + L.colred);  // [8][3][64]
  float* s_vec = reinterpret_cast<float*>(sm + L.vec);        // [3][di]
  float* s_acc2 = reinterpret_cast<float*>(sm + L.acc2);      // [nrl][3][di]
  float* s_mu = reinterpret_cast<float*>(sm + L.stats);       // [64]
  float* s_rstd = s_mu + kTM;                                 // [64]
  float* s_s12 = s_rstd + kTM;                                // [2][64][2]
  float* s_col = reinterpret_cast<float*>(sm + L.col);        // [3][di]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  const int b = blockIdx.y, p = blockIdx.x;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const size_t img = static_cast<size_t>(b) * H * W;
  const size_t prow = static_cast<size_t>(b) * P + p;
  auto token = [&](int i) -> size_t {  // i-th token of the line
    return img + (transposed ? static_cast<size_t>(i) * W + p
                             : static_cast<size_t>(p) * W + i);
  };
  const int nslab = (di + kSlab - 1) / kSlab;
  const int nph = kWide ? 2 : 3;  // the wide form has no dx̂ product
  const int per_tile = nslab * nph * nu;
  const int ntile = (ln + kTM - 1) / kTM;
  const int total = ntile * per_tile;
  const float inv_di = 1.f / static_cast<float>(di);
  const int ncg = di / 8, nrl = b_bwd_row_lanes(di);

  // stage s of a tile's sequence: per slab nu blocks of W_z (z), nu of
  // W_out (dgated), the nu blocks of W_z again (dx̂; not in the wide
  // form, whose stages carry the x̂ or g block of their K step instead)
  auto fetch = [&](int s, uint32_t dst) {
    if (s >= total) return;
    const int r = s % per_tile;
    const int n0 = r / (nph * nu) * kSlab, ph = r / nu % nph, kb = r % nu;
    const int sw = imin(kSlab, di - n0);
    if (ph == 1) {
      for (int h = 0; h < sw / 64; ++h)
        fv::cp_block(dst + h * kBlkBytes, w_out, di, 64 * kb, n0 + 64 * h, 64,
                     tid, kThreads);
    } else {
      fv::cp_block(dst, w_z, dm, n0, 64 * kb, sw, tid, kThreads);
    }
    if constexpr (kWide) {
      const int i0s = s / per_tile * kTM, nvs = imin(kTM, ln - i0s);
      cp_rows(dst + kStageBytes, ph == 1 ? g : x, dm, 64 * kb,
              [&](int row) -> long {  // masked before the load
                return row < nvs ? static_cast<long>(token(i0s + row)) : -1;
              });
    }
  };
  fv::Ring<kStages, kWide ? kWideStageBytes : kStageBytes, decltype(fetch)>
      ring(smem_u32(sm + L.ring), fetch);
  ring.start();

  for (int i = tid; i < 3 * di; i += kThreads) s_vec[i] = 0.f;
  for (int i = tid; i < nrl * 3 * di; i += kThreads) s_acc2[i] = 0.f;
  // m0 = ½(yf + D_f·xc_f + yb + D_b·xc_b) = c0 + hf·xc_f + hb·xc_b
  for (int i = tid; i < di; i += kThreads) {
    s_col[i] = 0.5f * (__bfloat162float(yf[prow * di + i]) +
                       __bfloat162float(yb[prow * di + i]));
    s_col[di + i] = 0.5f * d_f[i];
    s_col[2 * di + i] = 0.5f * d_b[i];
  }
  __syncthreads();
  float dbo[kWide ? kDbo : 2] = {};  // db_out of columns tid, tid + 256, ...

  PROF_INIT
  for (int i0 = 0; i0 < ln; i0 += kTM) {
    const int nval = imin(kTM, ln - i0);
    __syncthreads();  // the previous tile's readers are done
    PROF(0)
    if constexpr (!kWide) {
      for (int i = tid; i < kTM * 8 * kNU; i += kThreads) {
        const int r = i / (8 * kNU), c = i % (8 * kNU);
        const bool ok = r < nval;  // masked before the load
        const size_t off = (ok ? token(i0 + r) : img) * dm + c * 8;
        const uint32_t o = (c / 8) * kBlkBytes + swz(r, (c % 8) * 8);
        cp_async16(sx + o, x + off, ok);
        cp_async16(sgm + o, g + off, ok);
      }
      fv::cp_async_commit();
    }
    PROF(11)

    // first pass: LayerNorm statistics of m0, a warp per row; the wide
    // form a row at a time over 96-vector chunks, the narrow one with the
    // loads of 2 rows in flight together
    for (int rg = warp * 8; kWide && rg < warp * 8 + 8; ++rg) {
      const bool ok = use_ln && rg < nval;
      float sum = 0.f, sumsq = 0.f;
      const size_t o = token(i0 + imin(rg, nval - 1)) * di;
      for (int v = lane; ok && v < ncg; v += 32) {
        float a[8], c[8], c0[8], hf[8], hb[8];
        fv::widen16<bf16>(fv::load16(xc_f + o + v * 8), a);
        fv::widen16<bf16>(fv::load16(xc_b + o + v * 8), c);
        lds_f8(s_col + v * 8, c0);
        lds_f8(s_col + di + v * 8, hf);
        lds_f8(s_col + 2 * di + v * 8, hb);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float m = c0[e] + hf[e] * a[e] + hb[e] * c[e];
          sum += m;
          sumsq += m * m;
        }
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o2);
        sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o2);
      }
      if (lane == 0) {
        const float mu = sum * inv_di;
        s_mu[rg] = ok ? mu : 0.f;
        s_rstd[rg] = ok ? rsqrtf(sumsq * inv_di - mu * mu + eps) : 0.f;
      }
    }
    for (int rg = warp * 8; !kWide && rg < warp * 8 + 8; rg += 2) {
      uint4 xa[2][3], xb[2][3];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        // every load is started, at a clamped address where its row or
        // vector is masked, so that none waits for the one before it
        const size_t o = token(i0 + imin(rg + rr, nval - 1)) * di;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int v = imin(lane + 32 * k, ncg - 1);
          xa[rr][k] = fv::load16(xc_f + o + v * 8);
          xb[rr][k] = fv::load16(xc_b + o + v * 8);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const bool ok = use_ln && rg + rr < nval;
        float sum = 0.f, sumsq = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int v = lane + 32 * k;
          if (ok && v < ncg) {
            float a[8], c[8], c0[8], hf[8], hb[8];
            fv::widen16<bf16>(xa[rr][k], a);
            fv::widen16<bf16>(xb[rr][k], c);
            lds_f8(s_col + v * 8, c0);
            lds_f8(s_col + di + v * 8, hf);
            lds_f8(s_col + 2 * di + v * 8, hb);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float m = c0[e] + hf[e] * a[e] + hb[e] * c[e];
              sum += m;
              sumsq += m * m;
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
          sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
        }
        if (lane == 0) {
          const float mu = sum * inv_di;
          s_mu[rg + rr] = ok ? mu : 0.f;
          s_rstd[rg + rr] =
              ok ? rsqrtf(sumsq * inv_di - mu * mu + eps) : 0.f;
        }
      }
    }
    PROF(12)
    if constexpr (!kWide) fv::cp_async_wait<0>();
    fv::fence_async_smem();
    __syncthreads();

    PROF(1)
    // db_out += Σ_rows g (the wide form reads g's rows from L2)
#pragma unroll
    for (int k = 0; k < (kWide ? kDbo : 2); ++k) {
      const int c = tid + k * kThreads;
      if (c < dm) {
        float acc = 0.f;
        if constexpr (kWide) {
          for (int r = 0; r < nval; ++r)
            acc += __bfloat162float(g[token(i0 + r) * dm + c]);
        } else {
          const unsigned char* col = sm + L.g + (c / 64) * kBlkBytes;
          for (int r = 0; r < kTM; ++r)
            acc += __bfloat162float(
                *reinterpret_cast<const bf16*>(col + swz(r, c % 64)));
        }
        dbo[k] += acc;
      }
    }

    const int r0 = 16 * w4 + rq;  // this thread's rows: r0 and r0 + 8
    const bool rv[2] = {r0 < nval, r0 + 8 < nval};
    const size_t tokr[2] = {rv[0] ? token(i0 + r0) : img,
                            rv[1] ? token(i0 + r0 + 8) : img};
    const float mu[2] = {s_mu[r0], s_mu[r0 + 8]};
    const float rs[2] = {s_rstd[r0], s_rstd[r0 + 8]};
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    float dxa[kWide ? 1 : 16 * kNU];
#pragma unroll
    for (int i = 0; i < (kWide ? 1 : 16 * kNU); ++i) dxa[i] = 0.f;

    for (int n0 = 0; n0 < di; n0 += kSlab) {
      const int sw = imin(kSlab, di - n0);
      const bool active = 64 * wg < sw;
      float z[32], dg[32];
      PROF(2)
      // the slab's xc_f, xc_b are read in 16-byte vectors (from L2: the
      // first pass brought them) and m0 (bf16) goes where the epilogue
      // puts dz: each element is read and overwritten by the same thread
      const int mch = tid % 16, mr0 = tid / 16;  // chunk of 8 channels; rows
      if constexpr (kWide)
        slab_gemm_streamed<0>(z, nu, ring, wg * kBlkBytes, active);
      else
        slab_gemm<0>(z, sx, kNU, ring, wg * kBlkBytes, active);
      PROF(3)
      uint4 ma[4], mb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const size_t o = token(i0 + imin(mr0 + 16 * k, nval - 1)) * di + n0 +
                         imin(mch * 8, sw - 8);  // clamped where masked
        ma[k] = fv::load16(xc_f + o);
        mb[k] = fv::load16(xc_b + o);
      }
      if (8 * mch < sw) {
        float c0[8], hf[8], hb[8];
        lds_f8(s_col + n0 + mch * 8, c0);
        lds_f8(s_col + di + n0 + mch * 8, hf);
        lds_f8(s_col + 2 * di + n0 + mch * 8, hb);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = mr0 + 16 * k;
          float m[8];
          if (r < nval) {
            float a[8], c[8];
            fv::widen16<bf16>(ma[k], a);
            fv::widen16<bf16>(mb[k], c);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              m[e] = c0[e] + hf[e] * a[e] + hb[e] * c[e];
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) m[e] = 0.f;
          }
          *reinterpret_cast<uint4*>(s_dz + (mch / 8) * kBlkBytes +
                                    swz(r, (mch % 8) * 8)) = pack8(m);
        }
      }
      if constexpr (kWide)
        slab_gemm_streamed<1>(dg, nu, ring, wg * kBlkBytes, active);
      else
        slab_gemm<1>(dg, sgm, kNU, ring, wg * kBlkBytes, active);
      PROF(4)
      if (active) {
#pragma unroll
        for (int jg = 0; jg < 2; ++jg) {
        float csum[24];  // [3 sums][4 j][2 columns] over this thread's rows
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * jg + jj;
          const int cb = 8 * j + 2 * q;  // column in the warpgroup's block
          const int c = n0 + 64 * wg + cb;
          const float2 bz = b_z ? ld_f2(b_z + c) : make_float2(0.f, 0.f);
          const float2 lw = use_ln ? ld_f2(ln_w + c) : make_float2(1.f, 1.f);
          const float2 lb = use_ln ? ld_f2(ln_b + c) : make_float2(0.f, 0.f);
          float cs[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r0 + 8 * e;
            bf162* slot =
                reinterpret_cast<bf162*>(s_dz + wg * kBlkBytes + swz(r, cb));
            const float2 m0v = __bfloat1622float2(*slot);
            const float m0[2] = {m0v.x, m0v.y};
            const float bzv[2] = {bz.x, bz.y}, lwv[2] = {lw.x, lw.y},
                        lbv[2] = {lb.x, lb.y};
            float dzv[2], mgv[2], dmh[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int idx = 4 * j + 2 * e + h;
              const float mhat = use_ln ? (m0[h] - mu[e]) * rs[e] : m0[h];
              const float mln = use_ln ? mhat * lwv[h] + lbv[h] : mhat;
              const float zz = z[idx] + bzv[h];
              const float sig = sigmoid_fast(zz);
              const float sz = zz * sig;
              const float dgt = rv[e] ? dg[idx] : 0.f;
              const float dmln = dgt * sz;
              dzv[h] = dgt * mln * sig * (1.f + zz * (1.f - sig));
              mgv[h] = mln * sz;
              cs[0][h] += dzv[h];
              cs[1][h] += use_ln ? dmln * mhat : 0.f;
              cs[2][h] += use_ln ? dmln : 0.f;
              dmh[h] = use_ln ? dmln * lwv[h] : dmln;
              s1[e] += dmh[h];
              s2[e] += dmh[h] * mhat;
            }
            *slot = __floats2bfloat162_rn(dzv[0], dzv[1]);
            if (rv[e]) {
              // dm̂ waits in dxc_f for the second pass
              *reinterpret_cast<bf162*>(dxc_f + tokr[e] * di + c) =
                  __floats2bfloat162_rn(dmh[0], dmh[1]);
              *reinterpret_cast<bf162*>(mg + tokr[e] * di + c) =
                  __floats2bfloat162_rn(mgv[0], mgv[1]);
            }
          }
#pragma unroll
          for (int v = 0; v < 3; ++v)
#pragma unroll
            for (int h = 0; h < 2; ++h) csum[v * 8 + jj * 2 + h] = cs[v][h];
        }
        // Column sums over the warp's 16 rows: the 8 lanes that share
        // columns add their 24 values in three halving exchanges; a lane
        // ends with entries 12 b0 + 6 b1 + 3 b2 + {0, 1, 2}.
        const bool b0 = rq & 1, b1 = rq & 2, b2 = rq & 4;
#pragma unroll
        for (int i = 0; i < 12; ++i) {
          const float send = b0 ? csum[i] : csum[i + 12];
          const float keep = b0 ? csum[i + 12] : csum[i];
          csum[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float send = b1 ? csum[i] : csum[i + 6];
          const float keep = b1 ? csum[i + 6] : csum[i];
          csum[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float send = b2 ? csum[i] : csum[i + 3];
          const float keep = b2 ? csum[i + 3] : csum[i];
          const int k = 12 * b0 + 6 * b1 + 3 * b2 + i;
          s_colred[(warp * 3 + k / 8) * 64 + 8 * (4 * jg + k % 8 / 2) + 2 * q +
                   k % 2] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
        }
      }
      PROF(5)
      fv::fence_async_smem();
      __syncthreads();
      PROF(6)
      // db_z, dln_w, dln_b of the slab: add the 4 warps of each warpgroup
      for (int i = tid; i < 3 * sw; i += kThreads) {
        const int v = i / sw, c = i % sw;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s += s_colred[((c / 64 * 4 + k) * 3 + v) * 64 + c % 64];
        s_vec[v * di + n0 + c] += s;
      }
      slab_to_global(s_dz, sw, dzs, di, n0, [&](int r) -> long {
        return r < nval ? static_cast<long>(token(i0 + r)) : -1;
      });
      PROF(7)
      if constexpr (!kWide) dx_gemm<kNU>(dxa, smem_u32(s_dz), sw, ring, wg);
      PROF(8)
    }

    // the row sums of both warpgroups, and dx̂ of the tile
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = s1[e], c = s2[e];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      if (q == 0) {
        s_s12[(wg * kTM + r0 + 8 * e) * 2] = a;
        s_s12[(wg * kTM + r0 + 8 * e) * 2 + 1] = c;
      }
    }
#pragma unroll
    for (int u = 0; u < kNU; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wg * 32 * kNU + 32 * u + 8 * j + 2 * q;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (rv[e])
            *reinterpret_cast<float2*>(dx + tokr[e] * dm + c) = make_float2(
                dxa[16 * u + 4 * j + 2 * e], dxa[16 * u + 4 * j + 2 * e + 1]);
      }
    __syncthreads();
    PROF(9)

    // second pass: dm0 and what hangs on it, a thread per 8 channels (in
    // turn where there are more groups than threads)
    for (int item = tid; item < nrl * ncg; item += kThreads) {
      const int cg = item % ncg, rl = item / ncg;
      float c0[8], hf[8], hb[8];
      lds_f8(s_col + cg * 8, c0);
      lds_f8(s_col + di + cg * 8, hf);
      lds_f8(s_col + 2 * di + cg * 8, hb);
      float af[8], ab[8], ay[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) af[e] = ab[e] = ay[e] = 0.f;
      for (int rb = rl; rb < nval; rb += 4 * nrl) {  // 4 rows' loads in flight
        uint4 vd[4], va[4], vc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t o =
              token(i0 + imin(rb + k * nrl, nval - 1)) * di + cg * 8;
          vd[k] = __ldcg(reinterpret_cast<const uint4*>(dxc_f + o));
          va[k] = fv::load16(xc_f + o);
          vc[k] = fv::load16(xc_b + o);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = imin(rb + k * nrl, nval - 1);
          const bool live = rb + k * nrl < nval;  // else: a masked repeat
          const size_t o = token(i0 + r) * di + cg * 8;
          float dmh[8], a[8], c[8], of[8], ob[8];
          fv::widen16<bf16>(vd[k], dmh);
          fv::widen16<bf16>(va[k], a);
          fv::widen16<bf16>(vc[k], c);
          const float m_mu = s_mu[r], m_rs = s_rstd[r];
          const float t1 = (s_s12[r * 2] + s_s12[(kTM + r) * 2]) * inv_di;
          const float t2 =
              (s_s12[r * 2 + 1] + s_s12[(kTM + r) * 2 + 1]) * inv_di;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float dm0 = dmh[e];
            if (use_ln) {
              const float m0 = c0[e] + hf[e] * a[e] + hb[e] * c[e];
              dm0 = m_rs * (dmh[e] - t1 - (m0 - m_mu) * m_rs * t2);
            }
            of[e] = dm0 * hf[e];
            ob[e] = dm0 * hb[e];
            const float h = live ? 0.5f * dm0 : 0.f;
            af[e] += h * a[e];
            ab[e] += h * c[e];
            ay[e] += h;
          }
          if (live) {
            *reinterpret_cast<uint4*>(dxc_f + o) = pack8(of);
            *reinterpret_cast<uint4*>(dxc_b + o) = pack8(ob);
          }
        }
      }
      float* slot = s_acc2 + static_cast<size_t>(rl) * 3 * di + cg * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        slot[e] += af[e];
        slot[di + e] += ab[e];
        slot[2 * di + e] += ay[e];
      }
    }
  }

  PROF(10)
  // the block's sums: rows 0-4 and db_out to its slot of vec_part
  // ([5·di | dm]), the line sum to dy
  __syncthreads();
  float* vp = vec_part + prow * (5 * static_cast<size_t>(di) + dm);
  for (int i = tid; i < 3 * di; i += kThreads) {
    vp[i] = s_vec[i];
    float s = 0.f;
    for (int k = 0; k < nrl; ++k) s += s_acc2[static_cast<size_t>(k) * 3 * di + i];
    if (i < 2 * di)
      vp[3 * di + i] = s;
    else
      dy[prow * di + i - 2 * di] = __float2bfloat16(s);
  }
#pragma unroll
  for (int k = 0; k < (kWide ? kDbo : 2); ++k)
    if (tid + k * kThreads < dm) vp[5 * di + tid + k * kThreads] = dbo[k];
}

// =====================================================================
// weight gradients: part[job][split] (di × dm) = X[slice]ᵀ · Y[slice]
// =====================================================================
constexpr int kWgM = 128;        // rows of d_inner per block, 64 a warpgroup
constexpr int kWgNB = 3;         // up to 3 blocks of 64 columns of d_model
constexpr int kWgStage = (2 + kWgNB) * kBlkBytes;  // 40 KB
constexpr size_t kWgSmem = kStages * kWgStage + 1024;

struct WgradJobs {
  const bf16* X[2];
  const bf16* Y[2];
  int count;
};

// grid (m tiles × n tiles, nsplit, jobs). part: (jobs, nsplit, di, dm).
__global__ void __launch_bounds__(kThreads, 1)
wgrad_wgmma_kernel(WgradJobs jobs, float* __restrict__ part, long T, int di,
                   int dm, int ntile_n, int nb_per) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  const bf16* X = jobs.X[blockIdx.z];
  const bf16* Y = jobs.Y[blockIdx.z];
  const int m0 = blockIdx.x / ntile_n * kWgM;
  const int nb0 = blockIdx.x % ntile_n * nb_per;
  const int nb = imin(nb_per, dm / 64 - nb0);  // column blocks of this tile
  const int mblk = imin(2, (di - m0) / 64);
  const long per =
      ((T + gridDim.y - 1) / gridDim.y + kTM - 1) / kTM * kTM;
  const long t_begin = blockIdx.y * per;
  const long t_end = t_begin + per < T ? t_begin + per : T;
  const int nk = t_end > t_begin
                     ? static_cast<int>((t_end - t_begin + kTM - 1) / kTM)
                     : 0;

  auto fetch = [&](int s, uint32_t dst) {
    if (s >= nk) return;
    const long t0 = t_begin + static_cast<long>(s) * kTM;
    for (int i = tid; i < kTM * 8 * (mblk + nb); i += kThreads) {
      const int blk = i / (kTM * 8), r = i / 8 % kTM, ch = i % 8;
      const bool ok = t0 + r < t_end;  // masked before the load
      const long t = ok ? t0 + r : t_begin;
      const bf16* src = blk < mblk
                            ? X + t * di + m0 + 64 * blk + ch * 8
                            : Y + t * dm + 64 * (nb0 + blk - mblk) + ch * 8;
      cp_async16(dst + (blk < mblk ? blk : 2 + blk - mblk) * kBlkBytes +
                     r * fv::kBlkRowBytes + (((ch ^ r) & 7) << 4),
                 src, ok);
    }
  };
  // the ring's stages here are 40 KB: X blocks 0-1, Y blocks 2-4
  int cons = 0;
  auto slot = [&](int s) { return base + (s % kStages) * kWgStage; };
  for (int s = 0; s < kStages - 1; ++s) {
    fetch(s, slot(s));
    fv::cp_async_commit();
  }
  float acc[32 * kWgNB];
#pragma unroll
  for (int i = 0; i < 32 * kWgNB; ++i) acc[i] = 0.f;
  const bool active = wg < mblk;
  for (int k = 0; k < nk; ++k) {
    fv::cp_async_wait<kStages - 2>();
    fv::fence_async_smem();
    __syncthreads();
    fetch(cons + kStages - 1, slot(cons + kStages - 1));
    fv::cp_async_commit();
    const uint32_t st = slot(cons++);
    if (active) {
      fv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = gmma_desc(st + wg * kBlkBytes + 2048 * kk);
#pragma unroll
        for (int j = 0; j < kWgNB; ++j)
          if (j < nb)
            fv::wgmma_n64<1, 1>(acc + 32 * j, da,
                                gmma_desc(st + (2 + j) * kBlkBytes + 2048 * kk),
                                1);
      }
      fv::wgmma_commit();
      fv::wgmma_wait();
    }
  }
  if (!active) return;
  float* out = part + ((static_cast<size_t>(blockIdx.z) * gridDim.y +
                        blockIdx.y) * di + m0 + 64 * wg) * dm + 64 * nb0;
#pragma unroll
  for (int j = 0; j < kWgNB; ++j)
    if (j < nb)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(
              out + static_cast<size_t>(16 * w4 + rq + 8 * e) * dm + 64 * j +
              8 * i + 2 * q) =
              make_float2(acc[32 * j + 4 * i + 2 * e],
                          acc[32 * j + 4 * i + 2 * e + 1]);
}

cudaError_t wgrad_wgmma(const WgradJobs& jobs, float* part, long T, int di,
                        int dm, int nsplit, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmem));
  if (attr != cudaSuccess) return attr;
  const int nblk = dm / 64;
  const int ntile_n = (nblk + kWgNB - 1) / kWgNB;
  const int nb_per = (nblk + ntile_n - 1) / ntile_n;
  dim3 grid((di + kWgM - 1) / kWgM * ntile_n, nsplit, jobs.count);
  wgrad_wgmma_kernel<<<grid, kThreads, kWgSmem, stream>>>(jobs, part, T, di,
                                                          dm, ntile_n, nb_per);
  return cudaGetLastError();
}

// =====================================================================
// dx̂ of the wide forms: out (T × dm, fp32) = add + A·W
// =====================================================================
// A (T, di) bf16 (dz of K5, dxin of K6), W (di, dm) bf16 (W_z or W_x as it
// lies, read MN-major), add (T, dm) fp32 or null (K6: dx̂ of K5). A block
// owns 128 tokens (64 a warpgroup) × up to 3 blocks of 64 columns and walks
// d_inner in K steps of 64 through a ring of 40 KB stages (the tokens' A
// block, then the W blocks). grid: token tiles × column tiles.
constexpr int kDxM = 128;
__global__ void __launch_bounds__(kThreads, 1)
dx_wgmma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wm,
                const float* __restrict__ add, float* __restrict__ out,
                long T, int di, int dm, int ntile_n, int nb_per) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  const long t0 = static_cast<long>(blockIdx.x / ntile_n) * kDxM;
  const int nb0 = blockIdx.x % ntile_n * nb_per;
  const int nb = imin(nb_per, dm / 64 - nb0);  // column blocks of this tile
  const int nk = di / 64;

  auto fetch = [&](int s, uint32_t dst) {
    if (s >= nk) return;
    const int k0 = 64 * s;
    for (int i = tid; i < 8 * (kDxM + 64 * nb); i += kThreads) {
      const int r = i / 8, ch = i % 8;
      if (r < kDxM) {
        const bool ok = t0 + r < T;  // masked before the load
        cp_async16(dst + (r / kTM) * kBlkBytes + swz(r % kTM, 8 * ch),
                   A + (ok ? (t0 + r) * di + k0 + 8 * ch : 0), ok);
      } else {
        const int j = (r - kDxM) / 64, kr = (r - kDxM) % 64;
        cp_async16(dst + (2 + j) * kBlkBytes + swz(kr, 8 * ch),
                   Wm + static_cast<size_t>(k0 + kr) * dm + 64 * (nb0 + j) +
                       8 * ch);
      }
    }
  };
  int cons = 0;
  auto slot = [&](int s) { return base + (s % kStages) * kWgStage; };
  for (int s = 0; s < kStages - 1; ++s) {
    fetch(s, slot(s));
    fv::cp_async_commit();
  }
  float acc[32 * kWgNB];
#pragma unroll
  for (int i = 0; i < 32 * kWgNB; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    fv::cp_async_wait<kStages - 2>();
    fv::fence_async_smem();
    __syncthreads();
    fetch(cons + kStages - 1, slot(cons + kStages - 1));
    fv::cp_async_commit();
    const uint32_t st = slot(cons++);
    fv::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = gmma_desc(st + wg * kBlkBytes + 32 * kk);
#pragma unroll
      for (int j = 0; j < kWgNB; ++j)
        if (j < nb)
          fv::wgmma_n64<0, 1>(acc + 32 * j, da,
                              gmma_desc(st + (2 + j) * kBlkBytes + 2048 * kk),
                              1);
    }
    fv::wgmma_commit();
    fv::wgmma_wait();
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long row = t0 + 64 * wg + 16 * w4 + rq + 8 * e;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < kWgNB; ++j)
      if (j < nb)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const size_t o =
              static_cast<size_t>(row) * dm + 64 * (nb0 + j) + 8 * i + 2 * q;
          float2 v = make_float2(acc[32 * j + 4 * i + 2 * e],
                                 acc[32 * j + 4 * i + 2 * e + 1]);
          if (add) {
            const float2 a = __ldg(reinterpret_cast<const float2*>(add + o));
            v.x += a.x;
            v.y += a.y;
          }
          *reinterpret_cast<float2*>(out + o) = v;
        }
  }
}

cudaError_t dx_wgmma(const void* A, const void* Wm, const void* add,
                     void* out, long T, int di, int dm, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dx_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmem));
  if (attr != cudaSuccess) return attr;
  const int nblk = dm / 64;
  const int ntile_n = (nblk + kWgNB - 1) / kWgNB;
  const int nb_per = (nblk + ntile_n - 1) / ntile_n;
  const long tiles = (T + kDxM - 1) / kDxM * ntile_n;
  if (tiles > 0x7fffffffL) return cudaErrorInvalidValue;
  dx_wgmma_kernel<<<static_cast<unsigned>(tiles), kThreads, kWgSmem,
                    stream>>>(static_cast<const bf16*>(A),
                              static_cast<const bf16*>(Wm),
                              static_cast<const float*>(add),
                              static_cast<float*>(out), T, di, dm, ntile_n,
                              nb_per);
  return cudaGetLastError();
}

// =====================================================================
// K6: pass A backward
// =====================================================================
constexpr int kXinLd = kSlab + 4;  // fp32 row of the xin slab, skewed

// lines a 64-row window can touch (lines of >= 4 tokens)
constexpr int kMaxLines = kTM / 4 + 2;

struct ABwdSmem {
  size_t x, dxin, ring, xin, dxcf, dxcb, cred, pool, total;
};
// wide: the wide form, whose x̂ comes through the ring
__host__ __device__ inline ABwdSmem a_bwd_smem(int dm, bool wide) {
  ABwdSmem L;
  L.x = 0;
  L.dxin = wide ? 0 : static_cast<size_t>(dm / 64) * kBlkBytes;
  L.ring = L.dxin + 2 * kBlkBytes;
  L.xin = L.ring + kStages * (wide ? kWideStageBytes : kStageBytes);
  L.dxcf = L.xin + static_cast<size_t>(kTM) * kXinLd * sizeof(float);
  L.dxcb = L.dxcf + static_cast<size_t>(kTM) * kSlab * sizeof(bf16);
  L.cred = L.dxcb + static_cast<size_t>(kTM) * kSlab * sizeof(bf16);
  L.pool = L.cred + static_cast<size_t>(kCVec) * kSlab * sizeof(float);
  L.total = L.pool + 2 * static_cast<size_t>(kMaxLines) * kSlab * sizeof(float) +
            1024;
  return L;
}

// kNU: d_model / 64 (the narrow form), or 0: the wide form, which takes
// d_model from dm_arg
template <int kNU>
__global__ void __launch_bounds__(kThreads, 1)
pass_a_bwd_wgmma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dx_b,
    const bf16* __restrict__ dxc_f, const bf16* __restrict__ dxc_b,
    const bf16* __restrict__ dpf, const bf16* __restrict__ dpb,
    const bf16* __restrict__ w_x, const float* __restrict__ b_x,
    const float* __restrict__ w_cf, const float* __restrict__ b_cf,
    const float* __restrict__ w_ab, const float* __restrict__ b_ab,
    float* __restrict__ dx, bf16* __restrict__ dxin,
    float* __restrict__ c_part, int batch, int H, int W, int dm_arg, int di,
    bool transposed, float scaling) {
  constexpr bool kWide = kNU == 0;
  const int dm = kWide ? dm_arg : 64 * kNU;
  const int nu = kWide ? dm / 64 : kNU;  // K blocks of d_model
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const ABwdSmem L = a_bwd_smem(dm, kWide);
  const uint32_t sx = smem_u32(sm + L.x);
  unsigned char* s_dxin = sm + L.dxin;
  float* s_xin = reinterpret_cast<float*>(sm + L.xin);    // [64][kXinLd]
  bf16* s_dxcf = reinterpret_cast<bf16*>(sm + L.dxcf);    // [64][128]
  bf16* s_dxcb = reinterpret_cast<bf16*>(sm + L.dxcb);    // [64][128]
  float* s_cred = reinterpret_cast<float*>(sm + L.cred);  // [11][128]
  float* s_pool = reinterpret_cast<float*>(sm + L.pool);  // [2][lines][128]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const int Ltok = H * W;
  const int nwin = (Ltok + kAWin - 1) / kAWin;  // windows of an image
  const int nslab = (di + kSlab - 1) / kSlab;
  const int per_win = nslab * (kWide ? 1 : 2) * nu;
  // the block walks windows blockIdx.x, blockIdx.x + gridDim.x, ...
  const int nmine =
      (batch * nwin - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
      static_cast<int>(gridDim.x);
  const int total = nmine * per_win;
  const float sw_pool = scaling / static_cast<float>(ln);

  // per window and slab nu blocks of W_x (xin), then the same again (dx̂;
  // not in the wide form, whose stages carry the window's x̂ block of
  // their K step instead: rows outside the sequence zero-filled, not read)
  auto fetch = [&](int s, uint32_t dst) {
    if (s >= total) return;
    const int r = s % per_win;
    const int n0 = r / ((kWide ? 1 : 2) * nu) * kSlab, kb = r % nu;
    fv::cp_block(dst, w_x, dm, n0, 64 * kb, imin(kSlab, di - n0), tid,
                 kThreads);
    if constexpr (kWide) {
      const int w = static_cast<int>(blockIdx.x) +
                    s / per_win * static_cast<int>(gridDim.x);
      const int tw = w % nwin * kAWin - 3;
      const long im = static_cast<long>(w / nwin) * Ltok;
      cp_rows(dst + kStageBytes, x, dm, 64 * kb, [&](int row) -> long {
        const int t = tw + row;
        if (t < 0 || t >= Ltok) return -1;  // masked before the load
        return im + (transposed ? static_cast<long>(t % H) * W + t / H : t);
      });
    }
  };
  fv::Ring<kStages, kWide ? kWideStageBytes : kStageBytes, decltype(fetch)>
      ring(smem_u32(sm + L.ring), fetch);
  ring.start();

  const int r0 = 16 * w4 + rq;  // this thread's rows of a product
  const int c = tid % kSlab, hf = tid / kSlab;  // conv stage: channel, half
  const int u0 = hf ? 32 : 3;  // first of the 29 own rows this half emits
  PROF_INIT
  // start the copy of x̂ for window w (64 rows, rows outside the sequence
  // zero-filled and never read)
  auto load_x = [&](int w) {
    const size_t im = static_cast<size_t>(w / nwin) * Ltok;
    const int tw = w % nwin * kAWin - 3;
    for (int i = tid; i < kTM * 8 * kNU; i += kThreads) {
      const int r = i / (8 * kNU), ch = i % (8 * kNU);
      const int t = tw + r;
      const bool ok = t >= 0 && t < Ltok;  // masked before the load
      const size_t tok =
          !ok ? 0 : (transposed ? static_cast<size_t>(t % H) * W + t / H : t);
      cp_async16(sx + (ch / 8) * kBlkBytes + swz(r, (ch % 8) * 8),
                 x + (im + tok) * dm + ch * 8, ok);
    }
    fv::cp_async_commit();
  };
  if constexpr (!kWide) load_x(blockIdx.x);

  for (int wi = blockIdx.x; wi < batch * nwin; wi += gridDim.x) {
    const int b = wi / nwin;
    const size_t img = static_cast<size_t>(b) * Ltok;
    // row j of the tile is position tt0 + j of the conv's 1-D order;
    // rows 3..60 are the window's own, the rest halo
    const int tt0 = wi % nwin * kAWin - 3;
    auto in_seq = [&](int j) {
      const int t = tt0 + j;
      return t >= 0 && t < Ltok;
    };
    auto token = [&](int j) -> size_t {  // raster index in the image
      const int t = tt0 + j;
      return transposed ? static_cast<size_t>(t % H) * W + t / H
                        : static_cast<size_t>(t);
    };
    auto own = [&](int j) { return j >= 3 && j < 3 + kAWin && in_seq(j); };

    // x̂ of the window: the first was asked for before the loop, the
    // others while the window before them ran its last slab
    if constexpr (!kWide) fv::cp_async_wait<0>();
    // (the first acquire's barrier publishes the tile)
    const bool rv[2] = {in_seq(r0), in_seq(r0 + 8)};
    float dxa[kWide ? 1 : 16 * kNU];
#pragma unroll
    for (int i = 0; i < (kWide ? 1 : 16 * kNU); ++i) dxa[i] = 0.f;
    PROF(16)

    for (int n0 = 0; n0 < di; n0 += kSlab) {
      const int sw = imin(kSlab, di - n0);
      const bool active = 64 * wg < sw;
      float xin[32];
      // xin = x̂·W_xᵀ; the slab's cotangents travel with the first stage
      for (int kb = 0; kb < nu; ++kb) {
        const uint32_t st0 = ring.acquire(), st = st0 + wg * kBlkBytes;
        const uint32_t xa = kWide ? st0 + kStageBytes : sx + kb * kBlkBytes;
        if (kb == 0) {
          const int cpr = sw / 8;
          for (int i = tid; i < kTM * cpr; i += kThreads) {
            const int r = i / cpr, ch = i % cpr;
            const bool ok = in_seq(r);  // masked before the load
            const size_t off = (img + (ok ? token(r) : 0)) * di + n0 + ch * 8;
            cp_async16(smem_u32(s_dxcf + r * kSlab + ch * 8), dxc_f + off, ok);
            cp_async16(smem_u32(s_dxcb + r * kSlab + ch * 8), dxc_b + off, ok);
          }
          fv::cp_async_commit();
        }
        if (active) {
          fv::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            fv::wgmma_n64<0, 0>(xin, gmma_desc(xa + 32 * kk),
                                gmma_desc(st + 32 * kk), (kb | kk) != 0);
          fv::wgmma_commit();
        }
        ring.refill();
        if (active) fv::wgmma_wait();
      }
      PROF(17)
      if (active) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cb = 64 * wg + 8 * j + 2 * q;
          const float2 bx = b_x ? ld_f2(b_x + n0 + cb) : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float2*>(s_xin + (r0 + 8 * e) * kXinLd + cb) =
                rv[e] ? make_float2(xin[4 * j + 2 * e] + bx.x,
                                    xin[4 * j + 2 * e + 1] + bx.y)
                      : make_float2(0.f, 0.f);
        }
      }
      // the pooled cotangents of the lines the window touches, scaled; 0
      // for a line outside the image, whose tokens are outside the sequence
      const int lbase = tt0 < 0 ? -1 : tt0 / ln;
      const int nlines = (tt0 + kTM - 1) / ln - lbase + 1;
      for (int i = tid; i < 2 * nlines * sw; i += kThreads) {
        const int l = i / sw % nlines, ch = i % sw;
        const bf16* dp = i < nlines * sw ? dpf : dpb;
        const int line = lbase + l;
        s_pool[((i >= nlines * sw) * kMaxLines + l) * kSlab + ch] =
            line >= 0 && line < P
                ? __bfloat162float(
                      dp[(static_cast<size_t>(b) * P + line) * di + n0 + ch]) *
                      sw_pool
                : 0.f;
      }
      PROF(18)
      fv::cp_async_wait<0>();
      __syncthreads();
      // every warp is past the window's last x̂ product: its tile is free
      if (!kWide && n0 + kSlab >= di &&
          wi + static_cast<int>(gridDim.x) < batch * nwin)
        load_x(wi + gridDim.x);
      PROF(19)

      // The conv adjoint: a thread walks half of the rows of one channel.
      // At step i it has xin[i-3..i], forms dyc[i] and dya[i-3], and emits
      // dxin[i-3] from dyc[i-3..i] and dya[i-6..i-3].
      float part[kCVec];
#pragma unroll
      for (int k = 0; k < kCVec; ++k) part[k] = 0.f;
      if (c < sw) {
        const int cc = n0 + c;
        float wc[4], wa[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wc[k] = w_cf[cc * 4 + k];
          wa[k] = w_ab[cc * 4 + k];
        }
        const float bc = b_cf ? b_cf[cc] : 0.f, ba = b_ab ? b_ab[cc] : 0.f;
        // line (relative to the window's first) and position in it of row
        // i (causal) and of row i - 3 (anticausal)
        int li = (tt0 + u0) / ln - lbase, pi = (tt0 + u0) % ln;
        int la, pa;
        if (tt0 + u0 - 3 < 0) {  // up to 3 positions before the sequence
          la = 0;
          pa = ln + tt0 + u0 - 3;
        } else {
          la = (tt0 + u0 - 3) / ln - lbase;
          pa = (tt0 + u0 - 3) % ln;
        }
        const float* pool_f = s_pool + c;
        const float* pool_b = s_pool + kMaxLines * kSlab + c;
        float x0 = s_xin[(u0 - 3) * kXinLd + c],
              x1 = s_xin[(u0 - 2) * kXinLd + c],
              x2 = s_xin[(u0 - 1) * kXinLd + c];
        float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;  // dyc[i-3..i]
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // dya[i-6..i-3]
#pragma unroll 8
        for (int k = 0; k < 32; ++k) {
          const int i = u0 + k;
          const float x3 = s_xin[i * kXinLd + c];
          const float yc = bc + x0 * wc[0] + x1 * wc[1] + x2 * wc[2] +
                           x3 * wc[3];
          const float ya = ba + x0 * wa[3] + x1 * wa[2] + x2 * wa[1] +
                           x3 * wa[0];
          // a row outside the sequence holds zeros and so does its line's
          // pooled cotangent: its dyc and dya come out 0 without a branch
          const float dyc = (__bfloat162float(s_dxcf[i * kSlab + c]) +
                             pool_f[li * kSlab]) * dsilu_fast(yc);
          const float dya = (__bfloat162float(s_dxcb[(i - 3) * kSlab + c]) +
                             pool_b[la * kSlab]) * dsilu_fast(ya);
          // own tokens: row i for the causal sums (k < 29), row u = i - 3
          // for the anticausal ones and dxin (k >= 3)
          const float oc = k < 29 ? dyc : 0.f, oa = k >= 3 ? dya : 0.f;
          part[0] += x0 * oc;  // dw_c[k] += xin[t-3+k]·dyc[t]
          part[1] += x1 * oc;
          part[2] += x2 * oc;
          part[3] += x3 * oc;
          part[8] += oc;
          part[7] += x0 * oa;  // dw_a[3-k] += xin[t+k]·dya[t]
          part[6] += x1 * oa;
          part[5] += x2 * oa;
          part[4] += x3 * oa;
          part[9] += oa;
          c0 = c1; c1 = c2; c2 = c3; c3 = dyc;
          a0 = a1; a1 = a2; a2 = a3; a3 = dya;
          if (k >= 3) {
            const int u = i - 3;
            // dxin[u] = Σ_k w_c[k]·dyc[u+3-k] + w_a[3-k]·dya[u-k]
            const float dxi = wc[0] * c3 + wc[1] * c2 + wc[2] * c1 +
                              wc[3] * c0 + wa[3] * a3 + wa[2] * a2 +
                              wa[1] * a1 + wa[0] * a0;
            part[10] += in_seq(u) ? dxi : 0.f;
            *reinterpret_cast<bf16*>(s_dxin + (c / 64) * kBlkBytes +
                                     swz(u, c % 64)) = __float2bfloat16(dxi);
          }
          x0 = x1; x1 = x2; x2 = x3;
          const bool wi_ = ++pi == ln, wa_ = ++pa == ln;
          pi = wi_ ? 0 : pi;
          li += wi_;
          pa = wa_ ? 0 : pa;
          la += wa_;
        }
        if (hf == 1)
#pragma unroll
          for (int k = 0; k < kCVec; ++k) s_cred[k * kSlab + c] = part[k];
      }
      PROF(20)
      fv::fence_async_smem();
      __syncthreads();
      PROF(21)
      if (c < sw && hf == 0) {
        float* cp = c_part + static_cast<size_t>(wi) * kCVec * di + n0 + c;
#pragma unroll
        for (int k = 0; k < kCVec; ++k)
          cp[static_cast<size_t>(k) * di] = part[k] + s_cred[k * kSlab + c];
      }
      slab_to_global(s_dxin, sw, dxin, di, n0, [&](int r) -> long {
        return own(r) ? static_cast<long>(img + token(r)) : -1;
      });
      PROF(22)
      if constexpr (!kWide) dx_gemm<kNU>(dxa, smem_u32(s_dxin), sw, ring, wg);
      PROF(23)
    }

    // dx̂ = dx̂(K5) + dxin·W_x on the window's own rows
#pragma unroll
    for (int u = 0; u < kNU; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wg * 32 * kNU + 32 * u + 8 * j + 2 * q;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // loaded whether owned or not (at a clamped address), so that
          // the loads do not wait for one another
          const bool mine = own(r0 + 8 * e);
          const size_t o = (img + (mine ? token(r0 + 8 * e) : 0)) * dm + col;
          const float2 prev = __ldg(reinterpret_cast<const float2*>(dx_b + o));
          if (mine)
            *reinterpret_cast<float2*>(dx + o) =
                make_float2(prev.x + dxa[16 * u + 4 * j + 2 * e],
                            prev.y + dxa[16 * u + 4 * j + 2 * e + 1]);
        }
      }
  }
}

template <int kNU>
cudaError_t launch_b(const void* g, const void* x, const void* xc_f,
                     const void* xc_b, const void* yf, const void* yb,
                     const void* w_z, const void* b_z, const void* d_f,
                     const void* d_b, const void* ln_w, const void* ln_b,
                     const void* w_out, void* dx, void* dxc_f, void* dxc_b,
                     void* dy, void* mg, void* dz, void* vec_part, int batch,
                     int H, int W, int dm, int di, bool transposed,
                     bool use_ln, float eps, cudaStream_t stream) {
  const size_t smem = b_bwd_smem(dm, di, kNU == 0).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<pass_b_bwd_wgmma_kernel<kNU>>();
  if (err != cudaSuccess) return err;
  auto cT = [](const void* p) { return static_cast<const bf16*>(p); };
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  auto mT = [](void* p) { return static_cast<bf16*>(p); };
  dim3 grid(transposed ? W : H, batch);
  pass_b_bwd_wgmma_kernel<kNU><<<grid, kThreads, smem, stream>>>(
      cT(g), cT(x), cT(xc_f), cT(xc_b), cT(yf), cT(yb), cT(w_z), cF(b_z),
      cF(d_f), cF(d_b), cF(ln_w), cF(ln_b), cT(w_out), static_cast<float*>(dx),
      mT(dxc_f), mT(dxc_b), mT(dy), mT(mg), mT(dz),
      static_cast<float*>(vec_part), H, W, dm, di, transposed, use_ln, eps);
  return cudaGetLastError();
}

template <int kNU>
cudaError_t launch_a(const void* x, const void* dx_b, const void* dxc_f,
                     const void* dxc_b, const void* dpf, const void* dpb,
                     const void* w_x, const void* b_x, const void* w_cf,
                     const void* b_cf, const void* w_ab, const void* b_ab,
                     void* dx, void* dxin, void* c_part, int batch, int H,
                     int W, int dm, int di, bool transposed, float scaling,
                     cudaStream_t stream) {
  const size_t smem = a_bwd_smem(dm, kNU == 0).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<pass_a_bwd_wgmma_kernel<kNU>>();
  if (err != cudaSuccess) return err;
  auto cT = [](const void* p) { return static_cast<const bf16*>(p); };
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  const int nwin = (H * W + kAWin - 1) / kAWin;
  // one block per SM, each walking its share of the windows
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int blocks = imin(batch * nwin, sms);
  pass_a_bwd_wgmma_kernel<kNU><<<blocks, kThreads, smem, stream>>>(
      cT(x), cF(dx_b), cT(dxc_f), cT(dxc_b), cT(dpf), cT(dpb), cT(w_x),
      cF(b_x), cF(w_cf), cF(b_cf), cF(w_ab), cF(b_ab), static_cast<float*>(dx),
      static_cast<bf16*>(dxin), static_cast<float*>(c_part), batch, H, W, dm,
      di, transposed, scaling);
  return cudaGetLastError();
}

}  // namespace

namespace fvb {

cudaError_t pass_b_bwd_bf16(
    const void* g, const void* x, const void* xc_f, const void* xc_b,
    const void* yf, const void* yb, const void* w_z, const void* b_z,
    const void* d_f, const void* d_b, const void* ln_w, const void* ln_b,
    const void* w_out, void* dx, void* dxc_f, void* dxc_b, void* dy, void* mg,
    void* dz, void* vec_part, void* vec, void* w_part, void* dw_out,
    void* dw_z, int batch, int H, int W, int dm, int di, bool transposed,
    bool use_ln, int nsplit, float eps, cudaStream_t stream) {
  cudaError_t err;
#define FV_B(n) launch_b<n>(g, x, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, \
    ln_w, ln_b, w_out, dx, dxc_f, dxc_b, dy, mg, dz, vec_part, batch, H, W, \
    dm, di, transposed, use_ln, eps, stream)
  const bool wide = wide_form(dm, di);
  switch (wide ? 0 : dm / 64) {
    case 0: err = FV_B(0); break;
    case 1: err = FV_B(1); break;
    case 2: err = FV_B(2); break;
    case 3: err = FV_B(3); break;
    case 4: err = FV_B(4); break;
    case 5: err = FV_B(5); break;
    case 6: err = FV_B(6); break;
    default: return cudaErrorInvalidValue;
  }
#undef FV_B
  if (err != cudaSuccess) return err;
  const long T = static_cast<long>(batch) * H * W;
  if (wide) {  // dx̂ (z half) = dz·W_z
    err = dx_wgmma(dz, w_z, nullptr, dx, T, di, dm, stream);
    if (err != cudaSuccess) return err;
  }
  const size_t wn = static_cast<size_t>(di) * dm;
  auto* wp = static_cast<float*>(w_part);
  // dW_outᵀ (di, dm) = mgᵀ·g;  dW_z (di, dm) = dzᵀ·x̂
  WgradJobs jobs{{static_cast<const bf16*>(mg), static_cast<const bf16*>(dz)},
                 {static_cast<const bf16*>(g), static_cast<const bf16*>(x)},
                 2};
  err = wgrad_wgmma(jobs, wp, T, di, dm, nsplit, stream);
  if (err != cudaSuccess) return err;
  const int P = transposed ? W : H;
  SumSegs segs{{{wp, static_cast<float*>(dw_out), static_cast<long>(wn),
                 nsplit, dm},
                {wp + nsplit * wn, static_cast<float*>(dw_z),
                 static_cast<long>(wn), nsplit, 0},
                {static_cast<const float*>(vec_part), static_cast<float*>(vec),
                 5L * di + dm, batch * P, 0}},
               3};
  return sum_segments(segs, stream);
}

cudaError_t pass_a_bwd_bf16(
    const void* x, const void* dx_b, const void* dxc_f, const void* dxc_b,
    const void* dpf, const void* dpb, const void* w_x, const void* b_x,
    const void* w_cf, const void* b_cf, const void* w_ab, const void* b_ab,
    void* dx, void* dxin, void* c_part, void* c_vec, void* w_part, void* dw_x,
    int batch, int H, int W, int dm, int di, bool transposed, int nsplit,
    float scaling, cudaStream_t stream) {
  cudaError_t err;
#define FV_A(n) launch_a<n>(x, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x, w_cf, \
    b_cf, w_ab, b_ab, dx, dxin, c_part, batch, H, W, dm, di, transposed, \
    scaling, stream)
  const bool wide = wide_form(dm, di);
  switch (wide ? 0 : dm / 64) {
    case 0: err = FV_A(0); break;
    case 1: err = FV_A(1); break;
    case 2: err = FV_A(2); break;
    case 3: err = FV_A(3); break;
    case 4: err = FV_A(4); break;
    case 5: err = FV_A(5); break;
    case 6: err = FV_A(6); break;
    default: return cudaErrorInvalidValue;
  }
#undef FV_A
  if (err != cudaSuccess) return err;
  const long Ltok = static_cast<long>(H) * W;
  const long T = batch * Ltok;
  if (wide) {  // dx̂ = dx̂(K5) + dxin·W_x
    err = dx_wgmma(dxin, w_x, dx_b, dx, T, di, dm, stream);
    if (err != cudaSuccess) return err;
  }
  const int nwin = static_cast<int>((Ltok + kAWin - 1) / kAWin);
  WgradJobs jobs{{static_cast<const bf16*>(dxin), nullptr},
                 {static_cast<const bf16*>(x), nullptr}, 1};
  err = wgrad_wgmma(jobs, static_cast<float*>(w_part), T, di, dm, nsplit,
                    stream);
  if (err != cudaSuccess) return err;
  SumSegs segs{{{static_cast<const float*>(w_part), static_cast<float*>(dw_x),
                 static_cast<long>(di) * dm, nsplit, 0},
                {static_cast<const float*>(c_part), static_cast<float*>(c_vec),
                 static_cast<long>(kCVec) * di, batch * nwin, 0},
                {nullptr, nullptr, 0, 0, 0}},
               2};
  return sum_segments(segs, stream);
}

}  // namespace fvb
