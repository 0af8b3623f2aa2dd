// K7 in fp32, for Hopper (sm_90a): pass B of the fused FastVim mixer layer
// in its recompute form, with its three products on the tensor cores in
// split precision. What it computes, and the TPU kernels it replaces, are
// set out at the head of layer_fused_recompute.cu; this file is how the
// fp32 path computes it.
//
// What bounds it: operations. A token reads x̂ and writes out (8 bytes a
// channel of d_model in fp32) against three d_model × d_inner products
// (xin, z, out): 3 · 2 · 768 · 1536 FLOP a token at FastVim-B, ~2,300
// FLOP a byte. In 3xTF32 a product costs three TF32 products, so the bound
// is 3 × FLOP / 495 TFLOP/s (1.08 ms at FastVim-B, 224 px, B = 128), and
// the design spends its shared memory on keeping every product on chip:
// - Products (tf32.cuh): mma.sync m16n8k8, each fp32 operand split into
//   TF32 hi and lo in registers as its fragment is read, each k-step's
//   lo·hi + hi·lo + hi·hi summed in a fresh tile added in fp32 (mma3).
//   Operands stream through a ring of cp.async stages (fv::Ring): 4 of
//   25,344 bytes for xin and z (one 32-deep chunk of d_model: 48 x̂ rows
//   and 128 weight rows), 3 of 33,280 for out (16 channels: 32 g rows and
//   384 W_out rows), one ring at a time in the same 101,376 bytes.
// - A tile is kT = 32 consecutive tokens of the batch in conv order (the
//   raster on even layers, the column-major raster on odd ones) plus 3
//   halo tokens on each side: one flat conv-order index a row, masked
//   before the load past the batch; a tile may hold the end of one image
//   and the start of the next, and the conv masks each tap that would
//   cross an image's first or last token (the flat conv's zero padding).
//   Its 38 rows of x̂ (the 32 own tokens first, so that z reads the first
//   two m16 tiles as they lie, then the halo) are the A operand of xin in
//   three m16 tiles (kRows = 48, the last 10 zero); z and out take the 32
//   own rows.
// - LayerNorm needs each token's Σm and Σm² over all of d_inner before any
//   channel is gated, and m exists only on chip: 32 × 1,536 fp32 (196 KB)
//   at FastVim-B does not fit beside a ring in 227 KB. So a thread-block
//   cluster of C = max(⌈d_inner / 768⌉, ⌈d_model / 384⌉) CTAs (1 at
//   FastVim-T and -S, 2 at -B, 3 at -L, 4 at -H) shares a tile: CTA r owns
//   a slice of at most kRcSlice = 768 channels of d_inner and keeps their
//   m (≤ 98.8 KB). Three products a token, none of them twice:
//   1. per slab of 128 channels of its slice: xin = x̂·W_x[slab]ᵀ (48 ×
//      128; a warp on 16 channels of all three m tiles), + b_x into the
//      xin tile, then the dual width-4 conv, SiLU and the merge
//      m = ½(yf + D_f·xc_f + yb + D_b·xc_b) into the slice's m (a thread
//      a channel and 16 tokens, 7 rows of xin in registers);
//   2. each token's partial Σm and Σm² over the slice (a warp on 4 tokens,
//      lane l on channels l, l + 32, ... in order, then a butterfly),
//      swapped through distributed shared memory: every CTA adds the C
//      partials in rank order, so all hold the same μ and 1/σ (variance
//      E[m²] − μ², as K4 takes it);
//   3. per slab: z = x̂·W_z[slab]ᵀ (32 × 128), and the gate
//      LN(m)·silu(z + b_z) in place of m;
//   4. out = g·W_outᵀ + b_out for CTA r's group of at most kRcCols = 384
//      of d_model's columns over all of d_inner: each stage copies 16
//      channels of g from the CTA that owns them (distributed shared
//      memory) beside W_out's rows (cp.async); a warp holds 2 × 6 n-tiles
//      of accumulators, the k-steps in channel order.
//   Three cluster barriers: after the partial sums (with LayerNorm), after
//   the gate (every g is written before any is read), and before exit (no
//   CTA leaves while another reads its g).
// - Shared memory: the rings 101,376 bytes, the xin tile 25,344, m
//   32 × (slice + 4) × 4 ≤ 98,816: 225,536 bytes and the tables, one CTA
//   an SM of 8 warps (162 registers, no spills). Measured on an H100
//   (PERF.md §6): 4 xin / z stages ran 1.3 % faster than 3 at FastVim-B;
//   slices of 384 channels (4 CTAs a cluster at FastVim-B) 27 % slower
//   than 768, so the cluster is as small as the shared memory allows.
// Each call is one launch; no atomics, and every sum in a fixed order, so
// results repeat bit for bit. layer_fused.pass_b_recompute_tf32_plain
// models the products, the sums and the cluster split on the CPU.

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "layer_fused_fwd.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"  // cp.async, the ring of stages

namespace cg = cooperative_groups;

namespace {

using fv::cp_async16;
using fv::ld_f2;
using fv::smem_u32;

constexpr int kThreads = 256;  // 8 warps
constexpr int kPad = 3;        // d_conv - 1
constexpr int kRcMaxDm = 1280;  // the widest the kernel takes: FastVim-H's
constexpr int kRcMaxDi = 2560;
constexpr int kRcTok = 32;     // own tokens of a tile
constexpr int kRcSlice = 768;  // widest d_inner slice a CTA keeps m of
constexpr int kRcCols = 384;   // widest group of out columns a CTA forms
constexpr int kT = kRcTok;
constexpr int kExt = kT + 2 * kPad;  // own and halo rows: 38
constexpr int kRows = 48;            // rows of xin's A operand: 3 m16 tiles
constexpr int kSlab = 128;           // d_inner channels of a slab
constexpr int kK = 32;               // d_model of an xin / z stage
constexpr int kLd = kK + 4;          // its fp32 rows, skewed
constexpr int kKo = 16;              // d_inner of an out stage
constexpr int kLdO = kKo + 4;        // its fp32 rows, skewed
constexpr int kNT = kRcCols / 64;    // out's n-tiles a warp: 6
constexpr int kStagesX = 4;                     // the xin / z ring:
constexpr int kStageX = (kRows + kSlab) * kLd;  // floats a stage
constexpr int kStagesO = 3;                     // the out ring
constexpr int kStageO = (kT + kRcCols) * kLdO;
constexpr int kRing =  // floats of the rings' region, one ring at a time
    kStagesX * kStageX > kStagesO * kStageO ? kStagesX * kStageX
                                            : kStagesO * kStageO;
constexpr int kXLd = kSlab + 4;  // fp32 row of the xin tile, skewed

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// CTAs of a tile's cluster at these widths
__host__ __device__ inline int rc_ranks(int dm, int di) {
  const int a = cdiv(di, kRcSlice), b = cdiv(dm, kRcCols);
  return a > b ? a : b;
}
// first unit (of 32 channels or columns) of rank r's share of `units`
__host__ __device__ inline int share(int units, int r, int nranks) {
  return units * r / nranks;
}

// shared memory in bytes: the ring, the xin tile, m (rows of mld floats),
// then the partial sums, μ, 1/σ and the tables of rows
inline size_t rc_smem(int mld) {
  return (static_cast<size_t>(kRing) + kRows * kXLd +
          static_cast<size_t>(kT) * mld + 4 * kT) * sizeof(float) +
         (kRows + 2 * kT) * sizeof(int);
}

// Row of the tile holding the token at offset i in [-3, kT + 3) from its
// first own token: the own tokens first, then the halo before, then the
// halo after; and the offset a row r < kExt holds.
__device__ __forceinline__ int row_of(int i) {
  return i < 0 ? kT + kPad + i : (i < kT ? i : i + kPad);
}
__device__ __forceinline__ int offset_of(int r) {
  return r < kT ? r : (r < kT + kPad ? r - kT - kPad : r - kPad);
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// grid: tiles × C, a cluster of C CTAs a tile (cluster rank r: its slice
// of d_inner and its group of out columns)
__global__ void __launch_bounds__(kThreads, 1)
pass_b_rc_tf32_kernel(const float* __restrict__ x,
                      const float* __restrict__ yf,
                      const float* __restrict__ yb,
                      const float* __restrict__ w_x,
                      const float* __restrict__ b_x,
                      const float* __restrict__ w_cf,
                      const float* __restrict__ b_cf,
                      const float* __restrict__ w_ab,
                      const float* __restrict__ b_ab,
                      const float* __restrict__ w_z,
                      const float* __restrict__ b_z,
                      const float* __restrict__ d_f,
                      const float* __restrict__ d_b,
                      const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b,
                      const float* __restrict__ w_out,
                      const float* __restrict__ b_out,
                      float* __restrict__ out, int ntok, int H, int W, int dm,
                      int di, bool transposed, bool use_ln, float eps,
                      int nranks, int mld) {
  extern __shared__ __align__(16) float smem_rc[];
  float* s_xin = smem_rc + kRing;                      // [kRows][kXLd]
  float* s_m = s_xin + kRows * kXLd;                   // [kT][mld]
  float* s_part = s_m + static_cast<size_t>(kT) * mld;  // Σm, Σm² [2][kT]
  float* s_mu = s_part + 2 * kT;                       // [kT]
  float* s_rstd = s_mu + kT;                           // [kT]
  int* s_tok = reinterpret_cast<int*>(s_rstd + kT);    // [kRows]
  int* s_q = s_tok + kRows;                            // [kT]
  int* s_prow = s_q + kT;                              // [kT]
  const uint32_t ring_base = smem_u32(smem_rc);
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = static_cast<int>(cluster.block_rank());
  const int g0 = static_cast<int>(blockIdx.x) / nranks * kT;
  const int L = H * W, P = transposed ? W : H, ln = transposed ? H : W;
  const int udi = di / 32, udm = dm / 32;
  const int c_lo = 32 * share(udi, rank, nranks);  // the slice of d_inner
  const int sw = 32 * share(udi, rank + 1, nranks) - c_lo;
  const int o_lo = 32 * share(udm, rank, nranks);  // the group of columns
  const int ocols = 32 * share(udm, rank + 1, nranks) - o_lo;

  // the tables: the token (in memory) of each row, -1 outside the batch
  // and for the padding rows; each own token's place in its image's conv
  // order (-1 past the batch) and its pooled row b·P + line
  if (tid < kRows) {
    int tk = -1;
    if (tid < kExt) {
      const int G = g0 + offset_of(tid);
      if (G >= 0 && G < ntok) {
        const int b = G / L, q = G - b * L;
        tk = b * L + (transposed ? (q % H) * W + q / H : q);
        if (tid < kT) {
          s_q[tid] = q;
          s_prow[tid] = b * P + q / ln;
        }
      } else if (tid < kT) {
        s_q[tid] = -1;
        s_prow[tid] = 0;
      }
    }
    s_tok[tid] = tk;
  }
  __syncthreads();

  // ---- stages 1 and 3: xin and z by slabs of the slice, one ring ------
  const int nk = dm / kK, nslab = cdiv(sw, kSlab);
  const int n1 = nslab * nk, n12 = 2 * n1;
  const int ch = tid & 7;  // the 16-byte column of a 32-float chunk row
  auto fetch = [&](int s, uint32_t dst) {
    if (s >= n12) return;
    const bool xin = s < n1;
    const int s2 = xin ? s : s - n1;
    const int n0 = s2 / nk * kSlab, k0 = s2 % nk * kK + 4 * ch;
    const float* w = xin ? w_x : w_z;
#pragma unroll
    for (int it = 0; it < 2; ++it) {  // x̂: 48 rows for xin, 32 for z
      const int r = (tid >> 3) + 32 * it;
      if (r >= (xin ? kRows : kT)) break;
      const int tk = s_tok[r];
      cp_async16(dst + (r * kLd + 4 * ch) * 4,
                 x + (tk >= 0 ? static_cast<size_t>(tk) * dm + k0 : 0),
                 tk >= 0);
    }
#pragma unroll
    for (int it = 0; it < kSlab / 32; ++it) {  // the slab's weight rows
      const int r = (tid >> 3) + 32 * it;
      const bool ok = n0 + r < sw;
      cp_async16(dst + ((kRows + r) * kLd + 4 * ch) * 4,
                 w + (ok ? static_cast<size_t>(c_lo + n0 + r) * dm + k0 : 0),
                 ok);
    }
  };
  fv::Ring<kStagesX, kStageX * 4, decltype(fetch)> ring(ring_base, fetch);
  ring.start();
  const bool all[3] = {true, true, true};

  // 1. xin, the conv and the merge, slab by slab, into m
  for (int n0 = 0; n0 < sw; n0 += kSlab) {
    const bool on = n0 + 16 * warp < sw;  // sw % 32 == 0: whole warps
    float acc[3][2][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      const float* st = smem_rc + (ring.acquire() - ring_base) / 4;
      if (on) {
#pragma unroll
        for (int kk = 0; kk < kK / 8; ++kk) {
          uint32_t ah[3][4], al[3][4], bh[2][2], bl[2][2];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            frag_a(st + 16 * i * kLd + 8 * kk, kLd, lane, ah[i], al[i]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            frag_b(st + (kRows + 16 * warp + 8 * j) * kLd + 8 * kk, kLd, lane,
                   bh[j], bl[j]);
          mma3<3, 2>(&acc[0][0][0], 2, all, ah, al, bh, bl);
        }
      }
      ring.refill();
    }
    // + b_x into the xin tile; rows without a token 0 (the zero padding
    // past the batch; the conv masks the taps across images). The last
    // acquire's barrier came after the conv of the slab before read it.
    if (on) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * warp + 8 * j + 2 * t;
        const float2 bx =
            b_x ? ld_f2(b_x + c_lo + n0 + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = 16 * i + g + 8 * e;
            const bool valid = s_tok[row] >= 0;
            *reinterpret_cast<float2*>(s_xin + row * kXLd + col) =
                valid ? make_float2(acc[i][j][2 * e] + bx.x,
                                    acc[i][j][2 * e + 1] + bx.y)
                      : make_float2(0.f, 0.f);
          }
      }
    }
    __syncthreads();

    // the dual conv, SiLU and the merge: a thread on one channel and 16
    // own tokens, the 7 rows a token needs in a window of registers;
    // tokens past the batch get m = 0
    const int c = tid & (kSlab - 1), i0 = (tid >> 7) * 16;
    if (n0 + c < sw) {
      const int cg_ = c_lo + n0 + c;  // the channel in d_inner
      float wc[4], wa[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wc[k] = w_cf[cg_ * 4 + k];
        wa[k] = w_ab[cg_ * 4 + k];
      }
      const float bc = b_cf ? b_cf[cg_] : 0.f, ba = b_ab ? b_ab[cg_] : 0.f;
      const float df = d_f[cg_], db = d_b[cg_];
      float xw[7];
#pragma unroll
      for (int k = 0; k < 6; ++k)
        xw[k] = s_xin[row_of(i0 - kPad + k) * kXLd + c];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int tt = i0 + i;
        xw[6] = s_xin[row_of(tt + kPad) * kXLd + c];
        const int q = s_q[tt];
        // loaded at a clamped row, not in a branch
        const size_t po = static_cast<size_t>(s_prow[tt]) * di + cg_;
        const float pf = __ldg(yf + po), pb = __ldg(yb + po);
        const int rq = L - 1 - q;  // tokens after this one in its image
        // xc_f[t] = silu(Σ_k x[t-3+k]·w_c[k] + b), xc_b[t] = silu(Σ_k
        // x[t+k]·w_a[3-k] + b), taps outside the image 0
        const float yc = (q >= 3 ? xw[0] : 0.f) * wc[0] +
                         (q >= 2 ? xw[1] : 0.f) * wc[1] +
                         (q >= 1 ? xw[2] : 0.f) * wc[2] + xw[3] * wc[3] + bc;
        const float ya = xw[3] * wa[3] + (rq >= 1 ? xw[4] : 0.f) * wa[2] +
                         (rq >= 2 ? xw[5] : 0.f) * wa[1] +
                         (rq >= 3 ? xw[6] : 0.f) * wa[0] + ba;
        const float m =
            (pf + df * fv::silu(yc) + pb + db * fv::silu(ya)) * 0.5f;
        s_m[tt * mld + n0 + c] = q >= 0 ? m : 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) xw[k] = xw[k + 1];
      }
    }
  }

  // 2. the LayerNorm statistics over all of d_inner: the slice's partial
  // sums, a warp on 4 tokens, swapped across the cluster and added in
  // rank order by every CTA
  if (use_ln) {
    __syncthreads();  // every m of the slice is written
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tt = 4 * warp + e;
      float sum = 0.f, sumsq = 0.f;
      for (int c = lane; c < sw; c += 32) {
        const float v = s_m[tt * mld + c];
        sum += v;
        sumsq += v * v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
      }
      if (lane == 0) {
        s_part[tt] = sum;
        s_part[kT + tt] = sumsq;
      }
    }
    cluster.sync();  // every CTA's partial sums are written
    if (tid < kT) {
      float sum = 0.f, sumsq = 0.f;
      for (int r = 0; r < nranks; ++r) {
        const float* p = cluster.map_shared_rank(s_part, r);
        sum += p[tid];
        sumsq += p[kT + tid];
      }
      const float mu = sum / static_cast<float>(di);
      s_mu[tid] = mu;  // variance E[m²] - μ², unclamped
      s_rstd[tid] = rsqrtf(sumsq / static_cast<float>(di) - mu * mu + eps);
    }
  }

  // 3. z and the gate, slab by slab, in place of m (the acquires' barriers
  // publish μ and 1/σ)
  for (int n0 = 0; n0 < sw; n0 += kSlab) {
    const bool on = n0 + 16 * warp < sw;
    float z[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[i][j][e] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      const float* st = smem_rc + (ring.acquire() - ring_base) / 4;
      if (on) {
#pragma unroll
        for (int kk = 0; kk < kK / 8; ++kk) {
          uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            frag_a(st + 16 * i * kLd + 8 * kk, kLd, lane, ah[i], al[i]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            frag_b(st + (kRows + 16 * warp + 8 * j) * kLd + 8 * kk, kLd, lane,
                   bh[j], bl[j]);
          mma3<2, 2>(&z[0][0][0], 2, all, ah, al, bh, bl);
        }
      }
      ring.refill();
    }
    if (on) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + 16 * warp + 8 * j + 2 * t;  // in the slice
        const int cc = c_lo + col;
        const float2 bz = b_z ? ld_f2(b_z + cc) : make_float2(0.f, 0.f);
        const float2 lw = use_ln ? ld_f2(ln_w + cc) : make_float2(1.f, 1.f);
        const float2 lb = use_ln ? ld_f2(ln_b + cc) : make_float2(0.f, 0.f);
        const float lwv[2] = {lw.x, lw.y}, lbv[2] = {lb.x, lb.y};
        const float bzv[2] = {bz.x, bz.y};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = 16 * i + g + 8 * e;
            float2* p = reinterpret_cast<float2*>(s_m + row * mld + col);
            const float2 mv = *p;
            const float m[2] = {mv.x, mv.y};
            float gv[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v =
                  use_ln ? (m[h] - s_mu[row]) * s_rstd[row] * lwv[h] + lbv[h]
                         : m[h];
              gv[h] = v * fv::silu(z[i][j][2 * e + h] + bzv[h]);
            }
            *p = make_float2(gv[0], gv[1]);
          }
      }
    }
  }
  fv::cp_async_wait<0>();  // the ring's last (empty) groups
  cluster.sync();          // every g of the tile is written

  // 4. out = g·W_out[group]ᵀ + b_out over all of d_inner: a stage holds 16
  // channels of g, copied from the CTA whose slice holds them, and the
  // group's W_out rows of those channels
  const int no = ocols > 0 ? di / kKo : 0;
  auto fetch_o = [&](int s, uint32_t dst) {
    if (s >= no) return;
    const int k0 = s * kKo;
    int r = 0;  // the rank whose slice holds channels k0.. (whole 32s)
    while (32 * share(udi, r + 1, nranks) <= k0) ++r;
    if (tid < kT * kKo / 4) {
      const int row = tid >> 2, q4 = tid & 3;
      const float* src = cluster.map_shared_rank(s_m, r) + row * mld + k0 -
                         32 * share(udi, r, nranks) + 4 * q4;
      st_shared4(dst + (row * kLdO + 4 * q4) * 4,
                 *reinterpret_cast<const float4*>(src));
    }
    for (int i = tid; i < ocols * (kKo / 4); i += kThreads) {
      const int r2 = i >> 2, h = i & 3;
      cp_async16(dst + ((kT + r2) * kLdO + 4 * h) * 4,
                 w_out + static_cast<size_t>(o_lo + r2) * di + k0 + 4 * h);
    }
  };
  fv::Ring<kStagesO, kStageO * 4, decltype(fetch_o)> ring_o(ring_base,
                                                           fetch_o);
  ring_o.start();
  float oacc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][j][e] = 0.f;
  for (int s = 0; s < no; ++s) {
    const float* st = smem_rc + (ring_o.acquire() - ring_base) / 4;
#pragma unroll
    for (int kk = 0; kk < kKo / 8; ++kk) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        frag_a(st + 16 * i * kLdO + 8 * kk, kLdO, lane, ah[i], al[i]);
#pragma unroll
      for (int j0 = 0; j0 < kNT; j0 += 3) {
        if (64 * j0 + 8 * warp >= ocols) break;
        // n-tiles past the group read rows no copy wrote; never stored
        uint32_t bh[3][2], bl[3][2];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          frag_b(st + (kT + 64 * (j0 + j) + 8 * warp) * kLdO + 8 * kk, kLdO,
                 lane, bh[j], bl[j]);
        mma3<2, 3>(&oacc[0][j0][0], kNT, all, ah, al, bh, bl);
      }
    }
    ring_o.refill();
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (64 * j + 8 * warp >= ocols) continue;
    const int col = o_lo + 64 * j + 8 * warp + 2 * t;
    const float2 bo = b_out ? ld_f2(b_out + col) : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tk = s_tok[16 * i + g + 8 * e];
        if (tk >= 0)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(tk) * dm +
                                     col) =
              make_float2(oacc[i][j][2 * e] + bo.x,
                          oacc[i][j][2 * e + 1] + bo.y);
      }
  }
  cluster.sync();  // no CTA leaves while another reads its g
}

}  // namespace

namespace fvf {

cudaError_t pass_b_recompute_fwd_f32(
    const void* x, const void* yf, const void* yb, const void* w_x,
    const void* b_x, const void* w_cf, const void* b_cf, const void* w_ab,
    const void* b_ab, const void* w_z, const void* b_z, const void* d_f,
    const void* d_b, const void* ln_w, const void* ln_b, const void* w_out,
    const void* b_out, void* out, int batch, int H, int W, int dm, int di,
    bool transposed, bool use_ln, float eps, cudaStream_t stream) {
  if (dm % 32 != 0 || dm > kRcMaxDm || di % 32 != 0 || di > kRcMaxDi)
    return cudaErrorInvalidValue;
  const long ntok = static_cast<long>(batch) * H * W;
  const int nranks = rc_ranks(dm, di);
  const long blocks = (ntok + kT - 1) / kT * nranks;
  if (ntok > INT_MAX - kT || blocks > INT_MAX) return cudaErrorInvalidValue;
  const int mld = 32 * cdiv(di / 32, nranks) + 4;  // ≡ 4 (mod 32)
  const size_t smem = rc_smem(mld);
  if (smem > fv::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<pass_b_rc_tf32_kernel>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  err = cudaLaunchKernelEx(
      &cfg, pass_b_rc_tf32_kernel, cF(x), cF(yf), cF(yb), cF(w_x), cF(b_x),
      cF(w_cf), cF(b_cf), cF(w_ab), cF(b_ab), cF(w_z), cF(b_z), cF(d_f),
      cF(d_b), cF(ln_w), cF(ln_b), cF(w_out), cF(b_out),
      static_cast<float*>(out), static_cast<int>(ntok), H, W, dm, di,
      transposed, use_ln, eps, nranks, mld);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace fvf
