// K7 in bf16, for Hopper (sm_90a): pass B of the fused FastVim mixer
// layer in its recompute form, on warpgroup matrix products. What it
// computes is set out at the head of layer_fused_recompute.cu (the TPU
// kernels it replaces: `_pass_b_{even,odd}_kernel` of
// fastvim_tpu/ops/pallas/layer_fused.py, conv stage `_conv_stage_even` /
// `_conv_stage_odd`, tail `_merge_tail`); this file is how the bf16 path
// computes it. It joins the front of K3 to the back of K4
// (layer_fused_fwd_wgmma.cu), with xc never leaving the chip.
//
// What bounds it: operations. A token reads x̂ and writes out (768 bytes
// at d_model 192) against three d_model × d_inner GEMMs (0.44 MFLOP at
// FastVim-T's widths), ~580 FLOP per byte, above the ~295 at which bf16
// tensor cores limit. So the products run on `wgmma` from shared memory:
// - A block of two warpgroups owns 64 consecutive tokens of one image in
//   conv order (the raster on even layers, the column-major raster on odd
//   ones, where neighbours lie a whole row apart in memory), plus 3 halo
//   tokens on each side that cross lines as the flat conv does; tokens
//   outside the sequence are zero-filled, not read. Its x̂ comes once into
//   128-byte-swizzled tiles of 72 rows: the 64 own tokens first, so that
//   the z GEMM's A operand is the first M tile as it lies, then the 3 + 3
//   halo rows and 2 zero rows. xin covers those rows in two M tiles, rows
//   0-63 and 8-71, of which the second keeps only its halo rows: the price
//   of the halo at 64 tokens. The token of each row is looked up once into
//   a table (no 64-bit division in the loops).
// - Weights stream through a ring of 16 KB `cp.async` stages as K-major B
//   operands as they lie (fv::Ring): 5 or 6 stages, as many as the shared
//   memory left takes; W_x two K blocks a stage.
// - d_inner is walked in conv slabs of 64 channels (xin = x̂·W_x[slab]ᵀ, a
//   warpgroup on 32 of them, + b_x into an fp32 tile; then the dual conv,
//   SiLU and the merge m = ½(yf + D_f·xc_f + yb + D_b·xc_b) from that tile
//   with each thread on 4 channels of 4 consecutive tokens) and in gate
//   slabs of 128 (z = x̂·W_z[slab]ᵀ in registers, the gate
//   LN(m)·silu(z + b_z) on the fragments, rounded to bf16 into a swizzled
//   tile, in the xin tile's place, that is the A operand of out +=
//   g·W_out[:, slab]ᵀ, which accumulates in registers across slabs, the
//   two warpgroups splitting d_model, as K4 does). The global operands of
//   the merge (yf, yb, the conv weights, D) and of the gate are loaded
//   before the GEMM they follow, so that their latency passes under it:
//   with one block an SM nothing else hides it.
// - LayerNorm over all of d_inner must finish before any channel is
//   gated, and m exists only on chip. So d_inner is walked twice. The first
//   walk runs the conv slabs and keeps each token's Σm and Σm² (per slab, a
//   thread's 4 channels in order, then a butterfly over the 16 threads of
//   a row, added slab after slab: the order of
//   layer_fused.pass_b_recompute_slabs_plain). Where the tile's m fits in
//   shared memory (d_model <= 192, d_inner <= 384: FastVim-T) the first
//   walk keeps it there and the second walk runs the gate slabs from it
//   (design "whole"); else the first walk keeps the halo rows' xin, and the
//   second runs each gate slab's conv slabs again over the own rows only,
//   a fourth GEMM a token (design "twice": FastVim-S; without LayerNorm too,
//   for the halo rows).
// - Past d_model 384 or d_inner 768 (FastVim-B/L/H, up to kRcMaxDm and
//   kRcMaxDi) the wide form. The x̂ tile alone would take 184 KB at
//   d_model 1280 and out's accumulators 320 registers a thread, so, as
//   K4's wide form (layer_fused_fwd_wgmma.cu) does: a block owns 64 tokens
//   and a group of at most 384 d_model columns of out (a grid of column
//   groups × token tiles, the groups of a tile side by side so that they
//   share its x̂ in L2), and x̂ streams through the ring, each stage
//   carrying the 72 rows of its K block beside its W_x or W_z block, one
//   K block a stage, as K3's streamed form does. Each group runs the
//   "twice" design over all of d_inner: the conv and z products run once
//   for each group (2× at FastVim-B, 3× at -L, 4× at -H), out's once in
//   all. Its halo rows' xin stays on chip (61 KB at d_inner 2560); the
//   out rows leave through the ring's memory.
// - d_model that is not a multiple of 64 is zero-padded in shared memory,
//   d_inner that is not a multiple of 64 or 128 likewise: copies of the
//   missing rows and columns are zero-filled, and m of a missing channel
//   is 0.
// Each call is one launch; no atomics, so results repeat bit for bit.

#include <type_traits>

#include "layer_fused_fwd.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using fv::cp_async16;
using fv::gmma_desc;
using fv::kMaxSmem;
using fv::ld_f2;
using fv::silu_fast;
using fv::smem_u32;
using fv::swz;

constexpr int kThreads = 256;                // two warpgroups
constexpr int kTM = 64;                      // tokens a block owns: wgmma's M
constexpr int kPad = 3;                      // d_conv - 1
constexpr int kExt = kTM + 2 * kPad;         // own and halo rows: 70
constexpr int kRows = 72;                    // rows of the x̂ tile
constexpr int kRowBytes = fv::kBlkRowBytes;  // 64 bf16 of a tile row
constexpr int kBlkBytes = kTM * kRowBytes;   // a 64 × 64 bf16 block
constexpr int kXBlk = kRows * kRowBytes;     // a 64-column block of x̂
constexpr int kCS = 64;                      // conv slab: d_inner channels
constexpr int kGS = 128;                     // gate slab
constexpr int kStageBytes = 2 * kBlkBytes;   // 128 rows or 128 K of a weight
constexpr int kXLd = kCS + 4;                // fp32 row of the xin tile
constexpr int kMLd = kGS + 4;                // fp32 row of a gate slab's m
constexpr int kWholeNU = 3;                  // "whole": d_model <= 192 ...
constexpr int kWholeDi = 384;                // ... and d_inner <= 384
constexpr int kNarrowNU = 6;                 // x̂ whole on chip: d_model <= 384
constexpr int kNarrowDi = 768;               // ... and d_inner <= 768
constexpr int kRcMaxDm = 1280;               // the widest the wide form takes:
constexpr int kRcMaxDi = 2560;               // FastVim-H's
constexpr int kWideOU = 6;                   // out columns of a wide block / 64
constexpr int kHalo = 2 * kPad;              // halo rows a "twice" tile keeps
// a stage of the wide form: a weight stage and the x̂ block of its K step
constexpr int kWideStageBytes = kStageBytes + kXBlk;

// stages of the weight ring (kNU 0: the wide form), as many as the shared
// memory left takes, and their bytes
__host__ __device__ constexpr int rc_stages(int nu, bool whole) {
  return nu == 0 ? 4 : (whole ? 5 : 6);
}
__host__ __device__ constexpr int rc_stage_bytes(int nu) {
  return nu == 0 ? kWideStageBytes : kStageBytes;
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
// d_inner rounded up to whole conv slabs, whose missing channels hold 0
__host__ __device__ inline int round_cs(int di) {
  return (di + kCS - 1) / kCS * kCS;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

struct ConvIn {  // a thread's operands of the merge, see conv_load
  uint2 yf[4], yb[4];  // bf16 × 4 of 4 rows
  float wc[4][4], wa[4][4], bc[4], ba[4], df[4], db[4];
};

struct RcSmem {  // byte offsets from the 1024-aligned base
  size_t x, ring, out, xin, m, halo, stats, total;
};
// "whole": m of the whole tile stays; else ("twice") a gate slab's m and
// the halo rows' xin of all of d_inner. nu 0: the wide form ("twice"),
// whose x̂ blocks come through the ring
__host__ __device__ inline RcSmem rc_smem(int nu, bool whole, int di) {
  RcSmem L;
  L.x = 0;  // x̂: nu blocks of 72 rows
  L.ring = static_cast<size_t>(nu) * kXBlk;
  // the out rows at the end, in 72-row blocks: x̂'s, or the ring's memory
  L.out = nu ? L.x : L.ring;
  // the xin tile, and in its place once the conv has read it the gated
  // slab (2 swizzled blocks, 16 KB)
  L.xin = L.ring + static_cast<size_t>(rc_stages(nu, whole)) *
                       rc_stage_bytes(nu);
  L.m = L.xin + static_cast<size_t>(kExt) * kXLd * sizeof(float);
  L.halo = L.m + static_cast<size_t>(kTM) *
                     (whole ? round_cs(di) + 4 : kMLd) * sizeof(float);
  L.stats = L.halo + (whole ? 0 : static_cast<size_t>(kHalo) *
                                      round_cs(di) * sizeof(float));
  // mu, rstd [64] fp32; pooled row of each own token [64] and token of
  // each x̂ row [72] int
  L.total = L.stats + (3 * kTM + kRows) * sizeof(float) + 1024;
  return L;
}

__device__ __forceinline__ void lds_f4(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void ldg_f4(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

// kNU = ceil(d_model / 64) <= kNarrowNU, x̂ whole on chip; kNU = 0, the
// wide form, over the column group blockIdx.x % ngroups
template <int kNU, bool kWhole>
__global__ void __launch_bounds__(kThreads, 1)
pass_b_rc_wgmma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ yf,
    const bf16* __restrict__ yb, const bf16* __restrict__ w_x,
    const float* __restrict__ b_x, const float* __restrict__ w_cf,
    const float* __restrict__ b_cf, const float* __restrict__ w_ab,
    const float* __restrict__ b_ab, const bf16* __restrict__ w_z,
    const float* __restrict__ b_z, const float* __restrict__ d_f,
    const float* __restrict__ d_b, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, const bf16* __restrict__ w_out,
    const float* __restrict__ b_out, bf16* __restrict__ out, int H, int W,
    int dm, int di, bool transposed, bool use_ln, float eps) {
  constexpr bool kWide = kNU == 0;
  static_assert(!(kWide && kWhole), "the wide form walks d_inner twice");
  constexpr int kOU = kWide ? kWideOU : kNU;  // 64-column units of out
  constexpr int kStages = rc_stages(kNU, kWhole);
  constexpr int kKB = kWide ? 1 : 2;  // K blocks of W_x a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const RcSmem L = rc_smem(kNU, kWhole, di);
  const int ldm = kWhole ? round_cs(di) + 4 : kMLd;
  const int ldh = round_cs(di);  // row of the halo rows' xin
  const uint32_t sx = smem_u32(sm + L.x), sg = smem_u32(sm + L.xin);
  float* s_xin = reinterpret_cast<float*>(sm + L.xin);    // [70][kXLd]
  float* s_m = reinterpret_cast<float*>(sm + L.m);        // [64][ldm]
  float* s_halo = reinterpret_cast<float*>(sm + L.halo);  // [6][ldh]
  float* s_mu = reinterpret_cast<float*>(sm + L.stats);   // [64]
  float* s_rstd = s_mu + kTM;                             // [64]
  int* s_prow = reinterpret_cast<int*>(s_rstd + kTM);     // [64]
  int* s_tok = s_prow + kTM;                              // [72]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  const int nu = kWide ? (dm + 63) / 64 : kNU;  // K blocks of d_model
  const int ngroups = kWide ? (nu + kOU - 1) / kOU : 1;
  const int c0 = kWide ? static_cast<int>(blockIdx.x) % ngroups * 64 * kOU
                       : 0;
  const int dmo = kWide ? imin(64 * kOU, dm - c0) : dm;  // its out columns
  const long seq = static_cast<long>(H) * W;
  const long q0 =  // first own token
      static_cast<long>(blockIdx.x) / ngroups * kTM;
  const int b = blockIdx.y;
  const size_t img = static_cast<size_t>(b) * seq;
  const int ln = transposed ? H : W, P = transposed ? W : H;
  const int ncs = (di + kCS - 1) / kCS, ngs = (di + kGS - 1) / kGS;
  const int xs = kWide ? nu : (kNU + 1) / 2;  // stages of W_x a conv slab
  const int s1 = ncs * xs;                    // stages of the first walk
  const int per_gs = (kWhole ? 0 : 2 * xs) + nu + kOU;
  const int total = s1 + (kWhole ? 0 : ncs * xs) + ngs * (nu + kOU);

  // memory index of the token at conv position p of the image, or -1
  // outside the sequence
  auto token = [&](long p) -> long {
    if (p < 0 || p >= seq) return -1;
    return transposed ? (p % H) * W + p / H : p;
  };
  // conv position of x̂ tile row r < kExt: own rows, then the halo before
  // and the halo after
  auto row_pos = [&](int r) -> long {
    return q0 + (r < kTM ? r : (r < kTM + kPad ? r - kTM - kPad : r - kPad));
  };

  // the token of each x̂ row in the image (-1 outside the sequence and
  // for rows 70-71) and the pooled row (b·P + line) of each own token
  if (tid < kRows) {
    s_tok[tid] = tid < kExt ? static_cast<int>(token(row_pos(tid))) : -1;
  } else if (tid >= 128 && tid < 128 + kTM) {
    const long p = q0 + tid - 128 < seq ? q0 + tid - 128 : seq - 1;
    s_prow[tid - 128] = static_cast<int>(b * P + p / ln);
  }
  __syncthreads();

  // stage s. First walk: per conv slab xs stages of W_x's 64 rows, kKB K
  // blocks each (32 rows a warpgroup). Second walk, per gate slab:
  // ("twice") the xs stages of each of its conv slabs, then nu K blocks
  // of W_z's 128 rows (64 a warpgroup), then kOU stages of W_out's columns
  // c0.. (fv::cp_out_stage). The wide form's W_x and W_z stages also carry
  // the x̂ rows of their K block, as the x̂ tile below holds them. Rows and
  // columns past the widths zero-filled.
  auto fetch = [&](int s, uint32_t dst) {
    if (s >= total) return;
    int n0, kb, kind;  // kind 0: W_x, K blocks kKB·kb..; 1: W_z; 2: W_out
    if (s < s1) {
      n0 = s / xs * kCS;
      kb = s % xs;
      kind = 0;
    } else {
      const int r = s - s1, g = r / per_gs, k = r % per_gs;
      const int nc = kWhole ? 0 : imin(2, ncs - 2 * g);  // its conv slabs
      n0 = g * kGS;
      if (k < nc * xs) {
        n0 += k / xs * kCS;
        kb = k % xs;
        kind = 0;
      } else if (k < nc * xs + nu) {
        kb = k - nc * xs;
        kind = 1;
      } else {
        kb = k - nc * xs - nu;
        kind = 2;
      }
    }
    if (kind == 0) {
      for (int i = tid; i < kTM * 8 * kKB; i += kThreads) {
        const int r = i / (8 * kKB), h = (i >> 3) % kKB, ch = i & 7;
        const int col = 64 * (kKB * kb + h) + 8 * ch;
        const bool ok = n0 + r < di && col < dm;
        cp_async16(dst + h * kBlkBytes + swz(r, 8 * ch),
                   w_x + (ok ? static_cast<size_t>(n0 + r) * dm + col : 0),
                   ok);
      }
    } else if (kind == 1) {
      for (int i = tid; i < 2 * kTM * 8; i += kThreads) {
        const int r = i >> 3, ch = i & 7, col = 64 * kb + 8 * ch;
        const bool ok = n0 + r < di && col < dm;
        cp_async16(dst + (r / kTM) * kBlkBytes + swz(r % kTM, 8 * ch),
                   w_z + (ok ? static_cast<size_t>(n0 + r) * dm + col : 0),
                   ok);
      }
    } else {
      fv::cp_out_stage(dst, w_out + static_cast<size_t>(c0) * di, n0, kb,
                       kOU, dmo, di, tid);
    }
    if (kWide && kind != 2) {  // x̂ rows of K block kb: all 72 for W_x
      const int rows = kind == 0 ? kRows : kTM;
      for (int i = tid; i < rows * 8; i += kThreads) {
        const int r = i >> 3, ch = i & 7, col = 64 * kb + 8 * ch;
        const int t = s_tok[r];
        const bool ok = t >= 0 && col < dm;
        cp_async16(dst + kStageBytes + swz(r, 8 * ch),
                   x + (ok ? (img + t) * dm + col : 0), ok);
      }
    }
  };
  fv::Ring<kStages, rc_stage_bytes(kNU), decltype(fetch)> ring(
      smem_u32(sm + L.ring), fetch);
  ring.start();

  // x̂ of the 72 rows; rows without a token and columns past d_model
  // zero-filled
  if constexpr (!kWide) {
    for (int i = tid; i < kRows * 8 * kNU; i += kThreads) {
      const int r = i / (8 * kNU), c = i % (8 * kNU);
      const int t = s_tok[r];
      const bool ok = t >= 0 && 8 * c < dm;
      cp_async16(sx + (c / 8) * kXBlk + swz(r, (c % 8) * 8),
                 x + (ok ? (img + t) * dm + 8 * c : 0), ok);
    }
    fv::cp_async_commit();
    fv::cp_async_wait<0>();  // the first acquire's barrier publishes it
  }

  const int r0 = 16 * w4 + rq;  // this thread's rows of an M tile
  const int cg = tid % 16, i0 = 4 * (tid / 16);  // conv: 4 channels, rows

  // xin = x̂·W_x[n0..n0+63]ᵀ + b_x into the fp32 tile, by extended index
  // (row 3 + i holds own token i); rows outside the sequence 0. Over two
  // M tiles (kT = 2), issued alike so that no product sits in a branch,
  // of which the second keeps only the halo rows 64-69, copied also to
  // s_halo ("twice"); or over the own rows only (kT = 1), the halo rows
  // from s_halo.
  auto xin_slab = [&](int n0, auto tiles) {
    constexpr int kT = decltype(tiles)::value;
    float2 bx[4];  // b_x of this thread's columns, loaded ahead
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = imin(n0 + 32 * wg + 8 * jj + 2 * q, di - 2);
      bx[jj] = b_x ? ld_f2(b_x + c) : make_float2(0.f, 0.f);
    }
    float acc[kT][16];
#pragma unroll
    for (int k2 = 0; k2 < xs; ++k2) {
      const uint32_t sw = ring.acquire();
      const uint32_t st = sw + wg * 32 * kRowBytes;
      fv::wgmma_fence();
#pragma unroll
      for (int h = 0; h < kKB; ++h) {
        const int kb = kKB * k2 + h;
        if (kWide || kb < kNU) {  // known at compile time
#pragma unroll
          for (int t = 0; t < kT; ++t) {
            const uint32_t a0 = (kWide ? sw + kStageBytes : sx + kb * kXBlk) +
                                t * 8 * kRowBytes;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              fv::wgmma_n32<0, 0>(acc[t], gmma_desc(a0 + 32 * kk),
                                  gmma_desc(st + h * kBlkBytes + 32 * kk),
                                  (kb | kk) != 0);
          }
        }
      }
      fv::wgmma_commit();
      ring.refill();
      fv::wgmma_wait();
    }
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * t + r0 + 8 * e;
        if ((t == 1 && row < kTM) || row >= kExt) continue;
        const int j = row < kTM ? row + kPad : (row < kTM + kPad ? row - kTM
                                                                  : row);
        const bool valid = s_tok[row] >= 0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int cl = 32 * wg + 8 * jj + 2 * q, c = n0 + cl;
          const float2 v =
              valid ? make_float2(acc[t][4 * jj + 2 * e] + bx[jj].x,
                                  acc[t][4 * jj + 2 * e + 1] + bx[jj].y)
                    : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(s_xin + j * kXLd + cl) = v;
          if (!kWhole && t == 1)  // halo row j = 0-2 or 67-69
            *reinterpret_cast<float2*>(
                s_halo + (j < kPad ? j : j - kTM) * ldh + c) = v;
        }
      }
    if (kT == 1) {
      for (int i = tid; i < kHalo * kCS / 2; i += kThreads) {
        const int hr = i / (kCS / 2), cl = 2 * (i % (kCS / 2));
        *reinterpret_cast<float2*>(
            s_xin + (hr < kPad ? hr : hr + kTM) * kXLd + cl) =
            *reinterpret_cast<const float2*>(s_halo + hr * ldh + n0 + cl);
      }
    }
    __syncthreads();
  };
  using Two = std::integral_constant<int, 2>;
  using One = std::integral_constant<int, 1>;

  // the global operands of a conv slab's merge for this thread's 4
  // channels of 4 rows, loaded before the slab's xin GEMM so that their
  // latency passes under it
  auto conv_load = [&](int n0) {
    ConvIn ci;
    const int cc = imin(n0 + 4 * cg, di - 4);  // in range; masked later
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const size_t po = static_cast<size_t>(s_prow[i0 + r]) * di + cc;
      ci.yf[r] = fv::load4(yf + po);
      ci.yb[r] = fv::load4(yb + po);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ldg_f4(w_cf + 4 * (cc + e), ci.wc[e]);
      ldg_f4(w_ab + 4 * (cc + e), ci.wa[e]);
    }
    ldg_f4(d_f + cc, ci.df);
    ldg_f4(d_b + cc, ci.db);
#pragma unroll
    for (int e = 0; e < 4; ++e) ci.bc[e] = ci.ba[e] = 0.f;
    if (b_cf) ldg_f4(b_cf + cc, ci.bc);
    if (b_ab) ldg_f4(b_ab + cc, ci.ba);
    return ci;
  };

  // dual conv + SiLU + merge of the conv slab at n0 from the xin tile: m
  // of own rows i0..i0+3 and channels n0 + 4cg.. into dst (row stride ld,
  // the slab's first channel at dst); with `stats`, each row's Σm and Σm²
  // over the slab are added into sum, sq
  float sum[4] = {0.f, 0.f, 0.f, 0.f}, sq[4] = {0.f, 0.f, 0.f, 0.f};
  auto conv_merge = [&](int n0, const ConvIn& ci, float* dst, int ld,
                        bool stats) {
    const bool cok = n0 + 4 * cg < di;
    const auto &vyf = ci.yf, &vyb = ci.yb;
    const auto &wc = ci.wc, &wa = ci.wa;
    const auto &bc = ci.bc, &ba = ci.ba, &df = ci.df, &db = ci.db;
    float xw[7][4];  // extended rows i .. i + 6 of own row i
#pragma unroll
    for (int k = 0; k < 6; ++k) lds_f4(s_xin + (i0 + k) * kXLd + 4 * cg, xw[k]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      lds_f4(s_xin + (i0 + r + 6) * kXLd + 4 * cg, xw[6]);
      float pf[4], pb[4], m[4];
      fv::widen4(vyf[r], pf);
      fv::widen4(vyb[r], pb);
      float rs = 0.f, rq2 = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // xc_f = silu(Σ_k x[t-3+k]·w_c[k] + b), xc_b = silu(Σ_k
        // x[t+k]·w_a[3-k] + b); own row i is extended row i + 3
        const float yc = xw[0][e] * wc[e][0] + xw[1][e] * wc[e][1] +
                         xw[2][e] * wc[e][2] + xw[3][e] * wc[e][3] + bc[e];
        const float ya = xw[3][e] * wa[e][3] + xw[4][e] * wa[e][2] +
                         xw[5][e] * wa[e][1] + xw[6][e] * wa[e][0] + ba[e];
        const float v = (pf[e] + df[e] * silu_fast(yc) + pb[e] +
                         db[e] * silu_fast(ya)) * 0.5f;
        m[e] = cok ? v : 0.f;
        rs += m[e];
        rq2 += m[e] * m[e];
      }
      *reinterpret_cast<float4*>(dst + (i0 + r) * ld + 4 * cg) =
          make_float4(m[0], m[1], m[2], m[3]);
      if (stats) {  // the 16 threads of the row, a butterfly
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) {
          rs += __shfl_xor_sync(0xffffffffu, rs, o);
          rq2 += __shfl_xor_sync(0xffffffffu, rq2, o);
        }
        sum[r] += rs;
        sq[r] += rq2;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) xw[k][e] = xw[k + 1][e];
    }
  };

  // first walk: the LayerNorm statistics, and the tile's m (whole) or the
  // halo rows' xin (twice)
  for (int n0 = 0; n0 < di; n0 += kCS) {
    const ConvIn ci = conv_load(n0);
    xin_slab(n0, Two());
    conv_merge(n0, ci, s_m + (kWhole ? n0 : 0), ldm, true);
  }
  if (cg == 0) {  // published by the next acquire's barrier
    const float inv = 1.f / static_cast<float>(di);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float mu = sum[r] * inv;
      s_mu[i0 + r] = mu;
      s_rstd[i0 + r] = rsqrtf(sq[r] * inv - mu * mu + eps);
    }
  }

  float oacc[16 * kOU];
#pragma unroll
  for (int i = 0; i < 16 * kOU; ++i) oacc[i] = 0.f;
  unsigned char* s_g = sm + L.xin + wg * kBlkBytes;
  for (int n0 = 0; n0 < di; n0 += kGS) {
    if (!kWhole) {  // m of the gate slab, its conv slabs again
      for (int h = 0; h < imin(2, ncs - n0 / kCS); ++h) {
        const ConvIn ci = conv_load(n0 + h * kCS);
        xin_slab(n0 + h * kCS, One());
        conv_merge(n0 + h * kCS, ci, s_m + h * kCS, kMLd, false);
      }
    }
    // the gate's vectors of this thread's channels, loaded before the z
    // GEMM so that their latency passes under it
    float2 bz[8], lw[8], lb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = imin(n0 + 64 * wg + 8 * j + 2 * q, di - 2);
      bz[j] = b_z ? ld_f2(b_z + cc) : make_float2(0.f, 0.f);
      lw[j] = use_ln ? ld_f2(ln_w + cc) : make_float2(1.f, 1.f);
      lb[j] = use_ln ? ld_f2(ln_b + cc) : make_float2(0.f, 0.f);
    }
    // z = x̂·W_z[slab]ᵀ, 64 channels a warpgroup (the acquires' barriers
    // also publish s_m)
    float z[32];
    for (int kb = 0; kb < nu; ++kb) {
      const uint32_t sw = ring.acquire(), st = sw + wg * kBlkBytes;
      const uint32_t sa = kWide ? sw + kStageBytes : sx + kb * kXBlk;
      fv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        fv::wgmma_n64<0, 0>(z, gmma_desc(sa + 32 * kk),
                            gmma_desc(st + 32 * kk), (kb | kk) != 0);
      fv::wgmma_commit();
      ring.refill();
      fv::wgmma_wait();
    }

    // g = LN(m)·silu(z + b_z), rounded to bf16, into the swizzled slab
    float mu[2] = {0.f, 0.f}, rs[2] = {1.f, 1.f};
    if (use_ln) {
      mu[0] = s_mu[r0];
      mu[1] = s_mu[r0 + 8];
      rs[0] = s_rstd[r0];
      rs[1] = s_rstd[r0 + 8];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 64 * wg + 8 * j + 2 * q;  // column in the slab
      const int c = n0 + cl;
      const bool cok = c < di;
      const int cc = cok ? c : 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * e;
        // a channel past d_inner reads an in-range m and gets g = 0
        const float2 m = *reinterpret_cast<const float2*>(
            s_m + r * ldm + (kWhole ? cc : cl));
        const float mv[2] = {m.x, m.y}, bzv[2] = {bz[j].x, bz[j].y},
                    lwv[2] = {lw[j].x, lw[j].y}, lbv[2] = {lb[j].x, lb[j].y};
        float gv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mln =
              use_ln ? (mv[h] - mu[e]) * rs[e] * lwv[h] + lbv[h] : mv[h];
          const float zz = z[4 * j + 2 * e + h] + bzv[h];
          gv[h] = cok ? mln * silu_fast(zz) : 0.f;
        }
        *reinterpret_cast<bf162*>(s_g + swz(r, 8 * j + 2 * q)) =
            __floats2bfloat162_rn(gv[0], gv[1]);
      }
    }
    // out += g·W_out[c0.., slab]ᵀ (the first acquire publishes the slab;
    // the next xin tile overwrites it only after the last one's barrier)
    fv::out_gemm<kOU>(oacc, sg, ring, wg);
  }

  // out + b_out in bf16, staged in x̂'s blocks (every product that read
  // them was waited for before the last slab's barriers) or, in the wide
  // form, in the ring's (once both warpgroups' last products are done),
  // then whole rows in 16-byte vectors, each to its token's place
  if constexpr (kWide) __syncthreads();
#pragma unroll
  for (int u = 0; u < kOU; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wg * 32 * kOU + 32 * u + 8 * j + 2 * q;
      const float2 bo = b_out && col < dmo ? ld_f2(b_out + c0 + col)
                                           : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<bf162*>(sm + L.out + (col / 64) * kXBlk +
                                  swz(r0 + 8 * e, col % 64)) =
            __floats2bfloat162_rn(oacc[16 * u + 4 * j + 2 * e] + bo.x,
                                  oacc[16 * u + 4 * j + 2 * e + 1] + bo.y);
    }
  __syncthreads();
  const int nval = static_cast<int>(seq - q0 < kTM ? seq - q0 : kTM);
  const int cpr = dmo / 8;  // 16-byte chunks per row
  for (int i = tid; i < nval * cpr; i += kThreads) {
    const int r = i / cpr, ch = i % cpr;
    *reinterpret_cast<uint4*>(out + (img + s_tok[r]) * dm + c0 + 8 * ch) =
        *reinterpret_cast<const uint4*>(sm + L.out + (ch / 8) * kXBlk +
                                        swz(r, (ch % 8) * 8));
  }
}

template <int kNU, bool kWhole>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* x,
                   const void* yf, const void* yb, const void* w_x,
                   const void* b_x, const void* w_cf, const void* b_cf,
                   const void* w_ab, const void* b_ab, const void* w_z,
                   const void* b_z, const void* d_f, const void* d_b,
                   const void* ln_w, const void* ln_b, const void* w_out,
                   const void* b_out, void* out, int H, int W, int dm, int di,
                   bool transposed, bool use_ln, float eps) {
  const size_t smem = rc_smem(kNU, kWhole, di).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<pass_b_rc_wgmma_kernel<kNU, kWhole>>();
  if (err != cudaSuccess) return err;
  auto cT = [](const void* p) { return static_cast<const bf16*>(p); };
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  pass_b_rc_wgmma_kernel<kNU, kWhole><<<grid, kThreads, smem, stream>>>(
      cT(x), cT(yf), cT(yb), cT(w_x), cF(b_x), cF(w_cf), cF(b_cf), cF(w_ab),
      cF(b_ab), cT(w_z), cF(b_z), cF(d_f), cF(d_b), cF(ln_w), cF(ln_b),
      cT(w_out), cF(b_out), static_cast<bf16*>(out), H, W, dm, di,
      transposed, use_ln, eps);
  return cudaGetLastError();
}

// "whole" where the tile's m fits beside the rest, else "twice"
template <int kNU, typename... Args>
cudaError_t launch_either(int di, Args... args) {
  if constexpr (kNU >= 1 && kNU <= kWholeNU) {
    if (di <= kWholeDi && rc_smem(kNU, true, di).total <= kMaxSmem)
      return launch<kNU, true>(args...);
  }
  return launch<kNU, false>(args...);
}

}  // namespace

namespace fvf {

cudaError_t pass_b_recompute_fwd_bf16(
    const void* x, const void* yf, const void* yb, const void* w_x,
    const void* b_x, const void* w_cf, const void* b_cf, const void* w_ab,
    const void* b_ab, const void* w_z, const void* b_z, const void* d_f,
    const void* d_b, const void* ln_w, const void* ln_b, const void* w_out,
    const void* b_out, void* out, int batch, int H, int W, int dm, int di,
    bool transposed, bool use_ln, float eps, cudaStream_t stream) {
  // the narrow form up to d_model 384 and d_inner 768, else the wide one
  // (nu 0), in groups of kWideOU column units
  const int nu = (dm + 63) / 64 <= kNarrowNU && di <= kNarrowDi
                     ? (dm + 63) / 64 : 0;
  const long groups = nu ? 1 : ((dm + 63) / 64 + kWideOU - 1) / kWideOU;
  const long seq = static_cast<long>(H) * W;
  const long blocks = (seq + kTM - 1) / kTM * groups;
  if (dm > kRcMaxDm || di > kRcMaxDi || seq > 0x7fffffffL - kTM ||
      blocks > 0x7fffffffL)
    return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(blocks), batch);
#define FV_RC(n)                                                             \
  launch_either<n>(di, grid, stream, x, yf, yb, w_x, b_x, w_cf, b_cf, w_ab, \
                   b_ab, w_z, b_z, d_f, d_b, ln_w, ln_b, w_out, b_out, out,  \
                   H, W, dm, di, transposed, use_ln, eps)
  switch (nu) {
    case 0: return FV_RC(0);
    case 1: return FV_RC(1);
    case 2: return FV_RC(2);
    case 3: return FV_RC(3);
    case 4: return FV_RC(4);
    case 5: return FV_RC(5);
    case 6: return FV_RC(6);
    default: return cudaErrorInvalidValue;
  }
#undef FV_RC
}

}  // namespace fvf
