// K3 and K4 in bf16, for Hopper (sm_90a): the two forward passes of the
// fused FastVim mixer layer on warpgroup matrix products. What they
// compute is set out at the head of layer_fused_fwd.cu (the TPU kernels
// they replace: `_pass_a_{even,odd}_kernel` and `_pass_b_mat_kernel` of
// fastvim_tpu/ops/pallas/layer_fused.py); this file is how the bf16 path
// computes it.
//
// What bounds them: the bytes. At FastVim-T's widths a token costs about
// 0.15 MFLOP per pass against 1.9 KB (K3) and 2.3 KB (K4) of device
// memory, about 70 FLOP per byte, under the ~295 at which the tensor
// cores limit. So each token's data moves once, the weights come from L2
// into shared memory, and the rest stays on chip:
// - Weights stream through a ring of `cp.async` stages, in K chunks,
//   copied two to three stages ahead of the `wgmma`s that read them. W_x,
//   W_z (d_inner, d_model) and W_out (d_model, d_inner) are K-major B
//   operands as they lie: no transposed copy exists.
// - K4: a block of two warpgroups owns 64 consecutive tokens. Their x̂ is
//   brought once into 128-byte-swizzled tiles. A first pass reads xc_f,
//   xc_b, yf, yb in 16-byte vectors and keeps each token's LayerNorm sums
//   of m = ½(yf + D_f·xc_f + yb + D_b·xc_b) in fp32; where the tile's m
//   fits in shared memory (FastVim-T) it stays there. Then d_inner is
//   walked in 128-channel slabs: m of the slab is read there, or formed
//   again from L2 into an fp32 slab tile, z = x̂·W_zᵀ accumulates in
//   registers, the gate LN(m)·silu(z + b_z) runs on the fragments and
//   goes, rounded to bf16 as the contract rounds it, to a swizzled tile
//   that is the A operand of out += g·W_out[:, slab]ᵀ, which accumulates
//   in registers across slabs (the warpgroups split d_model). The out rows
//   leave through shared memory in 16-byte vectors. No whole-width tile
//   needs to stay on chip, so d_inner <= 768 with d_model <= 384 fits.
//   Past those widths (FastVim-B/L/H, up to fvf::kFwdMaxDm and
//   fvf::kFwdMaxDi) the wide form: a block owns 64 tokens and a group of
//   at most 384 d_model columns, x̂ streams through the ring beside W_z,
//   and z and the gate are computed again for each group (see the
//   kernel).
// - K3: a block owns a line (in segments of up to 186 tokens, one at
//   2048 px) and all of d_inner, so the pool over the line stays in the
//   block. The segment's x̂ plus its 3-token halo on each side is brought
//   once (up to d_model 384; wider, its K blocks come through the ring
//   beside W_x's, once for each slab); d_inner is walked in slabs of 64
//   channels, half a warpgroup; xin = x̂·W_xᵀ covers the extended
//   rows in M tiles of 64 (the last one
//   overlapping the one before it rather than running past the tile),
//   goes with b_x to an fp32 tile, and the dual conv, SiLU, the xc stores
//   and the pool sums run from there with each thread on 8 consecutive
//   channels, so that every xc store is 16 bytes and a warp writes whole
//   128-byte runs.
// - At FastVim-B's widths and up a token costs 4·d_model·d_inner FLOP
//   (K4: 4.7 MFLOP at -B, 13.1 at -H) against 4·(d_model + d_inner)
//   bytes, 512-853 FLOP a byte: K4 is then bound by the tensor cores, and
//   its wide form does 1.5-2.5× the FLOP of one pass (z again a group).
// - d_model that is not a multiple of 64 is zero-padded in shared memory
//   (and d_inner of K4 to its slab): the copies of the missing columns are
//   zero-filled, not read.
// Each call is one launch; no atomics, so results repeat bit for bit.

#include "layer_fused_fwd.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using fv::cp_async16;
using fv::gmma_desc;
using fv::kMaxSmem;
using fv::ld_f2;
using fv::lds_f8;
using fv::pack8;
using fv::silu_fast;
using fv::smem_u32;
using fv::swz;

constexpr int kThreads = 256;                   // two warpgroups
constexpr int kTM = 64;                         // wgmma's M
constexpr int kRowBytes = fv::kBlkRowBytes;     // 64 bf16 of a tile row
constexpr int kBlkBytes = kTM * kRowBytes;      // a 64 × 64 bf16 block
constexpr int kPad = 3;                         // d_conv - 1

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// =====================================================================
// K4: pass B
// =====================================================================
constexpr int kBSlab = 128;                   // d_inner channels per slab
constexpr int kBStages = 4;
constexpr int kBStageBytes = 2 * kBlkBytes;   // 128 rows or 128 K of a weight
constexpr int kMLd = kBSlab + 4;              // fp32 row of the m tile, skewed
constexpr int kWholeDi = 512;  // widest d_inner whose tile of m may stay
constexpr int kBMaxDi = 768;   // ... the first pass's registers: kBMaxDi / 256
constexpr int kBMaxNU = 6;     // widest out a block accumulates: d_model 384
// the wide form's W_z stages also carry the x̂ block of their K step
constexpr int kBWideStageBytes = kBStageBytes + kBlkBytes;

struct BSmem {  // byte offsets from the 1024-aligned base
  size_t x, g, ring, m, stats, total;
};
// whole_di: d_inner when m of the whole tile stays, else 0 (one slab's);
// wide: the wide form's stages
__host__ __device__ inline BSmem b_smem(int nu, int whole_di,
                                        bool wide = false) {
  BSmem L;
  L.x = 0;                        // x̂, then the out rows: nu blocks
  L.g = static_cast<size_t>(nu) * kBlkBytes;  // gated slab: 2 blocks
  L.ring = L.g + 2 * kBlkBytes;
  L.m = L.ring + kBStages * (wide ? kBWideStageBytes : kBStageBytes);
  L.stats = L.m + static_cast<size_t>(kTM) *
                     (whole_di ? whole_di + 4 : kMLd) * sizeof(float);
  // mu, rstd [64] fp32; pooled row of each token [64] int
  L.total = L.stats + 3 * kTM * sizeof(float) + 1024;
  return L;
}

// m = ½(yf + D_f·xc_f + yb + D_b·xc_b) of 8 channels, in the order of
// pass_b_plain's fp32 sum
__device__ __forceinline__ void merge8(const uint4& vf, const uint4& vb,
                                       const uint4& vyf, const uint4& vyb,
                                       const float* df, const float* db,
                                       float* m) {
  float a[8], c[8], p[8], q[8];
  fv::widen16<bf16>(vf, a);
  fv::widen16<bf16>(vb, c);
  fv::widen16<bf16>(vyf, p);
  fv::widen16<bf16>(vyb, q);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    m[e] = (p[e] + df[e] * a[e] + q[e] + db[e] * c[e]) * 0.5f;
}

__device__ __forceinline__ void ldg_f8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// kNU = ceil(d_model / 64) <= kBMaxNU with d_inner <= kBMaxDi: a block
// owns 64 tokens and all of d_model, its x̂ whole in shared memory. kWhole:
// the first pass keeps m of the whole tile in shared memory (d_inner <=
// 512 where it fits: FastVim-T), so xc_f, xc_b, yf, yb are read once;
// else each slab forms its m again from them (from L2).
//
// kNU = 0, the wide form (FastVim-B/L/H: d_model 768-1280, d_inner
// 1536-2560). Its out accumulators would need 192-320 registers a thread
// and its x̂ tile 96-160 KB. So a block owns 64 tokens and a group of
// kBMaxNU 64-column units of d_model (a grid of column groups × token
// tiles, the groups of a tile side by side so that they share its xc in
// L2), the x̂ block of each K step comes through the ring beside its W_z
// block, and each block computes z and the gate of all of d_inner again:
// z's GEMM runs once for each group (2× at FastVim-B, 3× at -L, 4× at
// -H), but there is one launch and nothing more goes through device
// memory. The other designs: the gated slab written to device memory and
// a second wgmma GEMM for out (4·d_inner more bytes a token, a second
// launch), or a cluster whose blocks share each gated slab through
// distributed shared memory (wgmma reads only its own block's shared
// memory, so each slab would be copied in anyway). This one reuses every
// piece of the narrow form and is the simplest that is right.
template <int kNU, bool kWhole>
__global__ void __launch_bounds__(kThreads, 1)
pass_b_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xc_f,
                    const bf16* __restrict__ xc_b, const bf16* __restrict__ yf,
                    const bf16* __restrict__ yb, const bf16* __restrict__ w_z,
                    const float* __restrict__ b_z,
                    const float* __restrict__ d_f,
                    const float* __restrict__ d_b,
                    const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b,
                    const bf16* __restrict__ w_out,
                    const float* __restrict__ b_out, bf16* __restrict__ out,
                    int ntokens, int H, int W, int dm, int di,
                    bool transposed, bool use_ln, float eps) {
  constexpr bool kWide = kNU == 0;
  static_assert(!(kWide && kWhole), "the wide form walks d_inner in slabs");
  constexpr int kOU = kWide ? kBMaxNU : kNU;  // 64-column units of out
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const BSmem L = b_smem(kOU, kWhole ? di : 0, kWide);
  const int ldm = kWhole ? di + 4 : kMLd;
  const uint32_t sx = smem_u32(sm + L.x), sg = smem_u32(sm + L.g);
  float* s_m = reinterpret_cast<float*>(sm + L.m);        // [64][ldm]
  float* s_mu = reinterpret_cast<float*>(sm + L.stats);   // [64]
  float* s_rstd = s_mu + kTM;                             // [64]
  int* s_prow = reinterpret_cast<int*>(s_rstd + kTM);     // [64]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  const int nu = kWide ? (dm + 63) / 64 : kNU;  // K blocks of z's GEMM
  const int ngroups = kWide ? (nu + kOU - 1) / kOU : 1;
  const int tok0 = static_cast<int>(blockIdx.x) / ngroups * kTM;
  const int c0 = static_cast<int>(blockIdx.x) % ngroups * 64 * kOU;
  const int dmo = imin(64 * kOU, dm - c0);  // this block's out columns
  const int nval = imin(kTM, ntokens - tok0);
  const int HW = H * W, P = transposed ? W : H;
  const int nslab = (di + kBSlab - 1) / kBSlab;
  const int per_slab = nu + kOU;
  const int total = nslab * per_slab;

  // stage s: per slab nu K blocks of W_z (128 channel rows, 64 a
  // warpgroup; in the wide form with the x̂ block of the same K), then kOU
  // stages of 64 rows of W_out's columns c0.. over the slab's channels
  // (see fv::cp_out_stage); rows and columns past the widths zero-filled
  auto fetch = [&](int s, uint32_t dst) {
    if (s >= total) return;
    const int n0 = s / per_slab * kBSlab, kb = s % per_slab;
    if (kb < nu) {
      for (int i = tid; i < 2 * kTM * 8; i += kThreads) {
        const int r = i >> 3, ch = i & 7, col = 64 * kb + 8 * ch;
        const bool ok = n0 + r < di && col < dm;
        cp_async16(dst + (r / kTM) * kBlkBytes + swz(r % kTM, 8 * ch),
                   w_z + (ok ? static_cast<size_t>(n0 + r) * dm + col : 0),
                   ok);
      }
      if constexpr (kWide) {
        for (int i = tid; i < kTM * 8; i += kThreads) {
          const int r = i >> 3, ch = i & 7, col = 64 * kb + 8 * ch;
          const bool ok = r < nval && col < dm;
          cp_async16(dst + kBStageBytes + swz(r, 8 * ch),
                     x + (ok ? static_cast<size_t>(tok0 + r) * dm + col : 0),
                     ok);
        }
      }
    } else {
      fv::cp_out_stage(dst, w_out + static_cast<size_t>(c0) * di, n0,
                       kb - nu, kOU, dmo, di, tid);
    }
  };
  fv::Ring<kBStages, kWide ? kBWideStageBytes : kBStageBytes,
           decltype(fetch)>
      ring(smem_u32(sm + L.ring), fetch);
  ring.start();

  // the tile's x̂, rows past the last token and columns past d_model 0
  if constexpr (!kWide) {
    for (int i = tid; i < kTM * 8 * kNU; i += kThreads) {
      const int r = i / (8 * kNU), c = i % (8 * kNU);
      const bool ok = r < nval && 8 * c < dm;
      cp_async16(sx + (c / 8) * kBlkBytes + swz(r, (c % 8) * 8),
                 x + (ok ? static_cast<size_t>(tok0 + r) * dm + 8 * c : 0),
                 ok);
    }
    fv::cp_async_commit();
  }
  if (tid < kTM) {  // the pooled row (b·P + line) of each token
    const int t = tok0 + imin(tid, nval - 1), pix = t % HW;
    s_prow[tid] = t / HW * P + (transposed ? pix % W : pix / W);
  }
  __syncthreads();

  // first pass: m of every row over all of d_inner (into s_m when the
  // whole tile fits) and its LayerNorm statistics, a warp per row, the
  // loads of kRows rows in flight together, every load issued at a
  // clamped address where its row or vector is masked
  const int ncg = di / 8;  // 8-channel groups
  const float inv_di = 1.f / static_cast<float>(di);
  if constexpr (kWide) {
    // two rows at a time, a lane's vectors lane + 32k in turn: the sums
    // in the order of the narrow form's registers, at any d_inner
    for (int rr = warp * 8; use_ln && rr < warp * 8 + 8; rr += 2) {
      float sum[2] = {0.f, 0.f}, sumsq[2] = {0.f, 0.f};
      for (int v = lane; v < ncg; v += 32) {
        float df[8], db[8];
        ldg_f8(d_f + 8 * v, df);
        ldg_f8(d_b + 8 * v, db);
        uint4 va[2], vb[2], ya[2], yb2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = imin(rr + e, nval - 1);
          const size_t o = static_cast<size_t>(tok0 + r) * di + 8 * v;
          const size_t po = static_cast<size_t>(s_prow[r]) * di + 8 * v;
          va[e] = fv::load16(xc_f + o);
          vb[e] = fv::load16(xc_b + o);
          ya[e] = fv::load16(yf + po);
          yb2[e] = fv::load16(yb + po);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m[8];
          merge8(va[e], vb[e], ya[e], yb2[e], df, db, m);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            sum[e] += m[i];
            sumsq[e] += m[i] * m[i];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], o);
          sumsq[e] += __shfl_xor_sync(0xffffffffu, sumsq[e], o);
        }
        if (lane == 0) {
          const float mu = sum[e] * inv_di;
          s_mu[rr + e] = mu;
          s_rstd[rr + e] = rsqrtf(sumsq[e] * inv_di - mu * mu + eps);
        }
      }
    }
  } else if (use_ln || kWhole) {
    constexpr int kK = kWhole ? kWholeDi / 256 : kBMaxDi / 256;  // vectors/lane
    constexpr int kRows = kWhole ? 4 : 2;
    float df[kK][8], db[kK][8];  // D_f, D_b of this lane's vectors
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int v = 8 * imin(lane + 32 * k, ncg - 1);
      ldg_f8(d_f + v, df[k]);
      ldg_f8(d_b + v, db[k]);
    }
    for (int rr = warp * 8; rr < warp * 8 + 8; rr += kRows) {
      uint4 va[kRows][kK], vb[kRows][kK], ya[kRows][kK], yb2[kRows][kK];
#pragma unroll
      for (int e = 0; e < kRows; ++e) {
        const int r = imin(rr + e, nval - 1);
        const size_t o = static_cast<size_t>(tok0 + r) * di;
        const size_t po = static_cast<size_t>(s_prow[r]) * di;
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          const int v = 8 * imin(lane + 32 * k, ncg - 1);
          va[e][k] = fv::load16(xc_f + o + v);
          vb[e][k] = fv::load16(xc_b + o + v);
          ya[e][k] = fv::load16(yf + po + v);
          yb2[e][k] = fv::load16(yb + po + v);
        }
      }
#pragma unroll
      for (int e = 0; e < kRows; ++e) {
        float sum = 0.f, sumsq = 0.f;
#pragma unroll
        for (int k = 0; k < kK; ++k) {
          const int v = lane + 32 * k;
          if (v < ncg) {
            float m[8];
            merge8(va[e][k], vb[e][k], ya[e][k], yb2[e][k], df[k], db[k], m);
            if (kWhole) {
              float* dst = s_m + (rr + e) * ldm + 8 * v;
              *reinterpret_cast<float4*>(dst) =
                  make_float4(m[0], m[1], m[2], m[3]);
              *reinterpret_cast<float4*>(dst + 4) =
                  make_float4(m[4], m[5], m[6], m[7]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              sum += m[i];
              sumsq += m[i] * m[i];
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
          s_mu[rr + e] = mu;
          s_rstd[rr + e] = rsqrtf(sumsq * inv_di - mu * mu + eps);
        }
      }
    }
  }

  float oacc[16 * kOU];
#pragma unroll
  for (int i = 0; i < 16 * kOU; ++i) oacc[i] = 0.f;
  const int r0 = 16 * w4 + rq;  // this thread's rows: r0 and r0 + 8
  const int mch = tid % 16, mr0 = tid / 16;  // m staging: 8 channels, rows

  for (int n0 = 0; n0 < di; n0 += kBSlab) {
    // m of the slab into s_m (fp32, as the contract keeps it), unless the
    // first pass left the whole tile's there; channels past d_inner 0
    if (!kWhole) {
      const int c = n0 + 8 * mch;
      const bool cok = c < di;
      const int cc = cok ? c : di - 8;
      float df[8], db[8];
      ldg_f8(d_f + cc, df);
      ldg_f8(d_b + cc, db);
#pragma unroll
      for (int kh = 0; kh < 4; kh += 2) {
        uint4 va[2], vb[2], ya[2], yb2[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int r = imin(mr0 + 16 * (kh + k), nval - 1);
          const size_t o = static_cast<size_t>(tok0 + r) * di + cc;
          const size_t po = static_cast<size_t>(s_prow[r]) * di + cc;
          va[k] = fv::load16(xc_f + o);
          vb[k] = fv::load16(xc_b + o);
          ya[k] = fv::load16(yf + po);
          yb2[k] = fv::load16(yb + po);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float m[8];
          merge8(va[k], vb[k], ya[k], yb2[k], df, db, m);
          float* dst = s_m + (mr0 + 16 * (kh + k)) * ldm + 8 * mch;
          *reinterpret_cast<float4*>(dst) =
              cok ? make_float4(m[0], m[1], m[2], m[3])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(dst + 4) =
              cok ? make_float4(m[4], m[5], m[6], m[7])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    // z = x̂·W_z[slab]ᵀ, 64 channels a warpgroup (the acquires' barriers
    // also publish s_m); the wide form's A blocks lie in the stages
    float z[32];
    if constexpr (kWide) {
      for (int b = 0; b < nu; ++b) {
        const uint32_t st = ring.acquire();
        fv::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          fv::wgmma_n64<0, 0>(z, gmma_desc(st + kBStageBytes + 32 * kk),
                              gmma_desc(st + wg * kBlkBytes + 32 * kk),
                              (b | kk) != 0);
        fv::wgmma_commit();
        ring.refill();
        fv::wgmma_wait();
      }
    } else {
      fv::slab_gemm<0>(z, sx, kNU, ring, wg * kBlkBytes, true);
    }

    // g = LN(m)·silu(z + b_z), rounded to bf16, into the swizzled slab
    float mu[2] = {0.f, 0.f}, rs[2] = {1.f, 1.f};
    if (use_ln) {
      mu[0] = s_mu[r0];
      mu[1] = s_mu[r0 + 8];
      rs[0] = s_rstd[r0];
      rs[1] = s_rstd[r0 + 8];
    }
    unsigned char* s_g = sm + L.g + wg * kBlkBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 64 * wg + 8 * j + 2 * q;  // column in the slab
      const int c = n0 + cl;
      const bool cok = c < di;
      const int cc = cok ? c : 0;
      const float2 bz = b_z ? ld_f2(b_z + cc) : make_float2(0.f, 0.f);
      const float2 lw = use_ln ? ld_f2(ln_w + cc) : make_float2(1.f, 1.f);
      const float2 lb = use_ln ? ld_f2(ln_b + cc) : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * e;
        // a channel past d_inner reads a column of the skew or of the
        // next row: finite, and its g is 0
        const float2 m = *reinterpret_cast<const float2*>(
            s_m + r * ldm + (kWhole ? c : cl));
        const float mv[2] = {m.x, m.y}, bzv[2] = {bz.x, bz.y},
                    lwv[2] = {lw.x, lw.y}, lbv[2] = {lb.x, lb.y};
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
    // out += g·W_out[c0.., slab]ᵀ (the first acquire publishes the slab)
    fv::out_gemm<kOU>(oacc, sg, ring, wg);
  }

  // out + b_out in bf16, staged in x̂'s blocks (the wide form's own; every
  // product that read them was waited for before the last slab's
  // barriers), then whole rows in 16-byte vectors
#pragma unroll
  for (int u = 0; u < kOU; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wg * 32 * kOU + 32 * u + 8 * j + 2 * q;
      const float2 bo = b_out && col < dmo ? ld_f2(b_out + c0 + col)
                                           : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<bf162*>(sm + L.x + (col / 64) * kBlkBytes +
                                  swz(r0 + 8 * e, col % 64)) =
            __floats2bfloat162_rn(oacc[16 * u + 4 * j + 2 * e] + bo.x,
                                  oacc[16 * u + 4 * j + 2 * e + 1] + bo.y);
    }
  __syncthreads();
  const int cpr = dmo / 8;  // 16-byte chunks per row
  for (int i = tid; i < nval * cpr; i += kThreads) {
    const int r = i / cpr, ch = i % cpr;
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(tok0 + r) * dm + c0 +
                              8 * ch) =
        *reinterpret_cast<const uint4*>(sm + L.x + (ch / 8) * kBlkBytes +
                                        swz(r, (ch % 8) * 8));
  }
}

// =====================================================================
// K3: pass A
// =====================================================================
// d_inner is walked in slabs of kSW channels, half a warpgroup. 128-channel
// slabs measured slower at FastVim-T's widths: the conv stage then spills.
constexpr int kSW = 64;
constexpr int kAStages = 4;
constexpr int kAStageBytes = kSW * kRowBytes;  // the slab's W_x rows × 64 K
constexpr int kXLd = kSW + 4;   // fp32 row of the xin tile, skewed
constexpr int kAMaxRows = 3 * kTM;          // extended rows of a segment
constexpr int kAMaxSeg = kAMaxRows - 2 * kPad;
constexpr int kAMaxNU = 6;  // widest x̂ tile a block holds whole: d_model 384
// the streamed form's stage: the W_x block, then the segment's x̂ rows × the
// same 64 K
constexpr int kAStreamStageBytes = kAStageBytes + kAMaxRows * kRowBytes;

struct ASmem {  // byte offsets from the 1024-aligned base
  size_t x, ring, xin, red, pool, total;
};
// rows: the extended rows a segment's x̂ tile holds, a multiple of 8; nu
// 0: the streamed form, whose x̂ blocks come through the ring
__host__ __device__ inline ASmem a_smem(int nu, int rows, int di) {
  ASmem L;
  L.x = 0;  // nu K blocks of rows × 64 bf16
  L.ring = static_cast<size_t>(nu) * rows * kRowBytes;
  L.xin = L.ring + kAStages * (nu ? kAStageBytes : kAStreamStageBytes);
  L.red = L.xin + static_cast<size_t>(rows) * kXLd * sizeof(float);
  L.pool = L.red + 8 * 2 * kSW * sizeof(float);  // [warp][f, b][kSW]
  L.total = L.pool + 2 * static_cast<size_t>(di) * sizeof(float) + 1024;
  return L;
}
__host__ __device__ inline int a_rows(int seg) {
  return imax(kTM, round8(seg + 2 * kPad));
}

// kNU = ceil(d_model / 64) <= kAMaxNU: the segment's x̂ tile is brought
// whole and stays while d_inner is walked. kNU = 0, the streamed form
// (d_model > 384, where that tile alone would take 160 KB at 1280): each
// ring stage carries the x̂ block of its K step beside the W_x block, so
// the segment's x̂ is read again from L2 for each slab
template <int kNU>
__global__ void __launch_bounds__(kThreads, 1)
pass_a_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_x,
                    const float* __restrict__ b_x,
                    const float* __restrict__ w_cf,
                    const float* __restrict__ b_cf,
                    const float* __restrict__ w_ab,
                    const float* __restrict__ b_ab, bf16* __restrict__ xc_f,
                    bf16* __restrict__ xc_b, bf16* __restrict__ pf,
                    bf16* __restrict__ pb, int H, int W, int dm, int di,
                    bool transposed, float scaling, int seg) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int rows = a_rows(seg);
  constexpr int kNJ = kSW / 16;   // 8-column groups of a warpgroup's half
  constexpr int kNcg = kSW / 8;   // conv: 8-channel groups of the slab
  const ASmem L = a_smem(kNU, rows, di);
  const uint32_t sx = smem_u32(sm + L.x);
  const uint32_t blk = static_cast<uint32_t>(rows) * kRowBytes;  // K block
  float* s_xin = reinterpret_cast<float*>(sm + L.xin);   // [rows][kXLd]
  float* s_red = reinterpret_cast<float*>(sm + L.red);   // [8][2][kSW]
  float* s_pool = reinterpret_cast<float*>(sm + L.pool);  // [2][di]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  const int p = blockIdx.x, b = blockIdx.y;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const size_t img = static_cast<size_t>(b) * H * W;
  const int nu = kNU ? kNU : (dm + 63) / 64;  // K blocks of d_model
  const int nseg = (ln + seg - 1) / seg;
  const int nslab = di / kSW;
  const int per_seg = nslab * nu;
  const int total = nseg * per_seg;

  // the token of extended row j of the segment whose own rows start at
  // s0 (rows 0-2 and the last 3 are the halo: the previous line's tail
  // and the next line's head along the conv's order), or -1 outside the
  // sequence
  auto token = [&](int s0, int j) -> long {
    int pos = s0 - kPad + j, line = p;
    if (pos < 0) {
      line = p - 1;
      pos += ln;
    } else if (pos >= ln) {
      line = p + 1;
      pos -= ln;
    }
    if (line < 0 || line >= P) return -1;
    return transposed ? static_cast<long>(pos) * W + line
                      : static_cast<long>(line) * W + pos;
  };

  // stage s: K block kb of W_x's rows n0..n0+kSW-1 (half a warpgroup),
  // for each slab of each segment; columns past d_model zero-filled. The
  // streamed form adds K block kb of the segment's extended x̂ rows, as
  // the whole tile below holds them
  auto fetch = [&](int s, uint32_t dst) {
    if (s >= total) return;
    const int r = s % per_seg;
    const int n0 = r / nu * kSW, kb = r % nu;
    for (int i = tid; i < kSW * 8; i += kThreads) {
      const int rr = i >> 3, ch = i & 7, col = 64 * kb + 8 * ch;
      const bool ok = col < dm;
      cp_async16(dst + rr * kRowBytes + (((ch ^ rr) & 7) << 4),
                 w_x + static_cast<size_t>(n0 + rr) * dm + (ok ? col : 0), ok);
    }
    if constexpr (kNU == 0) {
      const int s0 = s / per_seg * seg;
      const int ns = imin(seg, ln - s0), R = a_rows(ns);
      for (int i = tid; i < R * 8; i += kThreads) {
        const int j = i >> 3, ch = i & 7, col = 64 * kb + 8 * ch;
        const long t = j < ns + 2 * kPad ? token(s0, j) : -1;
        const bool ok = t >= 0 && col < dm;
        cp_async16(dst + kAStageBytes + swz(j, 8 * ch),
                   x + (ok ? (img + t) * dm + col : 0), ok);
      }
    }
  };
  fv::Ring<kAStages, kNU ? kAStageBytes : kAStreamStageBytes,
           decltype(fetch)>
      ring(smem_u32(sm + L.ring), fetch);
  ring.start();
  for (int i = tid; i < 2 * di; i += kThreads) s_pool[i] = 0.f;

  const int r0 = 16 * w4 + rq;  // this thread's rows of an M tile
  const int cg = tid % kNcg, rg = tid / kNcg;  // conv: 8 channels, rows
  for (int s0 = 0; s0 < ln; s0 += seg) {
    const int ns = imin(seg, ln - s0);
    const int next = ns + 2 * kPad;  // extended rows
    const int R = a_rows(ns);
    const int nmt = (R + kTM - 1) / kTM;
    // x̂ of the extended rows; rows outside the sequence (and past them)
    // zero-filled and never read. The previous segment's products were
    // all waited for before its last conv barrier.
    if constexpr (kNU != 0) {
      for (int i = tid; i < R * 8 * kNU; i += kThreads) {
        const int j = i / (8 * kNU), c = i % (8 * kNU);
        const long t = j < next ? token(s0, j) : -1;
        const bool ok = t >= 0 && 8 * c < dm;
        cp_async16(sx + (c / 8) * blk + swz(j, (c % 8) * 8),
                   x + (ok ? (img + t) * dm + 8 * c : 0), ok);
      }
      fv::cp_async_commit();
      fv::cp_async_wait<0>();  // the first acquire's barrier publishes it
    }

    for (int n0 = 0; n0 < di; n0 += kSW) {
      // xin = x̂·W_x[slab]ᵀ over three M tiles starting at min(64 t, R -
      // 64): where fewer cover the rows, the last ones repeat rows of the
      // one before (alike), so that no product sits in a branch, which
      // would make the compiler serialize them
      float acc[3][kSW / 4];
      for (int kb = 0; kb < nu; ++kb) {
        const uint32_t sw = ring.acquire();
        const uint32_t st = sw + wg * (kSW / 2) * kRowBytes;
        const uint32_t sa = kNU ? sx + kb * blk : sw + kAStageBytes;
        fv::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const uint32_t a0 = sa + imin(kTM * t, R - kTM) * kRowBytes;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            fv::wgmma_n32<0, 0>(acc[t], gmma_desc(a0 + 32 * kk),
                                gmma_desc(st + 32 * kk), (kb | kk) != 0);
        }
        fv::wgmma_commit();
        ring.refill();
        fv::wgmma_wait();
      }
      // + b_x into the fp32 tile; rows outside the sequence stay 0
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (t < nmt) {
          const int m0 = imin(kTM * t, R - kTM);
          bool valid[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = m0 + r0 + 8 * e;
            valid[e] = row < next && token(s0, row) >= 0;
          }
#pragma unroll
          for (int j = 0; j < kNJ; ++j) {
            const int cl = (kSW / 2) * wg + 8 * j + 2 * q;
            const float2 bx =
                b_x ? ld_f2(b_x + n0 + cl) : make_float2(0.f, 0.f);
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<float2*>(s_xin + (m0 + r0 + 8 * e) * kXLd +
                                         cl) =
                  valid[e] ? make_float2(acc[t][4 * j + 2 * e] + bx.x,
                                         acc[t][4 * j + 2 * e + 1] + bx.y)
                           : make_float2(0.f, 0.f);
          }
        }
      }
      __syncthreads();

      // dual conv + SiLU + xc stores + pool sums: 8 channels, a run of
      // consecutive own rows a thread, the 7 extended rows it needs in a
      // window of registers
      float sf[8], sb[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sf[e] = sb[e] = 0.f;
      constexpr int kNrg = kThreads / kNcg;  // row groups
      const int per = (ns + kNrg - 1) / kNrg;
      const int i0 = imin(rg * per, ns), i1 = imin(i0 + per, ns);
      if (i0 < i1) {
        const int c = n0 + 8 * cg;
        float wc[8][4], wa[8][4], bc[8], ba[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 vc = __ldg(reinterpret_cast<const float4*>(w_cf) + c + e);
          const float4 va = __ldg(reinterpret_cast<const float4*>(w_ab) + c + e);
          wc[e][0] = vc.x; wc[e][1] = vc.y; wc[e][2] = vc.z; wc[e][3] = vc.w;
          wa[e][0] = va.x; wa[e][1] = va.y; wa[e][2] = va.z; wa[e][3] = va.w;
        }
        if (b_cf) {
          ldg_f8(b_cf + c, bc);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) bc[e] = 0.f;
        }
        if (b_ab) {
          ldg_f8(b_ab + c, ba);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) ba[e] = 0.f;
        }
        float xw[7][8];  // extended rows i .. i + 6
#pragma unroll
        for (int k = 0; k < 6; ++k)
          lds_f8(s_xin + (i0 + k) * kXLd + 8 * cg, xw[k]);
        for (int i = i0; i < i1; ++i) {
          lds_f8(s_xin + (i + 6) * kXLd + 8 * cg, xw[6]);
          float of[8], ob[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            // xc_f[t] = silu(Σ_k x[t-3+k]·w_c[k] + b), xc_b[t] = silu(Σ_k
            // x[t+k]·w_a[3-k] + b); own row i is extended row i + 3
            const float yc = xw[0][e] * wc[e][0] + xw[1][e] * wc[e][1] +
                             xw[2][e] * wc[e][2] + xw[3][e] * wc[e][3] + bc[e];
            const float ya = xw[3][e] * wa[e][3] + xw[4][e] * wa[e][2] +
                             xw[5][e] * wa[e][1] + xw[6][e] * wa[e][0] + ba[e];
            of[e] = silu_fast(yc);
            ob[e] = silu_fast(ya);
            sf[e] += of[e];
            sb[e] += ob[e];
          }
          if (xc_f) {  // null in the pools-only form
            const size_t off =
                (img + static_cast<size_t>(token(s0, i + kPad))) * di + c;
            *reinterpret_cast<uint4*>(xc_f + off) = pack8(of);
            *reinterpret_cast<uint4*>(xc_b + off) = pack8(ob);
          }
#pragma unroll
          for (int k = 0; k < 6; ++k)
#pragma unroll
            for (int e = 0; e < 8; ++e) xw[k][e] = xw[k + 1][e];
        }
      }
      // the pool sums: the row groups of a warp by shuffles, the 8 warps
      // through shared memory, into the line's sums
#pragma unroll
      for (int o = kNcg; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sf[e] += __shfl_xor_sync(0xffffffffu, sf[e], o);
          sb[e] += __shfl_xor_sync(0xffffffffu, sb[e], o);
        }
      if (lane < kNcg) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s_red[(warp * 2) * kSW + 8 * cg + e] = sf[e];
          s_red[(warp * 2 + 1) * kSW + 8 * cg + e] = sb[e];
        }
      }
      __syncthreads();
      if (tid < 2 * kSW) {
        const int f = tid / kSW, cl = tid % kSW;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += s_red[(w * 2 + f) * kSW + cl];
        s_pool[f * di + n0 + cl] += s;
      }
    }
  }
  __syncthreads();
  const float sc = scaling / static_cast<float>(ln);
  const size_t prow = (static_cast<size_t>(b) * P + p) * di;
  for (int i = tid; i < 2 * di; i += kThreads) {
    bf16* dst = i < di ? pf : pb;
    dst[prow + i % di] = __float2bfloat16(s_pool[i] * sc);
  }
}

template <auto Kernel, typename... Args>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<Kernel>();
  if (err != cudaSuccess) return err;
  Kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

namespace fvf {

cudaError_t pass_a_fwd_bf16(const void* x, const void* w_x, const void* b_x,
                            const void* w_cf, const void* b_cf,
                            const void* w_ab, const void* b_ab, void* xc_f,
                            void* xc_b, void* pf, void* pb, int batch, int H,
                            int W, int dm, int di, bool transposed,
                            float scaling, cudaStream_t stream) {
  // past d_model 384 the streamed form (nu 0 in a_smem and the template)
  const int nu = (dm + 63) / 64 <= kAMaxNU ? (dm + 63) / 64 : 0;
  const int ln = transposed ? H : W;
  // the longest segment whose tiles fit
  int seg = imin(ln, kAMaxSeg);
  while (seg > 8 && a_smem(nu, a_rows(seg), di).total > kMaxSmem) seg -= 8;
  const size_t smem = a_smem(nu, a_rows(seg), di).total;
  dim3 grid(transposed ? W : H, batch);
  auto cT = [](const void* p) { return static_cast<const bf16*>(p); };
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  auto mT = [](void* p) { return static_cast<bf16*>(p); };
#define FV_A(n)                                                              \
  launch<pass_a_wgmma_kernel<n>>(                                            \
      grid, smem, stream, cT(x), cT(w_x), cF(b_x), cF(w_cf), cF(b_cf),       \
      cF(w_ab), cF(b_ab), mT(xc_f), mT(xc_b), mT(pf), mT(pb), H, W, dm, di,  \
      transposed, scaling, seg)
  switch (nu) {
    case 0: return FV_A(0);
    case 1: return FV_A(1);
    case 2: return FV_A(2);
    case 3: return FV_A(3);
    case 4: return FV_A(4);
    case 5: return FV_A(5);
    case 6: return FV_A(6);
    default: return cudaErrorInvalidValue;
  }
#undef FV_A
}

cudaError_t pass_b_fwd_bf16(const void* x, const void* xc_f,
                            const void* xc_b, const void* yf, const void* yb,
                            const void* w_z, const void* b_z, const void* d_f,
                            const void* d_b, const void* ln_w,
                            const void* ln_b, const void* w_out,
                            const void* b_out, void* out, int batch, int H,
                            int W, int dm, int di, bool transposed,
                            bool use_ln, float eps, cudaStream_t stream) {
  // the narrow form up to d_model 384 and d_inner 768, else the wide one
  // (nu 0), in groups of kBMaxNU column units
  const int nu = (dm + 63) / 64 <= kBMaxNU && di <= kBMaxDi ? (dm + 63) / 64
                                                            : 0;
  const long groups = nu ? 1 : ((dm + 63) / 64 + kBMaxNU - 1) / kBMaxNU;
  const long ntokens = static_cast<long>(batch) * H * W;
  const long blocks = (ntokens + kTM - 1) / kTM * groups;
  if (ntokens > 0x7fffffffL - kTM || blocks > 0x7fffffffL)
    return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(blocks));
  const bool whole = nu && di <= kWholeDi && b_smem(nu, di).total <= kMaxSmem;
  const size_t smem =
      nu ? b_smem(nu, whole ? di : 0).total : b_smem(kBMaxNU, 0, true).total;
  auto cT = [](const void* p) { return static_cast<const bf16*>(p); };
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
#define FV_B(n)                                                              \
  (whole ? FV_BW(n, true) : FV_BW(n, false))
#define FV_BW(n, w)                                                          \
  launch<pass_b_wgmma_kernel<n, w>>(                                         \
      grid, smem, stream, cT(x), cT(xc_f), cT(xc_b), cT(yf), cT(yb), cT(w_z), \
      cF(b_z), cF(d_f), cF(d_b), cF(ln_w), cF(ln_b), cT(w_out), cF(b_out),   \
      static_cast<bf16*>(out), static_cast<int>(ntokens), H, W, dm, di,      \
      transposed, use_ln, eps)
  switch (nu) {
    case 0: return FV_BW(0, false);
    case 1: return FV_B(1);
    case 2: return FV_B(2);
    case 3: return FV_B(3);
    case 4: return FV_B(4);
    case 5: return FV_B(5);
    case 6: return FV_B(6);
    default: return cudaErrorInvalidValue;
  }
#undef FV_BW
#undef FV_B
}

}  // namespace fvf
