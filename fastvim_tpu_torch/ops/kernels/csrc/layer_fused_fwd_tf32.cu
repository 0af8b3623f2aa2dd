// K3 and K4 in fp32, for Hopper (sm_90a): the two forward passes of the
// fused FastVim mixer layer with their products on the tensor cores in
// split precision. What they compute, the TPU kernels they replace, and
// the design of this file and what bounds it, are set out at the head of
// layer_fused_fwd.cu; this file is how the fp32 path computes it.
//
// Split precision (3xTF32): each fp32 operand v is split into hi =
// tf32(v) and lo = tf32(v - hi), both rounded to nearest (cvt.rna), and a
// product accumulates lo·hi + hi·lo + hi·hi in fp32 on the tensor cores.
// lo·lo (about 2^-22 of the product) is dropped, and each k-step's sum
// is added to the running one in fp32 (mma3). One TF32 product alone
// (hi·hi) keeps 11 bits and misses the fp32 contract's 1e-4 at these
// depths (tests/test_torch_port_tf32_split.py holds both on the CPU).
// The split is done in registers as each fragment is read from shared
// memory, so the operands stay fp32 everywhere else and a call is one
// launch.
//
// mma.sync m16n8k8 and not wgmma: TF32 wgmma reads both operands from
// shared memory in its swizzled layout, so a hi and a lo copy of every
// tile would have to be written there by the block before each product,
// and the conv stage (K3) and the gate (K4) want fp32 rows in plain
// layouts. mma.sync takes its fragments from registers: one fp32 tile in
// shared memory, read once a fragment, split on the way.

#include <climits>
#include <cstdint>

#include "layer_fused_fwd.cuh"
#include "wgmma.cuh"  // cp.async, the ring of stages

namespace {

using fv::cp_async16;
using fv::ld_f2;
using fv::smem_u32;

constexpr int kThreads = 256;  // 8 warps
constexpr int kPad = 3;        // d_conv - 1

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------
// 3xTF32 products
// ---------------------------------------------------------------------
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

// The B fragment of the 8 (K) × 8 (N) block at s, stored N-major (a row
// is one N index, ld floats, its K values consecutive: how W_x, W_z and
// W_out lie in device memory), split.
__device__ __forceinline__ void frag_b(const float* s, int ld, int lane,
                                       uint32_t* hi, uint32_t* lo) {
  const float* p = s + (lane >> 2) * ld + (lane & 3);
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

template <auto Kernel, typename... Args>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > fv::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<Kernel>();
  if (err != cudaSuccess) return err;
  Kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// =====================================================================
// K3: pass A
// =====================================================================
constexpr int kAM = 128;               // extended rows of a segment's tile
constexpr int kASeg = kAM - 2 * kPad;  // own tokens of a segment: 122
constexpr int kAN = 128;               // d_inner channels of a block
constexpr int kAK = 32;                // K (d_model) chunk of a stage
constexpr int kALd = kAK + 4;          // fp32 row of a staged chunk, skewed
constexpr int kAStages = 3;
constexpr int kAStageFloats = (kAM + kAN) * kALd;  // x̂ rows, then W_x rows
constexpr int kAXLd = kAN + 4;         // fp32 row of the xin tile, skewed
// the ring, then the partial line sums [2 halves][f, b][kAN]
constexpr size_t kASmem =
    (static_cast<size_t>(kAStages) * kAStageFloats + 4 * kAN) * sizeof(float);
static_assert(kAM * kAXLd <= kAStages * kAStageFloats,
              "the xin tile takes the ring's place");

// A block owns `nl` consecutive lines of one image (the last run of an
// image may hold fewer) and walks them in segments of `seg` own tokens:
// nl whole lines in one segment where a line fits a tile, else one line
// in balanced segments.
struct ARuns {
  int nl, seg;
};
inline ARuns a_runs(int P, int ln) {
  if (ln <= kASeg) {
    const int nl = imin(P, kASeg / ln);
    return {nl, nl * ln};
  }
  return {1, cdiv(ln, cdiv(ln, kASeg))};
}

// grid (d_inner slabs, runs of lines, batch): the slabs of a run are
// neighbours in the launch order, so they read its x̂ rows from L2
__global__ void __launch_bounds__(kThreads, 2)
pass_a_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w_x,
                   const float* __restrict__ b_x,
                   const float* __restrict__ w_cf,
                   const float* __restrict__ b_cf,
                   const float* __restrict__ w_ab,
                   const float* __restrict__ b_ab, float* __restrict__ xc_f,
                   float* __restrict__ xc_b, float* __restrict__ pf,
                   float* __restrict__ pb, int H, int W, int dm, int di,
                   bool transposed, float scaling, int nl, int seg) {
  extern __shared__ __align__(16) float smem_a[];
  float* s_xin = smem_a;  // [kAM][kAXLd] after each segment's products
  float* s_part = smem_a + kAStages * kAStageFloats;  // [2][2][kAN]
  const uint32_t ring_base = smem_u32(smem_a);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kAN;
  const int b = blockIdx.z;
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const int p0 = blockIdx.y * nl;
  const int f0 = p0 * ln, f1 = imin(P, p0 + nl) * ln;  // own flat range
  const int flat_end = P * ln;
  const size_t img = static_cast<size_t>(b) * H * W;
  const int nk = dm / kAK;
  const bool whole = ln <= kASeg;  // segments of whole lines

  // the token (in the image) of flat conv-order index f, or -1 outside
  // the sequence: the flat conv's zero padding at the image's first and
  // last line, never read from the neighbouring image
  auto token = [&](int f) -> long {
    if (f < 0 || f >= flat_end) return -1;
    if (!transposed) return f;
    const int line = f / ln;
    return static_cast<long>(f - line * ln) * W + line;
  };

  const int wm = warp & 3, wn = warp >> 2;  // rows 32wm.., channels 64wn..
  const bool n_on = n0 + 64 * wn < di;      // di % 64 == 0
  const int c = tid % kAN, half = tid / kAN;  // conv stage: channel, half
  const bool c_on = n0 + c < di;
  const float sc = scaling / static_cast<float>(ln);
  float line_f = 0.f, line_b = 0.f;  // a line in several segments: its sums

  for (int s0 = f0; s0 < f1; s0 += seg) {
    const int n = imin(seg, f1 - s0);  // own tokens; extended row j is
    const int R = n + 2 * kPad;        // flat index s0 - 3 + j
    // a thread copies the 16-byte column tid % 8 of rows tid / 8 + 32 it:
    // x̂ rows (masked outside the sequence and the tile), W_x rows
    const int ch = tid & 7;
    auto fetch = [&](int s, uint32_t dst) {
      if (s >= nk) return;
      const int k0 = s * kAK + 4 * ch;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int r = (tid >> 3) + 32 * it;
        const long tk = r < R ? token(s0 - kPad + r) : -1;
        const bool xok = tk >= 0;
        cp_async16(dst + (r * kALd + 4 * ch) * 4,
                   x + (xok ? (img + tk) * dm + k0 : 0), xok);
        const bool wok = n0 + r < di;
        cp_async16(dst + ((kAM + r) * kALd + 4 * ch) * 4,
                   w_x + (wok ? static_cast<size_t>(n0 + r) * dm + k0 : 0),
                   wok);
      }
    };
    fv::Ring<kAStages, kAStageFloats * 4, decltype(fetch)> ring(ring_base,
                                                                fetch);
    ring.start();

    // xin = x̂·W_x[slab]ᵀ: a warp owns 32 rows × 64 channels; row tiles
    // past the segment's extended rows are skipped
    const bool m_on[2] = {32 * wm < R, 32 * wm + 16 < R};
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      const float* st = smem_a + (ring.acquire() - ring_base) / 4;
      if (n_on && m_on[0]) {
#pragma unroll
        for (int kk = 0; kk < kAK / 8; ++kk) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (m_on[i])
              frag_a(st + (32 * wm + 16 * i) * kALd + 8 * kk, kALd, lane,
                     ah[i], al[i]);
#pragma unroll
          // n-tiles 2 at a time: the fewest live registers, for two
          // blocks an SM
          for (int j0 = 0; j0 < 8; j0 += 2) {
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int j = 0; j < 2; ++j)
              frag_b(st + (kAM + 64 * wn + 8 * (j0 + j)) * kALd + 8 * kk,
                     kALd, lane, bh[j], bl[j]);
            mma3<2, 2>(&acc[0][j0][0], 8, m_on, ah, al, bh, bl);
          }
        }
      }
      ring.refill();
    }
    fv::cp_async_wait<0>();
    __syncthreads();  // every product has read the ring: xin takes its place

    // + b_x into the fp32 tile; rows outside the sequence 0
    if (n_on) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 32 * wm + 16 * i + g + 8 * e;
          if (!m_on[i] || row >= R) continue;
          const bool valid = token(s0 - kPad + row) >= 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * wn + 8 * j + 2 * t;
            const float2 bx =
                b_x ? ld_f2(b_x + n0 + col) : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(s_xin + row * kAXLd + col) =
                valid ? make_float2(acc[i][j][2 * e] + bx.x,
                                    acc[i][j][2 * e + 1] + bx.y)
                      : make_float2(0.f, 0.f);
          }
        }
      }
    }
    __syncthreads();

    // dual conv + SiLU + xc stores + pool sums: a thread owns a channel
    // and walks whole lines (the two halves stride over the segment's
    // lines) or one half of a partial line, with the 7 extended rows a
    // token needs in a window of registers (the conv weights are read
    // here, not held through the products)
    if (c_on) {
      float wc[4], wa[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wc[k] = w_cf[(n0 + c) * 4 + k];
        wa[k] = w_ab[(n0 + c) * 4 + k];
      }
      const float bc = b_cf ? b_cf[n0 + c] : 0.f;
      const float ba = b_ab ? b_ab[n0 + c] : 0.f;
      const int npieces = whole ? n / ln : 2;
      const int hn = (n + 1) / 2;
      for (int q = half; q < npieces; q += 2) {
        const int i0 = whole ? q * ln : q * hn;
        const int i1 = whole ? i0 + ln : imin(n, i0 + hn);
        const int line = whole ? (s0 + i0) / ln : p0;
        const int pos0 = whole ? 0 : s0 - f0 + i0;
        float xw[7];
#pragma unroll
        for (int k = 0; k < 6; ++k) xw[k] = s_xin[(i0 + k) * kAXLd + c];
        float sf = 0.f, sb = 0.f;
        for (int i = i0; i < i1; ++i) {
          xw[6] = s_xin[(i + 6) * kAXLd + c];
          // xc_f[t] = silu(Σ_k x[t-3+k]·w_c[k] + b), xc_b[t] = silu(Σ_k
          // x[t+k]·w_a[3-k] + b); own token i is extended row i + 3
          const float yc = xw[0] * wc[0] + xw[1] * wc[1] + xw[2] * wc[2] +
                           xw[3] * wc[3] + bc;
          const float ya = xw[3] * wa[3] + xw[4] * wa[2] + xw[5] * wa[1] +
                           xw[6] * wa[0] + ba;
          const float of = fv::silu(yc), ob = fv::silu(ya);
          sf += of;
          sb += ob;
          if (xc_f) {  // null in the pools-only form
            const int pos = pos0 + i - i0;
            const long tk = transposed ? static_cast<long>(pos) * W + line
                                       : static_cast<long>(line) * W + pos;
            const size_t off = (img + tk) * di + n0 + c;
            xc_f[off] = of;
            xc_b[off] = ob;
          }
#pragma unroll
          for (int k = 0; k < 6; ++k) xw[k] = xw[k + 1];
        }
        if (whole) {
          const size_t off =
              (static_cast<size_t>(b) * P + line) * di + n0 + c;
          pf[off] = sf * sc;
          pb[off] = sb * sc;
        } else {
          s_part[(2 * q) * kAN + c] = sf;
          s_part[(2 * q + 1) * kAN + c] = sb;
        }
      }
    }
    if (!whole) {  // the two halves in a fixed order: results repeat
      __syncthreads();
      if (half == 0 && c_on) {
        line_f += s_part[c] + s_part[2 * kAN + c];
        line_b += s_part[kAN + c] + s_part[3 * kAN + c];
      }
    }
    __syncthreads();  // the next segment's copies overwrite the tile
  }
  if (!whole && half == 0 && c_on) {
    const size_t off = (static_cast<size_t>(b) * P + p0) * di + n0 + c;
    pf[off] = line_f * sc;
    pb[off] = line_b * sc;
  }
}

// =====================================================================
// K4: pass B
// =====================================================================
constexpr int kBT = 32;                 // tokens a block
constexpr int kBKz = 32;                // z's K (d_model) chunk
constexpr int kBLdZ = kBKz + 4;         // its staged fp32 rows, skewed
constexpr int kBKo = 16;                // out's K (d_inner) chunk
constexpr int kBLdO = kBKo + 4;         // its staged fp32 rows, skewed
constexpr int kBStages = 3;
constexpr int kBMaxGroup = 768;         // widest group of out columns

// d_inner channels a slab: 256 where a block's out columns take the
// registers of one block an SM anyway (groups of 512 columns and up),
// halving the times each x̂ fragment is split over the warps; else 128,
// so that two blocks fit an SM
template <int kNT>
__host__ __device__ constexpr int b_slab() {
  return kNT >= 8 ? 256 : 128;
}
// a stage holds a z chunk (x̂ rows, then the slab's W_z rows) or an out
// chunk of 64·kNT W_out rows
template <int kNT>
__host__ __device__ constexpr int b_stage_floats() {
  return (kBT + b_slab<kNT>()) * kBLdZ > 64 * kNT * kBLdO
             ? (kBT + b_slab<kNT>()) * kBLdZ
             : 64 * kNT * kBLdO;
}
// the ring, the gated slab (rows of slab + 4 floats), mu and rstd, the
// pooled row of each token
template <int kNT>
__host__ __device__ constexpr size_t b_smem() {
  return (static_cast<size_t>(kBStages) * b_stage_floats<kNT>() +
          kBT * (b_slab<kNT>() + 4) + 3 * kBT) * sizeof(float);
}

// A block owns kBT tokens and a group of at most kBMaxGroup out columns
// (c0.., width gw; the last group may be narrower): a warp's n-tile j
// holds columns c0 + 64j + 8·warp.., its out accumulators 2 × kNT × 4
// floats. grid: token tiles × groups, the groups of a tile neighbours.
template <int kNT>
__global__ void __launch_bounds__(kThreads, kNT <= 6 ? 2 : 1)
pass_b_tf32_kernel(const float* __restrict__ x, const float* __restrict__ xc_f,
                   const float* __restrict__ xc_b,
                   const float* __restrict__ yf, const float* __restrict__ yb,
                   const float* __restrict__ w_z,
                   const float* __restrict__ b_z,
                   const float* __restrict__ d_f,
                   const float* __restrict__ d_b,
                   const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b,
                   const float* __restrict__ w_out,
                   const float* __restrict__ b_out, float* __restrict__ out,
                   int ntokens, int H, int W, int dm, int di,
                   bool transposed, bool use_ln, float eps, int gw,
                   int ngroups) {
  constexpr int kStage = b_stage_floats<kNT>();
  constexpr int kBSlab = b_slab<kNT>();
  constexpr int kBNo = kBSlab / kBKo;    // out chunks a slab
  constexpr int kBZJ = kBSlab / 64;      // z's n-tiles a warp
  constexpr int kBGLd = kBSlab + 4;      // fp32 row of the gated slab
  constexpr int kJG = kNT % 4 == 0 ? 4 : 3;  // n-tiles a group of products
  static_assert(kNT % kJG == 0, "whole groups of n-tiles");
  extern __shared__ __align__(16) float smem_b[];
  float* s_g = smem_b + kBStages * kStage;          // [kBT][kBGLd]
  float* s_mu = s_g + kBT * kBGLd;                  // [kBT]
  float* s_rstd = s_mu + kBT;                       // [kBT]
  int* s_prow = reinterpret_cast<int*>(s_rstd + kBT);  // [kBT]
  const uint32_t ring_base = smem_u32(smem_b);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tok0 = static_cast<int>(blockIdx.x) / ngroups * kBT;
  const int c0 = static_cast<int>(blockIdx.x) % ngroups * gw;
  const int dmo = imin(gw, dm - c0);  // this block's out columns
  const int nval = imin(kBT, ntokens - tok0);
  const int HW = H * W, P = transposed ? W : H;
  const int nz = dm / kBKz;
  const int per_slab = nz + kBNo;
  const int total = cdiv(di, kBSlab) * per_slab;
  const int ch = tid & 7;
  const bool all2[2] = {true, true};

  // stage s: per slab nz chunks of x̂ (the tile's rows) and W_z (the
  // slab's channel rows), then kBNo chunks of kBKo channels of W_out's
  // rows c0..; rows and channels past the widths zero-filled, not read
  auto fetch = [&](int s, uint32_t dst) {
    if (s >= total) return;
    const int n0 = s / per_slab * kBSlab, kb = s % per_slab;
    if (kb < nz) {
      const int k0 = kb * kBKz + 4 * ch;
      const int r = tid >> 3;
      const bool xok = r < nval;
      cp_async16(dst + (r * kBLdZ + 4 * ch) * 4,
                 x + (xok ? static_cast<size_t>(tok0 + r) * dm + k0 : 0),
                 xok);
#pragma unroll
      for (int it = 0; it < kBSlab / 32; ++it) {
        const int rw = r + 32 * it;
        const bool ok = n0 + rw < di;
        cp_async16(dst + ((kBT + rw) * kBLdZ + 4 * ch) * 4,
                   w_z + (ok ? static_cast<size_t>(n0 + rw) * dm + k0 : 0),
                   ok);
      }
    } else {
      const int k0 = n0 + (kb - nz) * kBKo;  // di % 32 == 0: whole chunks
      for (int i = tid; i < 64 * kNT * (kBKo / 4); i += kThreads) {
        const int r = i / (kBKo / 4), h = i % (kBKo / 4);
        const bool ok = k0 < di && r < dmo;
        cp_async16(dst + (r * kBLdO + 4 * h) * 4,
                   w_out + (ok ? static_cast<size_t>(c0 + r) * di + k0 + 4 * h
                               : 0),
                   ok);
      }
    }
  };
  fv::Ring<kBStages, kStage * 4, decltype(fetch)> ring(ring_base, fetch);
  ring.start();

  if (tid < kBT) {  // the pooled row (b·P + line) of each token
    const int tk = tok0 + imin(tid, nval - 1), pix = tk % HW;
    s_prow[tid] = tk / HW * P + (transposed ? pix % W : pix / W);
  }
  __syncthreads();

  // m = ½(yf + D_f·xc_f + yb + D_b·xc_b) of the tile's rows over all of
  // d_inner, for the LayerNorm statistics (they do not depend on z): a
  // warp on 4 rows at once, a lane on 2 channels of each at a time, so
  // that 18 loads a lane are in flight
  if (use_ln) {
    size_t o[4], po[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = imin(4 * warp + e, nval - 1);
      o[e] = static_cast<size_t>(tok0 + rr) * di;
      po[e] = static_cast<size_t>(s_prow[rr]) * di;
    }
    float sum[4] = {0.f, 0.f, 0.f, 0.f}, sumsq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int cc = 2 * lane; cc < di; cc += 64) {
      const float2 df = ld_f2(d_f + cc), db = ld_f2(d_b + cc);
      float2 a[4], bv[4], p[4], q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = ld_f2(xc_f + o[e] + cc);
        bv[e] = ld_f2(xc_b + o[e] + cc);
        p[e] = ld_f2(yf + po[e] + cc);
        q[e] = ld_f2(yb + po[e] + cc);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m0 =
            (p[e].x + df.x * a[e].x + q[e].x + db.x * bv[e].x) * 0.5f;
        const float m1 =
            (p[e].y + df.y * a[e].y + q[e].y + db.y * bv[e].y) * 0.5f;
        sum[e] += m0 + m1;
        sumsq[e] += m0 * m0 + m1 * m1;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) {
        sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], o2);
        sumsq[e] += __shfl_xor_sync(0xffffffffu, sumsq[e], o2);
      }
      if (lane == 0) {
        const float mu = sum[e] / static_cast<float>(di);
        s_mu[4 * warp + e] = mu;  // variance E[m²] - μ², unclamped
        s_rstd[4 * warp + e] =
            rsqrtf(sumsq[e] / static_cast<float>(di) - mu * mu + eps);
      }
    }
  }

  float oacc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][j][e] = 0.f;

  for (int n0 = 0; n0 < di; n0 += kBSlab) {
    // z = x̂·W_z[slab]ᵀ: a warp owns the slab's channels 8·kBZJ·warp..
    // (whole or none of them: di % 32 == 0); the acquires' barriers also
    // publish s_prow, the statistics, and free s_g of the slab before
    const bool z_on = n0 + 8 * kBZJ * warp < di;
    float z[2][kBZJ][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kBZJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[i][j][e] = 0.f;
    for (int kb = 0; kb < nz; ++kb) {
      const float* st = smem_b + (ring.acquire() - ring_base) / 4;
      if (z_on) {
#pragma unroll
        for (int kk = 0; kk < kBKz / 8; ++kk) {
          uint32_t ah[2][4], al[2][4], bh[kBZJ][2], bl[kBZJ][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            frag_a(st + 16 * i * kBLdZ + 8 * kk, kBLdZ, lane, ah[i], al[i]);
#pragma unroll
          for (int j = 0; j < kBZJ; ++j)
            frag_b(st + (kBT + 8 * kBZJ * warp + 8 * j) * kBLdZ + 8 * kk,
                   kBLdZ, lane, bh[j], bl[j]);
          mma3<2, kBZJ>(&z[0][0][0], kBZJ, all2, ah, al, bh, bl);
        }
      }
      ring.refill();
    }

    // g = LN(m)·silu(z + b_z) of the slab into s_g, fp32; channels past
    // d_inner 0
#pragma unroll
    for (int j = 0; j < kBZJ; ++j) {
      const int cl = 8 * kBZJ * warp + 8 * j + 2 * t;  // column in the slab
      const bool cok = n0 + cl < di;
      const int cc = cok ? n0 + cl : 0;
      const float2 df = ld_f2(d_f + cc), db = ld_f2(d_b + cc);
      const float2 bz = b_z ? ld_f2(b_z + cc) : make_float2(0.f, 0.f);
      const float2 lw = use_ln ? ld_f2(ln_w + cc) : make_float2(1.f, 1.f);
      const float2 lb = use_ln ? ld_f2(ln_b + cc) : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 16 * i + g + 8 * e;
          const int rr = imin(row, nval - 1);
          const size_t o = static_cast<size_t>(tok0 + rr) * di + cc;
          const size_t po = static_cast<size_t>(s_prow[rr]) * di + cc;
          const float2 a = ld_f2(xc_f + o), bv = ld_f2(xc_b + o);
          const float2 p = ld_f2(yf + po), q = ld_f2(yb + po);
          float m[2] = {(p.x + df.x * a.x + q.x + db.x * bv.x) * 0.5f,
                        (p.y + df.y * a.y + q.y + db.y * bv.y) * 0.5f};
          const float lwv[2] = {lw.x, lw.y}, lbv[2] = {lb.x, lb.y};
          const float bzv[2] = {bz.x, bz.y};
          float gv[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v =
                use_ln ? (m[h] - s_mu[rr]) * s_rstd[rr] * lwv[h] + lbv[h]
                       : m[h];
            gv[h] = cok ? v * fv::silu(z[i][j][2 * e + h] + bzv[h]) : 0.f;
          }
          *reinterpret_cast<float2*>(s_g + row * kBGLd + cl) =
              make_float2(gv[0], gv[1]);
        }
      }
    }

    // out += g·W_out[c0.., slab]ᵀ, accumulated across slabs (the first
    // acquire publishes s_g)
    for (int oc = 0; oc < kBNo; ++oc) {
      const float* st = smem_b + (ring.acquire() - ring_base) / 4;
      if (n0 + oc * kBKo < di) {
#pragma unroll
        for (int kk = 0; kk < kBKo / 8; ++kk) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            frag_a(s_g + 16 * i * kBGLd + kBKo * oc + 8 * kk, kBGLd, lane,
                   ah[i], al[i]);
#pragma unroll
          for (int j0 = 0; j0 < kNT; j0 += kJG) {
            if (64 * j0 + 8 * warp >= dmo) break;
            // n-tiles past this block's columns read zero-filled rows
            uint32_t bh[kJG][2], bl[kJG][2];
#pragma unroll
            for (int j = 0; j < kJG; ++j)
              frag_b(st + (64 * (j0 + j) + 8 * warp) * kBLdO + 8 * kk,
                     kBLdO, lane, bh[j], bl[j]);
            mma3<2, kJG>(&oacc[0][j0][0], kNT, all2, ah, al, bh, bl);
          }
        }
      }
      ring.refill();
    }
  }

  // out + b_out
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (64 * j + 8 * warp >= dmo) continue;
    const int col = c0 + 64 * j + 8 * warp + 2 * t;
    const float2 bo = b_out ? ld_f2(b_out + col) : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * i + g + 8 * e;
        if (row < nval)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(tok0 + row) *
                                               dm + col) =
              make_float2(oacc[i][j][2 * e] + bo.x,
                          oacc[i][j][2 * e + 1] + bo.y);
      }
  }
}

}  // namespace

namespace fvf {

cudaError_t pass_a_fwd_f32(const void* x, const void* w_x, const void* b_x,
                           const void* w_cf, const void* b_cf,
                           const void* w_ab, const void* b_ab, void* xc_f,
                           void* xc_b, void* pf, void* pb, int batch, int H,
                           int W, int dm, int di, bool transposed,
                           float scaling, cudaStream_t stream) {
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const ARuns r = a_runs(P, ln);
  dim3 grid(cdiv(di, kAN), cdiv(P, r.nl), batch);
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  auto mF = [](void* p) { return static_cast<float*>(p); };
  return launch<pass_a_tf32_kernel>(
      grid, kASmem, stream, cF(x), cF(w_x), cF(b_x), cF(w_cf), cF(b_cf),
      cF(w_ab), cF(b_ab), mF(xc_f), mF(xc_b), mF(pf), mF(pb), H, W, dm, di,
      transposed, scaling, r.nl, r.seg);
}

cudaError_t pass_b_fwd_f32(const void* x, const void* xc_f, const void* xc_b,
                           const void* yf, const void* yb, const void* w_z,
                           const void* b_z, const void* d_f, const void* d_b,
                           const void* ln_w, const void* ln_b,
                           const void* w_out, const void* b_out, void* out,
                           int batch, int H, int W, int dm, int di,
                           bool transposed, bool use_ln, float eps,
                           cudaStream_t stream) {
  // groups of out columns, each a multiple of 64 wide: one up to
  // d_model 768, two past it (FastVim-L: 512, -H: 640)
  const int ngroups = cdiv(dm, kBMaxGroup);
  const int gw = cdiv(cdiv(dm, ngroups), 64) * 64;
  const int nt = gw / 64;
  const long ntokens = static_cast<long>(batch) * H * W;
  const long blocks = (ntokens + kBT - 1) / kBT * ngroups;
  if (ntokens > INT_MAX - kBT || blocks > INT_MAX)
    return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(blocks));
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
#define FV_B(n)                                                              \
  launch<pass_b_tf32_kernel<n>>(                                             \
      grid, b_smem<n>(), stream, cF(x), cF(xc_f), cF(xc_b), cF(yf), cF(yb),  \
      cF(w_z), cF(b_z), cF(d_f), cF(d_b), cF(ln_w), cF(ln_b), cF(w_out),     \
      cF(b_out), static_cast<float*>(out), static_cast<int>(ntokens), H, W,  \
      dm, di, transposed, use_ln, eps, gw, ngroups)
  if (nt <= 3) return FV_B(3);
  if (nt <= 6) return FV_B(6);
  if (nt <= 8) return FV_B(8);
  return FV_B(12);
#undef FV_B
}

}  // namespace fvf
