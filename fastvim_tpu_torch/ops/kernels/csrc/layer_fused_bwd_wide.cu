// K5 and K6 in bf16 at FastVim-B/L/H's widths (past fvb::kNarrowDm /
// kNarrowDi: fvb::wide_form), for Hopper (sm_90a). What they compute is
// set out at the head of layer_fused_bwd.cu; the narrow widths keep their
// single-kernel forms in layer_fused_bwd_wgmma.cu.
//
// What bounds them. At FastVim-B's widths and 2048 px (T = 32,768 tokens
// at B = 2) K5 does five T × 768 × 1536 products (z again, dgated, dx̂'s z
// half, dW_out, dW_z: 0.39 ms on the tensor cores) and K6 three (xin
// again, dxin·W_x, dW_x), and both move a few T × d_inner arrays through
// device memory (~0.5 ms for K5). A 128-token tile's products are fed
// from L2 at about 16 KB a MFLOP, so how many loads and products stay in
// flight sets their rate; the form before this one walked all of d_inner
// a 64-token tile at a time (every tile fetching every weight again, one
// block an SM, a wait on every stage) and reached 2-10 % of the bound.
//
// The design: every product on tiles of 128 tokens, 64 a warpgroup, that
// share one weight stage, in k-steps of 64; a warpgroup waits only for the
// k-step before last (`wgmma.wait_group 1`), so the tensor cores always
// hold the next step's products. The operands are read as they lie (the
// transposed ones MN-major through the descriptor, the 128-wide ones with
// a leading byte offset). In the two kernels that carry most of the
// products (K5's main kernel and the product kernel after the main
// kernels) a producer warp keeps TMA loads of the stages in flight on
// full / empty mbarriers, the two consumer warpgroups issue only the
// products and the epilogue, and a persistent block an SM walks the tiles,
// so the next tile's stages load under an epilogue. The work is cut so
// that the tiles fill the card at every line length:
//
// K5, six launches:
// 1. `b_stats_kernel`: m0's LayerNorm statistics and m̂, a warp a token;
//    m̂ goes in bf16 into dxc_b, which the second pass writes over (the
//    form before this one rounded m0 to bf16 in its epilogue too);
// 2. `b_main_kernel`: z = x̂·W_zᵀ and dgated = g·W_out for a tile of 128
//    flat tokens × 128 channels (whatever lines and images the tokens lie
//    in), then the gate and LayerNorm epilogue on the accumulators: dz and
//    mg = mln·silu(z) (the weight gradients' operands) and dm̂ (parked in
//    dxc_f), stored 16 bytes a lane after a transpose within each quad,
//    the tile's column sums (db_z, dln_w, dln_b) and its rows' sums Σdm̂,
//    Σdm̂·m̂ over its channels; the tile's m̂ loads beside its products;
// 3. `b_second_kernel`: a block a line adds each token's row sums over
//    the channel tiles in order, forms dm0, dxc_f, dxc_b, the line sum dy
//    (which never leaves the block), and the line's dD_f, dD_b, db_out;
// 4. dx̂ (z half) = dz·W_z and 5. dW_out = gᵀ·mg, dW_z = dzᵀ·x̂ (one launch,
//    each written as it lies: no transposed output, split over token
//    slices so that the tiles fill whole waves of the card), both by
//    `gemm_tma_kernel`;
// 6. `sum_rows_kernel`: every partial added in a fixed order, 16 bytes a
//    thread.
// K6, four launches:
// 1. `a_main_kernel`: a window of 128 rows of the conv's 1-D order (122
//    own tokens and 3 halo each side, within one image: rows gathered by
//    cp.async) × 128 channels; xin = x̂·W_xᵀ on the tensor cores, then the
//    conv adjoint a thread a channel and half of the rows: dxin and the
//    conv weight and bias sums; two blocks an SM, so that one's walk runs
//    under the other's products;
// 2. dx̂ = dx̂(K5) + dxin·W_x and 3. dW_x = dxinᵀ·x̂ (`gemm_tma_kernel`);
// 4. the fixed-order sums.
// No atomics anywhere: the results are the same from run to run.

#include <cuda.h>  // CUtensorMap (the driver's entry point is asked at run time)

#include "layer_fused_bwd.cuh"
#include "wgmma.cuh"

// Built with -DFV_PROFILE, thread 0 of each block adds the cycles it spent
// between the WPROF marks of the two main kernels to a row of
// fv_prof_wide, and fv_bwd_wide_phase_cycles sums the rows
// (utils/profiling.py --bwd-phases). Without the flag the marks are empty.
constexpr int kWProfBlocks = 1024, kWProfMarks = 12;
#ifdef FV_PROFILE
__device__ unsigned long long fv_prof_wide[kWProfBlocks][kWProfMarks];
#define WPROF_INIT long long prof_t = clock64();
#define WPROF(k)                                                      \
  if (threadIdx.x == 0) {                                             \
    const long long prof_n = clock64();                               \
    fv_prof_wide[blockIdx.x % kWProfBlocks][k] +=                     \
        static_cast<unsigned long long>(prof_n - prof_t);             \
    prof_t = prof_n;                                                  \
  }
#else
#define WPROF_INIT
#define WPROF(k)
#endif

// out: 12 × uint64, the cycles per mark summed over the blocks since the
// last call, which it sets back to 0. Synchronizes the device.
extern "C" int fv_bwd_wide_phase_cycles(void* out) {
  auto* sums = static_cast<unsigned long long*>(out);
  for (int k = 0; k < kWProfMarks; ++k) sums[k] = 0;
#ifdef FV_PROFILE
  static unsigned long long host[kWProfBlocks][kWProfMarks];
  cudaError_t err = cudaMemcpyFromSymbol(host, fv_prof_wide, sizeof(host));
  if (err != cudaSuccess) return err;
  for (int b = 0; b < kWProfBlocks; ++b)
    for (int k = 0; k < kWProfMarks; ++k) sums[k] += host[b][k];
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, fv_prof_wide);
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
using fv::pack8;
using fv::sigmoid_fast;
using fv::smem_u32;
using fv::swz;
using fvb::kCVec;

constexpr int kThreads = 256;          // two warpgroups
constexpr int kTM = fvb::kWideTM;      // tokens (rows) a tile, 64 a warpgroup
constexpr int kTN = fvb::kWideTN;      // d_inner channels a K5 / K6 tile
constexpr int kWin = fvb::kAWinWide;   // own rows of a K6 window
constexpr int kBlk = 8192;             // 64 × 64 bf16, swizzled
constexpr int kRows = 2 * kBlk;        // 128 rows × 64 bf16

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline long cdivl(long a, long b) { return (a + b - 1) / b; }

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define FV_D8(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
    "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
// d (64 × 128, 64 floats a thread) (+)= A (64 × 16) · B (16 × 128), as
// fv::wgmma_n64 for 128 columns
template <int kTa, int kTb>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : FV_D8(0), FV_D8(8), FV_D8(16), FV_D8(24), FV_D8(32), FV_D8(40),
        FV_D8(48), FV_D8(56)
      : "l"(da), "l"(db), "r"(acc), "n"(kTa), "n"(kTb));
}
#undef FV_D8

// the descriptor of an MN-major operand two 64-column blocks wide: the
// blocks `lbo` bytes apart (the leading byte offset), 8-row groups 1024
__device__ __forceinline__ uint64_t desc_lbo(uint32_t saddr, uint32_t lbo) {
  return (gmma_desc(saddr) & ~(0x3FFFull << 16)) |
         (static_cast<uint64_t>(lbo >> 4) << 16);
}

// acc (64 × 64·kNB) (+)= A (64 × 16, descriptor da) · B (16 × 64·kNB) at
// shared address sb (its k16 step): kTb 0, B K-major, its 64·kNB rows one
// run; 1, MN-major, kNB blocks of 64 columns kBlk apart. `on` 0
// overwrites acc. The accumulator of column 8j + 2(l%4) is acc[4j + ...]
// at every width.
template <int kNB, int kTa, int kTb>
__device__ __forceinline__ void mma_k16(float* acc, uint64_t da, uint32_t sb,
                                        int on) {
  if constexpr (kNB == 1) {
    fv::wgmma_n64<kTa, kTb>(acc, da, gmma_desc(sb), on);
  } else {
#pragma unroll
    for (int h = 0; h < kNB / 2; ++h) {
      const uint32_t b = sb + 2 * h * kBlk;
      wgmma_n128<kTa, kTb>(acc + 64 * h, da,
                           kTb ? desc_lbo(b, kBlk) : gmma_desc(b), on);
    }
  }
}

// The ring of stages, with one k-step's products left in flight: kS slots
// of kStageBytes from shared address `base`, the copies kD = kS - 2 stages
// ahead of the one read. fetch(s, addr) starts stage s's copies (nothing
// past the last) and the ring commits one group for it. acquire() waits
// for the next stage's copies and, by its barrier, for every thread's
// products on the stage two back (each waited for them with wg_wait<1>
// after issuing the stage before), then refills that stage's slot. Groups
// committed before start() only make the first waits stricter.
template <int kS, int kStageBytes, typename Fetch>
struct Ring2 {
  static constexpr int kD = kS - 2;
  uint32_t base;
  int cons;
  Fetch fetch;
  __device__ Ring2(uint32_t b, Fetch f) : base(b), cons(0), fetch(f) {}
  __device__ uint32_t slot(int s) const {
    return base + (s % kS) * kStageBytes;
  }
  __device__ void start() {
    for (int s = 0; s < kD; ++s) {
      fetch(s, slot(s));
      fv::cp_async_commit();
    }
  }
  __device__ uint32_t acquire() {
    fv::cp_async_wait<kD - 1>();
    fv::fence_async_smem();
    __syncthreads();
    const int c = cons++;
    fetch(c + kD, slot(c + kD));
    fv::cp_async_commit();
    return slot(c);
  }
};

// mbarriers and TMA loads (a producer warp and the consumer warpgroups)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a 2-D box of `map` at (inner c0, outer c1) into shared memory at dst,
// completing on the mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// a barrier of the first `n` threads (warps 0 .. n/32 - 1), id 1
__device__ __forceinline__ void bar_sync_first(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// The driver's cuTensorMapEncodeTiled, asked once through the runtime (no
// link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a row-major bf16 (rows, cols) array read in boxes of 64 columns × `box`
// rows, 128-byte swizzled (the tile blocks' layout); out of range: zeros
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, long rows, int cols,
                     int box) {
  EncodeTiled fn;
  const cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t boxd[2] = {64, static_cast<cuuint32_t>(box)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, boxd, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// 128 rows × columns [c0, c0 + 64) of a row-major bf16 array with `ld`
// elements a row into a K-major tile (row r at swz(r, ·)); row(r) < 0:
// zero-filled, not read
template <typename Row>
__device__ __forceinline__ void cp_k128(uint32_t dst, const bf16* src,
                                        size_t ld, int c0, Row row) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int r = i >> 3, ch = i & 7;
    const long t = row(r);
    cp_async16(dst + swz(r, 8 * ch),
               src + (t >= 0 ? static_cast<size_t>(t) * ld + c0 + 8 * ch : 0),
               t >= 0);
  }
}

__device__ __forceinline__ float dsilu_fast(float v) {
  const float s = sigmoid_fast(v);
  return s * (1.f + v * (1.f - s));
}

// two floats rounded to a bf16 pair, as 32 bits
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const bf162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 4 × 4 transpose of 32-bit words over the 4 lanes of a quad (lane q of
// the 4 that share rows in a wgmma accumulator): w[j] of lane q becomes w[q]
// of lane j, in two butterfly exchanges.
__device__ __forceinline__ void quad_transpose(uint32_t* w, int q) {
  {
    const bool hi = q & 2;
    const uint32_t a = __shfl_xor_sync(0xffffffffu, hi ? w[0] : w[2], 2);
    const uint32_t b = __shfl_xor_sync(0xffffffffu, hi ? w[1] : w[3], 2);
    w[0] = hi ? a : w[0];
    w[1] = hi ? b : w[1];
    w[2] = hi ? w[2] : a;
    w[3] = hi ? w[3] : b;
  }
  {
    const bool hi = q & 1;
    const uint32_t a = __shfl_xor_sync(0xffffffffu, hi ? w[0] : w[1], 1);
    const uint32_t b = __shfl_xor_sync(0xffffffffu, hi ? w[2] : w[3], 1);
    w[0] = hi ? a : w[0];
    w[2] = hi ? b : w[2];
    w[1] = hi ? w[1] : a;
    w[3] = hi ? w[3] : b;
  }
}

// m0 = ½(yf + D_f·xc_f + yb + D_b·xc_b) = c0 + hf·xc_f + hb·xc_b with c0 =
// ½(yf + yb), hf = ½D_f, hb = ½D_b: one expression for the three K5
// kernels, so that they form the same m0
__device__ __forceinline__ float m0_of(float c0, float hf, float hb, float a,
                                       float c) {
  return c0 + hf * a + hb * c;
}

// the pooled row (b·P + p) of flat token t
__device__ __forceinline__ int line_of(int t, int H, int W, bool transposed) {
  const int hw = H * W, b = t / hw, rem = t % hw;
  return b * (transposed ? W : H) + (transposed ? rem % W : rem / W);
}

// =====================================================================
// K5 launch 1: m0's LayerNorm statistics and m̂ = (m0 - mu)·rstd (m0
// without the LayerNorm) in bf16, a warp a token
// =====================================================================
constexpr int kStatRows = fvb::kWideStatRows;  // tokens a block

template <bool kLn>
__global__ void __launch_bounds__(kThreads)
b_stats_kernel(const bf16* __restrict__ xc_f, const bf16* __restrict__ xc_b,
               const bf16* __restrict__ yf, const bf16* __restrict__ yb,
               const float* __restrict__ d_f, const float* __restrict__ d_b,
               float2* __restrict__ stats, bf16* __restrict__ mhat, int T,
               int H, int W, int di, bool transposed, float eps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t0 = blockIdx.x * kStatRows;
  const int ncg = di / 8;
  const float inv_di = 1.f / static_cast<float>(di);
  for (int r = warp; r < kStatRows && t0 + r < T; r += kThreads / 32) {
    const int t = t0 + r;
    const size_t o = static_cast<size_t>(t) * di;
    const size_t ol = static_cast<size_t>(line_of(t, H, W, transposed)) * di;
    // m0 of the 8 channels from 8v
    auto m8 = [&](int v, float* m) {
      float a[8], c[8], pf[8], pb[8], df[8], db[8];
      fv::widen16<bf16>(fv::load16(xc_f + o + 8 * v), a);
      fv::widen16<bf16>(fv::load16(xc_b + o + 8 * v), c);
      fv::widen16<bf16>(fv::load16(yf + ol + 8 * v), pf);
      fv::widen16<bf16>(fv::load16(yb + ol + 8 * v), pb);
      fv::widen16<float>(fv::load16(d_f + 8 * v), df);
      fv::widen16<float>(fv::load16(d_f + 8 * v + 4), df + 4);
      fv::widen16<float>(fv::load16(d_b + 8 * v), db);
      fv::widen16<float>(fv::load16(d_b + 8 * v + 4), db + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        m[e] = m0_of(0.5f * (pf[e] + pb[e]), 0.5f * df[e], 0.5f * db[e],
                     a[e], c[e]);
    };
    float mu = 0.f, rstd = 1.f;
    if (kLn) {
      float sum = 0.f, sumsq = 0.f;
      for (int v = lane; v < ncg; v += 32) {
        float m[8];
        m8(v, m);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sum += m[e];
          sumsq += m[e] * m[e];
        }
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, s);
        sumsq += __shfl_xor_sync(0xffffffffu, sumsq, s);
      }
      mu = sum * inv_di;
      rstd = rsqrtf(sumsq * inv_di - mu * mu + eps);
      if (lane == 0) stats[t] = make_float2(mu, rstd);
    }
    // the row again (from L1 / L2): m̂ for the epilogue of the products
    for (int v = lane; v < ncg; v += 32) {
      float m[8];
      m8(v, m);
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = kLn ? (m[e] - mu) * rstd : m[e];
      *reinterpret_cast<uint4*>(mhat + o + 8 * v) = pack8(m);
    }
  }
}

// =====================================================================
// K5 launch 2: z, dgated and the gate / LayerNorm epilogue on tiles of
// 128 tokens × 128 channels. Warps 0-7 (two warpgroups, 64 rows each)
// issue the products and run the epilogue; warp 8 is the producer, whose
// one thread keeps TMA loads of the stages in flight (full / empty
// mbarriers), so that the warpgroups spend no instruction on copies.
// =====================================================================
constexpr int kBStages = 5;
constexpr int kBStage = 2 * kRows;  // the A rows (x̂ or g), then W's
constexpr int kNPar = 3;            // b_z, ln_w, ln_b
constexpr int kBConsumers = 256;    // threads of the two warpgroups
constexpr int kBThreads = kBConsumers + 128;
constexpr size_t kBMh = static_cast<size_t>(kBStages) * kBStage;
constexpr size_t kBColred = kBMh + kRows + kRows;  // m̂: two 64-col boxes
constexpr size_t kBPar = kBColred + 8 * 3 * kTN * sizeof(float);
constexpr size_t kBBar = kBPar + 2 * kNPar * kTN * sizeof(float);
constexpr size_t kBMainSmem = kBBar + (2 * kBStages + 2) * 8 + 1024;

// the tensor maps of one call: x̂, g (T, dm); W_z (di, dm); W_out (dm, di)
// in boxes of 64 × 64; m̂ (T, di)
struct BMaps {
  CUtensorMap x, g, w_z, w_out, mhat;
};

// kLn: the LayerNorm is on (use_ln)
template <bool kLn>
__global__ void __launch_bounds__(kBThreads, 1)
b_main_kernel(const __grid_constant__ BMaps maps,
              const float* __restrict__ b_z, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, bf16* __restrict__ park,
              bf16* __restrict__ mg, bf16* __restrict__ dzs,
              float* __restrict__ colpart, float2* __restrict__ rowpart, int T,
              int dm, int di) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  const uint32_t s_mh = base + kBMh;  // two K-major boxes of 128 × 64
  float* s_colred = reinterpret_cast<float*>(sm + kBColred);  // [8][3][128]
  float* s_par = reinterpret_cast<float*>(sm + kBPar);  // [2][kNPar][128]
  const uint32_t full = base + kBBar, empty = full + 8 * kBStages;
  const uint32_t mh_full = empty + 8 * kBStages, mh_empty = mh_full + 8;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nu = dm / 64, nct = (di + kTN - 1) / kTN;
  const int ntiles = (T + kTM - 1) / kTM * nct;
  if (tid == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kBConsumers / 32);
    }
    mbar_init(mh_full, 1);
    mbar_init(mh_empty, kBConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kBConsumers / 32) {
    // ---- the producer: one thread, the whole kernel ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != kBConsumers) return;
    int g = 0, tcount = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++tcount) {
      const int t0 = tile / nct * kTM, n0 = tile % nct * kTN;
      for (int r = 0; r < 2 * nu; ++r, ++g) {
        const int slot = g % kBStages;
        const uint32_t st = base + slot * kBStage, bar = full + 8 * slot;
        mbar_wait(empty + 8 * slot, ((g / kBStages) & 1) ^ 1);
        mbar_expect_tx(bar, kBStage);
        const int kb = r % nu;
        if (r < nu) {  // z: x̂ and W_z, both K-major
          tma_load(st, &maps.x, 64 * kb, t0, bar);
          tma_load(st + kRows, &maps.w_z, 64 * kb, n0, bar);
        } else {  // dgated: g K-major, W_out MN-major in two 64-col boxes
          tma_load(st, &maps.g, 64 * kb, t0, bar);
          tma_load(st + kRows, &maps.w_out, n0, 64 * kb, bar);
          tma_load(st + kRows + kBlk, &maps.w_out, n0 + 64, 64 * kb, bar);
        }
        // the tile's m̂, once the tile before has done with the buffer
        if (r == imin(kBStages, 2 * nu) - 1) {
          mbar_wait(mh_empty, (tcount & 1) ^ 1);
          mbar_expect_tx(mh_full, 2 * kRows);
          tma_load(s_mh, &maps.mhat, n0, t0, mh_full);
          tma_load(s_mh + kRows, &maps.mhat, n0 + 64, t0, mh_full);
        }
      }
    }
    return;
  }

  // ---- the two consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  float z[64], dg[64];
  int g = 0, tcount = 0;
  WPROF_INIT
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++tcount) {
    const int t0 = tile / nct * kTM, n0 = tile % nct * kTN;
    float* par = s_par + (tcount & 1) * kNPar * kTN;
    if (tid < kTN) {  // the tile's channels' parameters, for the epilogue
      const int c = n0 + tid;
      const bool ok = c < di;
      par[tid] = ok && b_z ? b_z[c] : 0.f;
      par[kTN + tid] = kLn ? (ok ? ln_w[c] : 0.f) : 1.f;
      par[2 * kTN + tid] = kLn && ok ? ln_b[c] : 0.f;
    }
    // z, then dgated: wait for a stage, issue its products, and free the
    // stage before it once its products are done (wgmma.wait_group 1)
    for (int r = 0; r < 2 * nu; ++r, ++g) {
      const int slot = g % kBStages;
      const uint32_t st = base + slot * kBStage;
      mbar_wait(full + 8 * slot, (g / kBStages) & 1);
      fv::wgmma_fence();
      const int kb = r % nu;
      if (r < nu) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_k16<2, 0, 0>(z, gmma_desc(st + wg * kBlk + 32 * kk),
                           st + kRows + 32 * kk, (kb | kk) != 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_k16<2, 0, 1>(dg, gmma_desc(st + wg * kBlk + 32 * kk),
                           st + kRows + 2048 * kk, (kb | kk) != 0);
      }
      fv::wgmma_commit();
      wg_wait<1>();
      if (r > 0 && lane == 0) mbar_arrive(empty + 8 * ((g - 1) % kBStages));
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % kBStages));
    mbar_wait(mh_full, tcount & 1);
    bar_sync_first(kBConsumers);  // the tile's parameters are written
    WPROF(0)

    // this thread's rows r0 and r0 + 8 of its warpgroup's 64
    const int r0 = 64 * wg + 16 * w4 + rq;
    const int jmax = imin(16, (di - n0) / 8);  // 8-column groups in di
    bool rv[2];
    size_t orow[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + r0 + 8 * e;
      rv[e] = t < T;
      orow[e] = static_cast<size_t>(rv[e] ? t : 0) * di + n0;
    }
    WPROF(8)
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int jg = 0; jg < 4; ++jg) {
      // dz, mg, dm̂ of this group's columns as bf16 pairs: [row][j]
      uint32_t wz[2][4], wm[2][4], wp[2][4];
      float csum[24];  // [3 sums][4 j][2 columns] over this thread's rows
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jg + jj;
        const int cb = 8 * j + 2 * q;  // column in the tile
        const float2 bz = *reinterpret_cast<const float2*>(par + cb);
        const float2 lw = *reinterpret_cast<const float2*>(par + kTN + cb);
        const float2 lb = *reinterpret_cast<const float2*>(par + 2 * kTN + cb);
        const float bzv[2] = {bz.x, bz.y}, lwv[2] = {lw.x, lw.y},
                    lbv[2] = {lb.x, lb.y};
        float cs[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 mh2 = __bfloat1622float2(*reinterpret_cast<const bf162*>(
              sm + kBMh + (cb / 64) * kRows + swz(r0 + 8 * e, cb % 64)));
          const float mhv[2] = {mh2.x, mh2.y};
          const bool live = rv[e] && j < jmax;
          float dzv[2], mgv[2], dmh[2];  // the row's two columns
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 4 * j + 2 * e + h;
            const float mhat = mhv[h];
            const float mln = kLn ? mhat * lwv[h] + lbv[h] : mhat;
            const float zz = z[idx] + bzv[h];
            const float sig = sigmoid_fast(zz);
            const float sz = zz * sig;
            const float dgt = live ? dg[idx] : 0.f;
            const float dmln = dgt * sz;
            dzv[h] = dgt * mln * sig * (1.f + zz * (1.f - sig));
            mgv[h] = mln * sz;
            cs[0][h] += dzv[h];
            if (kLn) {
              cs[1][h] += dmln * mhat;
              cs[2][h] += dmln;
            }
            dmh[h] = kLn ? dmln * lwv[h] : dmln;
            s1[e] += dmh[h];
            s2[e] += dmh[h] * mhat;
          }
          wz[e][jj] = pack2(dzv[0], dzv[1]);
          wm[e][jj] = pack2(mgv[0], mgv[1]);
          wp[e][jj] = pack2(dmh[0], dmh[1]);
        }
#pragma unroll
        for (int v = 0; v < 3; ++v)
#pragma unroll
          for (int h = 0; h < 2; ++h) csum[v * 8 + jj * 2 + h] = cs[v][h];
      }
      // the quad's pairs transposed, so that a lane holds the 8 columns
      // of group 4·jg + q: one 16-byte store an array and row (dm̂ waits in
      // dxc_f for the second pass)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        quad_transpose(wz[e], q);
        quad_transpose(wm[e], q);
        quad_transpose(wp[e], q);
        if (rv[e] && 4 * jg + q < jmax) {
          const size_t o = orow[e] + 8 * (4 * jg + q);
          *reinterpret_cast<uint4*>(dzs + o) =
              make_uint4(wz[e][0], wz[e][1], wz[e][2], wz[e][3]);
          *reinterpret_cast<uint4*>(mg + o) =
              make_uint4(wm[e][0], wm[e][1], wm[e][2], wm[e][3]);
          *reinterpret_cast<uint4*>(park + o) =
              make_uint4(wp[e][0], wp[e][1], wp[e][2], wp[e][3]);
        }
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
        s_colred[(warp * 3 + k / 8) * kTN + 8 * (4 * jg + k % 8 / 2) + 2 * q +
                 k % 2] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
    }
    // the warp has read its m̂: the producer may load the next tile's
    __syncwarp();
    if (lane == 0) mbar_arrive(mh_empty);
    // the rows' sums over this tile's channels
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = s1[e], c = s2[e];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      if (kLn && q == 0 && rv[e])
        rowpart[static_cast<size_t>(tile % nct) * T + t0 + r0 + 8 * e] =
            make_float2(a, c);
    }
    WPROF(1)
    bar_sync_first(kBConsumers);
    // db_z, dln_w, dln_b of the tile: the 8 warps' sums in order
    for (int i = tid; i < 3 * kTN; i += kBConsumers) {
      const int v = i / kTN, c = i % kTN;
      if (n0 + c < di) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += s_colred[(w * 3 + v) * kTN + c];
        colpart[static_cast<size_t>(tile / nct) * 3 * di + v * di + n0 + c] =
            sum;
      }
    }
    WPROF(2)
  }
}

// =====================================================================
// K5 launch 3: dm0 and what hangs on it, and db_out, a block a line
// =====================================================================
constexpr int kChunk = 128;  // rows whose row terms are staged at a time

__host__ __device__ inline int row_lanes(int di) {
  const int r = kThreads / (di / 8);
  return r > 1 ? r : 1;
}
inline size_t second_smem(int di) {
  return (3 + 3 * static_cast<size_t>(row_lanes(di))) * di * sizeof(float) +
         kChunk * sizeof(float4);
}

__global__ void __launch_bounds__(kThreads)
b_second_kernel(const bf16* __restrict__ g, const bf16* __restrict__ xc_f,
                const bf16* __restrict__ xc_b, const bf16* __restrict__ yf,
                const bf16* __restrict__ yb, const float* __restrict__ d_f,
                const float* __restrict__ d_b,
                const float2* __restrict__ stats,
                const float2* __restrict__ rowpart, bf16* dxc_f,
                bf16* __restrict__ dxc_b, bf16* __restrict__ dy,
                float* __restrict__ ddpart, int T, int H, int W, int dm,
                int di, bool transposed, bool use_ln) {
  extern __shared__ float4 smem_f4[];
  float* s_col = reinterpret_cast<float*>(smem_f4);  // c0, hf, hb [3][di]
  const int tid = threadIdx.x;
  const int ncg = di / 8, nrl = row_lanes(di), nct = (di + kTN - 1) / kTN;
  float* s_acc = s_col + 3 * di;                             // [nrl][3][di]
  float4* s_tp = reinterpret_cast<float4*>(s_acc + nrl * 3 * di);  // [kChunk]
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const int prow = blockIdx.x;
  const int img = prow / P * H * W, p = prow % P;
  auto token = [&](int i) -> int {
    return img + (transposed ? i * W + p : p * W + i);
  };
  const float inv_di = 1.f / static_cast<float>(di);
  float* dd = ddpart + static_cast<size_t>(prow) * (2 * di + dm);
  // db_out over the line's tokens: 8 columns a thread, the rows dealt out
  // to nrd lanes whose sums meet (in order) in s_acc
  const int ncd = dm / 8, nrd = kThreads / ncd > 1 ? kThreads / ncd : 1;
  for (int item = tid; item < nrd * ncd; item += kThreads) {
    const int c8 = item % ncd, rl = item / ncd;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int i = rl; i < ln; i += nrd) {
      float v[8];
      fv::widen16<bf16>(
          fv::load16(g + static_cast<size_t>(token(i)) * dm + 8 * c8), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += v[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) s_acc[rl * dm + 8 * c8 + e] = acc[e];
  }
  __syncthreads();
  for (int c = tid; c < dm; c += kThreads) {
    float sum = 0.f;
    for (int rl = 0; rl < nrd; ++rl) sum += s_acc[rl * dm + c];
    dd[2 * di + c] = sum;
  }
  __syncthreads();
  for (int i = tid; i < di; i += kThreads) {
    s_col[i] = 0.5f * (__bfloat162float(yf[static_cast<size_t>(prow) * di + i]) +
                       __bfloat162float(yb[static_cast<size_t>(prow) * di + i]));
    s_col[di + i] = 0.5f * d_f[i];
    s_col[2 * di + i] = 0.5f * d_b[i];
  }
  for (int i = tid; i < nrl * 3 * di; i += kThreads) s_acc[i] = 0.f;

  for (int i0 = 0; i0 < ln; i0 += kChunk) {
    const int nval = imin(kChunk, ln - i0);
    __syncthreads();  // s_col, s_acc set; the previous chunk's readers done
    // mu, rstd, Σdm̂ / di, Σdm̂·m̂ / di of each row: the channel tiles'
    // sums added in order
    for (int r = tid; r < nval; r += kThreads) {
      const int t = token(i0 + r);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (use_ln) {
        const float2 st = stats[t];
        float a = 0.f, c = 0.f;
        for (int ct = 0; ct < nct; ++ct) {
          const float2 rp = rowpart[static_cast<size_t>(ct) * T + t];
          a += rp.x;
          c += rp.y;
        }
        v = make_float4(st.x, st.y, a * inv_di, c * inv_di);
      }
      s_tp[r] = v;
    }
    __syncthreads();
    // a thread per 8 channels (in turn where there are more groups than
    // threads), 4 rows' loads in flight
    for (int item = tid; item < nrl * ncg; item += kThreads) {
      const int cg = item % ncg, rl = item / ncg;
      float c0[8], hf[8], hb[8];
      fv::lds_f8(s_col + cg * 8, c0);
      fv::lds_f8(s_col + di + cg * 8, hf);
      fv::lds_f8(s_col + 2 * di + cg * 8, hb);
      float af[8], ab[8], ay[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) af[e] = ab[e] = ay[e] = 0.f;
      for (int rb = rl; rb < nval; rb += 4 * nrl) {
        uint4 vd[4], va[4], vc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const size_t o =
              static_cast<size_t>(token(i0 + imin(rb + k * nrl, nval - 1))) *
                  di + cg * 8;
          vd[k] = __ldcg(reinterpret_cast<const uint4*>(dxc_f + o));
          va[k] = fv::load16(xc_f + o);
          vc[k] = fv::load16(xc_b + o);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = imin(rb + k * nrl, nval - 1);
          const bool live = rb + k * nrl < nval;  // else: a masked repeat
          const size_t o = static_cast<size_t>(token(i0 + r)) * di + cg * 8;
          float dmh[8], a[8], c[8], of[8], ob[8];
          fv::widen16<bf16>(vd[k], dmh);
          fv::widen16<bf16>(va[k], a);
          fv::widen16<bf16>(vc[k], c);
          const float4 tp = s_tp[r];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float dm0 = dmh[e];
            if (use_ln) {
              const float m0 = m0_of(c0[e], hf[e], hb[e], a[e], c[e]);
              dm0 = tp.y * (dmh[e] - tp.z - (m0 - tp.x) * tp.y * tp.w);
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
      float* slot = s_acc + static_cast<size_t>(rl) * 3 * di + cg * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        slot[e] += af[e];
        slot[di + e] += ab[e];
        slot[2 * di + e] += ay[e];
      }
    }
  }
  __syncthreads();
  // dD_f, dD_b to the line's partial, the line sum to dy
  for (int i = tid; i < 3 * di; i += kThreads) {
    float s = 0.f;
    for (int k = 0; k < nrl; ++k) s += s_acc[static_cast<size_t>(k) * 3 * di + i];
    if (i < 2 * di)
      dd[i] = s;
    else
      dy[static_cast<size_t>(prow) * di + i - 2 * di] = __float2bfloat16(s);
  }
}

// SMs of the device, asked once
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// =====================================================================
// The products of the wide forms after their main kernels, one persistent
// kernel on TMA loads: a tile of 128 rows × 64·kNB columns, K in steps of
// 64 through kGStages stages; warps 0-7 issue the products (64 rows a
// warpgroup), warp 8's one thread the loads (full / empty mbarriers).
// - dx̂ (kWgrad false): out (T × dm, fp32) = add + A·W with A (T, di) =
//   dz or dxin, K-major, and W (di, dm) = W_z or W_x as it lies (MN-major);
//   add (T, dm) fp32 or null (K6: dx̂ of K5).
// - weight gradients (kWgrad true): out[job] + split·M·N (M × N, fp32) =
//   X[slice]ᵀ · Y[slice], X (T, M) and Y (T, N) bf16 row-major, both
//   MN-major; the tokens in slices of whole 64-token steps (the last ends
//   at T, past which the loads read zeros).
// =====================================================================
constexpr int kGStages = 4;
template <int kNB>
__host__ __device__ constexpr int gemm_stage() {
  return kRows + kNB * kBlk;
}
template <int kNB>
constexpr size_t gemm_smem() {
  return static_cast<size_t>(kGStages) * gemm_stage<kNB>() +
         2 * kGStages * 8 + 1024;
}

struct GemmJobs {
  CUtensorMap a[2], b[2];  // A or X; W or Y (boxes of 64 × 128 / 64 rows)
  float* out[2];
  const float* add;        // dx̂ only
  int M[2], N[2];          // out's rows and columns
  int count;               // jobs
};

template <int kNB, bool kWgrad>
__global__ void __launch_bounds__(kBThreads, 1)
gemm_tma_kernel(const __grid_constant__ GemmJobs jobs, int T, int K,
                int nsplit) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  constexpr int kStage = gemm_stage<kNB>();
  const uint32_t full = base + kGStages * kStage, empty = full + 8 * kGStages;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // tiles: job, then token slice (weight gradients), then rows, columns
  auto tiles_of = [&](int j) {
    return (jobs.M[j] + kTM - 1) / kTM * (jobs.N[j] / (64 * kNB)) * nsplit;
  };
  const int ntiles = tiles_of(0) + (jobs.count > 1 ? tiles_of(1) : 0);
  const long per =
      kWgrad ? cdivl(cdivl(T, nsplit), 64) * 64 : static_cast<long>(K);
  struct Tile {
    int job, m0, n0, nk;
    long k0;
  };
  auto tile_at = [&](int t) {
    Tile u;
    u.job = t >= tiles_of(0);
    if (u.job) t -= tiles_of(0);
    const int nbn = jobs.N[u.job] / (64 * kNB);
    const int per_split = (jobs.M[u.job] + kTM - 1) / kTM * nbn;
    const int split = t / per_split, r = t % per_split;
    u.m0 = r / nbn * kTM;
    u.n0 = r % nbn * 64 * kNB;
    u.k0 = split * per;
    const long kend = kWgrad ? (u.k0 + per < T ? u.k0 + per : T) : K;
    u.nk = kend > u.k0 ? static_cast<int>(cdivl(kend - u.k0, 64)) : 0;
    return u;
  };
  if (tid == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kBConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kBConsumers / 32) {
    // ---- the producer: one thread, the whole kernel ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != kBConsumers) return;
    int g = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile u = tile_at(t);
      const CUtensorMap* a = &jobs.a[u.job];
      const CUtensorMap* b = &jobs.b[u.job];
      for (int k = 0; k < u.nk; ++k, ++g) {
        const int slot = g % kGStages;
        const uint32_t st = base + slot * kStage, bar = full + 8 * slot;
        mbar_wait(empty + 8 * slot, ((g / kGStages) & 1) ^ 1);
        mbar_expect_tx(bar, kStage);
        const int kc = static_cast<int>(u.k0) + 64 * k;
        if (kWgrad) {  // X's 128 columns, MN-major: two 64-column boxes
          tma_load(st, a, u.m0, kc, bar);
          tma_load(st + kBlk, a, u.m0 + 64, kc, bar);
        } else {  // A's 128 rows, K-major
          tma_load(st, a, kc, u.m0, bar);
        }
#pragma unroll
        for (int h = 0; h < kNB; ++h)
          tma_load(st + kRows + h * kBlk, b, u.n0 + 64 * h, kc, bar);
      }
    }
    return;
  }

  // ---- the two consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  float acc[32 * kNB];
  int g = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile u = tile_at(t);
    for (int k = 0; k < u.nk; ++k, ++g) {
      const int slot = g % kGStages;
      const uint32_t st = base + slot * kStage;
      mbar_wait(full + 8 * slot, (g / kGStages) & 1);
      fv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_k16<kNB, kWgrad ? 1 : 0, 1>(
            acc,
            gmma_desc(st + wg * kBlk + (kWgrad ? 2048 : 32) * kk),
            st + kRows + 2048 * kk, (k | kk) != 0);
      fv::wgmma_commit();
      wg_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(empty + 8 * ((g - 1) % kGStages));
    }
    wg_wait<0>();
    if (u.nk > 0 && lane == 0) mbar_arrive(empty + 8 * ((g - 1) % kGStages));
    const int M = jobs.M[u.job], N = jobs.N[u.job];
    float* out = jobs.out[u.job] +
                 (kWgrad ? static_cast<size_t>(u.k0 / per) * M * N : 0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = u.m0 + 64 * wg + 16 * w4 + rq + 8 * e;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8 * kNB; ++j) {
        const size_t o = static_cast<size_t>(row) * N + u.n0 + 8 * j + 2 * q;
        float2 v = u.nk > 0
                       ? make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1])
                       : make_float2(0.f, 0.f);
        if (!kWgrad && jobs.add) {
          const float2 a2 = ld_f2(jobs.add + o);
          v.x += a2.x;
          v.y += a2.y;
        }
        *reinterpret_cast<float2*>(out + o) = v;
      }
    }
  }
}

// the widest column group (64·kNB) that divides every N a call's
// products take
inline int wide_nb(int dm, int di) {
  if (dm % 256 == 0 && di % 256 == 0) return 4;
  if (dm % 128 == 0 && di % 128 == 0) return 2;
  return 1;
}

// Launch gemm_tma_kernel<nb, kWgrad> over `jobs` (their tensor maps set),
// a persistent block an SM
template <bool kWgrad>
cudaError_t gemm_tma(const GemmJobs& jobs, int nb, int T, int K, int nsplit,
                     cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  long tiles = 0;
  for (int j = 0; j < jobs.count; ++j)
    tiles += static_cast<long>(jobs.M[j] + kTM - 1) / kTM *
             (jobs.N[j] / (64 * nb)) * nsplit;
  if (tiles > 0x7fffffffL) return cudaErrorInvalidValue;
  const unsigned blocks =
      static_cast<unsigned>(tiles < sms ? tiles : sms > 0 ? sms : 1);
  auto run = [&](auto kernel, cudaError_t allowed,
                 size_t smem) -> cudaError_t {
    if (allowed != cudaSuccess) return allowed;
    kernel<<<blocks, kBThreads, smem, stream>>>(jobs, T, K, nsplit);
    return cudaGetLastError();
  };
  switch (nb) {
    case 4:
      return run(gemm_tma_kernel<4, kWgrad>,
                 fv::allow_max_smem<gemm_tma_kernel<4, kWgrad>>(),
                 gemm_smem<4>());
    case 2:
      return run(gemm_tma_kernel<2, kWgrad>,
                 fv::allow_max_smem<gemm_tma_kernel<2, kWgrad>>(),
                 gemm_smem<2>());
    default:
      return run(gemm_tma_kernel<1, kWgrad>,
                 fv::allow_max_smem<gemm_tma_kernel<1, kWgrad>>(),
                 gemm_smem<1>());
  }
}

// dx̂ = add + A·W: A (T, di) bf16, W (di, dm) bf16, add null or (T, dm)
cudaError_t dx_wide(const void* A, const void* Wm, const void* add, void* out,
                    int T, int di, int dm, cudaStream_t stream) {
  GemmJobs jobs{};
  cudaError_t err;
  if ((err = bf16_map(&jobs.a[0], A, T, di, kTM)) != cudaSuccess ||
      (err = bf16_map(&jobs.b[0], Wm, di, dm, 64)) != cudaSuccess)
    return err;
  jobs.out[0] = static_cast<float*>(out);
  jobs.add = static_cast<const float*>(add);
  jobs.M[0] = T;
  jobs.N[0] = dm;
  jobs.count = 1;
  return gemm_tma<false>(jobs, wide_nb(dm, di), T, di, 1, stream);
}

// out[j] (+ split·M·N) = X[j][slice]ᵀ · Y[j][slice]: X (T, M[j]), Y (T,
// N[j]) bf16; nsplit token slices
cudaError_t wgrad_wide(const void* const* X, const void* const* Y,
                       float* const* out, const int* M, const int* N,
                       int count, int T, int nsplit, int dm, int di,
                       cudaStream_t stream) {
  GemmJobs jobs{};
  cudaError_t err;
  for (int j = 0; j < count; ++j) {
    if ((err = bf16_map(&jobs.a[j], X[j], T, M[j], 64)) != cudaSuccess ||
        (err = bf16_map(&jobs.b[j], Y[j], T, N[j], 64)) != cudaSuccess)
      return err;
    jobs.out[j] = out[j];
    jobs.M[j] = M[j];
    jobs.N[j] = N[j];
  }
  jobs.count = count;
  return gemm_tma<true>(jobs, wide_nb(dm, di), T, 0, nsplit, stream);
}

// =====================================================================
// the fixed-order sums: out[i] = Σ_s part[s·n + i], s < S, in order, or
// past kSumWarps partials as kSumWarps interleaved sums added in order;
// n % 4 == 0, 16-byte aligned
// =====================================================================
struct RowSeg {
  const float* part;
  float* out;
  long n;
  int S;
};
constexpr int kMaxRowSegs = 4;
constexpr int kSumWarps = 16;
struct RowSegs {
  RowSeg seg[kMaxRowSegs];
  int count;
};

// entries of a segment a block adds: 128 (4 a lane) where its warps deal
// out the partials between them, 128 a warp where each warp takes them
// all (S <= kSumWarps)
__host__ __device__ inline long sum_span(const RowSeg& sg) {
  return sg.S > kSumWarps ? 128 : 128 * kSumWarps;
}

// S > kSumWarps: each warp takes every kSumWarps-th partial, then warp 0
// adds the warps' sums in order; else each warp adds its own 128 entries
// over all partials in order
__global__ void __launch_bounds__(32 * kSumWarps)
sum_rows_kernel(RowSegs segs) {
  __shared__ float4 red[kSumWarps][32];
  const int o = threadIdx.x % 32, sl = threadIdx.x / 32;
  long blk = blockIdx.x;
  int k = 0;
  while (k < segs.count - 1 && blk >= cdivl(segs.seg[k].n, sum_span(segs.seg[k])))
    blk -= cdivl(segs.seg[k].n, sum_span(segs.seg[k])), ++k;
  const RowSeg& sg = segs.seg[k];
  if (sg.S <= kSumWarps) {
    const long i = blk * sum_span(sg) + 128 * sl + 4 * o;
    if (i >= sg.n) return;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < sg.S; ++s) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(sg.part + s * sg.n + i));
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(sg.out + i) = acc;
    return;
  }
  const long i = blk * 128 + 4 * o;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < sg.n)
#pragma unroll 4
    for (int s = sl; s < sg.S; s += kSumWarps) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(sg.part + s * sg.n + i));
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  red[sl][o] = acc;
  __syncthreads();
  if (sl == 0 && i < sg.n) {
#pragma unroll
    for (int w = 1; w < kSumWarps; ++w) {
      acc.x += red[w][o].x;
      acc.y += red[w][o].y;
      acc.z += red[w][o].z;
      acc.w += red[w][o].w;
    }
    *reinterpret_cast<float4*>(sg.out + i) = acc;
  }
}

cudaError_t sum_rows(const RowSegs& segs, cudaStream_t stream) {
  long blocks = 0;
  for (int k = 0; k < segs.count; ++k)
    blocks += cdivl(segs.seg[k].n, sum_span(segs.seg[k]));
  if (blocks < 1) return cudaSuccess;
  sum_rows_kernel<<<static_cast<unsigned>(blocks), 32 * kSumWarps, 0,
                    stream>>>(segs);
  return cudaGetLastError();
}

// =====================================================================
// K6 launch 1: xin and the conv adjoint on a window of 128 conv-order rows
// × 128 channels; two blocks an SM, so that one's conv walk runs under
// the other's products
// =====================================================================
constexpr int kXinLd = kTN + 4;         // fp32 row of xin in shared, skewed
constexpr int kMaxLines = kTM / 4 + 2;  // lines a window can touch (>= 4 a line)
constexpr int kAStages = 3;
constexpr int kAStage = 2 * kRows;      // the window's x̂ rows, then W_x's
// after the products the ring's memory holds xin and the pooled
// cotangents
constexpr size_t kAXin = 0;
constexpr size_t kAPool = kTM * kXinLd * sizeof(float);
constexpr size_t kARing = static_cast<size_t>(kAStages) * kAStage;
constexpr size_t kACred = kARing;
constexpr size_t kATok = kACred + kCVec * kTN * sizeof(float);
constexpr size_t kAMainSmem = kATok + kTM * sizeof(int) + 1024;
static_assert(kAPool + 2 * kMaxLines * kTN * sizeof(bf16) <= kARing,
              "xin and the pooled cotangents fit the ring");
static_assert(2 * kAMainSmem <= kMaxSmem, "two blocks an SM");

__global__ void __launch_bounds__(kThreads, 2)
a_main_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dxc_f,
              const bf16* __restrict__ dxc_b, const bf16* __restrict__ dpf,
              const bf16* __restrict__ dpb, const bf16* __restrict__ w_x,
              const float* __restrict__ b_x, const float* __restrict__ w_cf,
              const float* __restrict__ b_cf, const float* __restrict__ w_ab,
              const float* __restrict__ b_ab, bf16* __restrict__ dxin,
              float* __restrict__ c_part, int H, int W, int dm, int di,
              bool transposed, float scaling) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  float* s_xin = reinterpret_cast<float*>(sm + kAXin);      // [128][kXinLd]
  bf16* s_pool = reinterpret_cast<bf16*>(sm + kAPool);      // [2][lines][128]
  float* s_cred = reinterpret_cast<float*>(sm + kACred);    // [11][128]
  int* s_tok = reinterpret_cast<int*>(sm + kATok);          // [128]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4, q = lane % 4, rq = lane / 4;
  const int nu = dm / 64, nct = (di + kTN - 1) / kTN;
  const int ct = static_cast<int>(blockIdx.x % nct);
  const int wi = static_cast<int>(blockIdx.x / nct);  // window of the batch
  const int P = transposed ? W : H, ln = transposed ? H : W;
  const int Ltok = H * W, nwin = (Ltok + kWin - 1) / kWin;
  const int b = wi / nwin;
  // row j of the tile is position tt0 + j of the conv's 1-D order; rows
  // 3 .. 3 + kWin - 1 are the window's own, the rest halo
  const int tt0 = wi % nwin * kWin - 3;
  const int img = b * Ltok;
  const int n0 = ct * kTN, sw = imin(kTN, di - n0);
  const float sw_pool = scaling / static_cast<float>(ln);
  WPROF_INIT

  // the token of each row, -1 outside the image
  for (int r = tid; r < kTM; r += kThreads) {
    const int t = tt0 + r;
    s_tok[r] = t >= 0 && t < Ltok
                   ? img + (transposed ? t % H * W + t / H : t)
                   : -1;
  }
  __syncthreads();
  auto fetch = [&](int s, uint32_t dst) {
    if (s >= nu) return;
    cp_k128(dst, x, dm, 64 * s, [&](int r) -> long { return s_tok[r]; });
    cp_k128(dst + kRows, w_x, dm, 64 * s, [&](int r) -> long {
      return n0 + r < di ? n0 + r : -1;
    });
  };
  Ring2<kAStages, kAStage, decltype(fetch)> ring(base, fetch);
  ring.start();
  WPROF(3)

  float xin[64];
  for (int kb = 0; kb < nu; ++kb) {
    const uint32_t st = ring.acquire();
    fv::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_k16<2, 0, 0>(xin, gmma_desc(st + wg * kBlk + 32 * kk),
                       st + kRows + 32 * kk, (kb | kk) != 0);
    fv::wgmma_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  WPROF(4)
  __syncthreads();  // every warpgroup is past its products: the ring is free
  {
    const int r0 = 64 * wg + 16 * w4 + rq;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int cb = 8 * j + 2 * q;
      const float2 bx = b_x && cb < sw ? ld_f2(b_x + n0 + cb)
                                       : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * e;
        *reinterpret_cast<float2*>(s_xin + r * kXinLd + cb) =
            s_tok[r] >= 0 ? make_float2(xin[4 * j + 2 * e] + bx.x,
                                        xin[4 * j + 2 * e + 1] + bx.y)
                          : make_float2(0.f, 0.f);
      }
    }
  }
  // the pooled cotangents of the lines the window touches (0 for a line
  // outside the image, whose rows are outside the sequence)
  const int lbase = tt0 < 0 ? -1 : tt0 / ln;
  const int nlines = (tt0 + kTM - 1) / ln - lbase + 1;
  for (int i = tid; i < 2 * nlines * kTN; i += kThreads) {
    const int l = i / kTN % nlines, ch = i % kTN;
    const bool bwd = i >= nlines * kTN;
    const int line = lbase + l;
    s_pool[(bwd * kMaxLines + l) * kTN + ch] =
        line >= 0 && line < P && ch < sw
            ? (bwd ? dpb : dpf)[(static_cast<size_t>(b) * P + line) * di +
                                n0 + ch]
            : __float2bfloat16(0.f);
  }
  __syncthreads();
  WPROF(5)

  // The conv adjoint: a thread walks half of the rows of one channel. At
  // step i it has xin[i-3..i], forms dyc[i] and dya[i-3], and emits
  // dxin[i-3] from dyc[i-3..i] and dya[i-6..i-3]. Half 0 emits own rows
  // 3..63, half 1 rows 64..124; the cotangents come from device memory
  // (0 outside the image), dxin goes straight to it.
  const int c = tid % kTN, hf = tid / kTN;
  const int u0 = hf ? 64 : 3;
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
    const bf16 zero = __float2bfloat16(0.f);
    auto cot = [&](const bf16* a, int r) {  // a cotangent of row r
      const int t = s_tok[r];
      return __bfloat162float(
          t >= 0 ? a[static_cast<size_t>(t) * di + cc] : zero);
    };
    // line (relative to the window's first) and position in it of row i
    // (causal) and of row i - 3 (anticausal)
    int li = (tt0 + u0) / ln - lbase, pi = (tt0 + u0) % ln;
    int la, pa;
    if (tt0 + u0 - 3 < 0) {  // up to 3 positions before the sequence
      la = 0;
      pa = ln + tt0 + u0 - 3;
    } else {
      la = (tt0 + u0 - 3) / ln - lbase;
      pa = (tt0 + u0 - 3) % ln;
    }
    const bf16* pool_f = s_pool + c;
    const bf16* pool_b = s_pool + kMaxLines * kTN + c;
    float x0 = s_xin[(u0 - 3) * kXinLd + c],
          x1 = s_xin[(u0 - 2) * kXinLd + c],
          x2 = s_xin[(u0 - 1) * kXinLd + c];
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;  // dyc[i-3..i]
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // dya[i-6..i-3]
#pragma unroll 8
    for (int k = 0; k < 64; ++k) {
      const int i = u0 + k;
      const float x3 = s_xin[i * kXinLd + c];
      const float yc = bc + x0 * wc[0] + x1 * wc[1] + x2 * wc[2] + x3 * wc[3];
      const float ya = ba + x0 * wa[3] + x1 * wa[2] + x2 * wa[1] + x3 * wa[0];
      // a row outside the sequence has no cotangent and its line's pooled
      // one is 0: its dyc and dya come out 0 without a branch
      const float dyc =
          (cot(dxc_f, i) + __bfloat162float(pool_f[li * kTN]) * sw_pool) *
          dsilu_fast(yc);
      const float dya =
          (cot(dxc_b, i - 3) + __bfloat162float(pool_b[la * kTN]) * sw_pool) *
          dsilu_fast(ya);
      // own tokens: row i for the causal sums (k < 61), row u = i - 3 for
      // the anticausal ones and dxin (k >= 3)
      const float oc = k < kWin / 2 ? dyc : 0.f, oa = k >= 3 ? dya : 0.f;
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
        const int u = i - 3, t = s_tok[u];
        // dxin[u] = Σ_k w_c[k]·dyc[u+3-k] + w_a[3-k]·dya[u-k]
        const float dxi = wc[0] * c3 + wc[1] * c2 + wc[2] * c1 + wc[3] * c0 +
                          wa[3] * a3 + wa[2] * a2 + wa[1] * a1 + wa[0] * a0;
        if (t >= 0) {
          part[10] += dxi;
          dxin[static_cast<size_t>(t) * di + cc] = __float2bfloat16(dxi);
        }
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
      for (int k = 0; k < kCVec; ++k) s_cred[k * kTN + c] = part[k];
  }
  __syncthreads();
  WPROF(6)
  if (c < sw && hf == 0) {
    float* cp = c_part + static_cast<size_t>(wi) * kCVec * di + n0 + c;
#pragma unroll
    for (int k = 0; k < kCVec; ++k)
      cp[static_cast<size_t>(k) * di] = part[k] + s_cred[k * kTN + c];
  }
  WPROF(7)
}

}  // namespace

namespace fvb {

cudaError_t pass_b_bwd_wide(
    const void* g, const void* x, const void* xc_f, const void* xc_b,
    const void* yf, const void* yb, const void* w_z, const void* b_z,
    const void* d_f, const void* d_b, const void* ln_w, const void* ln_b,
    const void* w_out, void* dx, void* dxc_f, void* dxc_b, void* dy, void* mg,
    void* dz, void* vec_part, void* vec, void* w_part, void* dw_out,
    void* dw_z, int batch, int H, int W, int dm, int di, bool transposed,
    bool use_ln, int nsplit, float eps, cudaStream_t stream) {
  auto cT = [](const void* p) { return static_cast<const bf16*>(p); };
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  const long Tl = static_cast<long>(batch) * H * W;
  if (Tl > 0x7fffffffL) return cudaErrorInvalidValue;
  const int T = static_cast<int>(Tl);
  const int P = transposed ? W : H;
  const int ntt = (T + kTM - 1) / kTM, nct = (di + kTN - 1) / kTN;
  // the scratch, as ops/kernels/layer_fused.py sizes it: the column sums
  // of each token tile, dD_f, dD_b and db_out of each line, the LayerNorm
  // statistics, the rows' sums of each channel tile
  float* colpart = static_cast<float*>(vec_part);
  float* ddpart = colpart + static_cast<size_t>(ntt) * 3 * di;
  auto* stats = reinterpret_cast<float2*>(
      ddpart + static_cast<size_t>(batch) * P * (2 * di + dm));
  float2* rowpart = stats + T;

  // m̂ waits in dxc_b until the second pass writes dxc_b over it
  bf16* mhat = static_cast<bf16*>(dxc_b);
  const unsigned nstat = (T + kStatRows - 1) / kStatRows;
  if (use_ln)
    b_stats_kernel<true><<<nstat, kThreads, 0, stream>>>(
        cT(xc_f), cT(xc_b), cT(yf), cT(yb), cF(d_f), cF(d_b), stats, mhat, T,
        H, W, di, transposed, eps);
  else
    b_stats_kernel<false><<<nstat, kThreads, 0, stream>>>(
        cT(xc_f), cT(xc_b), cT(yf), cT(yb), cF(d_f), cF(d_b), stats, mhat, T,
        H, W, di, transposed, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int ntiles = ntt * nct;
  const unsigned blocks = ntiles < sms ? ntiles : sms;
  BMaps maps;
  if ((err = bf16_map(&maps.x, x, T, dm, kTM)) != cudaSuccess ||
      (err = bf16_map(&maps.g, g, T, dm, kTM)) != cudaSuccess ||
      (err = bf16_map(&maps.w_z, w_z, di, dm, kTN)) != cudaSuccess ||
      (err = bf16_map(&maps.w_out, w_out, dm, di, 64)) != cudaSuccess ||
      (err = bf16_map(&maps.mhat, mhat, T, di, kTM)) != cudaSuccess)
    return err;
  auto run_main = [&](auto kernel, cudaError_t allowed) -> cudaError_t {
    if (allowed != cudaSuccess) return allowed;
    kernel<<<blocks, kBThreads, kBMainSmem, stream>>>(
        maps, cF(b_z), cF(ln_w), cF(ln_b), static_cast<bf16*>(dxc_f),
        static_cast<bf16*>(mg), static_cast<bf16*>(dz), colpart, rowpart, T,
        dm, di);
    return cudaGetLastError();
  };
  err = use_ln ? run_main(b_main_kernel<true>,
                          fv::allow_max_smem<b_main_kernel<true>>())
               : run_main(b_main_kernel<false>,
                          fv::allow_max_smem<b_main_kernel<false>>());
  if (err != cudaSuccess) return err;

  const size_t smem2 = second_smem(di);
  if (smem2 > kMaxSmem) return cudaErrorInvalidValue;
  err = fv::allow_max_smem<b_second_kernel>();
  if (err != cudaSuccess) return err;
  b_second_kernel<<<batch * P, kThreads, smem2, stream>>>(
      cT(g), cT(xc_f), cT(xc_b), cT(yf), cT(yb), cF(d_f), cF(d_b), stats,
      rowpart, static_cast<bf16*>(dxc_f), static_cast<bf16*>(dxc_b),
      static_cast<bf16*>(dy), ddpart, T, H, W, dm, di, transposed, use_ln);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dx̂ (z half) = dz·W_z
  err = dx_wide(dz, w_z, nullptr, dx, T, di, dm, stream);
  if (err != cudaSuccess) return err;

  // dW_out (dm, di) = gᵀ·mg;  dW_z (di, dm) = dzᵀ·x̂: straight into the
  // outputs where the tokens are one slice
  const size_t wn = static_cast<size_t>(di) * dm;
  auto* wp = static_cast<float*>(w_part);
  const bool split = nsplit > 1;
  const void* wx[2] = {g, dz};
  const void* wy[2] = {mg, x};
  float* wout[2] = {split ? wp : static_cast<float*>(dw_out),
                    split ? wp + nsplit * wn : static_cast<float*>(dw_z)};
  const int wm[2] = {dm, di}, wnn[2] = {di, dm};
  err = wgrad_wide(wx, wy, wout, wm, wnn, 2, T, nsplit, dm, di, stream);
  if (err != cudaSuccess) return err;

  // vec = [db_z | dln_w | dln_b | dd_f | dd_b | db_out]
  auto* v = static_cast<float*>(vec);
  RowSegs segs{};
  int n = 0;
  if (split) {
    segs.seg[n++] = {wp, static_cast<float*>(dw_out), static_cast<long>(wn),
                     nsplit};
    segs.seg[n++] = {wp + nsplit * wn, static_cast<float*>(dw_z),
                     static_cast<long>(wn), nsplit};
  }
  segs.seg[n++] = {colpart, v, 3L * di, ntt};
  segs.seg[n++] = {ddpart, v + 3 * di, 2L * di + dm, batch * P};
  segs.count = n;
  return sum_rows(segs, stream);
}

cudaError_t pass_a_bwd_wide(
    const void* x, const void* dx_b, const void* dxc_f, const void* dxc_b,
    const void* dpf, const void* dpb, const void* w_x, const void* b_x,
    const void* w_cf, const void* b_cf, const void* w_ab, const void* b_ab,
    void* dx, void* dxin, void* c_part, void* c_vec, void* w_part, void* dw_x,
    int batch, int H, int W, int dm, int di, bool transposed, int nsplit,
    float scaling, cudaStream_t stream) {
  auto cT = [](const void* p) { return static_cast<const bf16*>(p); };
  auto cF = [](const void* p) { return static_cast<const float*>(p); };
  const long Ltok = static_cast<long>(H) * W;
  const long T = batch * Ltok;
  const long nwin = static_cast<long>(batch) * cdivl(Ltok, kWin);
  const int nct = (di + kTN - 1) / kTN;
  if (T > 0x7fffffffL || nwin * nct > 0x7fffffffL)
    return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<a_main_kernel>();
  if (err != cudaSuccess) return err;
  a_main_kernel<<<static_cast<unsigned>(nwin * nct), kThreads, kAMainSmem,
                  stream>>>(cT(x), cT(dxc_f), cT(dxc_b), cT(dpf), cT(dpb),
                            cT(w_x), cF(b_x), cF(w_cf), cF(b_cf), cF(w_ab),
                            cF(b_ab), static_cast<bf16*>(dxin),
                            static_cast<float*>(c_part), H, W, dm, di,
                            transposed, scaling);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dx̂ = dx̂(K5) + dxin·W_x
  err = dx_wide(dxin, w_x, dx_b, dx, static_cast<int>(T), di, dm, stream);
  if (err != cudaSuccess) return err;

  // dW_x (di, dm) = dxinᵀ·x̂
  const bool split = nsplit > 1;
  const void* wx[1] = {dxin};
  const void* wy[1] = {x};
  float* wout[1] = {split ? static_cast<float*>(w_part)
                          : static_cast<float*>(dw_x)};
  const int wm[1] = {di}, wnn[1] = {dm};
  err = wgrad_wide(wx, wy, wout, wm, wnn, 1, static_cast<int>(T), nsplit, dm,
                   di, stream);
  if (err != cudaSuccess) return err;

  RowSegs segs{};
  int n = 0;
  if (split)
    segs.seg[n++] = {static_cast<const float*>(w_part),
                     static_cast<float*>(dw_x), static_cast<long>(di) * dm,
                     nsplit};
  segs.seg[n++] = {static_cast<const float*>(c_part),
                   static_cast<float*>(c_vec), static_cast<long>(kCVec) * di,
                   static_cast<int>(nwin)};
  segs.count = n;
  return sum_rows(segs, stream);
}

}  // namespace fvb
