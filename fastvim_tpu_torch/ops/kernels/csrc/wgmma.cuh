// Hopper building blocks of the fused layer's kernels in bf16
// (layer_fused_fwd_wgmma.cu, layer_fused_bwd_wgmma.cu): warpgroup matrix
// products (`wgmma`) on bf16 operands in shared memory, the
// 128-byte-swizzled tile layout they read, asynchronous 16-byte copies
// (`cp.async`) that fill such tiles, and the ring of weight stages they
// stream through.
//
// A tile block is R rows of 64 bf16 (128 bytes), its base aligned to 1024
// bytes; the 16-byte chunk c of row r lies at chunk c ^ (r % 8). One
// layout serves both operand orders:
// - K-major: a row is one M (or N) index and holds 64 consecutive K
//   values. A k16 step moves the start address by 32 bytes; 8 rows are
//   1024 bytes apart (SBO).
// - MN-major ("transposed"): a row is one K index and holds 64
//   consecutive M (or N) values, which is how a row-major (K, N) matrix
//   lies in memory, so no transposed copy of a weight is ever made. A k16
//   step moves the start address by 16 rows = 2048 bytes; a 32-column
//   half of the block starts 64 bytes in.
// The accumulator of m64nNk16 in a thread of warp w (of the warpgroup's
// 4), lane l: d[4j + {0, 1}] = D[16w + l/4][8j + 2(l%4) + {0, 1}],
// d[4j + {2, 3}] the same columns of row + 8.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace fv {

constexpr int kBlkRowBytes = 128;  // 64 bf16 per row of a tile block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (row r, column c < 64) in a swizzled tile block
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r) * kBlkRowBytes +
         ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// shared-memory matrix descriptor of a 128-byte-swizzled operand at most
// one 64-element block wide, whose 8-row groups are 1024 bytes apart (the
// leading byte offset, which no such operand uses, is set to 16)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// make generic-proxy writes to shared memory (st.shared, cp.async)
// visible to wgmma's reads; call before the barrier that hands a tile over
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define FV_D8(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
    "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 × 64, 32 floats a thread) (+)= A (64 × 16) · B (16 × 64); kTa /
// kTb: the operand is MN-major. `acc` = 0 overwrites d.
template <int kTa, int kTb>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : FV_D8(0), FV_D8(8), FV_D8(16), FV_D8(24)
      : "l"(da), "l"(db), "r"(acc), "n"(kTa), "n"(kTb));
}

// the same for a 64 × 32 result (16 floats a thread)
template <int kTa, int kTb>
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : FV_D8(0), FV_D8(8)
      : "l"(da), "l"(db), "r"(acc), "n"(kTa), "n"(kTb));
}
#undef FV_D8

// 16-byte asynchronous copy global → shared; with `ok` false nothing is
// read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t saddr, const void* g,
                                           bool ok = true) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(g), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy rows [r0, r0 + nrows) × columns [c0, c0 + 64) of a row-major bf16
// matrix with `ld` elements a row into a swizzled tile block at shared
// address `sblk`, by all `nthreads` threads of which this is `tid`.
__device__ __forceinline__ void cp_block(uint32_t sblk,
                                         const __nv_bfloat16* src, size_t ld,
                                         int r0, int c0, int nrows, int tid,
                                         int nthreads) {
  for (int i = tid; i < nrows * 8; i += nthreads) {
    const int r = i >> 3, ch = i & 7;
    cp_async16(sblk + r * kBlkRowBytes + (((ch ^ r) & 7) << 4),
               src + static_cast<size_t>(r0 + r) * ld + c0 + ch * 8);
  }
}

// The ring of weight stages: kStages slots of kStageBytes from shared
// address `base`. `fetch(s, addr)` starts the copies of stage s (or
// nothing past the last) and the ring commits; every acquire commits
// exactly one group, so the group of the stage being acquired is always
// the (kStages - 1)-th newest. Other groups committed in between only
// make the wait more conservative.
template <int kStages, int kStageBytes, typename Fetch>
struct Ring {
  uint32_t base;
  int cons;
  Fetch fetch;
  __device__ Ring(uint32_t b, Fetch f) : base(b), cons(0), fetch(f) {}
  __device__ uint32_t slot_addr(int s) const {
    return base + (s % kStages) * kStageBytes;
  }
  __device__ void start() {
    for (int s = 0; s < kStages - 1; ++s) {
      fetch(s, slot_addr(s));
      cp_async_commit();
    }
  }
  // The next stage's shared address. After its barrier every thread
  // has finished reading the stage before it (its wgmmas were waited
  // for), so that slot is free: the caller starts its products on the
  // new stage and then calls refill(), once per acquire, so that the
  // copies are started while the tensor cores work.
  __device__ uint32_t acquire() {
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    return slot_addr(cons++);
  }
  __device__ void refill() {
    const int s = cons + kStages - 2;
    fetch(s, slot_addr(s));
    cp_async_commit();
  }
};

// acc (64 × 64 of this warpgroup) = A (64 × 64·nblk, K-major 64-row
// blocks of 8 KB at `sa`) · B over the next nblk stages of the ring; kTb
// 0: the stage holds B K-major, this warpgroup's 64 rows at `boff`; 1:
// MN-major, its 64 columns in the block at `boff`. Warpgroups with
// `active` false only keep the ring moving.
template <int kTb, typename R>
__device__ __forceinline__ void slab_gemm(float* acc, uint32_t sa, int nblk,
                                          R& ring, uint32_t boff,
                                          bool active) {
  for (int b = 0; b < nblk; ++b) {
    const uint32_t st = ring.acquire() + boff;
    if (active) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n64<0, kTb>(acc, gmma_desc(sa + b * 64 * kBlkRowBytes + 32 * kk),
                          gmma_desc(st + (kTb ? 2048 : 32) * kk),
                          (b | kk) != 0);
      wgmma_commit();
    }
    ring.refill();
    if (active) wgmma_wait();
  }
}

// The stage of W_out (d_model, d_inner) that out_gemm's step kb reads for
// the d_inner slab at n0 (128 channels): two K-major blocks of 64 rows of
// W_out × 64 channels, rows 32kb.. for warpgroup 0 in rows 0-31 and rows
// 32·nu + 32kb.. for warpgroup 1 in rows 32-63 (nu = ceil(d_model / 64));
// rows and channels past the widths zero-filled. All 256 threads copy.
__device__ __forceinline__ void cp_out_stage(uint32_t dst,
                                             const __nv_bfloat16* w_out,
                                             int n0, int kb, int nu, int dm,
                                             int di, int tid) {
  for (int i = tid; i < 64 * 16; i += 256) {
    const int r = i >> 4, h = (i >> 3) & 1, ch = i & 7;
    const int row = (r / 32) * 32 * nu + 32 * kb + r % 32;
    const int col = n0 + 64 * h + 8 * ch;
    const bool ok = row < dm && col < di;
    cp_async16(dst + h * 64 * kBlkRowBytes + swz(r, 8 * ch),
               w_out + (ok ? static_cast<size_t>(row) * di + col : 0), ok);
  }
}

// oacc (64 × 32·kNU columns of this warpgroup) += A (64 × 128, two K-major
// blocks at `sa`) · W_out[cols, slab]ᵀ over the next kNU stages, each
// filled by cp_out_stage: both warpgroups issue the same products on their
// own half, since a product in a branch on the warpgroup makes the
// compiler serialize every product.
template <int kNU, typename R>
__device__ __forceinline__ void out_gemm(float* oacc, uint32_t sa, R& ring,
                                         int wg) {
  constexpr uint32_t kBlk = 64 * kBlkRowBytes;
#pragma unroll
  for (int u = 0; u < kNU; ++u) {
    const uint32_t st = ring.acquire() + wg * 32 * kBlkRowBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t ko = (kk / 4) * kBlk + 32 * (kk % 4);
      wgmma_n32<0, 0>(oacc + 16 * u, gmma_desc(sa + ko), gmma_desc(st + ko),
                      1);
    }
    wgmma_commit();
    ring.refill();
    wgmma_wait();
  }
}

}  // namespace fv
