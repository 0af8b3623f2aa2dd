// K8 and K9: the two fused block kernels of the unfused mixer path, for
// Hopper (sm_90a).
//
// K8 (conv_pool) replaces `_conv_pool_kernel` and K9 (merge_gate)
// `_merge_kernel` (fastvim_tpu/ops/pallas/fused_block.py). x is the x half
// of the in-projection, (batch, L, d) with L = rows·cols tokens in raster
// order:
//   cf = silu(causal width-4 conv of x + b_cf), cb = silu(anticausal ...),
//   both along the flat raster, rounded to x's type (the type the unfused
//   path holds them in);
//   K8: pf, pb = mean over each row of cf, cb (fp32 sum) × scaling, or the
//       max over each row, in fp32. cf and cb never reach device memory.
//   K9: cf and cb computed again from x; m = ½(yf + D_f·cf + yb + D_b·cb)
//       with yf, yb broadcast over their row; LayerNorm over d with fp32
//       statistics (or m as it is); × silu(z); written in x's type.
// The conv runs along the flat raster, so a row's first tokens take taps
// from the end of the row before; only tokens outside the image are 0.
// x and z may be column slices of one wider array (the in-projection's
// output): tokens are `ldx` / `ldz` elements apart.
//
// What bounds them on the H100: bytes, with issue slots and the MUFU unit
// close behind. K8 reads x once and writes two pooled arrays 1/cols of its
// size, but does 8 FMAs, two SiLUs (one MUFU op each) and two roundings an
// element; K9 reads x and z and writes out (6 bytes of bf16 an element)
// and does those again, plus the merge, LayerNorm and a third SiLU. The
// TPU kernels were handed 8-token halo arrays built outside; here each
// kernel reads the 3 tokens on either side itself.
//
// K8 design: a pair of lanes owns a 16-byte chunk of channels (8 in bf16,
// 4 in fp32); the even lane runs the causal conv into pf, the odd one the
// anticausal conv into pb. The anticausal conv is the causal recurrence
// with its taps reversed, three tokens later, so both run the same code,
// keep their 4 taps and bias per channel in registers, and each copies
// half of the x tokens into the warp's 20-token cp.async ring, 16 tokens
// ahead of the math. The convs are rolling accumulators: each x token is
// added into the 4 outputs it feeds, one retiring per token, so nothing is
// moved and the window needs no shifts (the token loop is unrolled by 4,
// the accumulators' period). Gp pairs side by side form a lane-group that
// walks a run of consecutive tokens, so a warp loads Gp·16 contiguous bytes
// of each of 16/Gp runs. Pooled sums stay in registers: a run of whole
// rows carries the conv across row ends and flushes each row as it ends;
// where a batch has too few rows to fill the card in one wave (FastVim's
// 2048 px grids at batch 2), rows are split into segments walked by the
// lane-groups of one warp, whose sums meet by shuffles in a fixed order.
// The launcher picks Gp, the segments and the rows a run takes so that the
// grid is one wave of the SMs (the occupancy API), each warp keeping its
// channels for all its runs.
//
// K9 design: a persistent block walks tiles of consecutive raster tokens
// (a tile may straddle row ends) with all of d. A tile's x rows, with the
// 3-token halo each side, its z rows and the yf / yb rows it touches are
// staged into shared memory by 16-byte cp.async, double-buffered: the
// next tile's copies fly while this one computes. A thread owns 4
// channels for the whole kernel, their 8 taps, 2 biases, D_f, D_b, ln_w
// and ln_b in registers, and computes 4-token chunks of the tile from 10
// staged x rows; m goes to shared memory in fp32. A warp then takes Σm and
// Σ(m − μ)² over d of two tokens at once, in a fixed order, and the
// 4-channel threads normalize, gate with silu(z) and store. Tokens per
// tile and threads per block come from `merge_gate_plan`
// (ops/kernels/fused_block.py), which fits the buffers into shared memory
// from d = 32 to d = 2560 and beyond; past 1536 channels a thread takes
// more than one quad of channels and reloads their weights per chunk.
//
// Stores are 4 channels a thread: 8 bytes in bf16, 32 lanes writing 256
// contiguous bytes. No atomics; every sum has one order, so two calls
// give the same bits. The TPU kernel normalizes 2·m with 4·eps; this one
// computes the plain form, LayerNorm of m with eps.

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kPad = 3;             // d_conv - 1
constexpr int kPoolWarps = 2;       // K8: warps a block
constexpr int kRingGroups = 5;      // K8: 4-token groups in a warp's ring
constexpr int kMinRun = 32;         // K8: tokens a lane-group walks at least
constexpr int kMgMaxThreads = 384;  // K9: threads a block (merge_gate_plan)
constexpr int kStages = 2;          // K9: tiles staged at once
constexpr int kChunk = 4;           // K9: tokens a thread computes at once

// ---------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// N bytes (4, 8 or 16) from global to shared; zeros without a load when
// !valid (the source must still be a mapped address)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
}

// 16 bytes as copies of `align` bytes (the source's alignment: a column
// slice need only keep channel pairs aligned)
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid,
                                       int align) {
  auto d = static_cast<char*>(dst);
  auto s = static_cast<const char*>(src);
  if (align == 16) {
    cp_async<16>(d, s, valid);
  } else if (align == 8) {
    cp_async<8>(d, s, valid);
    cp_async<8>(d + 8, s + 8, valid);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) cp_async<4>(d + 4 * k, s + 4 * k, valid);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The SiLUs (both convs', and K9's silu(z)): on the bf16 path the tanh
// unit's form (one MUFU op, ~2^-11 relative error, against the bf16
// rounding's 2^-9 that follows the conv SiLUs; the exact form's expf and
// divide cost more than the rest of K8's math), the exact one in fp32.
// PERF.md §6 has both forms' times and errors.
template <typename T> __device__ __forceinline__ float silu_t(float v) {
  return fv::silu_fast(v);
}
template <> __device__ __forceinline__ float silu_t<float>(float v) {
  return fv::silu(v);
}

// a and b rounded to T and widened back (one conversion for both in bf16)
template <typename T>
__device__ __forceinline__ void round2(float& a, float& b) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    a = __low2float(p);
    b = __high2float(p);
  }
}

// two warp-wide sums at once, each added in one fixed order
__device__ __forceinline__ void warp_sum2(float (&v)[2]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float a = __shfl_xor_sync(0xffffffffu, v[0], o);
    const float b = __shfl_xor_sync(0xffffffffu, v[1], o);
    v[0] += a;
    v[1] += b;
  }
}

// Largest of 16, 8, 4 bytes that divides the address and the row pitch.
inline int copy_align(const void* p, long pitch_bytes) {
  const auto a = reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(
                                                      pitch_bytes);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : 4;
}

// =====================================================================
// K8: conv + pool
// =====================================================================

struct PoolArgs {
  const void* x;
  const float *w_cf, *b_cf, *w_ab, *b_ab;
  float *pf, *pb;
  long ldx;       // elements between tokens
  int rows, cols, d;
  int lg_g;       // log2 of the chunk columns of a lane-group (Gp)
  int lg_segs;    // log2 of the segments a row is split into (0: whole rows)
  int seglen;     // tokens of a segment (segs > 1)
  int m;          // rows a lane-group walks (segs == 1)
  int rows_unit;  // rows a warp's unit covers: (16 / Gp / segs) · m
  long units;     // batch · units per image
  long units_img;
  int nob;        // lane-group slabs across d: d / (V · Gp)
  long warps;     // warps that work: a multiple of nob
  int n_it;       // tokens a lane walks per unit, a multiple of 4
  int align;      // bytes of x's copy granularity
  float scale;    // scaling / cols (mean), unused for max
};

// A row's pooled value: the mean (sum × scale) or the max, V floats as
// 16-byte stores; then the accumulator starts over.
template <int V, bool kMax>
__device__ __forceinline__ void flush_row(float (&acc)[V], float* o,
                                          float scale) {
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    const float s = kMax ? 1.f : scale;
    *reinterpret_cast<float4*>(o + e) = make_float4(
        acc[e] * s, acc[e + 1] * s, acc[e + 2] * s, acc[e + 3] * s);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = kMax ? -INFINITY : 0.f;
}

// Lane 2·i + dir of a warp takes chunk column i (16 bytes of channels)
// and one direction: dir 0 the causal conv (→ pf), dir 1 the anticausal
// one (→ pb). The anticausal conv is the causal recurrence with its taps
// reversed, three tokens later: Σ_k x[t-3+k]·w_a[3-k] is the anticausal
// output of token t - 3. So both lanes of a pair run the same code on
// the same x tokens, and each copies half of them into the warp's ring.
template <typename T, bool kMax>
__global__ void __launch_bounds__(32 * kPoolWarps)
conv_pool_kernel(const PoolArgs p) {
  constexpr int V = fv::kVec<T>;  // channels a chunk: 16 bytes
  __shared__ __align__(16) uint4 ring[kPoolWarps][kRingGroups][4][16];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long gw = static_cast<long>(blockIdx.x) * kPoolWarps + w;
  if (gw >= p.warps) return;  // whole warps leave together
  const int dir = lane & 1, col = lane >> 1;
  const int Gp = 1 << p.lg_g;
  const int j = col >> p.lg_g, g = col & (Gp - 1);
  const int rr = j >> p.lg_segs, seg = j & ((1 << p.lg_segs) - 1);
  const bool whole = p.lg_segs == 0;
  const int ob = static_cast<int>(gw % p.nob);
  const int c = (ob * Gp + g) * V;
  const int lag = dir ? kPad : 0;  // outputs trail the x token by 3 + lag
  const long L = static_cast<long>(p.rows) * p.cols;
  float* const pout = dir ? p.pb : p.pf;

  float u[V][4], bias[V];  // the taps in causal order
  {
    const float* wt = dir ? p.w_ab : p.w_cf;
    const float* bt = dir ? p.b_ab : p.b_cf;
#pragma unroll
    for (int e = 0; e < V; ++e) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        u[e][k] = __ldg(wt + (c + e) * 4 + (dir ? kPad - k : k));
      bias[e] = bt ? __ldg(bt + c + e) : 0.f;
    }
  }
  const int ngroups = p.n_it / 4;
  const T* x = static_cast<const T*>(p.x);

  for (long iu = gw / p.nob; iu < p.units; iu += p.warps / p.nob) {
    const long b = iu / p.units_img;
    const int r0 = static_cast<int>(iu % p.units_img) * p.rows_unit;
    long a, e;  // this lane-group's output tokens [a, e) in image b
    int row;    // the row of token a
    if (whole) {
      row = r0 + j * p.m;
      a = static_cast<long>(min(row, p.rows)) * p.cols;
      e = static_cast<long>(min(row + p.m, p.rows)) * p.cols;
    } else {
      row = r0 + rr;
      a = static_cast<long>(row) * p.cols + seg * p.seglen;
      e = row < p.rows ? min(a + p.seglen, static_cast<long>(row + 1) * p.cols)
                       : a;
    }
    const int nout = static_cast<int>(max(e - a, 0L));
    // x tokens this walk loads: [lo, hi), the rest are zeros
    const long lo = max(a - kPad, 0L);
    const long hi = nout > 0 ? min(e + kPad, L) : lo;
    const T* xb = x + static_cast<size_t>(b) * L * p.ldx + c;
    auto issue = [&](int gi) {  // this lane's half of group gi's tokens
      if (gi < ngroups) {
#pragma unroll
        for (int k = 0; k < 4; k += 2) {
          const long t = a - kPad + 4 * gi + k + dir;
          const bool valid = t >= lo && t < hi;
          copy16(&ring[w][gi % kRingGroups][k + dir][col],
                 xb + (valid ? t : 0) * p.ldx, valid, p.align);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int gi = 0; gi < kRingGroups - 1; ++gi) issue(gi);

    float S[4][V], acc[V];
#pragma unroll
    for (int e2 = 0; e2 < V; ++e2) {
      acc[e2] = kMax ? -INFINITY : 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) S[s][e2] = 0.f;
    }
    int ocol = -kPad - lag, orow = row;
    for (int gi = 0; gi < ngroups; ++gi) {
      cp_async_wait<kRingGroups - 2>();  // this lane's half of group gi
      __syncwarp();                       // and its partner's
      uint4 raw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) raw[k] = ring[w][gi % kRingGroups][k][col];
      issue(gi + kRingGroups - 1);  // into the slots read one group ago
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // x token i = 4·gi + k; slots by i % 4
        const int i = 4 * gi + k;
        float xv[V], r[V];
        fv::widen16<T>(raw[k], xv);
#pragma unroll
        for (int e2 = 0; e2 < V; ++e2) {
          // output i + 3 - n takes x[i]·u[n]; output i retires
          S[(k + 3) & 3][e2] = fmaf(xv[e2], u[e2][0], bias[e2]);
          S[(k + 2) & 3][e2] = fmaf(xv[e2], u[e2][1], S[(k + 2) & 3][e2]);
          S[(k + 1) & 3][e2] = fmaf(xv[e2], u[e2][2], S[(k + 1) & 3][e2]);
          r[e2] = fmaf(xv[e2], u[e2][3], S[k][e2]);
        }
        const int o = i - lag;  // output token a - 3 + o
        if (o >= kPad && o < nout + kPad) {
#pragma unroll
          for (int e2 = 0; e2 < V; e2 += 2) {
            float v0 = silu_t<T>(r[e2]), v1 = silu_t<T>(r[e2 + 1]);
            round2<T>(v0, v1);
            acc[e2] = kMax ? fmaxf(acc[e2], v0) : acc[e2] + v0;
            acc[e2 + 1] = kMax ? fmaxf(acc[e2 + 1], v1) : acc[e2 + 1] + v1;
          }
          if (whole && ocol == p.cols - 1)
            flush_row<V, kMax>(
                acc, pout + (static_cast<size_t>(b) * p.rows + orow++) * p.d +
                         c, p.scale);
        }
        ocol = ocol == p.cols - 1 ? 0 : ocol + 1;
      }
    }
    if (!whole) {  // a row's segments meet within the warp, in one order
      const int step = 2 << p.lg_g;  // lanes between segments
#pragma unroll
      for (int e2 = 0; e2 < V; ++e2)
        for (int off = step; off < (step << p.lg_segs); off <<= 1) {
          const float v = __shfl_xor_sync(0xffffffffu, acc[e2], off);
          acc[e2] = kMax ? fmaxf(acc[e2], v) : acc[e2] + v;
        }
      if (seg == 0 && row < p.rows)
        flush_row<V, kMax>(
            acc, pout + (static_cast<size_t>(b) * p.rows + row) * p.d + c,
            p.scale);
    }
    __syncwarp();  // the ring's last reads, before the next unit's copies
  }
  cp_async_wait<0>();
}

// The K8 grid: lane-group width Gp, segments per row and rows per run such
// that every lane-group walks at least kMinRun tokens and the warps fit
// one wave of the card; the widest Gp among the most parallel choices.
// With more rows than one wave takes at kMinRun-token runs, a run takes
// more rows instead.
template <typename T, bool kMax>
cudaError_t launch_conv_pool_t(PoolArgs p, int batch, cudaStream_t stream) {
  constexpr int V = fv::kVec<T>;
  const int O = p.d / V;  // 16-byte chunks of a token
  int sms, per_sm;
  cudaError_t err = fv::residency<conv_pool_kernel<T, kMax>>(
      32 * kPoolWarps, 0, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const long cap = static_cast<long>(sms) * per_sm * kPoolWarps;
  const int m_min = min(p.rows, (kMinRun + p.cols - 1) / p.cols);
  long best = -1;
  int best_g = 1, lg_segs = 0;
  for (int lg = 4; lg >= 1; --lg) {
    const int Gp = 1 << lg, NJ = 16 / Gp;
    if (O % Gp) continue;
    for (int ls = 0; (1 << ls) <= NJ; ++ls) {
      const int segs = 1 << ls;
      if (segs > 1 && (p.cols + segs - 1) / segs < kMinRun) continue;
      const int rpu = NJ / segs * (segs > 1 ? 1 : m_min);
      const long warps = static_cast<long>(O / Gp) * batch *
                         ((p.rows + rpu - 1) / rpu);
      if (warps <= cap && warps > best) {
        best = warps;
        best_g = lg;
        lg_segs = ls;
      }
    }
  }
  if (best < 0) {  // too many rows: the widest Gp, whole rows, longer runs
    for (best_g = 4; O % (1 << best_g); --best_g) {
    }
    lg_segs = 0;
  }
  const int NJ = 16 >> best_g;
  p.lg_g = best_g;
  p.lg_segs = lg_segs;
  p.nob = O >> best_g;
  const long slab_units = static_cast<long>(p.nob) * batch;
  if (lg_segs > 0) {
    p.seglen = (p.cols + (1 << lg_segs) - 1) >> lg_segs;
    p.m = 1;
    p.rows_unit = NJ >> lg_segs;
    p.n_it = p.seglen;
  } else {
    p.seglen = 0;
    p.m = m_min;
    if (best < 0)  // rows a lane-group walks so that the warps fit a wave
      while (p.m < p.rows &&
             slab_units * ((p.rows + NJ * p.m - 1) / (NJ * p.m)) > cap)
        ++p.m;
    p.rows_unit = NJ * p.m;
    p.n_it = p.m * p.cols;
  }
  // outputs trail x by 3 tokens, by 6 in the anticausal lanes
  p.n_it = (p.n_it + 2 * kPad + 3) / 4 * 4;
  p.units_img = (p.rows + p.rows_unit - 1) / p.rows_unit;
  p.units = p.units_img * batch;
  const long want = p.nob * p.units;
  p.warps = want <= cap ? want : cap / p.nob * p.nob;
  if (p.warps < 1) p.warps = p.nob;  // more slabs than a wave: loop over units
  const long blocks = (p.warps + kPoolWarps - 1) / kPoolWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  conv_pool_kernel<T, kMax><<<static_cast<unsigned>(blocks), 32 * kPoolWarps,
                               0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv_pool(const void* x, long ldx, const void* w_cf,
                             const void* b_cf, const void* w_ab,
                             const void* b_ab, void* pf, void* pb, int batch,
                             int rows, int cols, int d, bool is_max,
                             float scaling, cudaStream_t stream) {
  PoolArgs p{};
  p.x = x;
  p.w_cf = static_cast<const float*>(w_cf);
  p.b_cf = static_cast<const float*>(b_cf);
  p.w_ab = static_cast<const float*>(w_ab);
  p.b_ab = static_cast<const float*>(b_ab);
  p.pf = static_cast<float*>(pf);
  p.pb = static_cast<float*>(pb);
  p.ldx = ldx;
  p.rows = rows;
  p.cols = cols;
  p.d = d;
  p.align = copy_align(x, ldx * static_cast<long>(sizeof(T)));
  p.scale = scaling / static_cast<float>(cols);
  return is_max ? launch_conv_pool_t<T, true>(p, batch, stream)
                : launch_conv_pool_t<T, false>(p, batch, stream);
}

// =====================================================================
// K9: conv again + merge + LayerNorm + gate
// =====================================================================

struct MergeArgs {
  const void *x, *z;
  const float *yf, *yb, *w_cf, *b_cf, *w_ab, *b_ab, *d_f, *d_b, *ln_w, *ln_b;
  void* out;
  long ldx, ldz;
  int batch, rows, cols, d;
  int tile;  // tokens a tile (merge_gate_plan)
  int nr;    // yf / yb rows a tile's buffer holds
  int align_x, align_z, align_y;
  bool use_ln;
  float eps;
};

// Rows a tile of `tile` tokens touches at most: the yf / yb rows staged.
inline int merge_rows_staged(int tile, int rows, int cols) {
  return min(min(tile, rows), (tile + cols - 2) / cols + 1);
}

// Bytes of shared memory a K9 block takes; mirrors merge_gate_smem in
// ops/kernels/fused_block.py. Two buffers of x (tile + 6 rows), z (tile
// rows), yf and yb (nr rows each); m (tile rows, fp32); per token μ and
// rstd, and its row among the staged ones.
inline size_t merge_buffer_bytes(int tile, int d, int nr, size_t es) {
  return (2 * static_cast<size_t>(tile) + 2 * kPad) * d * es +
         2 * static_cast<size_t>(nr) * d * sizeof(float);
}
inline size_t merge_smem(int tile, int d, int nr, size_t es) {
  return kStages * merge_buffer_bytes(tile, d, nr, es) +
         static_cast<size_t>(tile) * d * sizeof(float) +
         static_cast<size_t>(tile) * 3 * sizeof(float);
}

// A thread's share of a 2-D loop over `n` items of `per` parts each
// (rows × 16-byte chunks, chunks × channel quads): with at least `per`
// threads, each keeps one part and strides over items (threads past the
// last whole multiple of `per` sit out); with fewer, each strides over
// parts of every item.
struct Walk {
  int i0, istep, j0, jstep;
};
__device__ __forceinline__ Walk make_walk(int per, int tid, int nt) {
  if (nt >= per) {
    const int s = nt / per;
    return tid < s * per ? Walk{tid / per, s, tid % per, per}
                         : Walk{INT_MAX / 2, 1, 0, per};
  }
  return Walk{0, 1, tid, nt};
}

// `count` rows of `row_bytes` into consecutive shared rows at `dst`; row
// r comes from src(r), or is zeros where src(r) is null (copied from
// `mapped` with a source size of 0)
template <typename Src>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int count,
                                           int row_bytes, const Walk& wk,
                                           int align, const void* mapped,
                                           Src src) {
  const int per = row_bytes / 16;
  for (int r = wk.i0; r < count; r += wk.istep) {
    const unsigned char* s = static_cast<const unsigned char*>(src(r));
    const bool ok = s != nullptr;
    if (!ok) s = static_cast<const unsigned char*>(mapped);
    for (int ch = wk.j0; ch < per; ch += wk.jstep)
      copy16(dst + static_cast<size_t>(r) * row_bytes + 16 * ch, s + 16 * ch,
             ok, align);
  }
}

template <typename T>
__device__ __forceinline__ void load4_smem(const T* p, float* f) {
  if constexpr (sizeof(T) == 2)
    fv::widen4(*reinterpret_cast<const uint2*>(p), f);
  else
    fv::widen4(*reinterpret_cast<const uint4*>(p), f);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float* f) {
  if constexpr (sizeof(T) == 2) {
    uint2 v;
    __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    v.x = *reinterpret_cast<unsigned*>(&a);
    v.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = v;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMgMaxThreads, 1)
merge_gate_kernel(const MergeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int d = a.d, tile = a.tile, Q = d / 4;
  const long L = static_cast<long>(a.rows) * a.cols;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const size_t xbytes = static_cast<size_t>(tile + 2 * kPad) * row_bytes;
  const size_t zbytes = static_cast<size_t>(tile) * row_bytes;
  const size_t ybytes = static_cast<size_t>(a.nr) * d * sizeof(float);
  const size_t bufbytes = xbytes + zbytes + 2 * ybytes;
  float* s_m = reinterpret_cast<float*>(smem + kStages * bufbytes);
  float2* s_stat = reinterpret_cast<float2*>(s_m + static_cast<size_t>(tile) * d);
  int* s_row = reinterpret_cast<int*>(s_stat + tile);
  const long tpi = (L + tile - 1) / tile;
  const long ntiles = tpi * a.batch;
  const Walk wrow = make_walk(row_bytes / 16, tid, nt);
  const Walk wy = make_walk(d / 4, tid, nt);  // fp32 rows: d/4 chunks
  const Walk wq = make_walk(Q, tid, nt);      // chunks × channel quads
  const T* x = static_cast<const T*>(a.x);
  const T* z = static_cast<const T*>(a.z);

  auto load = [&](long k, int buf) {  // tile k's copies, one group
    if (k < ntiles) {
      unsigned char* base = smem + buf * bufbytes;
      const long b = k / tpi, t0 = (k % tpi) * tile;
      const int n = static_cast<int>(min(static_cast<long>(tile), L - t0));
      const T* xb = x + static_cast<size_t>(b) * L * a.ldx;
      const T* zb = z + (static_cast<size_t>(b) * L + t0) * a.ldz;
      const long u0 = t0 - kPad;  // x rows: tokens u0 .. t0 + n + 2
      stage_rows(base, n + 2 * kPad, row_bytes, wrow, a.align_x, xb,
                 [&](int r) -> const void* {
                   const long u = u0 + r;
                   return u >= 0 && u < L ? xb + u * a.ldx : nullptr;
                 });
      stage_rows(base + xbytes, n, row_bytes, wrow, a.align_z, zb,
                 [&](int r) -> const void* { return zb + r * a.ldz; });
      const long r_first = t0 / a.cols;
      const int nrow = static_cast<int>((t0 + n - 1) / a.cols - r_first + 1);
      const size_t yoff = (static_cast<size_t>(b) * a.rows + r_first) * d;
      stage_rows(base + xbytes + zbytes, nrow, d * 4, wy, a.align_y, a.yf,
                 [&](int r) -> const void* { return a.yf + yoff + r * d; });
      stage_rows(base + xbytes + zbytes + ybytes, nrow, d * 4, wy, a.align_y,
                 a.yb,
                 [&](int r) -> const void* { return a.yb + yoff + r * d; });
    }
    cp_async_commit();
  };

  // this thread's channel quad and its constants (reloaded only where a
  // thread takes several quads: Q > threads)
  int wq_cur = -1, lq_cur = -1;
  float wc[4][4], wa[4][4], bc[4], ba[4], df[4], db[4], lw[4], lb[4];
  auto conv_weights = [&](int q) {
    if (q == wq_cur) return;
    wq_cur = q;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * q + e;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wc[e][k] = __ldg(a.w_cf + c * 4 + k);
        wa[e][k] = __ldg(a.w_ab + c * 4 + k);
      }
      bc[e] = a.b_cf ? __ldg(a.b_cf + c) : 0.f;
      ba[e] = a.b_ab ? __ldg(a.b_ab + c) : 0.f;
      df[e] = 0.5f * __ldg(a.d_f + c);
      db[e] = 0.5f * __ldg(a.d_b + c);
    }
  };
  auto ln_weights = [&](int q) {
    if (q == lq_cur) return;
    lq_cur = q;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lw[e] = a.ln_w ? __ldg(a.ln_w + 4 * q + e) : 1.f;
      lb[e] = a.ln_b ? __ldg(a.ln_b + 4 * q + e) : 0.f;
    }
  };

  long k = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(k + s * gridDim.x, s);
  for (int buf = 0; k < ntiles;
       k += gridDim.x, buf = buf == kStages - 1 ? 0 : buf + 1) {
    load(k + (kStages - 1) * static_cast<long>(gridDim.x),
         buf == 0 ? kStages - 1 : buf - 1);
    const long b = k / tpi, t0 = (k % tpi) * tile;
    const int n = static_cast<int>(min(static_cast<long>(tile), L - t0));
    const long r_first = t0 / a.cols;
    for (int t = tid; t < n; t += nt)
      s_row[t] = static_cast<int>((t0 + t) / a.cols - r_first);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* base = smem + buf * bufbytes;
    const T* sx = reinterpret_cast<const T*>(base);
    const T* sz = reinterpret_cast<const T*>(base + xbytes);
    const float* syf = reinterpret_cast<const float*>(base + xbytes + zbytes);
    const float* syb = syf + static_cast<size_t>(a.nr) * d;
    const int nchunks = (n + kChunk - 1) / kChunk;

    // conv pass: m of tokens 4c .. 4c + 3 for channels 4q .. 4q + 3, from
    // the staged x rows 4c .. 4c + 9 (row r is token t0 - 3 + r)
    for (int ci = wq.i0; ci < nchunks; ci += wq.istep) {
      for (int q = wq.j0; q < Q; q += wq.jstep) {
        conv_weights(q);
        float af[kChunk][4], ab[kChunk][4];
#pragma unroll
        for (int jt = 0; jt < kChunk; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            af[jt][e] = bc[e];
            ab[jt][e] = ba[e];
          }
#pragma unroll
        for (int r = 0; r < kChunk + 2 * kPad; ++r) {
          float v[4];
          const int sr = min(kChunk * ci + r, tile + 2 * kPad - 1);
          load4_smem(sx + static_cast<size_t>(sr) * d + 4 * q, v);
#pragma unroll
          for (int jt = 0; jt < kChunk; ++jt) {
            const int kk = r - jt;  // position in token jt's window
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (kk >= 0 && kk <= kPad)  // x[t-3+kk]·w_c[kk]
                af[jt][e] = fmaf(v[e], wc[e][kk], af[jt][e]);
              if (kk >= kPad && kk <= 2 * kPad)  // x[t+kk-3]·w_a[6-kk]
                ab[jt][e] = fmaf(v[e], wa[e][2 * kPad - kk], ab[jt][e]);
            }
          }
        }
#pragma unroll
        for (int jt = 0; jt < kChunk; ++jt) {
          const int t = kChunk * ci + jt;
          if (t < n) {
            const int lr = s_row[t];
            const float4 pf =
                *reinterpret_cast<const float4*>(syf + lr * d + 4 * q);
            const float4 pb =
                *reinterpret_cast<const float4*>(syb + lr * d + 4 * q);
            const float yf4[4] = {pf.x, pf.y, pf.z, pf.w};
            const float yb4[4] = {pb.x, pb.y, pb.z, pb.w};
            float cf[4], cb[4], m[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              cf[e] = silu_t<T>(af[jt][e]);
              cb[e] = silu_t<T>(ab[jt][e]);
            }
            round2<T>(cf[0], cf[1]);
            round2<T>(cf[2], cf[3]);
            round2<T>(cb[0], cb[1]);
            round2<T>(cb[2], cb[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              m[e] = fmaf(db[e], cb[e],
                          fmaf(df[e], cf[e], (yf4[e] + yb4[e]) * 0.5f));
            *reinterpret_cast<float4*>(s_m + static_cast<size_t>(t) * d +
                                       4 * q) =
                make_float4(m[0], m[1], m[2], m[3]);
          }
        }
      }
    }
    __syncthreads();

    if (a.use_ln) {  // μ and rstd of each token: a warp takes two at once
      const int lane = tid & 31, nw = nt / 32;
      for (int t = tid / 32; t < n && tid / 32 < nw; t += 2 * nw) {
        const int tt[2] = {t, min(t + nw, n - 1)};  // the second may repeat
        const float4* row[2];
        float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f}, mu[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          row[h] = reinterpret_cast<const float4*>(
              s_m + static_cast<size_t>(tt[h]) * d);
        for (int c4 = lane; c4 < Q; c4 += 32)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = row[h][c4];
            s[h] += (v.x + v.y) + (v.z + v.w);
          }
        warp_sum2(s);
#pragma unroll
        for (int h = 0; h < 2; ++h) mu[h] = s[h] / static_cast<float>(d);
        for (int c4 = lane; c4 < Q; c4 += 32)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = row[h][c4];
            const float e0 = v.x - mu[h], e1 = v.y - mu[h], e2 = v.z - mu[h],
                        e3 = v.w - mu[h];
            ss[h] += (e0 * e0 + e1 * e1) + (e2 * e2 + e3 * e3);
          }
        warp_sum2(ss);
        if (lane < 2 && (lane == 0 || t + nw < n))  // lane h writes token h
          s_stat[lane ? tt[1] : tt[0]] = make_float2(
              lane ? mu[1] : mu[0],
              rsqrtf((lane ? ss[1] : ss[0]) / static_cast<float>(d) + a.eps));
      }
      __syncthreads();
    }

    // gate pass: normalize, × silu(z), store 4 channels a token
    T* out = static_cast<T*>(a.out) + (static_cast<size_t>(b) * L + t0) * d;
    for (int ci = wq.i0; ci < nchunks; ci += wq.istep) {
      for (int q = wq.j0; q < Q; q += wq.jstep) {
        if (a.use_ln) ln_weights(q);
#pragma unroll
        for (int jt = 0; jt < kChunk; ++jt) {
          const int t = kChunk * ci + jt;
          if (t < n) {
            const float4 mv = *reinterpret_cast<const float4*>(
                s_m + static_cast<size_t>(t) * d + 4 * q);
            float v[4] = {mv.x, mv.y, mv.z, mv.w}, zz[4];
            load4_smem(sz + static_cast<size_t>(t) * d + 4 * q, zz);
            if (a.use_ln) {
              const float2 st = s_stat[t];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[e] = fmaf((v[e] - st.x) * st.y, lw[e], lb[e]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] *= silu_t<T>(zz[e]);
            store4(out + static_cast<size_t>(t) * d + 4 * q, v);
          }
        }
      }
    }
    __syncthreads();  // the buffer and m are free for the tiles after
  }
  cp_async_wait<0>();
}

// `plan_smem` is the plan's count of the bytes: a launch whose plan
// disagrees with this file's layout is refused, so the two formulas
// cannot drift apart unnoticed.
template <typename T>
cudaError_t launch_merge_gate(MergeArgs a, int threads, int plan_smem,
                              cudaStream_t stream) {
  if (a.tile < 1 || threads < 32 || threads > kMgMaxThreads)
    return cudaErrorInvalidValue;
  a.nr = merge_rows_staged(a.tile, a.rows, a.cols);
  const size_t smem = merge_smem(a.tile, a.d, a.nr, sizeof(T));
  if (smem > fv::kMaxSmem || smem != static_cast<size_t>(plan_smem))
    return cudaErrorInvalidValue;
  cudaError_t err = fv::allow_max_smem<merge_gate_kernel<T>>();
  if (err != cudaSuccess) return err;
  int sms, per_sm;
  err = fv::residency<merge_gate_kernel<T>>(threads, smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const long L = static_cast<long>(a.rows) * a.cols;
  const long ntiles = (L + a.tile - 1) / a.tile * a.batch;
  const long grid = min(ntiles, static_cast<long>(sms) * per_sm);
  a.align_x = copy_align(a.x, a.ldx * static_cast<long>(sizeof(T)));
  a.align_z = copy_align(a.z, a.ldz * static_cast<long>(sizeof(T)));
  a.align_y = min(copy_align(a.yf, a.d * 4L), copy_align(a.yb, a.d * 4L));
  merge_gate_kernel<T><<<static_cast<unsigned>(grid), threads, smem,
                         stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, rows·cols, d) of `dtype` (0 fp32, 1 bf16), tokens `ldx`
// elements apart (ldx >= d, even), channel pairs 4- (bf16) or 8-byte (fp32)
// aligned; w_cf, w_ab: (d, 4) fp32; b_cf, b_ab: (d,) fp32 or null. pf, pb:
// (batch, rows, d) fp32, 16-byte aligned, the mean × scaling of each row,
// or with `is_max` its maximum. d % 32 == 0. Returns a cudaError_t.
extern "C" int fv_conv_pool_fwd(const void* x, const void* w_cf,
                                const void* b_cf, const void* w_ab,
                                const void* b_ab, void* pf, void* pb,
                                int batch, int rows, int cols, int d, int ldx,
                                int is_max, int dtype, float scaling,
                                void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || d < 32 || d % 32 != 0 ||
      ldx < d || ldx % 2 != 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fv::kF32:
      return launch_conv_pool<float>(x, ldx, w_cf, b_cf, w_ab, b_ab, pf, pb,
                                     batch, rows, cols, d, is_max, scaling,
                                     st);
    case fv::kBF16:
      return launch_conv_pool<__nv_bfloat16>(x, ldx, w_cf, b_cf, w_ab, b_ab,
                                             pf, pb, batch, rows, cols, d,
                                             is_max, scaling, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// x, z: (batch, rows·cols, d) of `dtype`, tokens `ldx` / `ldz` elements
// apart, aligned as for fv_conv_pool_fwd; yf, yb: (batch, rows, d) fp32;
// w_cf, w_ab: (d, 4), d_f, d_b: (d,) fp32; b_cf, b_ab, ln_w, ln_b: (d,) fp32
// or null (ln_w / ln_b null: 1 / 0). out: (batch, rows·cols, d) of `dtype`,
// contiguous, 16-byte aligned. d % 32 == 0. `tile` tokens a tile,
// `threads` a block and `smem` bytes of shared memory a block, from
// merge_gate_plan (ops/kernels/fused_block.py). Returns a cudaError_t.
extern "C" int fv_merge_gate_fwd(const void* x, const void* z, const void* yf,
                                 const void* yb, const void* w_cf,
                                 const void* b_cf, const void* w_ab,
                                 const void* b_ab, const void* d_f,
                                 const void* d_b, const void* ln_w,
                                 const void* ln_b, void* out, int batch,
                                 int rows, int cols, int d, int ldx, int ldz,
                                 int dtype, int use_ln, int tile, int threads,
                                 int smem, float eps, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || d < 32 || d % 32 != 0 ||
      ldx < d || ldx % 2 != 0 || ldz < d || ldz % 2 != 0)
    return cudaErrorInvalidValue;
  MergeArgs a{};
  a.x = x;
  a.z = z;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  a.yf = f(yf);
  a.yb = f(yb);
  a.w_cf = f(w_cf);
  a.b_cf = f(b_cf);
  a.w_ab = f(w_ab);
  a.b_ab = f(b_ab);
  a.d_f = f(d_f);
  a.d_b = f(d_b);
  a.ln_w = f(ln_w);
  a.ln_b = f(ln_b);
  a.out = out;
  a.ldx = ldx;
  a.ldz = ldz;
  a.batch = batch;
  a.rows = rows;
  a.cols = cols;
  a.d = d;
  a.tile = tile;
  a.use_ln = use_ln != 0;
  a.eps = eps;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fv::kF32:
      return launch_merge_gate<float>(a, threads, smem, st);
    case fv::kBF16:
      return launch_merge_gate<__nv_bfloat16>(a, threads, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}
