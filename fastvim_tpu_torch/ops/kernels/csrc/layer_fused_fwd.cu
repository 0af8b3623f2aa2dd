// K3 and K4: the two passes of the fused FastVim mixer layer, forward,
// for Hopper (sm_90a).
//
// K3 (pass A) replaces `_pass_a_even_kernel` / `_pass_a_odd_kernel`
// (fastvim_tpu/ops/pallas/layer_fused.py, conv stage `_conv_stage_even` /
// `_conv_stage_odd`, boundary terms `_conv_corrections`):
//   xin = x̂·W_x + b_x;  causal and anticausal width-4 depthwise convs of
//   xin along the raster (even layers) or the transposed raster (odd);
//   SiLU; write xc_f, xc_b; pf, pb = mean over each line · scaling.
// K4 (pass B) replaces `_pass_b_mat_kernel` (tail `_merge_tail`):
//   z = x̂·W_z + b_z;  m = ½(yf + D_f·xc_f + yb + D_b·xc_b) with yf, yb
//   broadcast from the pooled line; LayerNorm with fp32 statistics
//   (variance E[m²]−μ², unclamped, as the TPU kernel takes it; ops/norms
//   clamps at 0); × silu(z); out = ·W_out + b_out.
//
// A "line" is a row (even layer: the conv runs along the flat raster and
// pools over columns) or a column (odd layer: the conv runs down the
// columns in column-major order and pools over rows). Token (line p,
// position i) is p·W + i on even layers and i·W + p on odd ones.
//
// This file holds the C entry points. The bf16 path, the main path's, is
// layer_fused_fwd_wgmma.cu (wgmma, weights staged through a cp.async
// ring, channel slabs), where its design and what bounds it are set out.
// The fp32 path, the default of every fp32 CLI (224 px and 512 px), is
// layer_fused_fwd_tf32.cu:
//
// fp32: products on the tensor cores in split precision (3xTF32: each
// operand split into two TF32 halves, three mma.sync m16n8k8 a product,
// fp32 sums), so the results keep the fp32 contract (1e-4) at up to 495 /
// 3 = 165 TFLOP/s against the FMA units' 67. What bounds
// them: the products. At FastVim-B's widths and 224 px, B = 128, K3 is
// one GEMM of 5.92e10 FLOP: 0.36 ms as three TF32 passes (0.88 ms on the
// FMA units), against about 385 MB of device memory (0.12 ms); K4 is two
// (0.72 ms; 1.77 on the FMA units) against about 460 MB (0.14 ms). At
// FastVim-T's widths (d_model 192) the bytes and the products are about
// level. Operands stream from L2 through a ring of cp.async stages; each
// fragment is split in registers as it is read from shared memory; each
// k-step's three products go to a fresh register tile that is then added
// to the running sum in fp32 (the tensor cores round their sums toward
// zero: accumulated straight into the running sum, those roundings made
// the forward about ten times less accurate than fp32 FMA, and FastVim-T's
// fused detector step left the unfused one's gradients by 2.2e-4 of the
// largest entry, chip_smoke.py phase 11). Both keep every intermediate
// but xc (which K4 needs after the pooled scans) out of device memory.
//
// K3 (fp32): a block owns a run of consecutive lines of one image in the
// conv's order (rows on even layers, columns on odd ones: each token of a
// column is W·d_model values from the next) and a slab of 128 d_inner
// channels: up to 122 tokens (8 lines of 14 at 224 px), plus one 3-token
// halo at each end of the run. So the W_x slab is read once for the whole
// run, and the halos cost 6 rows a run (not 6 a line). The run's rows
// form one M tile of 128: xin = x̂·W_xᵀ (8 warps of 32 rows × 64
// channels; row tiles past the run's rows are skipped) goes with b_x to
// an fp32 tile in the ring's place; the dual conv, SiLU, the xc stores
// and the pooled sums of each line run from there, a thread on one
// channel and whole lines, so the means stay in the block. The odd
// layers' wrap (a column's causal head reads the previous column's tail)
// is the flat conv-order index, and halo rows before the image's first or
// after its last line are masked before the load (the flat conv's zero
// padding, never the neighbouring image). The last run of an image may
// hold fewer lines. A line longer than the tile (128 tokens at 2048 px)
// is owned by one block and walked in balanced segments, its two halves'
// sums added in a fixed order.
//
// K4 (fp32): a block owns 32 consecutive tokens and a group of out
// columns (all of d_model up to 768; two groups past it, each block
// computing z and the gate of all of d_inner again). A first pass takes
// the LayerNorm statistics of m over d_inner (they do not depend on z).
// Then d_inner is walked in slabs of 128: z_slab = x̂·W_z[slab]ᵀ (x̂'s K
// chunks staged beside W_z's), g_slab = LN(m_slab)·silu(z_slab + b_z)
// into fp32 shared memory, out += g_slab·W_out[cols, slab]ᵀ accumulated
// in registers over the slabs (a warp on 8 of every 64 columns, at most
// 96 accumulators a thread).
// Each call is one launch; no atomics, so results repeat bit for bit.

#include "common.cuh"
#include "layer_fused_fwd.cuh"

// x: (batch, H, W, dm) of `dtype` (0 fp32, 1 bf16); w_x: (di, dm) of
// `dtype` (the x rows of in_proj.weight); b_x, b_cf, b_ab: (di,) fp32 or
// null; w_cf, w_ab: (di, 4) fp32. Outputs xc_f, xc_b: (batch, H, W, di);
// pf, pb: (batch, P, di), P = W if transposed else H; all of `dtype`. With
// xc_f and xc_b both null only the pools are written.
// dm % 32 == 0, dm <= fvf::kFwdMaxDm, di % 64 == 0, di <= fvf::kFwdMaxDi,
// lines of >= 4 tokens (of any length in both dtypes); x and w_x 32-byte
// aligned. Returns a cudaError_t.
extern "C" int fv_pass_a_fwd(const void* x, const void* w_x, const void* b_x,
                             const void* w_cf, const void* b_cf,
                             const void* w_ab, const void* b_ab, void* xc_f,
                             void* xc_b, void* pf, void* pb, int batch, int H,
                             int W, int dm, int di, int transposed,
                             int dtype, float scaling, void* stream) {
  const int ln = transposed ? H : W;
  const int P = transposed ? W : H;
  const bool bf = dtype == fv::kBF16;
  if ((dtype != fv::kF32 && !bf) || batch < 1 || batch > 65535 || P < 1 ||
      P > 65535 || ln < 4 || dm < 32 || dm % 32 != 0 ||
      dm > fvf::kFwdMaxDm || di < 64 || di % 64 != 0 ||
      di > fvf::kFwdMaxDi)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf)
    return fvf::pass_a_fwd_bf16(x, w_x, b_x, w_cf, b_cf, w_ab, b_ab, xc_f,
                                xc_b, pf, pb, batch, H, W, dm, di, transposed,
                                scaling, s);
  return fvf::pass_a_fwd_f32(x, w_x, b_x, w_cf, b_cf, w_ab, b_ab, xc_f, xc_b,
                             pf, pb, batch, H, W, dm, di, transposed,
                             scaling, s);
}

// x: (batch, H, W, dm); xc_f, xc_b: (batch, H, W, di); yf, yb: (batch, P,
// di); w_z: (di, dm) (the z rows of in_proj.weight); w_out: (dm, di), all
// of `dtype`. b_z, d_f, d_b, ln_w, ln_b: (di,) and b_out: (dm,) fp32; b_z,
// b_out may be null, ln_w/ln_b are read only with use_ln. out: (batch, H,
// W, dm) of `dtype`. dm, di % 32 == 0, dm <= fvf::kFwdMaxDm, di <=
// fvf::kFwdMaxDi; x, w_z, w_out 32-byte aligned. Returns a cudaError_t.
extern "C" int fv_pass_b_fwd(const void* x, const void* xc_f,
                             const void* xc_b, const void* yf, const void* yb,
                             const void* w_z, const void* b_z,
                             const void* d_f, const void* d_b,
                             const void* ln_w, const void* ln_b,
                             const void* w_out, const void* b_out, void* out,
                             int batch, int H, int W, int dm, int di,
                             int transposed, int dtype, int use_ln, float eps,
                             void* stream) {
  const bool bf = dtype == fv::kBF16;
  if ((dtype != fv::kF32 && !bf) || batch < 1 || H < 1 || W < 1 || dm < 32 ||
      dm % 32 != 0 || dm > fvf::kFwdMaxDm || di < 32 || di % 32 != 0 ||
      di > fvf::kFwdMaxDi)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf)
    return fvf::pass_b_fwd_bf16(x, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b,
                                ln_w, ln_b, w_out, b_out, out, batch, H, W,
                                dm, di, transposed, use_ln, eps, s);
  return fvf::pass_b_fwd_f32(x, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w,
                             ln_b, w_out, b_out, out, batch, H, W, dm, di,
                             transposed, use_ln, eps, s);
}
