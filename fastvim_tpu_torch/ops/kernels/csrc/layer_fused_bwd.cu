// K5 and K6: the adjoints of the two passes of the fused FastVim mixer
// layer, for Hopper (sm_90a).
//
// K5 (pass B backward) replaces `_pass_b_bwd_kernel`
// (fastvim_tpu/ops/pallas/layer_fused.py). With g = dL/d(out) it recomputes
//   z = x̂·W_zᵀ + b_z;  m0 = ½(yf + D_f·xc_f + yb + D_b·xc_b);  LayerNorm
//   statistics, m̂, mln = m̂·w + b
// and emits
//   dgated = g·W_out;  dmln = dgated·silu(z);  dz = dgated·mln·silu'(z);
//   dm0 = LayerNorm backward of dmln·w;  dx̂ (z half, fp32) = dz·W_z;
//   dxc_f = ½dm0·D_f, dxc_b = ½dm0·D_b;  dyf = dyb = Σ_line ½dm0;
//   dW_out = gᵀ·(mln·silu(z)), db_out = Σg, dW_z = dzᵀ·x̂, db_z = Σdz,
//   dLN w/b, dD_f = Σ½dm0·xc_f, dD_b, all summed over every token.
// K6 (pass A backward) replaces `_pass_a_bwd_even_kernel` /
// `_pass_a_bwd_odd_kernel`: with the cotangents of xc_f, xc_b (from K5)
// and of the pooled pf, pb (from the scans' backward) it recomputes
// xin = x̂·W_xᵀ + b_x and the conv pre-activations yc, ya and emits
//   dyc = (dxc_f + dpf·scaling/ln)·silu'(yc), dya likewise;
//   dxin[t] = Σ_k w_c[k]·dyc[t+3−k] + w_a[3−k]·dya[t−k] along the (transposed)
//   raster, across line boundaries;  dx̂ = dx̂(K5) + dxin·W_x (fp32);
//   dW_x = dxinᵀ·x̂, db_x, conv weight and bias gradients over every token.
// GEMM operands (dz, mln·silu(z), dxin) are rounded to the working dtype,
// products accumulate in fp32, as the TPU kernels do.
//
// The TPU kernel got its sums over all tokens from a sequential grid that
// revisits one output block (`_acc`); here blocks run in no order, so
// every such sum is written as per-block (or per token slice) partials
// and `sum_segments_kernel` (layer_fused_bwd.cuh) adds them in a fixed
// order. No atomics anywhere: the results are the same from run to run.
//
// This file holds the C entry points. The bf16 path, on `wgmma`, is
// layer_fused_bwd_wgmma.cu; the fp32 path, every product on the tensor
// cores in split precision (3xTF32 on `mma.sync`, which holds the
// gradients to a CPU run within 1e-4), is layer_fused_bwd_tf32.cu. Each
// file sets out its design and what bounds it.

#include "layer_fused_bwd.cuh"

namespace {

constexpr int kTile = 64;  // d_model and d_inner in whole 64-column tiles
constexpr int kPad = 3;    // d_conv - 1

}  // namespace

// Pass B backward. g, x: (batch, H, W, dm); xc_f, xc_b: (batch, H, W, di);
// yf, yb: (batch, P, di); w_z: (di, dm); w_out: (dm, di), out_proj.weight;
// all of `dtype` (0 fp32, 1 bf16), read as they lie. w_z_t and w_out_t
// are not read (may be null). b_z (may be null), d_f, d_b, ln_w, ln_b
// (read only with use_ln): (di,) fp32. Outputs: dx (batch, H, W, dm)
// fp32; dxc_f, dxc_b, dy (batch, P, di) of `dtype`; dw_out (dm, di), dw_z
// (di, dm) and vec = [db_z | dln_w | dln_b | dd_f | dd_b | db_out] (5·di +
// dm) fp32. Scratch: mg, dz (tokens, di) of `dtype`; vec_part (batch·P,
// 5·di + dm) and w_part (2, nsplit, di·dm) fp32. dm, di % 64 == 0, dm <=
// di, dm <= fvb::kBwdMaxDm, di <= fvb::kBwdMaxDi. bf16: three launches up
// to d_model 384 and d_inner 768, else four (the wide forms' dx̂ product);
// fp32: six. Returns a cudaError_t.
extern "C" int fv_pass_b_bwd(const void* g, const void* x, const void* xc_f,
                             const void* xc_b, const void* yf, const void* yb,
                             const void* w_z, const void* w_z_t,
                             const void* b_z, const void* d_f, const void* d_b,
                             const void* ln_w, const void* ln_b,
                             const void* w_out, const void* w_out_t, void* dx,
                             void* dxc_f, void* dxc_b, void* dy, void* mg,
                             void* dz, void* vec_part, void* vec, void* w_part,
                             void* dw_out, void* dw_z, int batch, int H, int W,
                             int dm, int di, int transposed, int dtype,
                             int use_ln, int nsplit, float eps, void* stream) {
  (void)w_z_t;
  (void)w_out_t;
  if ((dtype != fv::kF32 && dtype != fv::kBF16) || batch < 1 ||
      batch > 65535 || H < 1 || W < 1 || dm < kTile || dm % kTile != 0 ||
      dm > fvb::kBwdMaxDm || di < dm || di % kTile != 0 ||
      di > fvb::kBwdMaxDi || nsplit < 1 || 2 * nsplit > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return (dtype == fv::kBF16 ? fvb::pass_b_bwd_bf16 : fvb::pass_b_bwd_f32)(
      g, x, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b, w_out, dx,
      dxc_f, dxc_b, dy, mg, dz, vec_part, vec, w_part, dw_out, dw_z, batch, H,
      W, dm, di, transposed, use_ln, nsplit, eps, st);
}

// Pass A backward. x: (batch, H, W, dm); dxc_f, dxc_b: (batch, H, W, di);
// dpf, dpb: (batch, P, di); w_x: (di, dm); all of `dtype`, read as they
// lie; w_x_t is not read (may be null). dx_b: (batch, H, W, dm) fp32 from
// fv_pass_b_bwd. b_x, b_cf, b_ab: (di,) fp32 or null; w_cf, w_ab: (di, 4)
// fp32. Outputs: dx (batch, H, W, dm) fp32 = dx_b + dxin·W_x; dw_x (di,
// dm) fp32; c_vec (11, di) fp32 = rows dw_cf[:, 0..3], dw_ab[:, 0..3],
// db_cf, db_ab, db_x. Scratch: dxin (tokens, di) of `dtype`; c_part
// (batch·nblk, 11·di) with nblk = P (runs of lines) in fp32 and
// ceil(H·W / 58) windows in bf16; w_part (nsplit, di·dm) fp32. dm, di % 64
// == 0, dm <= di, dm <= fvb::kBwdMaxDm, di <= fvb::kBwdMaxDi, lines of >= 4
// tokens. Three launches in bf16 up to d_model 384 and d_inner 768, else
// four; four in fp32. Returns a cudaError_t.
extern "C" int fv_pass_a_bwd(const void* x, const void* dx_b,
                             const void* dxc_f, const void* dxc_b,
                             const void* dpf, const void* dpb, const void* w_x,
                             const void* w_x_t, const void* b_x,
                             const void* w_cf, const void* b_cf,
                             const void* w_ab, const void* b_ab, void* dx,
                             void* dxin, void* c_part, void* c_vec,
                             void* w_part, void* dw_x, int batch, int H, int W,
                             int dm, int di, int transposed, int dtype,
                             int nsplit, float scaling, void* stream) {
  (void)w_x_t;
  const int ln = transposed ? H : W;
  const int P = transposed ? W : H;
  if ((dtype != fv::kF32 && dtype != fv::kBF16) || batch < 1 ||
      batch > 65535 || P < 1 || P > 65535 || ln < kPad + 1 || dm < kTile ||
      dm % kTile != 0 || dm > fvb::kBwdMaxDm || di < dm || di % kTile != 0 ||
      di > fvb::kBwdMaxDi || nsplit < 1 || nsplit > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return (dtype == fv::kBF16 ? fvb::pass_a_bwd_bf16 : fvb::pass_a_bwd_f32)(
      x, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x, w_cf, b_cf, w_ab, b_ab, dx,
      dxin, c_part, c_vec, w_part, dw_x, batch, H, W, dm, di, transposed,
      nsplit, scaling, st);
}
