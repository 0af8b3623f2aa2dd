// K7: pass B of the fused FastVim mixer layer in its recompute form, for
// Hopper (sm_90a): the C entry point. The bf16 path is
// layer_fused_recompute_wgmma.cu (warpgroup products), the fp32 path
// layer_fused_recompute_tf32.cu (3xTF32 on mma.sync, thread-block clusters
// that split d_inner).
//
// Replaces `_pass_b_even_kernel` / `_pass_b_odd_kernel`
// (fastvim_tpu/ops/pallas/layer_fused.py; conv stage `_conv_stage_even` /
// `_conv_stage_odd`, tail `_merge_tail`): pass A wrote only the pooled
// means, so this pass computes the conv stage again from x̂
//   xin = x̂·W_x + b_x;  xc_f, xc_b = silu(causal / anticausal width-4
//   conv of xin along the raster (even layers) or the column-major raster
//   (odd layers)), kept in fp32,
// and then pass B's tail
//   z = x̂·W_z + b_z;  m = ½(yf + D_f·xc_f + yb + D_b·xc_b), yf and yb
//   broadcast from the pooled line;  LayerNorm (fp32 statistics, variance
//   E[m²]−μ², as K4 takes it);  × silu(z);  out = ·W_out + b_out.
//
// What bounds it on the H100: the function reads x̂ and writes out (768
// bytes per token in bf16 at d_model 192) against three GEMMs of d_model ×
// d_inner per token (0.44 MFLOP): ~580 FLOP/byte in bf16 (~2,300 in fp32
// at FastVim-B), above the ~295 at which bf16 tensor cores become the
// limit. So unlike K3 + K4, which move xc_f and xc_b through device
// memory, this pass is bound by operations; it trades the xc round trip
// (3 KB per token in bf16, 12 KB in fp32 at FastVim-B) for a second x-half
// product. In fp32 that trade loses even at the bounds (the extra product
// costs 0.36 ms at FastVim-B, 224 px, B = 128, the round trip 0.18 ms), so
// K3 → K4 stays the default route; the fp32 form keeps the recompute mode
// on the tensor cores at the rate of the fp32 K3 and K4. Both forms take
// every registry width and one launch a call.

#include "common.cuh"
#include "layer_fused_fwd.cuh"

namespace {

constexpr int kRcMaxDi = 2560;  // FastVim-H's widths, in both dtypes
constexpr int kRcMaxDm = 1280;

}  // namespace

// x: (batch, H, W, dm); yf, yb: (batch, P, di), P = W if transposed else H;
// w_x, w_z: (di, dm) (the x and z rows of in_proj.weight); w_out: (dm, di),
// all of `dtype` (0 fp32, 1 bf16). b_x, b_cf, b_ab, b_z, d_f, d_b, ln_w,
// ln_b: (di,), w_cf, w_ab: (di, 4) and b_out: (dm,) fp32; the biases may be
// null, ln_w/ln_b are read only with use_ln. out: (batch, H, W, dm) of
// `dtype`. dm, di % 32 == 0, dm <= kRcMaxDm, di <= kRcMaxDi, H, W >= 4;
// x, yf, yb, w_x, w_z, w_out 32-byte aligned. One launch. Returns a
// cudaError_t.
extern "C" int fv_pass_b_recompute_fwd(
    const void* x, const void* yf, const void* yb, const void* w_x,
    const void* b_x, const void* w_cf, const void* b_cf, const void* w_ab,
    const void* b_ab, const void* w_z, const void* b_z, const void* d_f,
    const void* d_b, const void* ln_w, const void* ln_b, const void* w_out,
    const void* b_out, void* out, int batch, int H, int W, int dm, int di,
    int transposed, int dtype, int use_ln, float eps, void* stream) {
  if ((dtype != fv::kF32 && dtype != fv::kBF16) || batch < 1 ||
      batch > 65535 || H < 4 || W < 4 || dm < 32 || dm % 32 != 0 ||
      dm > kRcMaxDm || di < 32 || di % 32 != 0 || di > kRcMaxDi)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto fn = dtype == fv::kBF16 ? fvf::pass_b_recompute_fwd_bf16
                               : fvf::pass_b_recompute_fwd_f32;
  return fn(x, yf, yb, w_x, b_x, w_cf, b_cf, w_ab, b_ab, w_z, b_z, d_f, d_b,
            ln_w, ln_b, w_out, b_out, out, batch, H, W, dm, di, transposed,
            use_ln, eps, st);
}
