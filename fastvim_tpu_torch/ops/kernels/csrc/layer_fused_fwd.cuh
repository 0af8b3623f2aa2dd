// The forward kernels of the fused layer that the C entry points in
// layer_fused_fwd.cu and layer_fused_recompute.cu call: K3 and K4 in bf16
// (layer_fused_fwd_wgmma.cu) and fp32 (layer_fused_fwd_tf32.cu), K7 in
// bf16 (layer_fused_recompute_wgmma.cu) and fp32
// (layer_fused_recompute_tf32.cu).
#pragma once

#include <cuda_runtime.h>

namespace fvf {

// The widths K3 and K4 take, in both dtypes: FastVim-H's (the widest
// registry model). ops/kernels/layer_fused.py's FWD_MAX_DM and FWD_MAX_DI
// state the same limits.
constexpr int kFwdMaxDm = 1280;
constexpr int kFwdMaxDi = 2560;

// K3: x (batch, H, W, dm), w_x (di, dm) bf16; dm % 32 == 0, dm <= kFwdMaxDm,
// di % 64 == 0, di <= kFwdMaxDi, lines of >= 4 tokens. xc_f, xc_b may both
// be null (pools only). One launch.
cudaError_t pass_a_fwd_bf16(const void* x, const void* w_x, const void* b_x,
                            const void* w_cf, const void* b_cf,
                            const void* w_ab, const void* b_ab, void* xc_f,
                            void* xc_b, void* pf, void* pb, int batch, int H,
                            int W, int dm, int di, bool transposed,
                            float scaling, cudaStream_t stream);

// K4: dm, di % 32 == 0, dm <= kFwdMaxDm, di <= kFwdMaxDi. One launch.
cudaError_t pass_b_fwd_bf16(const void* x, const void* xc_f,
                            const void* xc_b, const void* yf, const void* yb,
                            const void* w_z, const void* b_z, const void* d_f,
                            const void* d_b, const void* ln_w,
                            const void* ln_b, const void* w_out,
                            const void* b_out, void* out, int batch, int H,
                            int W, int dm, int di, bool transposed,
                            bool use_ln, float eps, cudaStream_t stream);

// K3 and K4 in fp32 (layer_fused_fwd_tf32.cu), the same contracts, lines
// of any length. One launch each.
cudaError_t pass_a_fwd_f32(const void* x, const void* w_x, const void* b_x,
                           const void* w_cf, const void* b_cf,
                           const void* w_ab, const void* b_ab, void* xc_f,
                           void* xc_b, void* pf, void* pb, int batch, int H,
                           int W, int dm, int di, bool transposed,
                           float scaling, cudaStream_t stream);
cudaError_t pass_b_fwd_f32(const void* x, const void* xc_f, const void* xc_b,
                           const void* yf, const void* yb, const void* w_z,
                           const void* b_z, const void* d_f, const void* d_b,
                           const void* ln_w, const void* ln_b,
                           const void* w_out, const void* b_out, void* out,
                           int batch, int H, int W, int dm, int di,
                           bool transposed, bool use_ln, float eps,
                           cudaStream_t stream);

// K7: dm, di % 32 == 0, dm <= 1280, di <= 2560, H, W >= 4. One launch.
cudaError_t pass_b_recompute_fwd_bf16(
    const void* x, const void* yf, const void* yb, const void* w_x,
    const void* b_x, const void* w_cf, const void* b_cf, const void* w_ab,
    const void* b_ab, const void* w_z, const void* b_z, const void* d_f,
    const void* d_b, const void* ln_w, const void* ln_b, const void* w_out,
    const void* b_out, void* out, int batch, int H, int W, int dm, int di,
    bool transposed, bool use_ln, float eps, cudaStream_t stream);

// K7 in fp32 (layer_fused_recompute_tf32.cu), the same contract. One
// launch: a cluster of 1-4 CTAs a tile of 32 tokens.
cudaError_t pass_b_recompute_fwd_f32(
    const void* x, const void* yf, const void* yb, const void* w_x,
    const void* b_x, const void* w_cf, const void* b_cf, const void* w_ab,
    const void* b_ab, const void* w_z, const void* b_z, const void* d_f,
    const void* d_b, const void* ln_w, const void* ln_b, const void* w_out,
    const void* b_out, void* out, int batch, int H, int W, int dm, int di,
    bool transposed, bool use_ln, float eps, cudaStream_t stream);

}  // namespace fvf
