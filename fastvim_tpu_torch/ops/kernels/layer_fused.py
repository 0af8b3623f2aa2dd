"""K3 and K4: the two passes of the fused FastVim mixer layer, forward
(``csrc/layer_fused_fwd.cu``), and ``fused_mixer_core``, which chains
pass A → the pooled scans → pass B.

Counterpart of ``fastvim_tpu/ops/pallas/layer_fused.py``:

  pass A:  x̂ ──x̂·W_x──dual conv──silu──┬─► xc_f, xc_b
                                        └─mean over each line─► pf, pb
  between: pf/pb ──x_proj, dt_proj GEMMs──K1 scans──► yf, yb (pooled)
  pass B:  x̂ ──x̂·W_z──silu─┐
           xc, yf/yb ──broadcast + D·xc──merge──LN──·──·W_out─► out

Weights are in the torch reference layout (``in_proj.weight`` is
``(2·d_inner, d_model)``, conv weights ``(d_inner, 4)``, ``out_proj.weight``
``(d_model, d_inner)``); activations keep the JAX layouts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.conv import grid_dual_conv1d
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.scan import selective_scan


def fusable(grid_shape: Sequence[int], pool_axes: Sequence[int],
            transposed: bool, d_conv: int, collapse_method: str) -> bool:
    """The limits of what pass A/B compute: a 2-D grid, width-4 convs,
    mean pooling over the axis that matches the orientation, and grid
    axes long enough that conv taps wrap at most one line."""
    if len(grid_shape) != 2 or d_conv != 4 or collapse_method != "mean":
        return False
    if tuple(pool_axes) != ((0,) if transposed else (1,)):
        return False
    H, W = grid_shape
    return H >= d_conv and W >= d_conv


# ----------------------------------------------------------------------
# K3: pass A
# ----------------------------------------------------------------------

def pass_a_plain(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling: float,
                 transposed: bool):
    """x4: (B, H, W, dm); w_x: (di, dm) in x4's dtype; b_x, b_cf, b_ab:
    (di,) float32 or None; w_cf, w_ab: (di, 4) float32. Math in fp32 on
    the given values. Returns xc_f, xc_b (B, H, W, di) and pf, pb (B, P,
    di), P = W if transposed else H, all in x4's dtype; the pools are taken
    from the fp32 conv outputs."""
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    dtype = x4.dtype
    xin = x4.reshape(B, H * W, dm).float() @ w_x.float().t()
    if b_x is not None:
        xin = xin + b_x.float()
    xcf, xcb = grid_dual_conv1d(xin, w_cf.float().t(), b_cf,
                                w_ab.float().t(), b_ab, (H, W),
                                axis=0 if transposed else 1)
    line_axis, ln = (1, H) if transposed else (2, W)
    pool = lambda xc: (xc.reshape(B, H, W, di).sum(line_axis)
                       * (scaling / ln)).to(dtype)
    return (xcf.reshape(B, H, W, di).to(dtype),
            xcb.reshape(B, H, W, di).to(dtype), pool(xcf), pool(xcb))


def pass_a(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling: float,
           transposed: bool):
    """Pass A (K3); same contract as :func:`pass_a_plain`. On CUDA,
    d_model must be a multiple of 32 and d_inner of 64."""
    if x4.device.type == "cpu":
        return pass_a_plain(x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, scaling,
                            transposed)
    name = "pass_a_fwd"
    kernels.check_cuda_args(name, x4.device, x4=x4, w_x=w_x, b_x=b_x,
                            w_cf=w_cf, b_cf=b_cf, w_ab=w_ab, b_ab=b_ab)
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    code = kernels.dtype_code(name, x4)
    if w_x.dtype != x4.dtype or tuple(w_x.shape) != (di, dm):
        raise ValueError(f"{name}: w_x must be {x4.dtype} ({di}, {dm})")
    for arg, t, shape in (("w_cf", w_cf, (di, 4)), ("w_ab", w_ab, (di, 4)),
                          ("b_x", b_x, (di,)), ("b_cf", b_cf, (di,)),
                          ("b_ab", b_ab, (di,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}")
    if dm % 32 or di % 64 or min(H, W) < 4:
        raise ValueError(f"{name}: needs d_model % 32 == 0, d_inner % 64 == "
                         f"0 and H, W >= 4, got d_model={dm}, d_inner={di}, "
                         f"grid=({H}, {W})")
    kernels.check_aligned(name, x4=x4, w_x=w_x)
    P = W if transposed else H
    xc_f = x4.new_empty(B, H, W, di)
    xc_b = x4.new_empty(B, H, W, di)
    pf = x4.new_empty(B, P, di)
    pb = x4.new_empty(B, P, di)
    err = _build.library().fv_pass_a_fwd(
        *map(kernels.ptr, (x4, w_x, b_x, w_cf, b_cf, w_ab, b_ab, xc_f, xc_b,
                           pf, pb)),
        B, H, W, dm, di, int(transposed), code, float(scaling),
        kernels.stream_ptr(x4.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return xc_f, xc_b, pf, pb


# ----------------------------------------------------------------------
# K4: pass B
# ----------------------------------------------------------------------

def pass_b_plain(x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b,
                 w_out, b_out, eps: float, use_ln: bool, transposed: bool):
    """x4: (B, H, W, dm); xc_f, xc_b: (B, H, W, di); yf, yb: (B, P, di);
    w_z: (di, dm); w_out: (dm, di), all in x4's dtype. b_z, d_f, d_b,
    ln_w, ln_b: (di,) and b_out: (dm,) float32 (biases may be None). Math
    in fp32; LayerNorm variance E[m²]−μ² (not clamped); the gated value is
    rounded to the dtype before the out projection. Returns (B, H, W, dm)
    in x4's dtype."""
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    dtype = x4.dtype
    z = x4.reshape(-1, dm).float() @ w_z.float().t()
    if b_z is not None:
        z = z + b_z.float()
    bshape = (B, 1, W, di) if transposed else (B, H, 1, di)
    m = (yf.float().reshape(bshape) + d_f.float() * xc_f.float()
         + yb.float().reshape(bshape) + d_b.float() * xc_b.float()) * 0.5
    if use_ln:
        mu = m.mean(-1, keepdim=True)
        var = (m * m).mean(-1, keepdim=True) - mu * mu
        m = (m - mu) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    g = (m.reshape(-1, di) * F.silu(z)).to(dtype).float()
    out = g @ w_out.float().t()
    if b_out is not None:
        out = out + b_out.float()
    return out.to(dtype).reshape(B, H, W, dm)


def pass_b(x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b, w_out,
           b_out, eps: float, use_ln: bool, transposed: bool):
    """Pass B (K4); same contract as :func:`pass_b_plain`. On CUDA,
    d_model and d_inner must be multiples of 32 and d_inner <= 768."""
    if x4.device.type == "cpu":
        return pass_b_plain(x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b,
                            ln_w, ln_b, w_out, b_out, eps, use_ln,
                            transposed)
    name = "pass_b_fwd"
    if not use_ln:
        ln_w = ln_b = None
    kernels.check_cuda_args(name, x4.device, x4=x4, xc_f=xc_f, xc_b=xc_b,
                            yf=yf, yb=yb, w_z=w_z, b_z=b_z, d_f=d_f, d_b=d_b,
                            ln_w=ln_w, ln_b=ln_b, w_out=w_out, b_out=b_out)
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    P = W if transposed else H
    code = kernels.dtype_code(name, x4)
    for arg, t, shape in (("xc_f", xc_f, (B, H, W, di)),
                          ("xc_b", xc_b, (B, H, W, di)),
                          ("yf", yf, (B, P, di)), ("yb", yb, (B, P, di)),
                          ("w_z", w_z, (di, dm)), ("w_out", w_out, (dm, di))):
        if t.dtype != x4.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {x4.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for arg, t, shape in (("b_z", b_z, (di,)), ("d_f", d_f, (di,)),
                          ("d_b", d_b, (di,)), ("ln_w", ln_w, (di,)),
                          ("ln_b", ln_b, (di,)), ("b_out", b_out, (dm,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}")
    if use_ln and (ln_w is None or ln_b is None):
        raise ValueError(f"{name}: use_ln needs ln_w and ln_b")
    if dm % 32 or di % 32 or di > 768:
        raise ValueError(f"{name}: needs d_model, d_inner % 32 == 0 and "
                         f"d_inner <= 768, got {dm}, {di}")
    kernels.check_aligned(name, x4=x4, w_z=w_z, w_out=w_out)
    out = torch.empty_like(x4)
    err = _build.library().fv_pass_b_fwd(
        *map(kernels.ptr, (x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w,
                           ln_b, w_out, b_out, out)),
        B, H, W, dm, di, int(transposed), code, int(use_ln), float(eps),
        kernels.stream_ptr(x4.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


# ----------------------------------------------------------------------
# the fused layer
# ----------------------------------------------------------------------

class FusedParams(NamedTuple):
    """One mixer's parameters, torch reference layouts, float32."""
    in_w: torch.Tensor                 # (2·di, dm)
    in_b: Optional[torch.Tensor]       # (2·di,)
    conv_f_w: torch.Tensor             # (di, 4)
    conv_f_b: Optional[torch.Tensor]
    conv_b_w: torch.Tensor
    conv_b_b: Optional[torch.Tensor]
    x_proj_f: torch.Tensor             # (dt_rank + 2n, di)
    dt_w_f: torch.Tensor               # (di, dt_rank)
    dt_b_f: torch.Tensor               # (di,)
    A_log_f: torch.Tensor              # (di, n)
    D_f: torch.Tensor                  # (di,)
    x_proj_b: torch.Tensor
    dt_w_b: torch.Tensor
    dt_b_b: torch.Tensor
    A_log_b: torch.Tensor
    D_b: torch.Tensor
    ln_w: Optional[torch.Tensor]       # (di,)
    ln_b: Optional[torch.Tensor]
    out_w: torch.Tensor                # (dm, di)
    out_b: Optional[torch.Tensor]      # (dm,)


def proj_scan(xp: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
              dt_b: torch.Tensor, A_log: torch.Tensor, dtype: torch.dtype,
              scan_impl: str, reverse: bool) -> torch.Tensor:
    """x_proj → (dt, B, C) → dt_proj → selective scan of a (pooled)
    sequence xp (batch, L, di); the GEMMs run in ``dtype``. Counterpart
    of ``MambaMixer._proj_scan`` / ``layer_fused._proj_scan``."""
    xp = xp.to(dtype)
    dbl = F.linear(xp, x_proj_w.to(dtype))
    r = dt_w.shape[1]
    n = A_log.shape[1]
    dt = F.linear(dbl[..., :r], dt_w.to(dtype))
    A = -torch.exp(A_log.float())
    return selective_scan(xp, dt, A, dbl[..., r:r + n].contiguous(),
                          dbl[..., r + n:].contiguous(),
                          delta_bias=dt_b.float(), delta_softplus=True,
                          reverse=reverse, impl=scan_impl)


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


def fused_mixer_core(x_hat: torch.Tensor, p: FusedParams,
                     grid: Tuple[int, int], transposed: bool, scaling: float,
                     eps: float, use_ln: bool, dtype: torch.dtype,
                     scan_impl: str = "auto",
                     return_saved: bool = False):
    """The fused mixer layer, in_proj → … → out_proj. x_hat: (B, L, dm)
    normed block input. Returns (B, L, dm) in ``dtype``; with
    ``return_saved`` also ``(xc_f, xc_b, pf, pb, yf, yb)``."""
    B, L, dm = x_hat.shape
    H, W = grid
    if L != H * W:
        raise ValueError(f"L={L} does not match grid {grid}")
    di = p.conv_f_w.shape[0]
    x4 = x_hat.reshape(B, H, W, dm).to(dtype).contiguous()
    in_w = p.in_w.to(dtype)
    in_b = (None, None) if p.in_b is None else (_f32(p.in_b[:di]),
                                                _f32(p.in_b[di:]))
    xc_f, xc_b, pf, pb = pass_a(
        x4, in_w[:di], in_b[0], _f32(p.conv_f_w.reshape(di, -1)),
        _f32(p.conv_f_b), _f32(p.conv_b_w.reshape(di, -1)), _f32(p.conv_b_b),
        scaling, transposed)
    yf = proj_scan(pf, p.x_proj_f, p.dt_w_f, p.dt_b_f, p.A_log_f, dtype,
                   scan_impl, False).to(dtype)
    yb = proj_scan(pb, p.x_proj_b, p.dt_w_b, p.dt_b_b, p.A_log_b, dtype,
                   scan_impl, True).to(dtype)
    out = pass_b(x4, xc_f, xc_b, yf, yb, in_w[di:], in_b[1], _f32(p.D_f),
                 _f32(p.D_b), _f32(p.ln_w) if use_ln else None,
                 _f32(p.ln_b) if use_ln else None, p.out_w.to(dtype),
                 _f32(p.out_b), eps, use_ln, transposed)
    out = out.reshape(B, L, dm)
    if return_saved:
        return out, (xc_f, xc_b, pf, pb, yf, yb)
    return out
