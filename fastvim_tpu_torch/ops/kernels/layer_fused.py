"""K3-K6: the two passes of the fused FastVim mixer layer, forward
(``csrc/layer_fused_fwd.cu``) and backward (``csrc/layer_fused_bwd.cu``),
and ``fused_mixer_core``, which chains pass A → the pooled scans → pass B
and differentiates through ``FusedMixerCoreFn``.

Counterpart of ``fastvim_tpu/ops/pallas/layer_fused.py``:

  pass A:  x̂ ──x̂·W_x──dual conv──silu──┬─► xc_f, xc_b
                                        └─mean over each line─► pf, pb
  between: pf/pb ──x_proj, dt_proj GEMMs──K1 scans──► yf, yb (pooled)
  pass B:  x̂ ──x̂·W_z──silu─┐
           xc, yf/yb ──broadcast + D·xc──merge──LN──·──·W_out─► out
  backward: pass B backward (K5) ─► VJP of the section between (GEMMs by
           autograd, scans by K2) ─► pass A backward (K6)

Weights are in the torch reference layout (``in_proj.weight`` is
``(2·d_inner, d_model)``, conv weights ``(d_inner, 4)``, ``out_proj.weight``
``(d_model, d_inner)``); activations keep the JAX layouts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.conv import dual_conv1d, grid_dual_conv1d
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.norms import layer_norm
from fastvim_tpu_torch.ops.scan import (
    broadcast_grid,
    pool_grid,
    selective_scan,
)


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
# K5: pass B backward
# ----------------------------------------------------------------------

BWD_MAX_DI = 384  # widest d_inner K5 holds in one block's registers


def _dsilu(v: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(v)
    return s * (1 + v * (1 - s))


def _wgrad_splits(ntokens: int) -> int:
    """Token slices the weight-gradient GEMMs are split into: enough
    blocks to fill the card, each with at least ~1k tokens."""
    return max(1, min(32, ntokens // 1024))


def pass_b_bwd_plain(g4, x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w,
                     ln_b, w_out, eps: float, use_ln: bool, transposed: bool):
    """The adjoint of :func:`pass_b_plain`, written out in tensor ops
    (not autograd). g4: (B, H, W, dm) cotangent of the output in x4's
    dtype; the other arguments as in :func:`pass_b_plain`. z, m and the
    LayerNorm statistics are recomputed in fp32; the GEMM operands dz and
    the gated value are rounded to the dtype as the TPU kernel rounds
    them. Returns

      dx (B, H, W, dm) float32: the z-half part of the gradient of x4,
      dxc_f, dxc_b (B, H, W, di) and dy (B, P, di) in the dtype (yf and
      yb enter the merge alike, so both take dy),
      dw_out (dm, di), db_out (dm,), dw_z (di, dm), db_z, dln_w, dln_b,
      dd_f, dd_b (di,), all float32 (dln_* are zeros without use_ln).
    """
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    dtype = x4.dtype
    rnd = lambda t: t.to(dtype).float()
    x = x4.reshape(-1, dm).float()
    g = g4.reshape(-1, dm).float()
    z = x @ w_z.float().t()
    if b_z is not None:
        z = z + b_z.float()
    sz = F.silu(z)
    bshape = (B, 1, W, di) if transposed else (B, H, 1, di)
    xcf, xcb = xc_f.float(), xc_b.float()
    m0 = ((yf.float().reshape(bshape) + d_f.float() * xcf
           + yb.float().reshape(bshape) + d_b.float() * xcb)
          * 0.5).reshape(-1, di)
    dmg = g @ w_out.float()
    if use_ln:
        mu = m0.mean(-1, keepdim=True)
        var = (m0 * m0).mean(-1, keepdim=True) - mu * mu
        rstd = torch.rsqrt(var + eps)
        mhat = (m0 - mu) * rstd
        mln = mhat * ln_w.float() + ln_b.float()
    else:
        mhat = mln = m0
    dmln = dmg * sz
    dz = dmg * mln * _dsilu(z)
    dw_out = g.t() @ rnd(mln * sz)
    if use_ln:
        dln_w, dln_b = (dmln * mhat).sum(0), dmln.sum(0)
        dmhat = dmln * ln_w.float()
        dm0 = rstd * (dmhat - dmhat.mean(-1, keepdim=True)
                      - mhat * (dmhat * mhat).mean(-1, keepdim=True))
    else:
        dln_w = dln_b = z.new_zeros(di)
        dm0 = dmln
    dzr = rnd(dz)
    dm0h = (dm0 * 0.5).reshape(B, H, W, di)
    return ((dzr @ w_z.float()).reshape(B, H, W, dm),
            (dm0h * d_f.float()).to(dtype), (dm0h * d_b.float()).to(dtype),
            dm0h.sum(1 if transposed else 2).to(dtype),
            dw_out, g.sum(0), dzr.t() @ x, dz.sum(0), dln_w, dln_b,
            (dm0h * xcf).sum((0, 1, 2)), (dm0h * xcb).sum((0, 1, 2)))


def pass_b_bwd(g4, x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b,
               w_out, eps: float, use_ln: bool, transposed: bool):
    """Pass B backward (K5); same contract as :func:`pass_b_bwd_plain`.
    On CUDA, d_model and d_inner must be multiples of 64 and d_inner <=
    384. The sums over all tokens (weight and vector gradients) are
    written as per-block partials and added by a second kernel in a
    fixed order."""
    if x4.device.type == "cpu":
        return pass_b_bwd_plain(g4, x4, xc_f, xc_b, yf, yb, w_z, b_z, d_f,
                                d_b, ln_w, ln_b, w_out, eps, use_ln,
                                transposed)
    name = "pass_b_bwd"
    if not use_ln:
        ln_w = ln_b = None
    kernels.check_cuda_args(name, x4.device, g4=g4, x4=x4, xc_f=xc_f,
                            xc_b=xc_b, yf=yf, yb=yb, w_z=w_z, b_z=b_z,
                            d_f=d_f, d_b=d_b, ln_w=ln_w, ln_b=ln_b,
                            w_out=w_out)
    B, H, W, dm = x4.shape
    di = w_z.shape[0]
    P = W if transposed else H
    code = kernels.dtype_code(name, x4)
    for arg, t, shape in (("g4", g4, (B, H, W, dm)),
                          ("xc_f", xc_f, (B, H, W, di)),
                          ("xc_b", xc_b, (B, H, W, di)),
                          ("yf", yf, (B, P, di)), ("yb", yb, (B, P, di)),
                          ("w_z", w_z, (di, dm)), ("w_out", w_out, (dm, di))):
        if t.dtype != x4.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {x4.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for arg, t in (("b_z", b_z), ("d_f", d_f), ("d_b", d_b), ("ln_w", ln_w),
                   ("ln_b", ln_b)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (di,)):
            raise ValueError(f"{name}: {arg} must be float32 ({di},)")
    if use_ln and (ln_w is None or ln_b is None):
        raise ValueError(f"{name}: use_ln needs ln_w and ln_b")
    if dm % 64 or di % 64 or di > BWD_MAX_DI:
        raise ValueError(f"{name}: needs d_model, d_inner % 64 == 0 and "
                         f"d_inner <= {BWD_MAX_DI}, got {dm}, {di}")
    w_z_t = w_z.t().contiguous()      # (dm, di): dx = dz · W_z
    w_out_t = w_out.t().contiguous()  # (di, dm): d(gated) = g · W_out
    kernels.check_aligned(name, g4=g4, x4=x4, w_z=w_z, w_z_t=w_z_t,
                          w_out_t=w_out_t)
    T = B * H * W
    nsplit = _wgrad_splits(T)
    f32 = dict(dtype=torch.float32, device=x4.device)
    dx = torch.empty(B, H, W, dm, **f32)
    dxc_f, dxc_b = torch.empty_like(xc_f), torch.empty_like(xc_b)
    dy = x4.new_empty(B, P, di)
    mg, dz = x4.new_empty(T, di), x4.new_empty(T, di)  # GEMM operands
    nvec = 5 * di + dm
    vec_part = torch.empty(B * P, nvec, **f32)
    vec = torch.empty(nvec, **f32)
    w_part = torch.empty(nsplit, dm * di, **f32)
    dw_out = torch.empty(dm, di, **f32)
    dw_z = torch.empty(di, dm, **f32)
    err = _build.library().fv_pass_b_bwd(
        *map(kernels.ptr, (g4, x4, xc_f, xc_b, yf, yb, w_z, w_z_t, b_z, d_f,
                           d_b, ln_w, ln_b, w_out_t, dx, dxc_f, dxc_b, dy,
                           mg, dz, vec_part, vec, w_part, dw_out, dw_z)),
        B, H, W, dm, di, int(transposed), code, int(use_ln), nsplit,
        float(eps), kernels.stream_ptr(x4.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    db_z, dln_w, dln_b, dd_f, dd_b = vec[:5 * di].view(5, di).unbind(0)
    return (dx, dxc_f, dxc_b, dy, dw_out, vec[5 * di:], dw_z, db_z, dln_w,
            dln_b, dd_f, dd_b)


# ----------------------------------------------------------------------
# K6: pass A backward
# ----------------------------------------------------------------------

def _to_lines(t4: torch.Tensor, transposed: bool) -> torch.Tensor:
    """(B, H, W, c) → (B, H·W, c) in the order the conv runs in: the
    raster, or the column-major raster when transposed."""
    B, H, W, c = t4.shape
    return (t4.transpose(1, 2) if transposed else t4).reshape(B, H * W, c)


def pass_a_bwd_plain(x4, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x, w_cf, b_cf,
                     w_ab, b_ab, scaling: float, transposed: bool):
    """The adjoint of :func:`pass_a_plain`, written out in tensor ops
    (not autograd). dx_b: (B, H, W, dm) float32, pass B's part of the
    gradient of x4; dxc_f, dxc_b: (B, H, W, di) and dpf, dpb: (B, P, di)
    cotangents in x4's dtype; the rest as in :func:`pass_a_plain`. The
    conv pre-activations are recomputed in fp32; the GEMM operand dxin is
    rounded to the dtype. Returns dx (B, H, W, dm) float32 (dx_b plus the
    x-half part), dw_x (di, dm), db_x (di,), dw_cf (di, 4), db_cf,
    dw_ab (di, 4), db_ab, all float32."""
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    dtype = x4.dtype
    L = H * W
    x = x4.reshape(-1, dm).float()
    xin = x @ w_x.float().t()
    if b_x is not None:
        xin = xin + b_x.float()
    xp = F.pad(_to_lines(xin.reshape(B, H, W, di), transposed), (0, 0, 3, 3))
    wc, wa = w_cf.float(), w_ab.float()
    yc = sum(xp[:, k:k + L] * wc[:, k] for k in range(4))
    ya = sum(xp[:, 3 + k:3 + k + L] * wa[:, 3 - k] for k in range(4))
    if b_cf is not None:
        yc = yc + b_cf.float()
    if b_ab is not None:
        ya = ya + b_ab.float()
    bshape = (B, 1, W, di) if transposed else (B, H, 1, di)
    s = scaling / (H if transposed else W)
    dyc = _to_lines(dxc_f.float() + dpf.float().reshape(bshape) * s,
                    transposed) * _dsilu(yc)
    dya = _to_lines(dxc_b.float() + dpb.float().reshape(bshape) * s,
                    transposed) * _dsilu(ya)
    dycp, dyap = F.pad(dyc, (0, 0, 3, 3)), F.pad(dya, (0, 0, 3, 3))
    dxin = sum(dycp[:, 6 - k:6 - k + L] * wc[:, k]
               + dyap[:, 3 - k:3 - k + L] * wa[:, 3 - k] for k in range(4))
    dw_cf = torch.stack([(xp[:, k:k + L] * dyc).sum((0, 1))
                         for k in range(4)], 1)
    dw_ab = torch.stack([(xp[:, 6 - k:6 - k + L] * dya).sum((0, 1))
                         for k in range(4)], 1)
    if transposed:  # back to raster order
        dxin = dxin.reshape(B, W, H, di).transpose(1, 2)
    dxr = dxin.reshape(-1, di).to(dtype).float()
    dx = dx_b.reshape(-1, dm).float() + dxr @ w_x.float()
    return (dx.reshape(B, H, W, dm), dxr.t() @ x,
            dxin.reshape(-1, di).sum(0), dw_cf, dyc.sum((0, 1)), dw_ab,
            dya.sum((0, 1)))


def pass_a_bwd(x4, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x, w_cf, b_cf, w_ab,
               b_ab, scaling: float, transposed: bool):
    """Pass A backward (K6); same contract as :func:`pass_a_bwd_plain`.
    On CUDA, d_model and d_inner must be multiples of 64. The sums over
    all tokens are per-block partials added by a second kernel in a fixed
    order."""
    if x4.device.type == "cpu":
        return pass_a_bwd_plain(x4, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, b_x,
                                w_cf, b_cf, w_ab, b_ab, scaling, transposed)
    name = "pass_a_bwd"
    kernels.check_cuda_args(name, x4.device, x4=x4, dx_b=dx_b, dxc_f=dxc_f,
                            dxc_b=dxc_b, dpf=dpf, dpb=dpb, w_x=w_x, b_x=b_x,
                            w_cf=w_cf, b_cf=b_cf, w_ab=w_ab, b_ab=b_ab)
    B, H, W, dm = x4.shape
    di = w_x.shape[0]
    P = W if transposed else H
    code = kernels.dtype_code(name, x4)
    for arg, t, shape in (("dxc_f", dxc_f, (B, H, W, di)),
                          ("dxc_b", dxc_b, (B, H, W, di)),
                          ("dpf", dpf, (B, P, di)), ("dpb", dpb, (B, P, di)),
                          ("w_x", w_x, (di, dm))):
        if t.dtype != x4.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {x4.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if dx_b.dtype != torch.float32 or dx_b.shape != x4.shape:
        raise ValueError(f"{name}: dx_b must be float32 {tuple(x4.shape)}")
    for arg, t, shape in (("w_cf", w_cf, (di, 4)), ("w_ab", w_ab, (di, 4)),
                          ("b_x", b_x, (di,)), ("b_cf", b_cf, (di,)),
                          ("b_ab", b_ab, (di,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}")
    if dm % 64 or di % 64 or min(H, W) < 4:
        raise ValueError(f"{name}: needs d_model, d_inner % 64 == 0 and "
                         f"H, W >= 4, got d_model={dm}, d_inner={di}, "
                         f"grid=({H}, {W})")
    w_x_t = w_x.t().contiguous()  # (dm, di): dx = dxin · W_x
    kernels.check_aligned(name, x4=x4, w_x=w_x, w_x_t=w_x_t)
    T = B * H * W
    nsplit = _wgrad_splits(T)
    f32 = dict(dtype=torch.float32, device=x4.device)
    dx = torch.empty(B, H, W, dm, **f32)
    dxin = x4.new_empty(T, di)  # GEMM operand
    c_part = torch.empty(B * P, 11 * di, **f32)
    c_vec = torch.empty(11, di, **f32)
    w_part = torch.empty(nsplit, di * dm, **f32)
    dw_x = torch.empty(di, dm, **f32)
    err = _build.library().fv_pass_a_bwd(
        *map(kernels.ptr, (x4, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, w_x_t, b_x,
                           w_cf, b_cf, w_ab, b_ab, dx, dxin, c_part, c_vec,
                           w_part, dw_x)),
        B, H, W, dm, di, int(transposed), code, nsplit, float(scaling),
        kernels.stream_ptr(x4.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    # c_vec rows: dw_cf[:, 0..3], dw_ab[:, 0..3], db_cf, db_ab, db_x
    return (dx, dw_x, c_vec[10], c_vec[0:4].t(), c_vec[8], c_vec[4:8].t(),
            c_vec[9])


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


def reference_core(x_hat: torch.Tensor, p: FusedParams,
                   grid: Tuple[int, int], transposed: bool, scaling: float,
                   eps: float, use_ln: bool, dtype: torch.dtype,
                   scan_impl: str = "auto") -> torch.Tensor:
    """The unfused mixer math for the dense pooled-mean layer, in plain
    differentiable ops (the scans through
    :func:`~fastvim_tpu_torch.ops.scan.selective_scan`). Counterpart of
    ``_reference_core`` of the JAX package: what the "remat" backward
    differentiates, and the oracle of the fused layer on any grid."""
    c = lambda t: None if t is None else t.to(dtype)
    di = p.conv_f_w.shape[0]
    xz = F.linear(x_hat.to(dtype), p.in_w.to(dtype), c(p.in_b))
    xin, z = xz[..., :di], xz[..., di:]
    conv_args = (xin, p.conv_f_w.reshape(di, -1).t().to(dtype),
                 c(p.conv_f_b), p.conv_b_w.reshape(di, -1).t().to(dtype),
                 c(p.conv_b_b))
    if transposed:
        xc_f, xc_b = grid_dual_conv1d(*conv_args, grid, axis=0)
        pool_axes = (0,)
    else:
        xc_f, xc_b = dual_conv1d(*conv_args)
        pool_axes = (1,)
    pf = pool_grid(xc_f, grid, pool_axes, "mean", scaling)
    pb = pool_grid(xc_b, grid, pool_axes, "mean", scaling)
    yf = proj_scan(pf, p.x_proj_f, p.dt_w_f, p.dt_b_f, p.A_log_f, dtype,
                   scan_impl, False)
    yb = proj_scan(pb, p.x_proj_b, p.dt_w_b, p.dt_b_b, p.A_log_b, dtype,
                   scan_impl, True)
    y_f = broadcast_grid(yf.to(dtype), grid, pool_axes) + c(p.D_f) * xc_f
    y_b = broadcast_grid(yb.to(dtype), grid, pool_axes) + c(p.D_b) * xc_b
    merged = (y_f + y_b) * 0.5
    if use_ln:
        merged = layer_norm(merged, p.ln_w, p.ln_b, eps=eps)
    merged = merged * F.silu(z)
    return F.linear(merged, p.out_w.to(dtype), c(p.out_b))


def _fused_forward(x_hat, p: FusedParams, grid, transposed, scaling, eps,
                   use_ln, dtype, scan_impl, keep_mid_graph: bool = False):
    """Pass A → pooled scans → pass B. Returns (out (B, H, W, dm), x4,
    the pass B arguments, (xc_f, xc_b, pf, pb, yf, yb), mid). With
    ``keep_mid_graph`` the x_proj / dt_proj / scan section between the
    passes runs with autograd recording on detached leaves, and ``mid`` =
    (leaves, yf, yb) is that graph, for the fused backward to
    differentiate."""
    B, L, dm = x_hat.shape
    H, W = grid
    if L != H * W:
        raise ValueError(f"L={L} does not match grid {grid}")
    di = p.conv_f_w.shape[0]
    x4 = x_hat.reshape(B, H, W, dm).to(dtype).contiguous()
    in_w = p.in_w.to(dtype)
    in_b = (None, None) if p.in_b is None else (_f32(p.in_b[:di]),
                                                _f32(p.in_b[di:]))
    a_args = (in_w[:di], in_b[0], _f32(p.conv_f_w.reshape(di, -1)),
              _f32(p.conv_f_b), _f32(p.conv_b_w.reshape(di, -1)),
              _f32(p.conv_b_b))
    xc_f, xc_b, pf, pb = pass_a(x4, *a_args, scaling, transposed)
    scan_p = (p.x_proj_f, p.dt_w_f, p.dt_b_f, p.A_log_f,
              p.x_proj_b, p.dt_w_b, p.dt_b_b, p.A_log_b)
    mid = None
    if keep_mid_graph:
        leaves = [t.detach().requires_grad_() for t in (pf, pb) + scan_p]
        with torch.enable_grad():
            yf = proj_scan(leaves[0], *leaves[2:6], dtype, scan_impl,
                           False).to(dtype)
            yb = proj_scan(leaves[1], *leaves[6:10], dtype, scan_impl,
                           True).to(dtype)
        mid = (leaves, yf, yb)
        yf, yb = yf.detach(), yb.detach()
    else:
        yf = proj_scan(pf, *scan_p[:4], dtype, scan_impl, False).to(dtype)
        yb = proj_scan(pb, *scan_p[4:], dtype, scan_impl, True).to(dtype)
    b_args = (in_w[di:], in_b[1], _f32(p.D_f), _f32(p.D_b),
              _f32(p.ln_w) if use_ln else None,
              _f32(p.ln_b) if use_ln else None, p.out_w.to(dtype))
    out = pass_b(x4, xc_f, xc_b, yf, yb, *b_args, _f32(p.out_b), eps, use_ln,
                 transposed)
    return out, x4, a_args, b_args, (xc_f, xc_b, pf, pb, yf, yb), mid


def _param_grads(p: FusedParams, grads: dict, needs) -> tuple:
    """Gradients in FusedParams order, cast to each parameter's dtype and
    shape; None for an absent parameter or one that needs none."""
    return tuple(
        None if t is None or not need or grads.get(name) is None
        else grads[name].to(t.dtype).reshape(t.shape)
        for (name, t), need in zip(p._asdict().items(), needs))


class FusedMixerCoreFn(torch.autograd.Function):
    """The fused layer with the fused backward: forward = pass A (K3) →
    pooled scans (K1, states saved) → pass B (K4), saving (x̂, xc_f, xc_b,
    pf, pb) and the graph of the section between the passes; backward =
    pass B backward (K5) → the VJP of that section (its GEMMs by
    autograd, its scans by K2) → pass A backward (K6). Counterpart of
    ``fused_mixer_core`` with ``bwd_mode="fused"`` in the JAX package."""

    @staticmethod
    def forward(ctx, x_hat, grid, transposed, scaling, eps, use_ln, dtype,
                scan_impl, *params):
        p = FusedParams(*params)
        out, x4, a_args, b_args, saved, mid = _fused_forward(
            x_hat, p, grid, transposed, scaling, eps, use_ln, dtype,
            scan_impl, keep_mid_graph=True)
        ctx.p, ctx.mid = p, mid
        ctx.tensors = (x4, a_args, b_args, saved[:2], saved[4:])
        ctx.cfg = (transposed, scaling, eps, use_ln, x_hat.dtype)
        return out.reshape(x_hat.shape[0], -1, x4.shape[-1])

    @staticmethod
    def backward(ctx, g):
        p, (leaves, yf_g, yb_g) = ctx.p, ctx.mid
        x4, a_args, b_args, (xc_f, xc_b), (yf, yb) = ctx.tensors
        transposed, scaling, eps, use_ln, x_dtype = ctx.cfg
        di = p.conv_f_w.shape[0]
        g4 = g.reshape(x4.shape).to(x4.dtype).contiguous()
        (dx_b, dxc_f, dxc_b, dy, dw_out, db_out, dw_z, db_z, dln_w, dln_b,
         dd_f, dd_b) = pass_b_bwd(g4, x4, xc_f, xc_b, yf, yb, *b_args, eps,
                                  use_ln, transposed)
        mid = torch.autograd.grad((yf_g, yb_g), leaves, (dy, dy))
        dx, dw_x, db_x, dw_cf, db_cf, dw_ab, db_ab = pass_a_bwd(
            x4, dx_b, dxc_f, dxc_b, mid[0].contiguous(),
            mid[1].contiguous(), *a_args, scaling, transposed)
        grads = dict(
            in_w=torch.cat([dw_x, dw_z], 0), in_b=torch.cat([db_x, db_z]),
            conv_f_w=dw_cf, conv_f_b=db_cf, conv_b_w=dw_ab, conv_b_b=db_ab,
            x_proj_f=mid[2], dt_w_f=mid[3], dt_b_f=mid[4], A_log_f=mid[5],
            D_f=dd_f, x_proj_b=mid[6], dt_w_b=mid[7], dt_b_b=mid[8],
            A_log_b=mid[9], D_b=dd_b, ln_w=dln_w if use_ln else None,
            ln_b=dln_b if use_ln else None, out_w=dw_out, out_b=db_out)
        ctx.mid = ctx.tensors = None
        return ((dx.reshape(g.shape).to(x_dtype),) + (None,) * 7
                + _param_grads(p, grads, ctx.needs_input_grad[8:]))


class FusedMixerCoreRematFn(torch.autograd.Function):
    """The fused forward with the rematerializing backward: autograd
    through :func:`reference_core`, recomputed from x̂ and the
    parameters. Counterpart of ``bwd_mode="remat"`` in the JAX package."""

    @staticmethod
    def forward(ctx, x_hat, grid, transposed, scaling, eps, use_ln, dtype,
                scan_impl, *params):
        p = FusedParams(*params)
        out, x4, *_ = _fused_forward(x_hat, p, grid, transposed, scaling,
                                     eps, use_ln, dtype, scan_impl)
        ctx.p, ctx.x_hat = p, x_hat
        ctx.cfg = (grid, transposed, scaling, eps, use_ln, dtype, scan_impl)
        return out.reshape(x_hat.shape[0], -1, x4.shape[-1])

    @staticmethod
    def backward(ctx, g):
        present = [i for i, t in enumerate(ctx.p) if t is not None]
        leaves = [ctx.x_hat.detach().requires_grad_()] + [
            ctx.p[i].detach().requires_grad_() for i in present]
        params = [None] * len(ctx.p)
        for i, leaf in zip(present, leaves[1:]):
            params[i] = leaf
        with torch.enable_grad():
            out = reference_core(leaves[0], FusedParams(*params), *ctx.cfg)
        grads = torch.autograd.grad(out, leaves, g.to(out.dtype),
                                    allow_unused=True)
        dp = [None] * len(ctx.p)
        for i, gr in zip(present, grads[1:]):
            dp[i] = gr
        return (grads[0],) + (None,) * 7 + tuple(dp)


def fused_mixer_core(x_hat: torch.Tensor, p: FusedParams,
                     grid: Tuple[int, int], transposed: bool, scaling: float,
                     eps: float, use_ln: bool, dtype: torch.dtype,
                     scan_impl: str = "auto", return_saved: bool = False,
                     bwd_mode: str = "fused"):
    """The fused mixer layer, in_proj → … → out_proj. x_hat: (B, L, dm)
    normed block input. Returns (B, L, dm) in ``dtype``; with
    ``return_saved`` (forward only) also ``(xc_f, xc_b, pf, pb, yf, yb)``.

    When a gradient is needed the call goes through
    :class:`FusedMixerCoreFn` (``bwd_mode="fused"``: the K5 and K6
    adjoint kernels) or :class:`FusedMixerCoreRematFn` (``"remat"``:
    autograd through :func:`reference_core`)."""
    if bwd_mode not in ("fused", "remat"):
        raise ValueError(f"bwd_mode must be fused|remat, got {bwd_mode!r}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x_hat,) + tuple(p))
    if needs_grad:
        if return_saved:
            raise ValueError("return_saved is a forward-only option")
        dm, di = x_hat.shape[-1], p.conv_f_w.shape[0]
        if (bwd_mode == "fused" and x_hat.is_cuda
                and (dm % 64 or di % 64 or di > BWD_MAX_DI)):
            # say so before the forward runs, not in the middle of backward
            raise ValueError(
                f"fused_mixer_core: the fused backward kernels need d_model, "
                f"d_inner % 64 == 0 and d_inner <= {BWD_MAX_DI}, got {dm}, "
                f"{di}; use bwd_mode='remat' (layer_fused_bwd) for this width")
        fn = FusedMixerCoreFn if bwd_mode == "fused" else FusedMixerCoreRematFn
        return fn.apply(x_hat, tuple(grid), transposed, scaling, eps, use_ln,
                        dtype, scan_impl, *p)
    out, _, _, _, saved, _ = _fused_forward(x_hat, p, grid, transposed,
                                            scaling, eps, use_ln, dtype,
                                            scan_impl)
    out = out.reshape(x_hat.shape[0], -1, x_hat.shape[-1])
    return (out, saved) if return_saved else out
