"""K10: broadcast + D-skip + merge + LayerNorm + gate from materialized
conv outputs (``csrc/merge_gate.cu``).

Counterpart of ``fastvim_tpu/ops/pallas/merge_gate.py``: the unfused
mixer's chain after the pooled scans,

  LN(½(bcast(yf) + D_f·xc_f + bcast(yb) + D_b·xc_b)) · silu(z),

in one pass over xc_f, xc_b and z. Two broadcast patterns: with
``pool_axes=(1,)`` (even layers) token (h, w) reads pooled row h; with
``(0,)`` (the odd layers' in-place orientation) pooled column w. A
forward kernel: ``MergeLnGateFn`` takes the gradient by autograd through
the plain version, as the JAX package takes it through its reference.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.scan import broadcast_grid


def fusable(grid_shape: Sequence[int], pool_axes: Sequence[int],
            d_inner: int) -> bool:
    """What K10 takes: a 2-D grid pooled over one of its axes and a
    d_inner that is a multiple of 32. The TPU kernel's W % 8 and
    d_inner % 128 were its block rules and have no counterpart here."""
    return (len(grid_shape) == 2 and tuple(pool_axes) in ((0,), (1,))
            and min(grid_shape) >= 1 and d_inner >= 32 and d_inner % 32 == 0)


def merge_ln_gate_plain(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b,
                        grid_shape, pool_axes, eps: float, use_ln: bool):
    """xc_f, xc_b, z: (B, H·W, d); yf, yb: (B, P, d) pooled scan outputs,
    P = H for ``pool_axes=(1,)`` and W for ``(0,)``; d_f, d_b: (d,);
    ln_w, ln_b: (d,) or None. Math in fp32, LayerNorm over d with the
    variance as the mean of (m − μ)². Returns (B, H·W, d) in xc_f's
    dtype."""
    bc = lambda y: broadcast_grid(y.float(), grid_shape, pool_axes)
    m = (bc(yf) + d_f.float() * xc_f.float()
         + bc(yb) + d_b.float() * xc_b.float()) * 0.5
    if use_ln:
        mu = m.mean(-1, keepdim=True)
        var = ((m - mu) ** 2).mean(-1, keepdim=True)
        m = (m - mu) * torch.rsqrt(var + eps)
        if ln_w is not None:
            m = m * ln_w.float()
        if ln_b is not None:
            m = m + ln_b.float()
    return (m * F.silu(z.float())).to(xc_f.dtype)


def merge_ln_gate(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b, grid_shape,
                  pool_axes, eps: float, use_ln: bool) -> torch.Tensor:
    """K10; same contract as :func:`merge_ln_gate_plain`. On CUDA xc_f,
    xc_b, z, yf and yb share one dtype, the vectors are float32 and d is a
    multiple of 32; z may be a column slice of a wider contiguous
    array."""
    if xc_f.device.type == "cpu":
        return merge_ln_gate_plain(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w,
                                   ln_b, grid_shape, pool_axes, eps, use_ln)
    name = "merge_ln_gate_fwd"
    if not use_ln:
        ln_w = ln_b = None
    kernels.check_cuda_args(name, xc_f.device, token_strided=("z",),
                            xc_f=xc_f, xc_b=xc_b, z=z, yf=yf, yb=yb, d_f=d_f,
                            d_b=d_b, ln_w=ln_w, ln_b=ln_b)
    code = kernels.dtype_code(name, xc_f)
    B, L, d = xc_f.shape
    if not fusable(grid_shape, pool_axes, d):
        raise ValueError(f"{name}: needs a 2-D grid pooled over one axis and "
                         f"d % 32 == 0, got grid {tuple(grid_shape)}, "
                         f"pool_axes {tuple(pool_axes)}, d={d}")
    H, W = grid_shape
    along_w = tuple(pool_axes) == (1,)
    P = H if along_w else W
    for arg, t, shape in (("xc_f", xc_f, (B, H * W, d)),
                          ("xc_b", xc_b, (B, H * W, d)),
                          ("z", z, (B, H * W, d)), ("yf", yf, (B, P, d)),
                          ("yb", yb, (B, P, d))):
        if t.dtype != xc_f.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {xc_f.dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for arg, t in (("d_f", d_f), ("d_b", d_b), ("ln_w", ln_w),
                   ("ln_b", ln_b)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (d,)):
            raise ValueError(f"{name}: {arg} must be float32 ({d},)")
    out = torch.empty_like(xc_f)
    err = _build.library().fv_merge_ln_gate_fwd(
        *map(kernels.ptr, (xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b, out)),
        B, H, W, d, kernels.token_stride(name, "z", z), int(along_w), code,
        int(use_ln), float(eps), kernels.stream_ptr(xc_f.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


class MergeLnGateFn(torch.autograd.Function):
    """out = merge_ln_gate(...): K10 forward (its plain version on the
    CPU); backward by autograd through :func:`merge_ln_gate_plain`, also
    where the layer has no LayerNorm (ln_w, ln_b None)."""

    @staticmethod
    def forward(ctx, xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b, grid_shape,
                pool_axes, eps, use_ln):
        ctx.save_for_backward(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b)
        ctx.static = (tuple(grid_shape), tuple(pool_axes), eps, use_ln)
        return merge_ln_gate(xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b,
                             *ctx.static)

    @staticmethod
    def backward(ctx, g):
        return kernels.plain_vjp(merge_ln_gate_plain, ctx.saved_tensors,
                                 ctx.static, g,
                                 ctx.needs_input_grad[:9]) + (None,) * 4
