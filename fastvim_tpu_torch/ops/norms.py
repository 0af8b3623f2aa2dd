"""Add + LayerNorm/RMSNorm with an fp32 residual stream.

Counterpart of ``fastvim_tpu/ops/norms.py``: with ``prenorm=True``
``add_norm`` returns ``(normed, residual_out)`` where
``residual_out = x + residual`` stays in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch


def _norm(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], eps: float, rms: bool) -> torch.Tensor:
    """Normalize with fp32 statistics; LayerNorm uses E[x²]−E[x]²
    clamped at 0, as the JAX package does."""
    x32 = x.float()
    if rms:
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
    else:
        mean = x32.mean(-1, keepdim=True)
        mean2 = x32.square().mean(-1, keepdim=True)
        var = (mean2 - mean.square()).clamp_min(0.0)
        y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y


def add_norm(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None,
             prenorm: bool = False, residual_in_fp32: bool = True,
             eps: float = 1e-5, rms: bool = False,
             out_dtype: Optional[torch.dtype] = None):
    """(x + residual) → norm. Returns ``normed`` or, with ``prenorm``,
    ``(normed, residual_out)``."""
    out_dtype = out_dtype or x.dtype
    total = x.float()
    if residual is not None:
        total = total + residual.float()
    y = _norm(total, weight, bias, eps, rms).to(out_dtype)
    if prenorm:
        return y, (total if residual_in_fp32 else total.to(out_dtype))
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    return _norm(x, weight, bias, eps, rms=False).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    return _norm(x, weight, None, eps, rms=True).to(x.dtype)
