"""Depthwise causal / anticausal conv1d with SiLU, channels-last.

Counterpart of ``fastvim_tpu/ops/conv.py``: a width-``w`` depthwise conv
along the token axis of ``(batch, L, d)``, written as ``w`` shifted
multiply-adds. Weights are ``(width, d)`` as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _finish(y: torch.Tensor, bias: Optional[torch.Tensor],
            activation: Optional[str]) -> torch.Tensor:
    if bias is not None:
        y = y + bias
    if activation == "silu":
        return F.silu(y)
    if activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = "silu") -> torch.Tensor:
    """y[:, t] = Σ_k weight[k] · x[:, t - (width-1) + k]  (zero-padded)."""
    width = weight.shape[0]
    L = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = sum(xp[:, k:k + L] * weight[k] for k in range(width))
    return _finish(y, bias, activation)


def anticausal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = "silu") -> torch.Tensor:
    """The causal conv of the reversed sequence, in original order:
    y[t] = Σ_j weight[width-1-j] · x[t + j]  (zero-padded at the end)."""
    width = weight.shape[0]
    L = x.shape[1]
    xp = F.pad(x, (0, 0, 0, width - 1))
    y = sum(xp[:, j:j + L] * weight[width - 1 - j] for j in range(width))
    return _finish(y, bias, activation)


def dual_conv1d(x: torch.Tensor, weight_c: torch.Tensor,
                bias_c: Optional[torch.Tensor], weight_a: torch.Tensor,
                bias_a: Optional[torch.Tensor],
                activation: Optional[str] = "silu"):
    """Causal and anticausal convs of the same input: (yc, ya)."""
    return (causal_conv1d(x, weight_c, bias_c, activation),
            anticausal_conv1d(x, weight_a, bias_a, activation))


def grid_dual_conv1d(x: torch.Tensor, weight_c: torch.Tensor,
                     bias_c: Optional[torch.Tensor], weight_a: torch.Tensor,
                     bias_a: Optional[torch.Tensor], grid: Sequence[int],
                     axis: int, activation: Optional[str] = "silu"):
    """Dual conv along a token-grid axis of a raster-order sequence.

    ``axis=1`` convolves along the raster itself; ``axis=0`` along the
    transposed (column-major) raster, FastVim's odd layers: the sequence
    is transposed, convolved and transposed back. Taps cross line
    boundaries exactly as in the flat 1-D conv of that order.
    """
    if axis == 1:
        return dual_conv1d(x, weight_c, bias_c, weight_a, bias_a, activation)
    if axis != 0:
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    B, L, d = x.shape
    H, W = grid
    xt = x.reshape(B, H, W, d).transpose(1, 2).reshape(B, L, d)
    yc, ya = dual_conv1d(xt, weight_c, bias_c, weight_a, bias_a, activation)
    back = lambda y: y.reshape(B, W, H, d).transpose(1, 2).reshape(B, L, d)
    return back(yc), back(ya)
