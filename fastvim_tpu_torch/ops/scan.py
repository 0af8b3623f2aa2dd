"""Selective scan (Mamba SSM) and the pooled-grid helpers.

Counterpart of ``fastvim_tpu/ops/scan.py``. Per (batch, channel):

    h[t] = exp(delta[t] * A) * h[t-1] + delta[t] * B[t] * u[t]
    y[t] = <C[t], h[t]> (+ D * u[t])

Layout is channels-last ``(batch, L, d)``; the scan math is fp32 and the
output takes u's dtype. ``selective_scan`` sends a CPU tensor to the
sequential reference and a CUDA tensor to the chunked scan kernel
(``ops/kernels/selective_scan.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = False,
                       reverse: bool = False) -> torch.Tensor:
    """Sequential oracle. u/delta: (batch, L, d); A: (d, n); B/C:
    (batch, L, n); D, delta_bias: (d,). Returns y (batch, L, d) in u's
    dtype.

    ``reverse=True`` scans right to left (h[t] = a[t]·h[t+1] + b[t]) with
    the output in original order.
    """
    if B.dim() != 3 or C.dim() != 3:
        raise ValueError(f"B/C must be (batch, L, n), got {tuple(B.shape)} "
                         f"and {tuple(C.shape)}")
    batch, L, d = u.shape
    u32 = u.float()
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = F.softplus(dt)
    a = torch.exp(dt.unsqueeze(-1) * A.float())               # (b, L, d, n)
    b = (dt * u32).unsqueeze(-1) * B.float().unsqueeze(2)     # (b, L, d, n)
    Cf = C.float()
    h = u32.new_zeros(batch, d, A.shape[1])
    ys = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        h = a[:, t] * h + b[:, t]
        ys[t] = (h * Cf[:, t, None, :]).sum(-1)
    y = torch.stack(ys, 1) if L else u32.new_zeros(batch, 0, d)
    if D is not None:
        y = y + u32 * D.float()
    return y.to(u.dtype)


def selective_scan(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus: bool = False, reverse: bool = False,
                   impl: str = "auto",
                   variant: str = "sublane") -> torch.Tensor:
    """Dispatching entry point: ``impl="ref"`` runs the sequential
    reference on any device, differentiated by autograd through its loop;
    otherwise a CPU tensor runs the reference and a CUDA tensor launches
    the chunked scan kernel (K1). When a gradient is needed, the call goes
    through ``SelectiveScanFn``, whose backward is K2 (its plain version
    on the CPU).

    ``variant="lanes"`` (the name the JAX package gives it; "sublane" is
    the default kernel) takes the forward through the lanes kernel
    instead, time across a warp's lanes, forward direction only; its
    gradient goes through ``SelectiveScanLanesFn``."""
    if variant not in ("sublane", "lanes"):
        raise ValueError(f"variant must be sublane|lanes, got {variant!r}")
    if variant == "lanes" and reverse:
        raise NotImplementedError(
            "variant='lanes' is forward-only; use the default variant for "
            "reverse")
    if impl == "ref":
        return selective_scan_ref(u, delta, A, B, C, D=D,
                                  delta_bias=delta_bias,
                                  delta_softplus=delta_softplus,
                                  reverse=reverse)
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, delta, A, B, C, D, delta_bias))
    if variant == "lanes":
        if needs_grad:
            return ss.SelectiveScanLanesFn.apply(u, delta, A, B, C, D,
                                                 delta_bias, delta_softplus)
        return ss.selective_scan_fwd_lanes(u, delta, A, B, C, D=D,
                                           delta_bias=delta_bias,
                                           delta_softplus=delta_softplus)
    if needs_grad:
        return ss.SelectiveScanFn.apply(u, delta, A, B, C, D, delta_bias,
                                        delta_softplus, reverse)
    return ss.selective_scan_fwd(u, delta, A, B, C, D=D,
                                 delta_bias=delta_bias,
                                 delta_softplus=delta_softplus,
                                 reverse=reverse)


def pool_grid(x: torch.Tensor, grid_shape: Sequence[int],
              pool_axes: Sequence[int], method: str = "mean",
              scaling_factor: float = 1.0) -> torch.Tensor:
    """Pool a flattened token grid along ``pool_axes``.

    x: (batch, prod(grid_shape), d) in raster order of ``grid_shape``.
    Returns (batch, prod(kept dims), d).
    """
    b, L, d = x.shape
    if L != math.prod(grid_shape):
        raise ValueError(f"L={L} does not match grid {tuple(grid_shape)}")
    xg = x.reshape(b, *grid_shape, d)
    axes = tuple(a + 1 for a in pool_axes)
    if method == "mean":
        out = xg.mean(dim=axes)
        if scaling_factor != 1.0:
            out = out * scaling_factor
    elif method == "max":
        out = xg.amax(dim=axes)
    else:
        raise ValueError(f"unknown collapse method {method!r}")
    return out.reshape(b, -1, d)


def broadcast_grid(y: torch.Tensor, grid_shape: Sequence[int],
                   pool_axes: Sequence[int]) -> torch.Tensor:
    """Inverse of pool_grid: broadcast pooled outputs back over the pooled
    grid axes."""
    b, Lc, d = y.shape
    kept = [s for i, s in enumerate(grid_shape) if i not in pool_axes]
    if Lc != math.prod(kept):
        raise ValueError(f"{Lc} pooled rows do not match grid "
                         f"{tuple(grid_shape)} pooled over {pool_axes}")
    yg = y.reshape(b, *kept, d)
    for a in sorted(pool_axes):
        yg = yg.unsqueeze(a + 1)
    yg = yg.expand(b, *grid_shape, d)
    return yg.reshape(b, math.prod(grid_shape), d)
