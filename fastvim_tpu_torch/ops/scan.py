"""Selective scan (Mamba SSM) and the pooled-grid helpers.

Counterpart of ``fastvim_tpu/ops/scan.py``. Per (batch, channel):

    h[t] = exp(delta[t] * A) * h[t-1] + delta[t] * B[t] * u[t]
    y[t] = <C[t], h[t]> (+ D * u[t]) (* silu(z[t]))

Layout is channels-last ``(batch, L, d)``; the scan math is fp32 and the
output takes u's dtype, rounded once after the D skip and the gate. B and
C are ``(batch, L, n)`` (the Mamba / FastVim case), ``(d, n)`` (constant
over batch and time) or ``(batch, L, g, n)`` (grouped: each group of
``d // g`` channels shares one). A complex A (the reference's complex
``wtype``) runs in real-pair arithmetic; its B and C may be complex, or
real with time-interleaved (re, im) pairs ``(batch, 2L, n[, g])``.

:func:`selective_scan` dispatches. A real A with ``(batch, L, n)`` B/C
goes to the sequential reference on a CPU tensor and to the scan kernel
K1 (``ops/kernels/selective_scan.py``) on a CUDA tensor, with the gate
and the final state in its epilogue. The other B/C layouts and a complex
A take :func:`selective_scan_assoc`, a log-depth scan in tensor ops, on
every device: the counterpart of the JAX package's XLA path, which never
sends them to its Pallas kernel either. ``impl="ref"`` takes the
sequential oracle for all of them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _delta(delta, delta_bias, delta_softplus):
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    return F.softplus(dt) if delta_softplus else dt


def _expand_bc(mat: torch.Tensor, d: int) -> torch.Tensor:
    """B or C as fp32, broadcastable to the scan layout (batch, L, d, n):
    (d, n) → (1, 1, d, n); (batch, L, n) → (batch, L, 1, n); (batch, L,
    g, n) → (batch, L, d, n), each group repeated over its d // g
    channels."""
    if mat.dim() == 2:
        return mat.float()[None, None]
    if mat.dim() == 3:
        return mat.float()[:, :, None, :]
    if mat.dim() == 4:
        return mat.float().repeat_interleave(d // mat.shape[2], dim=2)
    raise ValueError(f"unsupported B/C shape {tuple(mat.shape)}")


def _finalize(y, u32, D, z, dtype):
    """+ D·u, × silu(z), in fp32, then the one cast."""
    if D is not None:
        y = y + u32 * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(dtype)


def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = False,
                       reverse: bool = False,
                       z: Optional[torch.Tensor] = None,
                       return_last_state: bool = False):
    """Sequential oracle. u/delta/z: (batch, L, d); A: (d, n) real; B/C:
    (d, n), (batch, L, n) or (batch, L, g, n); D, delta_bias: (d,).
    Returns y (batch, L, d) in u's dtype, and with ``return_last_state``
    ``(y, last_state)``: the state after the last step in scan order,
    (batch, d, n) fp32.

    ``reverse=True`` scans right to left (h[t] = a[t]·h[t+1] + b[t]) with
    the output in original order; its last state is the one after t = 0.
    """
    batch, L, d = u.shape
    u32 = u.float()
    dt = _delta(delta, delta_bias, delta_softplus)
    a = torch.exp(dt.unsqueeze(-1) * A.float())               # (b, L, d, n)
    b = (dt * u32).unsqueeze(-1) * _expand_bc(B, d)           # (b, L, d, n)
    Cx = _expand_bc(C, d).expand(batch, L, d, A.shape[1])
    h = u32.new_zeros(batch, d, A.shape[1])
    ys = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        h = a[:, t] * h + b[:, t]
        ys[t] = (h * Cx[:, t]).sum(-1)
    y = torch.stack(ys, 1) if L else u32.new_zeros(batch, 0, d)
    y = _finalize(y, u32, D, z, u.dtype)
    return (y, h) if return_last_state else y


def _shift(t: torch.Tensor, k: int, fill: float, reverse: bool):
    """t moved k steps along time (axis 1), toward later steps (earlier
    for ``reverse``), with ``fill`` shifted in."""
    pad = t.new_full((t.shape[0], k, *t.shape[2:]), fill)
    if reverse:
        return torch.cat([t[:, k:], pad], 1)
    return torch.cat([pad, t[:, :-k]], 1)


def _doubling_scan(elems, identity, combine, reverse: bool):
    """Inclusive scan over time (axis 1) of a tuple of tensors, in log
    depth: for shifts k = 1, 2, 4, ... each step combines with the one k
    before it in scan order (``combine(earlier, later)``), the identity
    shifted in."""
    L = elems[0].shape[1]
    k = 1
    while k < L:
        earlier = tuple(_shift(e, k, f, reverse)
                        for e, f in zip(elems, identity))
        elems = combine(earlier, elems)
        k *= 2
    return elems


def _assoc_combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a2 * a1, a2 * b1 + b2


def selective_scan_assoc(u, delta, A, B, C, D=None, delta_bias=None,
                         delta_softplus: bool = False,
                         reverse: bool = False, z=None,
                         return_last_state: bool = False):
    """Log-depth scan in tensor ops, on any device: the pairs (a, b) of
    the recurrence combined as (a, b) ← (a·a₋ₖ, a·b₋ₖ + b) for k = 1, 2,
    4, .... Same contract as :func:`selective_scan_ref`; the counterpart
    of the JAX package's ``selective_scan_assoc``."""
    batch, L, d = u.shape
    n = A.shape[1]
    u32 = u.float()
    dt = _delta(delta, delta_bias, delta_softplus)
    a = torch.exp(dt.unsqueeze(-1) * A.float())
    b = ((dt * u32).unsqueeze(-1) * _expand_bc(B, d)).expand(batch, L, d, n)
    _, hs = _doubling_scan((a, b), (1.0, 0.0), _assoc_combine, reverse)
    y = (hs * _expand_bc(C, d)).sum(-1)
    y = _finalize(y, u32, D, z, u.dtype)
    if not return_last_state:
        return y
    last = (hs[:, 0] if reverse else hs[:, -1]) if L else \
        u32.new_zeros(batch, d, n)
    return y, last


def _split_complex_bc(mat: torch.Tensor, L: int):
    """B/C of a complex-A scan → (real, imag) in the real layouts:
    complex (d, n) / (batch, L, n) / (batch, L, g, n), or real
    (batch, 2L, n[, g]) time-interleaved (re, im) pairs (the torch
    ``view_as_complex`` convention), or real (imaginary part 0)."""
    if mat.is_complex():
        return mat.real, mat.imag
    if mat.dim() >= 3 and mat.shape[1] == 2 * L:
        pairs = mat.reshape(mat.shape[0], L, 2, *mat.shape[2:])
        return pairs[:, :, 0], pairs[:, :, 1]
    return mat, torch.zeros_like(mat)


def _complex_combine(left, right):
    """(a, b) ← (a2·a1, a2·b1 + b2) over ℂ, in real pairs."""
    a1R, a1I, b1R, b1I = left
    a2R, a2I, b2R, b2I = right
    return (a2R * a1R - a2I * a1I,
            a2R * a1I + a2I * a1R,
            a2R * b1R - a2I * b1I + b2R,
            a2R * b1I + a2I * b1R + b2I)


def _selective_scan_complex(u, delta, A, B, C, D=None, delta_bias=None,
                            delta_softplus: bool = False,
                            reverse: bool = False, z=None,
                            return_last_state: bool = False,
                            sequential: bool = False):
    """Complex-A scan in real-pair arithmetic: a = exp(delta·Ar)·(cos +
    i·sin)(delta·Ai), the recurrence over ℂ^n, y = 2·Re<C, h> (the
    reference's ``y.real * 2``). The output is real; the last state is
    complex64 (batch, d, n). ``sequential`` runs the steps one by one
    (the oracle), else the log-depth scan."""
    batch, L, d = u.shape
    n = A.shape[1]
    u32 = u.float()
    dt = _delta(delta, delta_bias, delta_softplus).unsqueeze(-1)
    mag = torch.exp(dt * A.real.float())
    ang = dt * A.imag.float()
    du = dt * u32.unsqueeze(-1)
    full = (batch, L, d, n)
    BR, BI = (_expand_bc(m, d) for m in _split_complex_bc(B, L))
    CR, CI = (_expand_bc(m, d).expand(full)
              for m in _split_complex_bc(C, L))
    elems = (mag * torch.cos(ang), mag * torch.sin(ang),
             (du * BR).expand(full), (du * BI).expand(full))
    if sequential:
        aR, aI, bR, bI = elems
        hR = hI = u32.new_zeros(batch, d, n)
        hsR, hsI = u32.new_empty(full), u32.new_empty(full)
        for t in (range(L - 1, -1, -1) if reverse else range(L)):
            hR, hI = (aR[:, t] * hR - aI[:, t] * hI + bR[:, t],
                      aR[:, t] * hI + aI[:, t] * hR + bI[:, t])
            hsR[:, t], hsI[:, t] = hR, hI
    else:
        _, _, hsR, hsI = _doubling_scan(elems, (1.0, 0.0, 0.0, 0.0),
                                        _complex_combine, reverse)
        t_last = 0 if reverse else -1
        hR, hI = ((hsR[:, t_last], hsI[:, t_last]) if L else
                  (u32.new_zeros(batch, d, n),) * 2)
    y = 2.0 * (hsR * CR - hsI * CI).sum(-1)
    y = _finalize(y, u32, D, z, u.dtype)
    if return_last_state:
        return y, torch.complex(hR, hI)
    return y


def selective_scan(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus: bool = False, reverse: bool = False,
                   impl: str = "auto", variant: str = "sublane", z=None,
                   return_last_state: bool = False):
    """Dispatching entry point (see the module docstring for the routes).
    Returns y, or with ``return_last_state`` ``(y, last_state)``.

    ``impl="ref"`` runs the sequential oracle on any device,
    differentiated by autograd through its loop. Otherwise a real A with
    (batch, L, n) B/C runs the reference on a CPU tensor and the scan
    kernel K1 on a CUDA tensor (any other ``impl``, the JAX package's
    "assoc" and "pallas" included, dispatches so); when a gradient is
    needed, the call goes through ``SelectiveScanFn``, whose backward is
    K2 (its plain version on the CPU) and whose last state is not
    differentiated. The other layouts and a complex A run
    :func:`selective_scan_assoc` (complex: its real-pair form), which
    autograd differentiates; ``impl="pallas"`` refuses a complex A, as
    the JAX package does.

    ``variant="lanes"`` (the name the JAX package gives it; "sublane" is
    the default kernel) takes the forward through the lanes kernel
    instead, time across a warp's lanes, forward direction only, without
    ``z`` or the last state; its gradient goes through
    ``SelectiveScanLanesFn``."""
    if variant not in ("sublane", "lanes"):
        raise ValueError(f"variant must be sublane|lanes, got {variant!r}")
    if variant == "lanes" and (reverse or z is not None or return_last_state
                               or A.is_complex() or B.dim() != 3
                               or C.dim() != 3):
        raise NotImplementedError(
            "variant='lanes' is forward-only, with (batch, L, n) B/C and "
            "without z or the last state; use the default variant")
    kw = dict(D=D, delta_bias=delta_bias, delta_softplus=delta_softplus,
              reverse=reverse, z=z, return_last_state=return_last_state)
    if A.is_complex():
        if impl == "pallas":
            raise ValueError("a complex-A selective scan has no kernel; use "
                             "impl='auto', 'assoc' or 'ref'")
        return _selective_scan_complex(u, delta, A, B, C,
                                       sequential=impl == "ref", **kw)
    if impl == "ref":
        return selective_scan_ref(u, delta, A, B, C, **kw)
    if B.dim() != 3 or C.dim() != 3:
        return selective_scan_assoc(u, delta, A, B, C, **kw)
    from fastvim_tpu_torch.ops.kernels import selective_scan as ss

    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, delta, A, B, C, D, delta_bias, z))
    if variant == "lanes":
        if needs_grad:
            return ss.SelectiveScanLanesFn.apply(u, delta, A, B, C, D,
                                                 delta_bias, delta_softplus)
        return ss.selective_scan_fwd_lanes(u, delta, A, B, C, D=D,
                                           delta_bias=delta_bias,
                                           delta_softplus=delta_softplus)
    if needs_grad:
        return ss.SelectiveScanFn.apply(u, delta, A, B, C, D, delta_bias, z,
                                        delta_softplus, reverse,
                                        return_last_state)
    return ss.selective_scan_fwd(u, delta, A, B, C, **kw)


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


def pool_tokens(x: torch.Tensor, rows: int, cols: int, method: str = "mean",
                scaling_factor: float = 1.0) -> torch.Tensor:
    """Pool a raster-order token sequence along its fast (col) axis:
    (batch, rows·cols, d) → (batch, rows, d); :func:`pool_grid` over the
    last axis of a (rows, cols) grid."""
    return pool_grid(x, (rows, cols), (1,), method, scaling_factor)


def broadcast_tokens(y: torch.Tensor, cols: int) -> torch.Tensor:
    """Inverse of :func:`pool_tokens`: each row's output repeated over its
    cols tokens, (batch, rows, d) → (batch, rows·cols, d)."""
    b, rows, d = y.shape
    return y[:, :, None, :].expand(b, rows, cols, d).reshape(b, rows * cols,
                                                              d)
