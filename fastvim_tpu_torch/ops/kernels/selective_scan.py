"""K1 and K2: the chunked selective scan, forward
(``csrc/selective_scan_fwd.cu``) and backward
(``csrc/selective_scan_bwd.cu``), and the ``torch.autograd.Function``
around both.

K1 replaces ``_scan_kernel`` and K2 ``_bwd_kernel`` of
``fastvim_tpu/ops/pallas/selective_scan.py``. K1's plain version is the
sequential reference :func:`fastvim_tpu_torch.ops.scan.selective_scan_ref`;
K2's is :func:`selective_scan_bwd_plain`, the same adjoint written in
tensor ops (not autograd through the forward).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.scan import selective_scan_ref

selective_scan_plain = selective_scan_ref

CHUNK = 64        # steps per chunk in K1 and K2 (kChunk in csrc/)
BWD_CHANNELS = 8  # channels per K2 block (kBwdChannels in csrc/)


def _check_scan_args(name, u, delta, A, B, C, D, delta_bias):
    batch, L, d = u.shape
    n = A.shape[1]
    code = kernels.dtype_code(name, u)
    for arg, t, shape in (("delta", delta, (batch, L, d)),
                          ("B", B, (batch, L, n)), ("C", C, (batch, L, n))):
        if t.dtype != u.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {u.dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for arg, t, shape in (("A", A, (d, n)), ("D", D, (d,)),
                          ("delta_bias", delta_bias, (d,))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {arg} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return batch, L, d, n, code


def selective_scan_fwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = False,
                       reverse: bool = False, save_states: bool = False):
    """u, delta: (batch, L, d); B, C: (batch, L, n), all of one dtype
    (float32 or bfloat16); A: (d, n) float32; D, delta_bias: (d,) float32
    or None. Returns y (batch, L, d) in u's dtype. On CUDA, d must be a
    multiple of 4 and n 8 or 16.

    With ``save_states`` returns ``(y, states)``: states (batch,
    ceil(L / 64), d, n) float32 holds the state h on entry to each
    64-step chunk, in scan order, which K2 rebuilds h from. On the CPU
    states is None (the plain backward needs none)."""
    if u.device.type == "cpu":
        y = selective_scan_plain(u, delta, A, B, C, D=D,
                                 delta_bias=delta_bias,
                                 delta_softplus=delta_softplus,
                                 reverse=reverse)
        return (y, None) if save_states else y
    name = "selective_scan_fwd"
    kernels.check_cuda_args(name, u.device, u=u, delta=delta, A=A, B=B, C=C,
                            D=D, delta_bias=delta_bias)
    batch, L, d, n, code = _check_scan_args(name, u, delta, A, B, C, D,
                                            delta_bias)
    if d % 4 or n not in (8, 16):
        raise ValueError(f"{name}: needs d % 4 == 0 and n in (8, 16), got "
                         f"d={d}, n={n}")
    kernels.check_aligned(name, u=u, delta=delta, B=B, C=C,
                          delta_bias=delta_bias)
    out = torch.empty_like(u)
    states = (u.new_empty(batch, -(-L // CHUNK), d, n, dtype=torch.float32)
              if save_states else None)
    err = _build.library().fv_selective_scan_fwd(
        kernels.ptr(u), kernels.ptr(delta), kernels.ptr(A), kernels.ptr(B),
        kernels.ptr(C), kernels.ptr(delta_bias), kernels.ptr(D),
        kernels.ptr(out), kernels.ptr(states), batch, L, d, n, code,
        int(delta_softplus), int(reverse), kernels.stream_ptr(u.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return (out, states) if save_states else out


# ----------------------------------------------------------------------
# K2: the backward
# ----------------------------------------------------------------------

ScanGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor, torch.Tensor]


def selective_scan_bwd_plain(u, delta, A, B, C, D, delta_bias, g,
                             delta_softplus: bool = False,
                             reverse: bool = False) -> ScanGrads:
    """The adjoint of the sequential scan in tensor ops, fp32: rebuild h
    in scan order, run λ[t] = C[t]·g[t] + a[next t]·λ[next t] against it,
    and contract. Returns (du, ddelta, dA, dB, dC, dD, dbias), all
    float32; dD and dbias are sums even where D / delta_bias is None."""
    batch, L, d = u.shape
    u32, g32 = u.float(), g.float()
    dt_in = delta.float()
    if delta_bias is not None:
        dt_in = dt_in + delta_bias.float()
    dt = F.softplus(dt_in) if delta_softplus else dt_in
    A32, Bf, Cf = A.float(), B.float(), C.float()
    a = torch.exp(dt.unsqueeze(-1) * A32)                     # (b, L, d, n)
    x = dt * u32
    order = list(range(L - 1, -1, -1) if reverse else range(L))
    hs = torch.empty_like(a)
    h_prev = torch.empty_like(a)
    h = a.new_zeros(batch, d, A.shape[1])
    for t in order:
        h_prev[:, t] = h
        h = a[:, t] * h + x[:, t, :, None] * Bf[:, t, None, :]
        hs[:, t] = h
    lam = torch.empty_like(a)
    carry = torch.zeros_like(h)
    for t in reversed(order):
        lam[:, t] = Cf[:, t, None, :] * g32[:, t, :, None] + carry
        carry = a[:, t] * lam[:, t]
    daa = lam * h_prev * a                                    # dL/da · a
    lam_b = torch.einsum("bldn,bln->bld", lam, Bf)
    du = lam_b * dt
    if D is not None:
        du = du + D.float() * g32
    ddelta = torch.einsum("bldn,dn->bld", daa, A32) + lam_b * u32
    if delta_softplus:
        ddelta = ddelta * torch.sigmoid(dt_in)
    return (du, ddelta, torch.einsum("bldn,bld->dn", daa, dt),
            torch.einsum("bldn,bld->bln", lam, x),
            torch.einsum("bldn,bld->bln", hs, g32),
            (g32 * u32).sum((0, 1)), ddelta.sum((0, 1)))


def selective_scan_bwd(u, delta, A, B, C, D, delta_bias, g, states,
                       delta_softplus: bool = False,
                       reverse: bool = False) -> ScanGrads:
    """K2; same contract as :func:`selective_scan_bwd_plain`, with the
    chunk-entry ``states`` that :func:`selective_scan_fwd` saved (unused
    on the CPU). On CUDA, d must be a multiple of 8 and n 8 or 16.

    dB and dC sum over d and dA over the batch across blocks: the kernel
    writes one partial per block and a second kernel adds them in a fixed
    order, so the result is the same from run to run."""
    if u.device.type == "cpu":
        return selective_scan_bwd_plain(u, delta, A, B, C, D, delta_bias, g,
                                        delta_softplus, reverse)
    name = "selective_scan_bwd"
    kernels.check_cuda_args(name, u.device, u=u, delta=delta, A=A, B=B, C=C,
                            D=D, delta_bias=delta_bias, g=g, states=states)
    batch, L, d, n, code = _check_scan_args(name, u, delta, A, B, C, D,
                                            delta_bias)
    nchunks = -(-L // CHUNK)
    if g.dtype != u.dtype or g.shape != u.shape:
        raise ValueError(f"{name}: g must be {u.dtype} {tuple(u.shape)}")
    if (states is None or states.dtype != torch.float32
            or tuple(states.shape) != (batch, nchunks, d, n)):
        raise ValueError(f"{name}: states must be float32 "
                         f"{(batch, nchunks, d, n)} from selective_scan_fwd("
                         "save_states=True)")
    if d % BWD_CHANNELS or n not in (8, 16):
        raise ValueError(f"{name}: needs d % {BWD_CHANNELS} == 0 and n in "
                         f"(8, 16), got d={d}, n={n}")
    kernels.check_aligned(name, u=u, delta=delta, B=B, C=C, g=g)
    f32 = dict(dtype=torch.float32, device=u.device)
    nblk = d // BWD_CHANNELS
    du = torch.empty(batch, L, d, **f32)
    ddelta = torch.empty(batch, L, d, **f32)
    # per-block partials: dB, dC over the d-blocks; dA, dD, dbias over batch
    dbc_part = torch.empty(2, batch, nblk, L, n, **f32)
    vec_part = torch.empty(batch, d * (n + 2), **f32)
    dB = torch.empty(batch, L, n, **f32)
    dC = torch.empty(batch, L, n, **f32)
    vec = torch.empty(d * (n + 2), **f32)
    err = _build.library().fv_selective_scan_bwd(
        *map(kernels.ptr, (u, delta, A, B, C, delta_bias, D, g, states, du,
                           ddelta, dbc_part, vec_part, dB, dC, vec)),
        batch, L, d, n, code, int(delta_softplus), int(reverse),
        kernels.stream_ptr(u.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return (du, ddelta, vec[:d * n].view(d, n), dB, dC,
            vec[d * n:d * (n + 1)], vec[d * (n + 1):])


class SelectiveScanFn(torch.autograd.Function):
    """y = scan(u, delta, A, B, C, D, delta_bias): K1 with saved
    chunk-entry states forward, K2 backward (their plain versions on the
    CPU). Gradients are computed in fp32 and cast to each input's dtype."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, delta_softplus,
                reverse):
        u, delta, B, C = (t.contiguous() for t in (u, delta, B, C))
        if u.is_cuda and u.shape[-1] % BWD_CHANNELS:
            # say so before the forward runs, not in the middle of backward
            raise ValueError(f"selective_scan: the backward kernel needs d % "
                             f"{BWD_CHANNELS} == 0, got d={u.shape[-1]}")
        y, states = selective_scan_fwd(u, delta, A, B, C, D=D,
                                       delta_bias=delta_bias,
                                       delta_softplus=delta_softplus,
                                       reverse=reverse, save_states=True)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, states)
        ctx.flags = (delta_softplus, reverse)
        return y

    @staticmethod
    def backward(ctx, g):
        u, delta, A, B, C, D, delta_bias, states = ctx.saved_tensors
        grads = selective_scan_bwd(u, delta, A, B, C, D, delta_bias,
                                   g.contiguous(), states, *ctx.flags)
        ins = (u, delta, A, B, C, D, delta_bias)
        return tuple(
            gr.to(t.dtype) if t is not None and need else None
            for gr, t, need in zip(grads, ins, ctx.needs_input_grad)
        ) + (None, None)
