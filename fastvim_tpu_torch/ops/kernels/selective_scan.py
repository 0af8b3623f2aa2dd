"""K1: the chunked selective-scan forward (``csrc/selective_scan_fwd.cu``).

Replaces ``_scan_kernel`` of ``fastvim_tpu/ops/pallas/selective_scan.py``.
Its plain version is the sequential reference
:func:`fastvim_tpu_torch.ops.scan.selective_scan_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.scan import selective_scan_ref

selective_scan_plain = selective_scan_ref


def selective_scan_fwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = False,
                       reverse: bool = False) -> torch.Tensor:
    """u, delta: (batch, L, d); B, C: (batch, L, n), all of one dtype
    (float32 or bfloat16); A: (d, n) float32; D, delta_bias: (d,) float32
    or None. Returns y (batch, L, d) in u's dtype. On CUDA, d must be a
    multiple of 4 and n 8 or 16."""
    if u.device.type == "cpu":
        return selective_scan_plain(u, delta, A, B, C, D=D,
                                    delta_bias=delta_bias,
                                    delta_softplus=delta_softplus,
                                    reverse=reverse)
    name = "selective_scan_fwd"
    kernels.check_cuda_args(name, u.device, u=u, delta=delta, A=A, B=B, C=C,
                            D=D, delta_bias=delta_bias)
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
    if d % 4 or n not in (8, 16):
        raise ValueError(f"{name}: needs d % 4 == 0 and n in (8, 16), got "
                         f"d={d}, n={n}")
    kernels.check_aligned(name, u=u, delta=delta, B=B, C=C,
                          delta_bias=delta_bias)
    out = torch.empty_like(u)
    err = _build.library().fv_selective_scan_fwd(
        kernels.ptr(u), kernels.ptr(delta), kernels.ptr(A), kernels.ptr(B),
        kernels.ptr(C), kernels.ptr(delta_bias), kernels.ptr(D),
        kernels.ptr(out), batch, L, d, n, code, int(delta_softplus),
        int(reverse), kernels.stream_ptr(u.device))
    _build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out
