"""One step of the SSM state for incremental decoding.

Counterpart of ``fastvim_tpu/ops/state_update.py``:

    state ← state · exp(softplus(dt + dt_bias) ⊗ A) + dt · B · x
    y = <C, state> + D · x   (× silu(z))

Plain torch on every device: the JAX package leaves it to XLA, which
fuses it, and has no Pallas kernel for it. One step is a few elementwise
operations over (batch, d, n).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def selective_state_update(state: torch.Tensor, x: torch.Tensor,
                           dt: torch.Tensor, A: torch.Tensor,
                           B: torch.Tensor, C: torch.Tensor,
                           D: Optional[torch.Tensor] = None,
                           z: Optional[torch.Tensor] = None,
                           dt_bias: Optional[torch.Tensor] = None,
                           dt_softplus: bool = False):
    """state: (batch, d, n) fp32; x, dt, z: (batch, d); A: (d, n); B, C:
    (batch, n); D, dt_bias: (d,). Returns (y (batch, d) in x's dtype,
    new_state (batch, d, n) fp32). The input state is not modified."""
    x32 = x.float()
    dt = dt.float()
    if dt_bias is not None:
        dt = dt + dt_bias.float()
    if dt_softplus:
        dt = F.softplus(dt)
    dA = torch.exp(dt[..., None] * A.float())
    dBx = dt[..., None] * B.float()[:, None, :] * x32[..., None]
    new_state = state * dA + dBx
    y = (new_state * C.float()[:, None, :]).sum(-1)
    if D is not None:
        y = y + D.float() * x32
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(x.dtype), new_state
