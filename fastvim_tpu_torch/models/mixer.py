"""Bidirectional (FastVim/Vim) Mamba mixer, dense path.

Counterpart of ``fastvim_tpu/models/mixer.py``:

* ``collapse_method="mean"|"max"``: FastVim's pooled scan — the conv
  output is pooled over one grid axis, the scan runs over the other, the
  result is broadcast back and per-token detail returns through the
  ``D·conv_out`` skip.
* ``collapse_method="none"``: plain Vim, a full-length scan.

The reverse direction is computed in original token order (anticausal
conv + reverse scan), with no full-length flips. ``transposed`` is the
odd-layer orientation: the conv runs along the column-major raster and
pooling is over rows, without moving the tokens.

Dispatch: with ``layer_fused`` "auto" or "on" (the same here: the fused
layer runs on every device) and a grid that :func:`fusable` accepts, the
whole layer runs as pass A (K3) → pooled scans (K1) → pass B (K4);
otherwise the unfused path below, whose scans still go through
:func:`~fastvim_tpu_torch.ops.scan.selective_scan`. ``scan_impl="ref"``
forces the sequential reference scan; any other value ("auto", and the
JAX package's "assoc"/"pallas") dispatches on the device. When a gradient
is needed, ``layer_fused_bwd`` picks the fused layer's backward: "fused"
(the K5 and K6 adjoint kernels, scans by K2) or "remat" (autograd through
the unfused math, recomputed); the unfused path's scans differentiate
through K2 either way.

Parameters have the torch reference's names and layouts; they stay
float32 and are cast to the module ``dtype`` where they are used.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from fastvim_tpu_torch.models.layers import (
    a_log_init_,
    dt_bias_init_,
    dt_proj_weight_init_,
    torch_linear_init_,
)
from fastvim_tpu_torch.ops.conv import dual_conv1d, grid_dual_conv1d
from fastvim_tpu_torch.ops.kernels.layer_fused import (
    FusedParams,
    fusable,
    fused_mixer_core,
    proj_scan,
)
from fastvim_tpu_torch.ops.norms import layer_norm
from fastvim_tpu_torch.ops.scan import broadcast_grid, pool_grid


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class MambaMixer(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: Union[int, str] = "auto",
                 dt_min: float = 1e-3, dt_max: float = 0.1,
                 dt_init: str = "random", dt_scale: float = 1.0,
                 dt_init_floor: float = 1e-4, conv_bias: bool = True,
                 bias: bool = False, use_norm_after_ssm: bool = True,
                 collapse_method: str = "mean", scaling_factor: float = 1.0,
                 n_layer: int = 24, norm_eps: float = 1e-5,
                 scan_impl: str = "auto", layer_fused: str = "auto",
                 layer_fused_bwd: str = "fused",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if layer_fused not in ("auto", "on", "off"):
            raise ValueError(f"layer_fused must be auto|on|off, got "
                             f"{layer_fused!r}")
        if layer_fused_bwd not in ("fused", "remat"):
            raise ValueError(f"layer_fused_bwd must be fused|remat, got "
                             f"{layer_fused_bwd!r}")
        if collapse_method not in ("mean", "max", "none"):
            raise ValueError(f"unknown collapse method {collapse_method!r}")
        self.d_model = d_model
        self.d_state = d_state
        self.d_conv = d_conv
        self.d_inner = int(expand * d_model)
        self.dt_rank = (-(-d_model // 16) if dt_rank == "auto"
                        else int(dt_rank))
        self.dt_min, self.dt_max = dt_min, dt_max
        self.dt_init, self.dt_scale = dt_init, dt_scale
        self.dt_init_floor = dt_init_floor
        self.use_norm_after_ssm = use_norm_after_ssm
        self.collapse_method = collapse_method
        self.scaling_factor = scaling_factor
        self.n_layer = n_layer
        self.norm_eps = norm_eps
        self.scan_impl = scan_impl
        self.layer_fused = layer_fused
        self.layer_fused_bwd = layer_fused_bwd
        self.dtype = dtype

        di, n, r = self.d_inner, d_state, self.dt_rank
        self.in_proj = skip_init(nn.Linear, d_model, 2 * di, bias=bias)
        for sfx in ("", "_b"):
            setattr(self, f"conv1d{sfx}",
                    skip_init(nn.Conv1d, di, di, d_conv, groups=di,
                              bias=conv_bias))
            setattr(self, f"x_proj{sfx}",
                    skip_init(nn.Linear, di, r + 2 * n, bias=False))
            setattr(self, f"dt_proj{sfx}",
                    skip_init(nn.Linear, r, di, bias=True))
            setattr(self, f"A{sfx}_log", nn.Parameter(torch.empty(di, n)))
            setattr(self, f"D{sfx}", nn.Parameter(torch.ones(di)))
        self.layernorm = (skip_init(nn.LayerNorm, di)
                          if use_norm_after_ssm else None)
        self.out_proj = skip_init(nn.Linear, di, d_model, bias=bias)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference init (see ``models/layers.py``), drawn from
        ``generator``."""
        di = self.d_inner
        torch_linear_init_(self.in_proj.weight, self.d_model, generator)
        if self.in_proj.bias is not None:
            nn.init.zeros_(self.in_proj.bias)
        for sfx in ("", "_b"):
            conv = getattr(self, f"conv1d{sfx}")
            torch_linear_init_(conv.weight, self.d_conv, generator)
            if conv.bias is not None:
                torch_linear_init_(conv.bias, self.d_conv, generator)
            torch_linear_init_(getattr(self, f"x_proj{sfx}").weight, di,
                               generator)
            dt_proj = getattr(self, f"dt_proj{sfx}")
            dt_proj_weight_init_(dt_proj.weight, self.dt_rank, generator,
                                 self.dt_scale, self.dt_init)
            dt_bias_init_(dt_proj.bias, generator, self.dt_min, self.dt_max,
                          self.dt_init_floor)
            a_log_init_(getattr(self, f"A{sfx}_log"))
            nn.init.ones_(getattr(self, f"D{sfx}"))
        if self.layernorm is not None:
            nn.init.ones_(self.layernorm.weight)
            nn.init.zeros_(self.layernorm.bias)
        torch_linear_init_(self.out_proj.weight, di, generator,
                           scale=1.0 / math.sqrt(self.n_layer))
        if self.out_proj.bias is not None:
            nn.init.zeros_(self.out_proj.bias)

    def _conv_w(self, sfx: str) -> torch.Tensor:
        """conv1d{sfx}.weight (di, 1, w) as the ops' (w, di)."""
        return getattr(self, f"conv1d{sfx}").weight.squeeze(1).t()

    def fused_params(self) -> FusedParams:
        di = self.d_inner
        ln = self.layernorm
        return FusedParams(
            self.in_proj.weight, self.in_proj.bias,
            self.conv1d.weight.reshape(di, -1), self.conv1d.bias,
            self.conv1d_b.weight.reshape(di, -1), self.conv1d_b.bias,
            self.x_proj.weight, self.dt_proj.weight, self.dt_proj.bias,
            self.A_log, self.D,
            self.x_proj_b.weight, self.dt_proj_b.weight, self.dt_proj_b.bias,
            self.A_b_log, self.D_b,
            None if ln is None else ln.weight, None if ln is None else ln.bias,
            self.out_proj.weight, self.out_proj.bias)

    def _scan_branch(self, xc: torch.Tensor, sfx: str,
                     grid_shape: Sequence[int], pool_axes: Sequence[int],
                     reverse: bool) -> torch.Tensor:
        """One direction: (pool) → projections → scan → (broadcast) →
        + D·conv_out. xc: (batch, L, d_inner) conv output."""
        dtype = self.dtype
        pooled = self.collapse_method != "none"
        xp = (pool_grid(xc, grid_shape, pool_axes, self.collapse_method,
                        self.scaling_factor) if pooled else xc)
        dt_proj = getattr(self, f"dt_proj{sfx}")
        y = proj_scan(xp, getattr(self, f"x_proj{sfx}").weight,
                      dt_proj.weight, dt_proj.bias,
                      getattr(self, f"A{sfx}_log"), dtype, self.scan_impl,
                      reverse)
        if pooled:
            y = broadcast_grid(y, grid_shape, pool_axes)
        return y.to(dtype) + getattr(self, f"D{sfx}").to(dtype) * xc

    def forward(self, x: torch.Tensor, grid_shape: Sequence[int],
                pool_axes: Optional[Sequence[int]] = None,
                transposed: bool = False) -> torch.Tensor:
        """x: (batch, L, d_model); grid_shape: the token grid in this
        mixer's orientation; pool_axes: grid axes pooled before the scan
        (default: the last)."""
        grid_shape = tuple(grid_shape)
        pool_axes = (tuple(pool_axes) if pool_axes is not None
                     else (len(grid_shape) - 1,))
        dtype = self.dtype
        x = x.to(dtype)
        if self.layer_fused != "off" and fusable(
                grid_shape, pool_axes, transposed, self.d_conv,
                self.collapse_method):
            return fused_mixer_core(
                x, self.fused_params(), grid_shape, transposed,
                self.scaling_factor, self.norm_eps, self.use_norm_after_ssm,
                dtype, self.scan_impl, bwd_mode=self.layer_fused_bwd)
        return self._unfused(x, grid_shape, pool_axes, transposed)

    def _unfused(self, x, grid_shape, pool_axes, transposed):
        dtype = self.dtype
        di = self.d_inner
        xz = F.linear(x, self.in_proj.weight.to(dtype),
                      _cast(self.in_proj.bias, dtype))
        xin, z = xz[..., :di], xz[..., di:]
        conv_args = (xin, self._conv_w("").to(dtype),
                     _cast(self.conv1d.bias, dtype),
                     self._conv_w("_b").to(dtype),
                     _cast(self.conv1d_b.bias, dtype))
        if transposed:
            xc_f, xc_b = grid_dual_conv1d(*conv_args, grid_shape, axis=0)
        else:
            xc_f, xc_b = dual_conv1d(*conv_args)
        y_f = self._scan_branch(xc_f, "", grid_shape, pool_axes, False)
        y_b = self._scan_branch(xc_b, "_b", grid_shape, pool_axes, True)
        merged = (y_f + y_b) * 0.5
        if self.layernorm is not None:
            merged = layer_norm(merged, self.layernorm.weight,
                                self.layernorm.bias, eps=self.norm_eps)
        merged = merged * F.silu(z)
        return F.linear(merged, self.out_proj.weight.to(dtype),
                        _cast(self.out_proj.bias, dtype))
