"""Shared layers and initializers for the model zoo.

Counterpart of ``fastvim_tpu/models/layers.py``. The initializers fill a
tensor in place from an explicit ``torch.Generator`` and draw from the
same distributions as the JAX package (not the same numbers):

* torch-Linear default U(±1/√fan_in) for in_proj / x_proj / conv, with
  a 1/√n_layer rescale for out_proj;
* dt_proj weight U(±dt_rank^-½·dt_scale); bias softplus⁻¹(dt) with dt ~
  LogUniform(dt_min, dt_max) clipped at dt_init_floor;
* A_log = log(1..d_state) per channel; D = 1.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from fastvim_tpu_torch.ops.norms import add_norm
from fastvim_tpu_torch.parallel import rand_rows

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def torch_linear_init_(t: torch.Tensor, fan_in: int, generator: torch.Generator,
                       scale: float = 1.0) -> torch.Tensor:
    """U(±scale/√fan_in): the torch nn.Linear / Conv default."""
    bound = scale / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def dt_proj_weight_init_(t: torch.Tensor, dt_rank: int,
                         generator: torch.Generator, dt_scale: float = 1.0,
                         dt_init: str = "random") -> torch.Tensor:
    std = dt_rank ** -0.5 * dt_scale
    if dt_init == "constant":
        return t.fill_(std)
    if dt_init == "random":
        return t.uniform_(-std, std, generator=generator)
    raise NotImplementedError(dt_init)


@torch.no_grad()
def dt_bias_init_(t: torch.Tensor, generator: torch.Generator,
                  dt_min: float = 1e-3, dt_max: float = 0.1,
                  dt_init_floor: float = 1e-4) -> torch.Tensor:
    """Inverse softplus of dt ~ LogUniform(dt_min, dt_max), so that
    softplus(bias) == dt."""
    r = torch.rand(t.shape, generator=generator, dtype=torch.float32)
    dt = torch.exp(r * (math.log(dt_max) - math.log(dt_min))
                   + math.log(dt_min)).clamp_min(dt_init_floor)
    return t.copy_(dt + torch.log(-torch.expm1(-dt)))


@torch.no_grad()
def a_log_init_(t: torch.Tensor) -> torch.Tensor:
    """A_log[c, s] = log(s + 1): the S4D-real init."""
    d_state = t.shape[1]
    a = torch.arange(1, d_state + 1, dtype=torch.float32)
    return t.copy_(torch.log(a).expand_as(t))


@torch.no_grad()
def trunc_normal_init_(t: torch.Tensor, stddev: float,
                       generator: torch.Generator) -> torch.Tensor:
    """Normal(0, stddev) truncated at ±2·stddev (flax truncated_normal)."""
    return nn.init.trunc_normal_(t, 0.0, stddev, -2 * stddev, 2 * stddev,
                                 generator=generator)


@torch.no_grad()
def lecun_normal_init_(t: torch.Tensor, fan_in: int,
                       generator: torch.Generator) -> torch.Tensor:
    """flax lecun_normal: truncated normal with variance 1/fan_in."""
    return trunc_normal_init_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                              generator)


class DropPath(nn.Module):
    """Stochastic depth on the residual branch, per sample, kept samples
    rescaled by 1/keep; identity in eval mode or at rate 0. In training
    mode the mask is drawn from ``generator``, a ``torch.Generator`` on
    the input's device that the caller sets (see
    ``VisionMamba.set_drop_path_generator``); the global generator is
    never used. Over several ranks the mask is drawn for the global batch
    and each rank keeps its rows (``parallel.rand_rows``), as the JAX
    step draws it over the whole sharded batch."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor, tokens=None) -> torch.Tensor:
        """``tokens`` (a ``parallel.TokenShard``; ``Dropout`` only): x's
        dimension 1 holds this rank's tokens of a sharded grid, and the
        mask is drawn for the whole grid."""
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath in training mode needs a generator "
                               "(set_drop_path_generator)")
        keep = 1.0 - self.rate
        mask = rand_rows(self.mask_shape(x), self.generator,
                         x.device, tokens) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def mask_shape(self, x: torch.Tensor):
        return (x.shape[0],) + (1,) * (x.dim() - 1)


class Dropout(DropPath):
    """Element-wise dropout (flax ``nn.Dropout``): DropPath's draw, one
    per element instead of one per sample, from the same generator."""

    def mask_shape(self, x: torch.Tensor):
        return x.shape


class Norm(nn.Module):
    """Add + RMSNorm/LayerNorm with an fp32 residual stream
    (``ops.norms.add_norm``); holds ``weight`` (and ``bias`` unless
    ``rms``)."""

    def __init__(self, dim: int, rms: bool = True, eps: float = 1e-5):
        super().__init__()
        self.rms = rms
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = None if rms else nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                prenorm: bool = False, residual_in_fp32: bool = True,
                out_dtype: Optional[torch.dtype] = None):
        return add_norm(x, self.weight, self.bias, residual=residual,
                        prenorm=prenorm, residual_in_fp32=residual_in_fp32,
                        eps=self.eps, rms=self.rms, out_dtype=out_dtype)
