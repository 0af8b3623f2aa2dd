"""Dense-prediction adapters: SimpleFPN (ViTDet) and a channel LayerNorm.

Counterpart of ``fastvim_tpu/models/heads.py``: the backbone's single
stride-16 map becomes a pyramid of ``num_outs`` maps (strides 4, 8, 16,
32, then 64 ...) by transposed-conv upsampling and max-pool downsampling,
then a 1 × 1 lateral and a 3 × 3 output conv, each with a channel
LayerNorm. NHWC at the boundaries; the parameter names are the JAX
module's (``fpn1_deconv1``, ``lateral_norm_0``, ...). ``dtype`` is the
computation's, as flax's ``dtype=``: the parameters stay fp32, the
convolutions take their input and weights cast to it, and the maps come
out in it (the norms keep fp32 statistics). The GELU is the tanh
approximation, ``jax.nn.gelu``'s default. A flax ``ConvTranspose`` does
not flip its kernel, so a ``ConvTranspose2d`` weight holds the flax
kernel flipped on both spatial axes (``utils/convert.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastvim_tpu_torch.models.layers import lecun_normal_init_
from fastvim_tpu_torch.models.upernet import conv_nhwc


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of NHWC maps: fp32 statistics
    (mean, then the mean square of the deviation), eps 1e-6, the output
    cast back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class SimpleFPN(nn.Module):
    """(batch, H, W, backbone_channel) → a tuple of ``num_outs`` NHWC maps
    of ``out_channels``, at 4×, 2×, 1×, ½× the input's resolution and then
    halving, in ``dtype``."""

    def __init__(self, backbone_channel: int, out_channels: int = 256,
                 num_outs: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = backbone_channel
        self.num_outs = num_outs
        self.dtype = dtype
        deconv = lambda cin, cout: nn.ConvTranspose2d(cin, cout, 2, stride=2)
        self.fpn1_deconv1 = deconv(c, c // 2)
        self.fpn1_norm = ChannelLayerNorm(c // 2)
        self.fpn1_deconv2 = deconv(c // 2, c // 4)
        self.fpn2_deconv = deconv(c, c // 2)
        for i, cin in enumerate((c // 4, c // 2, c, c)):
            self.add_module(f"lateral_{i}",
                            nn.Conv2d(cin, out_channels, 1, bias=False))
            self.add_module(f"lateral_norm_{i}",
                            ChannelLayerNorm(out_channels))
            self.add_module(f"fpn_conv_{i}",
                            nn.Conv2d(out_channels, out_channels, 3,
                                      padding=1, bias=False))
            self.add_module(f"fpn_norm_{i}", ChannelLayerNorm(out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers (lecun-normal kernels, zero biases, unit
        norms), in the JAX module's order of creation."""
        for name in ("fpn1_deconv1", "fpn1_norm", "fpn1_deconv2",
                     "fpn2_deconv", *(f"{m}_{i}" for i in range(4) for m in (
                         "lateral", "lateral_norm", "fpn_conv", "fpn_norm"))):
            m = getattr(self, name)
            if isinstance(m, ChannelLayerNorm):
                m.reset_parameters()
                continue
            cin = m.in_channels
            lecun_normal_init_(m.weight, cin * m.kernel_size[0]
                               * m.kernel_size[1], generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        conv = lambda name, t: conv_nhwc(getattr(self, name), t, self.dtype)
        p4 = conv("fpn1_deconv1", x)
        p4 = F.gelu(self.fpn1_norm(p4), approximate="tanh")
        p4 = conv("fpn1_deconv2", p4)
        p8 = conv("fpn2_deconv", x)
        p32 = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        outs = []
        for i, feat in enumerate((p4, p8, x, p32)):
            lat = getattr(self, f"lateral_norm_{i}")(conv(f"lateral_{i}",
                                                          feat))
            outs.append(getattr(self, f"fpn_norm_{i}")(
                conv(f"fpn_conv_{i}", lat)))
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, ::2, ::2])  # max pool, window 1, stride 2
        return tuple(outs)
