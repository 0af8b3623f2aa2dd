"""Patch embedding, channels-last.

Counterpart of ``fastvim_tpu/models/patch_embed.py``: images are NHWC;
patchify is a space-to-depth reshape plus one matmul (not a strided
conv). The parameters keep the reference conv's names and layout,
``proj.weight (D, C, p, p)`` and ``proj.bias``. ``scanpath_type="colwise"``
transposes the grid after patchify.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fastvim_tpu_torch.models.layers import lecun_normal_init_


class PatchProj(nn.Module):
    """Stride-p patchify via reshape + matmul, with conv-shaped params."""

    def __init__(self, channels: int, embed_dim: int, patch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(embed_dim, channels, patch, patch))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        D, C, p, _ = self.weight.shape
        lecun_normal_init_(self.weight, p * p * C, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        B, _, _, C = x.shape
        p = self.patch
        D = self.weight.shape[0]
        patches = x.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(B, gh, gw, p * p * C)
        # (D, C, p, p) → (p, p, C, D) → (p·p·C, D), the patch order above
        w = self.weight.permute(2, 3, 1, 0).reshape(p * p * C, D)
        return patches.to(self.dtype) @ w.to(self.dtype) \
            + self.bias.to(self.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 channels: int = 3, scanpath_type: str = "rowwise",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.scanpath_type = scanpath_type
        self.proj = PatchProj(channels, embed_dim, patch_size, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """x: (batch, H, W, C) → tokens (batch, rows·cols, D) and
        (rows, cols) in scan orientation."""
        p = self.patch_size
        B, H, W, C = x.shape
        if H % p or W % p:
            raise ValueError(f"image {H}x{W} is not a multiple of patch {p}")
        gh, gw = H // p, W // p
        x = self.proj(x, gh, gw)
        if self.scanpath_type == "colwise":
            x = x.transpose(1, 2)
            rows, cols = gw, gh
        else:
            rows, cols = gh, gw
        return x.reshape(B, rows * cols, self.embed_dim), (rows, cols)
