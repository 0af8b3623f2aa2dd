"""FastVim residual Block: Add → Norm → (rotate) → Mixer → (unrotate).

Counterpart of ``fastvim_tpu/models/blocks.py`` for 2-D token grids: the
add+norm keeps an fp32 residual stream, and odd layers swap the grid's
two axes. A pooled (mean/max) odd layer runs in place as the mixer's
``transposed`` orientation (column-major conv, pooling over rows); any
other rotated layer (the full-scan Vim) materializes the transposed
sequence and transposes back.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fastvim_tpu_torch.models.layers import DropPath, Norm
from fastvim_tpu_torch.models.mixer import MambaMixer


def rotate_grid(x: torch.Tensor, grid_shape: Sequence[int],
                axes: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Swap two grid axes of a flattened (batch, prod(grid), d) sequence."""
    b, L, d = x.shape
    xg = x.reshape(b, *grid_shape, d).transpose(axes[0] + 1, axes[1] + 1)
    return xg.reshape(b, L, d)


class Block(nn.Module):
    def __init__(self, dim: int, layer_idx: int, token_size: Sequence[int],
                 mixer_kwargs: Optional[dict] = None,
                 rotate_every_block: bool = True, rms_norm: bool = True,
                 residual_in_fp32: bool = True, norm_eps: float = 1e-5,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_idx = layer_idx
        self.token_size = tuple(token_size)
        self.rotate_every_block = rotate_every_block
        self.residual_in_fp32 = residual_in_fp32
        self.dtype = dtype
        self.norm = Norm(dim, rms=rms_norm, eps=norm_eps)
        self.mixer = MambaMixer(d_model=dim, dtype=dtype,
                                **(mixer_kwargs or {}))
        self.drop_path = DropPath(drop_path)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.norm.weight)
        if self.norm.bias is not None:
            nn.init.zeros_(self.norm.bias)
        self.mixer.reset_parameters(generator)

    def forward(self, hidden: torch.Tensor,
                residual: Optional[torch.Tensor]):
        if residual is not None:
            hidden = self.drop_path(hidden)
        hidden, residual = self.norm(
            hidden, residual, prenorm=True,
            residual_in_fp32=self.residual_in_fp32, out_dtype=self.dtype)
        grid = self.token_size
        rotated = self.rotate_every_block and self.layer_idx % 2 != 0
        transposed = (rotated and len(grid) == 2
                      and self.mixer.collapse_method in ("mean", "max"))
        if transposed:
            hidden = self.mixer(hidden, grid, pool_axes=(0,),
                                transposed=True)
        elif rotated:
            swapped = (grid[1], grid[0])
            hidden = self.mixer(rotate_grid(hidden, grid), swapped)
            hidden = rotate_grid(hidden, swapped)
        else:
            hidden = self.mixer(hidden, grid)
        return hidden, residual
