"""FastVim residual Block: Add → Norm → (rotate) → Mixer → (unrotate).

Counterpart of ``fastvim_tpu/models/blocks.py``: the add+norm keeps an
fp32 residual stream, and rotated layers (the odd ones, unless
``rotate`` says otherwise) swap two axes of the token grid. The grid is
generic: (rows, cols) for FastVim, (rows, cols, C) for Channel-First
ChannelVim and (C, rows, cols) for Spatial-First; ``transpose_axes``
names the two axes a rotation swaps and ``pool_axes`` the axes pooled
before the scan (None: the last).

A pooled (mean/max) rotated layer on a 2-D grid that swaps (0, 1) and
leaves ``pool_axes`` to the mixer runs in place as the mixer's
``transposed`` orientation (column-major conv, pooling over rows); any
other rotated layer materializes the rotated sequence and rotates back:
the full-scan Vim, every ChannelVim layer, and a model whose
``fused_kernels`` is not "never", because the fused block kernels (K8,
K9) pool over the last grid axis only. ``fused_merge`` (K10) keeps the
in-place orientation. On a grid sharded over a seq group (``shard``, a
``parallel.TokenShard``) every rotated layer takes the in-place
orientation, whatever ``fused_kernels`` says: a rank holds whole rows,
and a materialized rotation would need the whole grid.
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


def _swapped(grid_shape: Sequence[int], axes: Tuple[int, int]):
    g = list(grid_shape)
    g[axes[0]], g[axes[1]] = g[axes[1]], g[axes[0]]
    return tuple(g)


class Block(nn.Module):
    def __init__(self, dim: int, layer_idx: int,
                 mixer_kwargs: Optional[dict] = None,
                 rotate_every_block: bool = True, rms_norm: bool = True,
                 residual_in_fp32: bool = True, norm_eps: float = 1e-5,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32,
                 pool_axes: Optional[Tuple[int, ...]] = None,
                 transpose_axes: Tuple[int, int] = (0, 1),
                 rotate: Optional[bool] = None):
        super().__init__()
        self.layer_idx = layer_idx
        self.rotate_every_block = rotate_every_block
        self.pool_axes = None if pool_axes is None else tuple(pool_axes)
        self.transpose_axes = tuple(transpose_axes)
        # an explicit rotate overrides the odd-layer schedule (the
        # 2dcompress ChannelVim rotates on its own three-layer cycle)
        self.rotated = (rotate if rotate is not None
                        else rotate_every_block and layer_idx % 2 != 0)
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
                residual: Optional[torch.Tensor], grid: Sequence[int],
                shard=None):
        """``grid``: the token grid of this input, in the base
        orientation; with ``shard`` the whole grid, of which ``hidden``
        holds this rank's rows."""
        if residual is not None:
            hidden = self.drop_path(hidden)
        hidden, residual = self.norm(
            hidden, residual, prenorm=True,
            residual_in_fp32=self.residual_in_fp32, out_dtype=self.dtype)
        grid = tuple(grid)
        if shard is not None:
            return self.mixer(hidden, grid, transposed=self.rotated,
                              shard=shard), residual
        transposed = (self.rotated and len(grid) == 2
                      and self.transpose_axes == (0, 1)
                      and self.pool_axes is None
                      and self.mixer.collapse_method in ("mean", "max")
                      and self.mixer.fused_kernels == "never")
        if transposed:
            hidden = self.mixer(hidden, grid, pool_axes=(0,),
                                transposed=True)
        elif self.rotated:
            axes = self.transpose_axes
            swapped = _swapped(grid, axes)
            hidden = self.mixer(rotate_grid(hidden, grid, axes), swapped,
                                pool_axes=self.pool_axes)
            hidden = rotate_grid(hidden, swapped, axes)
        else:
            hidden = self.mixer(hidden, grid, pool_axes=self.pool_axes)
        return hidden, residual
