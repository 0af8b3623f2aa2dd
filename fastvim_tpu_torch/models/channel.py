"""FastChannelVim: per-channel tokenization for multi-channel cell imaging.

Counterpart of ``fastvim_tpu/models/channel.py``:

* ``PatchEmbedPerChannel``: one patch filter shared by every channel
  (the reference's Conv3d(1, D, (1, p, p)), here a reshape and one
  matmul) plus a learned per-channel embedding, indexed by the ids of
  the channels the image holds;
* scan orders: ``Channel-First`` lays the tokens out as (rows, cols, C),
  channel fastest, ``Spatial-First`` as (C, rows, cols);
* pooling over the spatial cols axis of the current orientation (rotated
  layers swap rows and cols); the ``2dcompress`` variant pools every
  third layer over the whole spatial grid, leaving a C-step channel
  scan, and rotates on its own row → col → channel cycle;
* HCS (hierarchical channel sampling): the caller draws a channel subset
  per batch (:func:`hcs_sample`) and passes the subset image with its
  channel ids; the token grid, and so every scan length, follows the
  number of channels kept.

A 3-D grid never fuses: every layer runs the mixer's unfused path, its
scans through K1 (K2 under autograd) at L = rows·C, rows or C.

Images are NHWC. ``drop_rate`` dropout (after the position embedding)
and DropPath draw from the generator ``set_drop_path_generator`` hands
them; ``model.train()`` / ``model.eval()`` switch both. ``remat=True``
recomputes each block in the backward pass with its DropPath draws
replayed. Parameters carry the torch reference's names and shapes:
``patch_embed.proj.weight`` (D, 1, 1, p, p), ``patch_embed.proj.bias``,
``patch_embed.channel_embed.weight`` (channels, D), ``pos_embed``,
``layers.{i}``, ``norm_f``, ``head``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from fastvim_tpu_torch.models.blocks import Block
from fastvim_tpu_torch.models.layers import (
    DropPath,
    Dropout,
    Norm,
    lecun_normal_init_,
    trunc_normal_init_,
)
from fastvim_tpu_torch.models.vision_mamba import VisionMamba, run_blocks

SCAN_ORDERS = ("Channel-First", "Spatial-First")


class SharedPatchProj(nn.Module):
    """A stride-p patchify of each channel by one (D, 1, 1, p, p) filter:
    a reshape and one matmul."""

    def __init__(self, embed_dim: int, patch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(embed_dim, 1, 1, patch, patch))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_init_(self.weight, self.patch ** 2, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (batch, H, W, C) → (batch, C, H/p, W/p, D)."""
        B, H, W, C = x.shape
        p = self.patch
        patches = x.reshape(B, H // p, p, W // p, p, C).permute(
            0, 5, 1, 3, 2, 4).reshape(B, C, H // p, W // p, p * p)
        w = self.weight.reshape(-1, p * p).t()
        return patches.to(self.dtype) @ w.to(self.dtype) \
            + self.bias.to(self.dtype)


class PatchEmbedPerChannel(nn.Module):
    def __init__(self, patch_size: int = 16, in_chans: int = 8,
                 embed_dim: int = 768, scan_order: str = "Channel-First",
                 scanpath_type: str = "rowwise",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if scan_order not in SCAN_ORDERS:
            raise ValueError(f"scan_order must be one of {SCAN_ORDERS}, got "
                             f"{scan_order!r}")
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.scan_order = scan_order
        self.scanpath_type = scanpath_type
        self.proj = SharedPatchProj(embed_dim, patch_size, dtype)
        self.channel_embed = skip_init(nn.Embedding, in_chans, embed_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.proj.reset_parameters(generator)
        nn.init.normal_(self.channel_embed.weight, 0.0, 0.02,
                        generator=generator)

    def forward(self, x: torch.Tensor,
                channel_ids: Optional[torch.Tensor] = None):
        """x: (batch, H, W, C_used); channel_ids: (C_used,) ids into the
        channel-embedding table (default: 0..C_used-1). Returns (tokens
        (batch, L, D), grid), the grid (rows, cols, C) for Channel-First
        or (C, rows, cols) for Spatial-First, in the tokens' order."""
        p = self.patch_size
        B, H, W, C = x.shape
        if H % p or W % p:
            raise ValueError(f"image {H}x{W} is not a multiple of patch {p}")
        if channel_ids is None:
            channel_ids = torch.arange(C, device=x.device)
        feat = self.proj(x)                                # (B, C, gh, gw, D)
        chan = self.channel_embed.weight[channel_ids.long()]      # (C, D)
        feat = feat + chan[None, :, None, None, :].to(feat.dtype)
        rows, cols = H // p, W // p
        if self.scanpath_type == "colwise":
            feat = feat.transpose(2, 3)
            rows, cols = cols, rows
        if self.scan_order == "Channel-First":
            feat = feat.permute(0, 2, 3, 1, 4)
            grid = (rows, cols, C)
        else:
            grid = (C, rows, cols)
        return feat.reshape(B, C * rows * cols, self.embed_dim), grid


class ChannelVisionMamba(nn.Module):
    """The FastChannelVim trunk: per-channel patch embed → pos-embed
    broadcast over the channels → N blocks on the 3-D grid → norm → mean
    pool (the last token with ``final_pool_type="none"``; with "max" the
    head on every token, then the max over tokens) → head."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 depth: int = 24, embed_dim: int = 384, channels: int = 8,
                 num_classes: int = 161, ssm_cfg: Optional[dict] = None,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 norm_epsilon: float = 1e-5, rms_norm: bool = True,
                 residual_in_fp32: bool = True,
                 final_pool_type: str = "mean", if_abs_pos_embed: bool = True,
                 init_layer_scale: Optional[float] = None,
                 scan_order: str = "Channel-First",
                 scanpath_type: str = "rowwise",
                 use_norm_after_ssm: bool = True,
                 rotate_every_block: bool = True,
                 collapse_method: str = "mean", compress_2d: bool = False,
                 scan_impl: str = "auto", remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if final_pool_type not in ("mean", "none", "max"):
            raise ValueError(f"final_pool_type must be mean|none|max, got "
                             f"{final_pool_type!r}")
        if compress_2d and scan_order != "Channel-First":
            raise ValueError("2dcompress implements Channel-First only")
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_classes = num_classes
        self.residual_in_fp32 = residual_in_fp32
        self.final_pool_type = final_pool_type
        self.scan_order = scan_order
        self.scanpath_type = scanpath_type
        self.remat = remat
        self.dtype = dtype

        self.patch_embed = PatchEmbedPerChannel(
            patch_size, channels, embed_dim, scan_order, scanpath_type, dtype)
        rows, cols = self.grid_size
        self.pos_embed = (nn.Parameter(torch.empty(1, rows * cols, embed_dim))
                          if if_abs_pos_embed else None)
        self.pos_drop = Dropout(drop_rate)
        mixer_kwargs = dict(
            use_norm_after_ssm=use_norm_after_ssm,
            init_layer_scale=init_layer_scale,
            collapse_method=collapse_method, n_layer=depth,
            scan_impl=scan_impl, **(ssm_cfg or {}))
        transpose_axes = ((0, 1) if scan_order == "Channel-First"
                          else (1, 2))
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        inter_dpr = [0.0] + dpr[:-1] if depth > 1 else [0.0]
        layers = []
        for i in range(depth):
            rotate = None  # the odd-layer schedule
            if compress_2d:
                # pool the whole spatial grid every third layer (a C-step
                # scan), else cols·C (a rows-step scan); rotate the
                # middle layer of each triple: rows → cols → channels
                pool_axes = (0, 1) if (i + 1) % 3 == 0 else (1, 2)
                rotate = rotate_every_block and (i + 2) % 3 == 0
            else:
                pool_axes = (1,) if scan_order == "Channel-First" else (2,)
            layers.append(Block(
                embed_dim, i, mixer_kwargs,
                rotate_every_block=rotate_every_block, rms_norm=rms_norm,
                residual_in_fp32=residual_in_fp32, norm_eps=norm_epsilon,
                drop_path=inter_dpr[i], dtype=dtype, pool_axes=pool_axes,
                transpose_axes=transpose_axes, rotate=rotate))
        self.layers = nn.ModuleList(layers)
        self.drop_path = DropPath(drop_path_rate)
        self.norm_f = Norm(embed_dim, rms=rms_norm, eps=norm_epsilon)
        self.head = skip_init(nn.Linear, embed_dim, num_classes)

    @property
    def grid_size(self) -> Tuple[int, int]:
        """The spatial (rows, cols) grid at ``img_size``, in scan
        orientation."""
        g = self.img_size // self.patch_size
        return g, g

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize every parameter from ``generator``, in a fixed order
        (the JAX package's distributions)."""
        self.patch_embed.reset_parameters(generator)
        if self.pos_embed is not None:
            trunc_normal_init_(self.pos_embed, 0.02, generator)
        for blk in self.layers:
            blk.reset_parameters(generator)
        nn.init.ones_(self.norm_f.weight)
        if self.norm_f.bias is not None:
            nn.init.zeros_(self.norm_f.bias)
        trunc_normal_init_(self.head.weight, 0.02, generator)
        nn.init.zeros_(self.head.bias)

    # every DropPath, the dropout (a DropPath subclass) included
    set_drop_path_generator = VisionMamba.set_drop_path_generator

    def forward(self, x: torch.Tensor,
                channel_ids: Optional[torch.Tensor] = None,
                return_features: bool = False) -> torch.Tensor:
        """x: (batch, H, W, C_used) images; channel_ids: (C_used,) their
        channels' ids (default: 0..C_used-1). Returns logits (batch,
        num_classes), or the features before the head with
        ``return_features``."""
        tokens, grid = self.patch_embed(x, channel_ids)
        if self.scan_order == "Channel-First":
            rows, cols, C = grid
        else:
            C, rows, cols = grid
        if (rows, cols) != self.grid_size:
            raise ValueError(f"input grid {(rows, cols)} differs from the "
                             f"model's {self.grid_size}")
        if self.pos_embed is not None:
            # the spatial table broadcast over the channels, in scan order
            pos = self.pos_embed.reshape(rows, cols, 1, self.embed_dim)
            if self.scan_order == "Channel-First":
                pos = pos.expand(rows, cols, C, self.embed_dim)
            else:
                pos = pos.reshape(1, rows, cols, self.embed_dim).expand(
                    C, rows, cols, self.embed_dim)
            tokens = tokens + pos.reshape(1, -1, self.embed_dim).to(
                tokens.dtype)
            tokens = self.pos_drop(tokens)
        hidden, residual = run_blocks(
            self.layers, tokens, grid,
            self.remat and self.training and torch.is_grad_enabled())
        hidden = self.norm_f(self.drop_path(hidden), residual=residual,
                             residual_in_fp32=self.residual_in_fp32,
                             out_dtype=self.dtype)
        if self.final_pool_type == "mean":
            feat = hidden.mean(dim=1)
        elif self.final_pool_type == "none":
            feat = hidden[:, -1]
        else:
            feat = hidden
        if return_features:
            return feat
        logits = F.linear(feat, self.head.weight.to(self.dtype),
                          self.head.bias.to(self.dtype))
        if self.final_pool_type == "max":
            logits = logits.amax(dim=1)
        return logits


def hcs_sample(rng, num_channels: int) -> List[int]:
    """Hierarchical channel sampling, on the host: a sorted list of
    channel indices, of a size drawn from 1..num_channels. ``rng`` is an
    int seed (None: fresh entropy); the same seed draws the same subset
    as the JAX package's."""
    rng = np.random.default_rng(rng if isinstance(rng, int) else None)
    c_new = int(rng.integers(1, num_channels + 1))
    channels = sorted(rng.choice(num_channels, size=c_new, replace=False))
    return [int(c) for c in channels]


def _channel_factory(embed_dim: int, depth: int, patch_size: int,
                     collapse: str = "mean", compress_2d: bool = False):
    def factory(img_size=224, **kwargs) -> ChannelVisionMamba:
        cfg = dict(img_size=img_size, patch_size=patch_size,
                   embed_dim=embed_dim, depth=depth, rms_norm=True,
                   residual_in_fp32=True, collapse_method=collapse,
                   compress_2d=compress_2d)
        cfg.update(kwargs)
        return ChannelVisionMamba(**cfg)

    return factory


CHANNEL_MODELS = {
    "channelvim_small_patch16_224_final_pool_mean_abs_pos_embed_"
    "with_noclstok_div2": _channel_factory(384, 24, 16),
    "fastchannelvim_small_ps16": _channel_factory(384, 24, 16),
    "fastchannelvim_small_ps8": _channel_factory(384, 24, 8),
    "fastchannelvim_small_ps16_maxpool": _channel_factory(
        384, 24, 16, collapse="max"),
    "fastchannelvim_small_ps8_maxpool": _channel_factory(
        384, 24, 8, collapse="max"),
    "fastchannelvim_small_ps16_2dcompress": _channel_factory(
        384, 24, 16, compress_2d=True),
    "fastchannelvim_small_ps8_2dcompress": _channel_factory(
        384, 24, 8, compress_2d=True),
    "channelvim_small_ps16_baseline": _channel_factory(
        384, 24, 16, collapse="none"),
    "channelvim_small_ps8_baseline": _channel_factory(
        384, 24, 8, collapse="none"),
}
