"""VisionMamba classification trunk: patchify → pos-embed → N blocks →
norm → mean pool (or the cls token) → head.

Counterpart of the classification path of
``fastvim_tpu/models/vision_mamba.py``, including the Vim baseline's
(middle) cls token. Images are NHWC. The input grid must be the one
``img_size`` gives: there is no pos-embed resize and no ``out_indices``
feature-map mode here. ``model.train()`` / ``model.eval()`` take the place
of the JAX package's ``deterministic`` argument: they switch DropPath.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from fastvim_tpu_torch.models.blocks import Block
from fastvim_tpu_torch.models.layers import DropPath, Norm, trunc_normal_init_
from fastvim_tpu_torch.models.patch_embed import PatchEmbed


class VisionMamba(nn.Module):
    def __init__(self, img_size: Union[int, Tuple[int, int]] = 224,
                 patch_size: int = 16, depth: int = 24, embed_dim: int = 192,
                 channels: int = 3, num_classes: int = 1000,
                 ssm_cfg: Optional[dict] = None,
                 drop_path_rate: float = 0.1, norm_epsilon: float = 1e-5,
                 rms_norm: bool = True, residual_in_fp32: bool = True,
                 if_cls_token: bool = False,
                 use_middle_cls_token: bool = False,
                 scanpath_type: str = "rowwise",
                 use_norm_after_ssm: bool = True,
                 rotate_every_block: bool = True,
                 collapse_method: str = "mean", scaling_factor: float = 1.0,
                 scan_impl: str = "auto", layer_fused: str = "auto",
                 layer_fused_bwd: str = "fused",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if if_cls_token and (collapse_method != "none" or rotate_every_block):
            raise ValueError("cls token is only supported for the non-pooled, "
                             "non-rotating Vim baseline")
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_classes = num_classes
        self.residual_in_fp32 = residual_in_fp32
        self.if_cls_token = if_cls_token
        self.use_middle_cls_token = use_middle_cls_token
        self.scanpath_type = scanpath_type
        self.dtype = dtype

        self.patch_embed = PatchEmbed(patch_size, embed_dim, channels,
                                      scanpath_type, dtype=dtype)
        self.cls_token = (nn.Parameter(torch.empty(1, 1, embed_dim))
                          if if_cls_token else None)
        n_pos = self.num_patches + (1 if if_cls_token else 0)
        self.pos_embed = nn.Parameter(torch.empty(1, n_pos, embed_dim))
        mixer_kwargs = dict(
            use_norm_after_ssm=use_norm_after_ssm,
            collapse_method=collapse_method, scaling_factor=scaling_factor,
            n_layer=depth, scan_impl=scan_impl, layer_fused=layer_fused,
            layer_fused_bwd=layer_fused_bwd, **(ssm_cfg or {}))
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        inter_dpr = [0.0] + dpr[:-1] if depth > 1 else [0.0]
        self.layers = nn.ModuleList(
            Block(embed_dim, i, self.grid_size, mixer_kwargs,
                  rotate_every_block=rotate_every_block, rms_norm=rms_norm,
                  residual_in_fp32=residual_in_fp32, norm_eps=norm_epsilon,
                  drop_path=inter_dpr[i], dtype=dtype)
            for i in range(depth))
        self.drop_path = DropPath(drop_path_rate)
        self.norm_f = Norm(embed_dim, rms=rms_norm, eps=norm_epsilon)
        self.head = (skip_init(nn.Linear, embed_dim, num_classes)
                     if num_classes > 0 else None)

    @property
    def grid_size(self) -> Tuple[int, int]:
        """Token grid at ``img_size``, in scan orientation."""
        hw = (tuple(self.img_size) if isinstance(self.img_size, (tuple, list))
              else (self.img_size, self.img_size))
        gh, gw = hw[0] // self.patch_size, hw[1] // self.patch_size
        return (gw, gh) if self.scanpath_type == "colwise" else (gh, gw)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize every parameter from ``generator``, in a fixed order."""
        self.patch_embed.proj.reset_parameters(generator)
        if self.cls_token is not None:
            trunc_normal_init_(self.cls_token, 0.02, generator)
        trunc_normal_init_(self.pos_embed, 0.02, generator)
        for blk in self.layers:
            blk.reset_parameters(generator)
        nn.init.ones_(self.norm_f.weight)
        if self.norm_f.bias is not None:
            nn.init.zeros_(self.norm_f.bias)
        if self.head is not None:
            trunc_normal_init_(self.head.weight, 0.02, generator)
            nn.init.zeros_(self.head.bias)

    def set_drop_path_generator(
            self, generator: Optional[torch.Generator]) -> None:
        """Hand every DropPath the generator its training-mode masks are
        drawn from (on the model's device)."""
        for m in self.modules():
            if isinstance(m, DropPath):
                m.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (batch, H, W, C) images. Returns logits (batch, num_classes),
        or the pooled features (batch, embed_dim) when num_classes <= 0."""
        B = x.shape[0]
        tokens, grid = self.patch_embed(x)
        if grid != self.grid_size:
            raise ValueError(f"input grid {grid} differs from the model's "
                             f"{self.grid_size} (img_size {self.img_size}); "
                             "pos-embed resize is not supported")
        cls_position = None
        if self.cls_token is not None:
            M = tokens.shape[1]
            cls_position = M // 2 if self.use_middle_cls_token else 0
            cls = self.cls_token.to(tokens.dtype).expand(B, 1, self.embed_dim)
            tokens = torch.cat([tokens[:, :cls_position], cls,
                                tokens[:, cls_position:]], dim=1)
        tokens = tokens + self.pos_embed.to(tokens.dtype)

        hidden, residual = tokens, None
        for blk in self.layers:
            hidden, residual = blk(hidden, residual)
        hidden = self.norm_f(self.drop_path(hidden), residual=residual,
                             residual_in_fp32=self.residual_in_fp32,
                             out_dtype=self.dtype)

        feat = (hidden[:, cls_position] if cls_position is not None
                else hidden.mean(dim=1))
        if self.head is None:
            return feat
        return F.linear(feat, self.head.weight.to(self.dtype),
                        self.head.bias.to(self.dtype))
