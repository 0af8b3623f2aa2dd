"""VisionMamba trunk: patchify → pos-embed → N blocks → norm → pool →
head, or, with ``out_indices``, multi-scale feature maps.

Counterpart of ``fastvim_tpu/models/vision_mamba.py``, including the Vim
baseline's (middle) cls token. Images are NHWC. At another resolution
than ``img_size`` the pos-embed is resized to the input's grid (bicubic,
as the JAX package does), except with a cls token, which takes only the
training grid. ``final_pool_type`` is "mean", "none" (the last token),
"max" (the head on every token, then the max over tokens) or "all" (the
head on every token). ``drop_rate`` drops elements after the pos-embed
add; ``if_abs_pos_embed=False`` builds no ``pos_embed``;
``fused_add_norm`` is accepted for the configs and ignored (the add and
the norm are always one step here). With ``out_indices`` (the
segmentation / detection backbone) the forward returns, for each listed
block, its mixer output under its own LayerNorm (``outnorm_{j}``, fp32,
eps 1e-5) as a (batch, rows, cols, D) map, and the model has no final
norm and no head.
``remat=True`` recomputes each block's activations in the backward pass
(``torch.utils.checkpoint``) instead of keeping them; the recompute
replays the DropPath draws of the forward, so the gradients are those
of ``remat=False``. ``model.train()`` / ``model.eval()`` take the place
of the JAX package's ``deterministic`` argument: they switch DropPath.
``init_layer_scale`` gives every mixer a ``gamma`` on its output. ``forward(x,
return_features=True)`` returns the pooled features before the head.
``layer_fused`` ("auto", "on", "off", "recompute") and ``layer_fused_bwd``
are model fields; ``fused_kernels`` and ``fused_merge`` reach the mixers
through ``ssm_cfg``, as in the JAX ``VisionMamba`` (see
``models/mixer.py`` for the dispatch). All of them share one parameter
tree.

Over a mesh with a seq axis (``parallel.make_mesh(data, seq)``) the
tokens are sharded where ``parallel.token_shard`` says so (a 2-D pooled
grid without a cls token, whose rows and tokens the S ranks of a seq
group divide): each rank embeds its rows of patches and its slice of the
position embedding (the table resized whole first), the blocks run on
its tokens (``parallel/tokens.py``: halo exchanges for the convs, the
pooled scans run whole on every rank), and the final pool and the
feature maps are made whole over the group, so that every rank of a seq
group returns the whole output, the same function as one process.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from fastvim_tpu_torch.models.blocks import Block
from fastvim_tpu_torch.models.layers import (
    DropPath,
    Dropout,
    Norm,
    trunc_normal_init_,
)
from fastvim_tpu_torch.models.patch_embed import PatchEmbed, resize_pos_embed
from fastvim_tpu_torch.parallel import tokens as seq
from fastvim_tpu_torch.parallel.mesh import TokenShard, token_shard


class VisionMamba(nn.Module):
    def __init__(self, img_size: Union[int, Tuple[int, int]] = 224,
                 patch_size: int = 16, depth: int = 24, embed_dim: int = 192,
                 channels: int = 3, num_classes: int = 1000,
                 ssm_cfg: Optional[dict] = None, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, norm_epsilon: float = 1e-5,
                 rms_norm: bool = True, residual_in_fp32: bool = True,
                 fused_add_norm: bool = True, final_pool_type: str = "mean",
                 if_abs_pos_embed: bool = True, if_cls_token: bool = False,
                 use_middle_cls_token: bool = False,
                 scanpath_type: str = "rowwise",
                 use_norm_after_ssm: bool = True,
                 rotate_every_block: bool = True,
                 collapse_method: str = "mean", scaling_factor: float = 1.0,
                 scan_impl: str = "auto", layer_fused: str = "auto",
                 layer_fused_bwd: str = "auto", remat: bool = False,
                 init_layer_scale: Optional[float] = None,
                 out_indices: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if if_cls_token and (collapse_method != "none" or rotate_every_block):
            raise ValueError("cls token is only supported for the non-pooled, "
                             "non-rotating Vim baseline")
        if if_cls_token and out_indices is not None:
            raise ValueError("out_indices takes no cls token")
        if final_pool_type not in ("mean", "none", "max", "all"):
            raise ValueError(f"final_pool_type must be mean|none|max|all, got "
                             f"{final_pool_type!r}")
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_classes = num_classes
        self.residual_in_fp32 = residual_in_fp32
        self.if_cls_token = if_cls_token
        self.use_middle_cls_token = use_middle_cls_token
        self.final_pool_type = final_pool_type
        self.out_indices = (None if out_indices is None
                            else tuple(int(i) for i in out_indices))
        self.scanpath_type = scanpath_type
        self.collapse_method = collapse_method
        self.remat = remat
        self.dtype = dtype

        self.patch_embed = PatchEmbed(patch_size, embed_dim, channels,
                                      scanpath_type, dtype=dtype)
        self.cls_token = (nn.Parameter(torch.empty(1, 1, embed_dim))
                          if if_cls_token else None)
        n_pos = self.num_patches + (1 if if_cls_token else 0)
        self.pos_embed = (nn.Parameter(torch.empty(1, n_pos, embed_dim))
                          if if_abs_pos_embed else None)
        self.pos_drop = Dropout(drop_rate)
        mixer_kwargs = dict(
            use_norm_after_ssm=use_norm_after_ssm,
            init_layer_scale=init_layer_scale,
            collapse_method=collapse_method, scaling_factor=scaling_factor,
            n_layer=depth, scan_impl=scan_impl, layer_fused=layer_fused,
            layer_fused_bwd=layer_fused_bwd, **(ssm_cfg or {}))
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        inter_dpr = [0.0] + dpr[:-1] if depth > 1 else [0.0]
        self.layers = nn.ModuleList(
            Block(embed_dim, i, mixer_kwargs,
                  rotate_every_block=rotate_every_block, rms_norm=rms_norm,
                  residual_in_fp32=residual_in_fp32, norm_eps=norm_epsilon,
                  drop_path=inter_dpr[i], dtype=dtype)
            for i in range(depth))
        self.drop_path = DropPath(drop_path_rate)
        self.norm_f = self.head = None
        if self.out_indices is not None:
            # the feature maps' norms (JAX ``outnorm_{j}_weight`` / _bias)
            for j in range(len(self.out_indices)):
                self.add_module(f"outnorm_{j}", Norm(embed_dim, rms=False))
        else:
            self.norm_f = Norm(embed_dim, rms=rms_norm, eps=norm_epsilon)
            if num_classes > 0:
                self.head = skip_init(nn.Linear, embed_dim, num_classes)

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
        if self.pos_embed is not None:
            trunc_normal_init_(self.pos_embed, 0.02, generator)
        for blk in self.layers:
            blk.reset_parameters(generator)
        for norm in self.out_norms():
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)
        if self.norm_f is not None:
            nn.init.ones_(self.norm_f.weight)
            if self.norm_f.bias is not None:
                nn.init.zeros_(self.norm_f.bias)
        if self.head is not None:
            trunc_normal_init_(self.head.weight, 0.02, generator)
            nn.init.zeros_(self.head.bias)

    def token_shard(self, x: torch.Tensor) -> Optional[TokenShard]:
        """This rank's part of the token grid of images ``x`` over the
        mesh's seq axis, or None where the tokens stay whole
        (``parallel.token_shard``)."""
        p = self.patch_size
        if x.shape[1] % p or x.shape[2] % p:
            return None  # the patch embed refuses it
        gh, gw = x.shape[1] // p, x.shape[2] // p
        grid = (gw, gh) if self.scanpath_type == "colwise" else (gh, gw)
        return token_shard(grid, cls_token=self.cls_token is not None,
                           pooled=self.collapse_method != "none")

    def out_norms(self) -> List[Norm]:
        """The feature maps' norms, in ``out_indices`` order (none without
        ``out_indices``)."""
        n = 0 if self.out_indices is None else len(self.out_indices)
        return [getattr(self, f"outnorm_{j}") for j in range(n)]

    def set_drop_path_generator(
            self, generator: Optional[torch.Generator]) -> None:
        """Hand every DropPath, the dropouts included, the generator its
        training-mode masks are drawn from (on the model's device)."""
        for m in self.modules():
            if isinstance(m, DropPath):
                m.generator = generator

    def forward(self, x: torch.Tensor, return_features: bool = False
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """x: (batch, H, W, C) images. Returns logits (batch, num_classes),
        or the pooled features (batch, embed_dim) with ``return_features``
        or when num_classes <= 0 ((batch, L, embed_dim) for the "max" and
        "all" pools); with ``out_indices``, the list of (batch, rows, cols,
        embed_dim) fp32 feature maps."""
        B = x.shape[0]
        shard = self.token_shard(x)
        if shard is not None:
            # this rank's patch rows: image rows, or columns for colwise
            px = slice(shard.rows().start * self.patch_size,
                       shard.rows().stop * self.patch_size)
            x = x[:, :, px] if self.scanpath_type == "colwise" else x[:, px]
        tokens, grid = self.patch_embed(x)
        if shard is not None:
            grid = shard.grid
        if grid != self.grid_size and self.cls_token is not None:
            raise ValueError(f"input grid {grid} differs from the "
                             f"model's {self.grid_size}: a cls-token "
                             "model takes its training grid only")
        cls_position = None
        if self.cls_token is not None:
            M = tokens.shape[1]
            cls_position = M // 2 if self.use_middle_cls_token else 0
            cls = self.cls_token.to(tokens.dtype).expand(B, 1, self.embed_dim)
            tokens = torch.cat([tokens[:, :cls_position], cls,
                                tokens[:, cls_position:]], dim=1)
        if self.pos_embed is not None:
            pos = self.pos_embed
            if grid != self.grid_size:
                pos = resize_pos_embed(pos, grid, self.grid_size,
                                       self.scanpath_type)
            if shard is not None:
                pos = pos[:, shard.tokens()]
            tokens = self.pos_drop(tokens + pos.to(tokens.dtype), shard)

        remat = self.remat and self.training and torch.is_grad_enabled()
        if self.out_indices is not None:
            maps = {}
            for i, (hidden, _) in enumerate(iter_blocks(
                    self.layers, tokens, grid, remat, shard)):
                if i in self.out_indices:
                    maps[i] = hidden
            local = grid if shard is None else shard.local_grid
            out = [norm(maps[i].float()).reshape(B, *local, self.embed_dim)
                   for i, norm in zip(self.out_indices, self.out_norms())]
            return out if shard is None else [seq.gather_rows(m, shard)
                                              for m in out]

        hidden, residual = run_blocks(self.layers, tokens, grid, remat, shard)
        hidden = self.norm_f(self.drop_path(hidden), residual=residual,
                             residual_in_fp32=self.residual_in_fp32,
                             out_dtype=self.dtype)

        if cls_position is not None:
            feat = hidden[:, cls_position]
        elif self.final_pool_type == "mean":
            feat = (hidden.mean(dim=1) if shard is None
                    else seq.mean_tokens(hidden, shard))
        elif self.final_pool_type == "none":
            feat = (hidden[:, -1] if shard is None
                    else seq.last_token(hidden, shard))
        else:  # "max" and "all": the head on every token
            feat = hidden if shard is None else seq.gather_tokens(hidden,
                                                                  shard)
        if return_features or self.head is None:
            return feat
        logits = F.linear(feat, self.head.weight.to(self.dtype),
                          self.head.bias.to(self.dtype))
        if self.final_pool_type == "max":
            logits = logits.amax(dim=1)
        return logits


def iter_blocks(layers, hidden: torch.Tensor, grid, remat: bool,
                shard: Optional[TokenShard] = None
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """The residual stack, one block at a time: each block on (hidden,
    residual) and the token ``grid``, yielding its (hidden, residual);
    with ``remat`` each block's activations are recomputed in the
    backward pass, its DropPath draws replayed, and its collectives over
    a ``shard``'s group called again (in the same order on every rank:
    the backward passes run the same graph). With ``shard`` hidden holds
    this rank's rows of ``grid``."""
    residual = None
    for blk in layers:
        if remat:
            hidden, residual = checkpoint(
                blk, hidden, residual, grid, shard, use_reentrant=False,
                context_fn=lambda: _replay_drop_path(blk.drop_path))
        else:
            hidden, residual = blk(hidden, residual, grid, shard)
        yield hidden, residual


def run_blocks(layers, hidden: torch.Tensor, grid, remat: bool,
               shard: Optional[TokenShard] = None):
    """The whole residual stack (``iter_blocks``). Returns the last
    block's (hidden, residual)."""
    residual = None
    for hidden, residual in iter_blocks(layers, hidden, grid, remat, shard):
        pass
    return hidden, residual


class _NoteState:
    """Entered around a block's forward: note the generator's state."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.state = None

    def __enter__(self):
        self.state = self.generator.get_state()

    def __exit__(self, *exc):
        return False


class _ReplayFrom:
    """Entered around a recompute (as often as it runs): start the
    generator from the noted state, and leave it where it was found."""

    def __init__(self, noted: _NoteState):
        self.noted = noted
        self.now = None

    def __enter__(self):
        self.now = self.noted.generator.get_state()
        self.noted.generator.set_state(self.noted.state)

    def __exit__(self, *exc):
        self.noted.generator.set_state(self.now)
        return False


def _replay_drop_path(drop_path: DropPath):
    """``checkpoint``'s ``context_fn`` for a block whose DropPath draws
    from its own generator, which ``checkpoint`` does not restore."""
    gen = drop_path.generator if drop_path.rate > 0 else None
    if gen is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    noted = _NoteState(gen)
    return noted, _ReplayFrom(noted)
