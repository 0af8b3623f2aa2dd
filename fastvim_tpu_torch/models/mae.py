"""FastMaskVim: masked-autoencoder pretraining for FastVim.

Counterpart of ``fastvim_tpu/models/mae.py``:

* fixed 2-D sin-cos position tables, computed (not parameters) for the
  encoder and the decoder;
* sorted random masking: the kept quarter of the shuffle is re-sorted, so
  the visible tokens keep their raster order (load-bearing for the scan);
* an encoder of masked pooled-mixer blocks (``BlockMasked``), whose odd
  layers rotate by permuting ``ids_keep`` through the transposed grid and
  sorting, or, with ``encoder_type="vim"``, of plain Vim blocks over the
  visible sequence with a cls token in its middle;
* a decoder of plain Vim blocks (no pooling, no rotation);
* the norm-pix MSE on the masked patches, with the unbiased variance.

Images are NHWC. The mask is drawn from an explicit ``torch.Generator``
(or given as ``noise``, a (batch, L) uniform draw, which is how the tests
hand the JAX model's draw to the port). ``remat=True`` recomputes each
encoder and decoder block in the backward pass. Parameters carry the
torch reference's names (``layers.{i}``, ``decoder_blocks.{i}``,
``decoder_embed``, ``mask_token``, ``decoder_pred``, ``decoder_norm``,
``norm_f``, ``cls_token``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from fastvim_tpu_torch.models.blocks import Block
from fastvim_tpu_torch.models.layers import Norm, trunc_normal_init_
from fastvim_tpu_torch.models.patch_embed import PatchEmbed
from fastvim_tpu_torch.parallel import rand_rows


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """Fixed 2-D sin-cos position table, (grid², embed_dim) float32: the
    first half of the channels encodes the column coordinate, the second
    the row, each as sines then cosines of geometrically spaced
    frequencies."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim {embed_dim} is not a multiple of 4")
    d_half = embed_dim // 2

    def embed_1d(pos: np.ndarray) -> np.ndarray:
        omega = np.arange(d_half // 2, dtype=np.float64)
        omega = 1.0 / 10000 ** (omega / (d_half / 2.0))
        out = np.einsum("p,f->pf", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.arange(grid_size, dtype=np.float64)
    gw, gh = np.meshgrid(grid, grid)  # gh varies over rows
    return np.concatenate([embed_1d(gw), embed_1d(gh)],
                          axis=1).astype(np.float32)


def sorted_random_masking(noise: torch.Tensor, len_keep: int):
    """Per-sample random masking from ``noise`` (batch, L): the
    ``len_keep`` tokens of smallest noise stay. Returns (ids_keep (batch,
    len_keep) ascending, mask (batch, L) with 1 = removed, ids_restore
    (batch, L))."""
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    kept = torch.sort(ids_shuffle[:, :len_keep], dim=1).values
    ids_shuffle = torch.cat([kept, ids_shuffle[:, len_keep:]], dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask = torch.ones(noise.shape, device=noise.device)
    mask[:, :len_keep] = 0.0
    return kept, torch.gather(mask, 1, ids_restore), ids_restore


def _take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[b, ids[b, i]] for (batch, L, d) x and (batch, M) ids."""
    return torch.gather(x, 1, ids.unsqueeze(-1).expand(-1, -1, x.shape[-1]))


class BlockMasked(Block):
    """Add → RMSNorm → (ids rotation) → masked mixer → (back), over the
    visible tokens of a ``token_size`` (rows, cols) grid."""

    def __init__(self, dim: int, layer_idx: int, token_size: Tuple[int, int],
                 mixer_kwargs: Optional[dict] = None, **kwargs):
        super().__init__(dim, layer_idx, mixer_kwargs, **kwargs)
        self.token_size = tuple(token_size)

    def forward(self, hidden: torch.Tensor,
                residual: Optional[torch.Tensor], ids_keep: torch.Tensor):
        """hidden: the visible tokens (batch, len_keep, dim) in raster
        order; ids_keep: their raster indices, ascending."""
        hidden, residual = self.norm(
            hidden, residual, prenorm=True,
            residual_in_fp32=self.residual_in_fp32, out_dtype=self.dtype)
        rows, cols = self.token_size
        if self.rotated:
            # raster index (i, j) → transposed raster index j·rows + i
            ids = (ids_keep % cols) * rows + ids_keep // cols
            order = torch.argsort(ids, dim=1, stable=True)
            ids = torch.gather(ids, 1, order)
            hidden = _take(hidden, order)
            rows, cols = cols, rows
        else:
            ids = ids_keep
        hidden = self.mixer(hidden, (rows, cols), row_ids=ids // cols)
        if self.rotated:
            hidden = _take(hidden, torch.argsort(order, dim=1, stable=True))
        return hidden, residual


class MaskedAutoencoderVim(nn.Module):
    """FastMaskVim MAE: masked pooled-mixer encoder, plain Vim decoder.
    ``forward(imgs, mask_ratio, noise=None, generator=None)`` returns
    (loss, pred (batch, L, p²·C), mask (batch, L))."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 depth: int = 24, embed_dim: int = 192,
                 decoder_embed_dim: int = 512, decoder_depth: int = 2,
                 norm_pix_loss: bool = True, channels: int = 3,
                 ssm_cfg: Optional[dict] = None, norm_epsilon: float = 1e-5,
                 rms_norm: bool = True, residual_in_fp32: bool = True,
                 init_layer_scale: Optional[float] = None,
                 use_norm_after_ssm: bool = True,
                 scanpath_type: str = "rowwise",
                 rotate_every_block: bool = True,
                 collapse_method: str = "mean",
                 encoder_type: str = "fastvim", use_cls_token: bool = False,
                 scan_impl: str = "auto", layer_fused: str = "auto",
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if encoder_type not in ("fastvim", "vim"):
            raise ValueError(f"encoder_type must be fastvim|vim, got "
                             f"{encoder_type!r}")
        if use_cls_token and encoder_type != "vim":
            raise ValueError("the cls token belongs to the Vim encoder")
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.decoder_embed_dim = decoder_embed_dim
        self.norm_pix_loss = norm_pix_loss
        self.residual_in_fp32 = residual_in_fp32
        self.encoder_type = encoder_type
        self.use_cls_token = use_cls_token
        self.remat = remat
        self.dtype = dtype

        grid = self.grid
        self.register_buffer("enc_pos", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, grid)), persistent=False)
        self.register_buffer("dec_pos", torch.from_numpy(
            get_2d_sincos_pos_embed(decoder_embed_dim, grid)),
            persistent=False)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, channels,
                                      scanpath_type, dtype=dtype)
        self.cls_token = (nn.Parameter(torch.empty(1, 1, embed_dim))
                          if use_cls_token else None)
        common = dict(use_norm_after_ssm=use_norm_after_ssm,
                      scan_impl=scan_impl, layer_fused=layer_fused,
                      **(ssm_cfg or {}))
        norm = dict(rms_norm=rms_norm, residual_in_fp32=residual_in_fp32,
                    norm_eps=norm_epsilon, dtype=dtype)
        enc_kwargs = dict(common, init_layer_scale=init_layer_scale,
                          n_layer=depth, collapse_method=collapse_method)
        if encoder_type == "vim":
            enc_kwargs["collapse_method"] = "none"
            self.layers = nn.ModuleList(
                Block(embed_dim, i, enc_kwargs, rotate_every_block=False,
                      **norm) for i in range(depth))
        else:
            self.layers = nn.ModuleList(
                BlockMasked(embed_dim, i, (grid, grid), enc_kwargs,
                            rotate_every_block=rotate_every_block, **norm)
                for i in range(depth))
        self.norm_f = Norm(embed_dim, rms=rms_norm, eps=norm_epsilon)
        self.decoder_embed = skip_init(nn.Linear, embed_dim,
                                       decoder_embed_dim)
        self.mask_token = nn.Parameter(torch.empty(1, 1, decoder_embed_dim))
        dec_kwargs = dict(common, n_layer=decoder_depth,
                          collapse_method="none")
        self.decoder_blocks = nn.ModuleList(
            Block(decoder_embed_dim, i, dec_kwargs, rotate_every_block=False,
                  **norm) for i in range(decoder_depth))
        self.decoder_norm = Norm(decoder_embed_dim, rms=rms_norm,
                                 eps=norm_epsilon)
        self.decoder_pred = skip_init(nn.Linear, decoder_embed_dim,
                                      patch_size ** 2 * channels)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialize every parameter from ``generator``, in a fixed order
        (the JAX package's distributions: lecun-normal patch projection,
        truncated-normal 0.02 tokens, Xavier-uniform dense layers)."""
        self.patch_embed.proj.reset_parameters(generator)
        if self.cls_token is not None:
            trunc_normal_init_(self.cls_token, 0.02, generator)
        for blk in self.layers:
            blk.reset_parameters(generator)
        nn.init.ones_(self.norm_f.weight)
        for lin in (self.decoder_embed, self.decoder_pred):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)
        trunc_normal_init_(self.mask_token, 0.02, generator)
        for blk in self.decoder_blocks:
            blk.reset_parameters(generator)
        nn.init.ones_(self.decoder_norm.weight)
        for norm in (self.norm_f, self.decoder_norm):
            if norm.bias is not None:
                nn.init.zeros_(norm.bias)

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs (batch, H, W, C) → (batch, L, p·p·C)."""
        p = self.patch_size
        B, H, W, C = imgs.shape
        x = imgs.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, (H // p) * (W // p), p * p * C)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        B, L, _ = x.shape
        h = w = int(round(L ** 0.5))
        C = x.shape[2] // (p * p)
        x = x.reshape(B, h, w, p, p, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, h * p, w * p, C)

    def _run(self, blk, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    def forward(self, imgs: torch.Tensor, mask_ratio: float = 0.75,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        latent, mask, ids_restore = self.encode(imgs, mask_ratio, noise,
                                                generator)
        pred = self.decode(latent, ids_restore)
        return self.loss(imgs, pred, mask), pred, mask

    def encode(self, imgs: torch.Tensor, mask_ratio: float,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """The mask comes from ``noise`` (batch, L) or, without it, from a
        uniform draw of ``generator`` on the images' device, made over the
        global batch on several ranks (``parallel.rand_rows``)."""
        tokens, (rows, cols) = self.patch_embed(imgs)
        B, L, _ = tokens.shape
        tokens = tokens + self.enc_pos.to(tokens.dtype)
        len_keep = int(L * (1 - mask_ratio))
        if noise is None:
            if generator is None:
                raise ValueError("encode needs noise or a generator")
            noise = rand_rows((B, L), generator, imgs.device)
        ids_keep, mask, ids_restore = sorted_random_masking(
            noise.to(imgs.device), len_keep)
        hidden, residual = _take(tokens, ids_keep), None
        if self.encoder_type == "vim":
            enc_len = len_keep
            if self.cls_token is not None:
                # its position-table row is zero, so it takes none
                tp = len_keep // 2
                cls = self.cls_token.to(hidden.dtype).expand(B, 1, -1)
                hidden = torch.cat([hidden[:, :tp], cls, hidden[:, tp:]], 1)
                enc_len += 1
            for blk in self.layers:
                hidden, residual = self._run(blk, hidden, residual,
                                             (enc_len, 1))
        else:
            for blk in self.layers:
                hidden, residual = self._run(blk, hidden, residual, ids_keep)
        hidden = self.norm_f(hidden, residual=residual,
                             residual_in_fp32=self.residual_in_fp32,
                             out_dtype=self.dtype)
        return hidden, mask, ids_restore

    def decode(self, latent: torch.Tensor,
               ids_restore: torch.Tensor) -> torch.Tensor:
        B, n_latent, _ = latent.shape
        L = ids_restore.shape[1]
        dtype = self.dtype
        has_cls = self.cls_token is not None
        len_keep = n_latent - 1 if has_cls else n_latent
        x = F.linear(latent, self.decoder_embed.weight.to(dtype),
                     self.decoder_embed.bias.to(dtype))
        if has_cls:
            # out of the middle before the unshuffle, back at the end after
            tp = len_keep // 2
            cls_dec = x[:, tp:tp + 1]
            x = torch.cat([x[:, :tp], x[:, tp + 1:]], 1)
        mask_tokens = self.mask_token.to(x.dtype).expand(B, L - len_keep, -1)
        x = _take(torch.cat([x, mask_tokens], 1), ids_restore)
        x = x + self.dec_pos.to(x.dtype)
        if has_cls:
            x = torch.cat([x, cls_dec], 1)
        residual = None
        grid = (self.grid, self.grid)
        for blk in self.decoder_blocks:
            x, residual = self._run(blk, x, residual, grid)
        x = self.decoder_norm(x, residual=residual,
                              residual_in_fp32=self.residual_in_fp32,
                              out_dtype=dtype)
        pred = F.linear(x, self.decoder_pred.weight.to(dtype),
                        self.decoder_pred.bias.to(dtype))
        return pred[:, :-1] if has_cls else pred

    def loss(self, imgs: torch.Tensor, pred: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """Mean squared error over the masked patches; with
        ``norm_pix_loss`` each target patch is normalized by its mean and
        its unbiased variance."""
        target = self.patchify(imgs).float()
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, correction=1)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        per_patch = (pred.float() - target).square().mean(dim=-1)
        return (per_patch * mask).sum() / mask.sum()


def _mae_factory(embed_dim: int, depth: int, patch_size: int,
                 encoder_type: str = "fastvim"):
    def factory(img_size=224, **kwargs) -> MaskedAutoencoderVim:
        cfg = dict(img_size=img_size, patch_size=patch_size,
                   embed_dim=embed_dim, depth=depth, decoder_embed_dim=512,
                   decoder_depth=2, rms_norm=True, residual_in_fp32=True,
                   encoder_type=encoder_type,
                   use_cls_token=encoder_type == "vim")
        cfg.update(kwargs)
        return MaskedAutoencoderVim(**cfg)

    return factory


MAE_MODELS = {
    "mae_FastVim_base_dec512d2b": _mae_factory(768, 24, 16),
    "mae_FastVim_large_dec512d2b": _mae_factory(1024, 48, 16),
    "mae_FastVim_huge_dec512d2b": _mae_factory(1280, 64, 14),
    "mae_FastVim_tiny_dec512d2b": _mae_factory(192, 24, 16),
    "mae_FastVim_small_dec512d2b": _mae_factory(384, 24, 16),
    "mae_vim_base_dec512d2b": _mae_factory(768, 24, 16, "vim"),
    "mae_vim_large_dec512d2b": _mae_factory(1024, 48, 16, "vim"),
    "mae_vim_huge_dec512d2b": _mae_factory(1280, 64, 14, "vim"),
}
