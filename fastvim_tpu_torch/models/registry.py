"""Model zoo registry: the FastVim and Vim classification models, the
MAE models and the ChannelVim models.

Counterpart of ``fastvim_tpu/models/registry.py``, with the same names
and sizes: tiny 192×24, small 384×24, base 768×24, large 1024×48, huge
1280×64 (patch 14 for huge), plus the short aliases ``fastvim_{size}``,
``vim_{size}`` and ``vim_{size}_midclstok``; and the eight
``models/mae.py`` models (``mae_FastVim_{size}_dec512d2b``,
``mae_vim_{size}_dec512d2b``); and the nine ``models/channel.py`` models
(``fastchannelvim_small_ps{16,8}`` with ``_maxpool`` and ``_2dcompress``,
``channelvim_small_ps{16,8}_baseline`` and the reference's long name).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from fastvim_tpu_torch.models.channel import CHANNEL_MODELS
from fastvim_tpu_torch.models.mae import MAE_MODELS
from fastvim_tpu_torch.models.vision_mamba import VisionMamba

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {**MAE_MODELS,
                                                  **CHANNEL_MODELS}

_COMMON = dict(rms_norm=True, residual_in_fp32=True, fused_add_norm=True,
               final_pool_type="mean", if_abs_pos_embed=True)

_SIZES = {
    "tiny": dict(embed_dim=192, depth=24, patch_size=16),
    "small": dict(embed_dim=384, depth=24, patch_size=16),
    "base": dict(embed_dim=768, depth=24, patch_size=16),
    "large": dict(embed_dim=1024, depth=48, patch_size=16),
    "huge": dict(embed_dim=1280, depth=64, patch_size=14),
}


def _factory(size: str, **fixed) -> Callable[..., VisionMamba]:
    def factory(img_size=224, **kwargs) -> VisionMamba:
        params = dict(_COMMON, img_size=img_size, **_SIZES[size])
        params.update(fixed)
        params.update(kwargs)
        return VisionMamba(**params)

    return factory


for _size, _patch in [("tiny", 16), ("small", 16), ("base", 16),
                      ("large", 16), ("huge", 14)]:
    _stem = f"vim_{_size}_patch{_patch}_224"
    # FastVim: pooled scan
    _name = f"{_stem}_final_pool_mean_abs_pos_embed_with_noclstok_div2"
    _REGISTRY[_name] = _REGISTRY[f"fastvim_{_size}"] = _factory(
        _size, collapse_method="mean")
    # Vim baseline: full-length scan, middle cls token, no rotation
    _name = f"{_stem}_final_pool_mean_abs_pos_embed_with_midclstok_div2"
    _REGISTRY[_name] = _REGISTRY[f"vim_{_size}_midclstok"] = _factory(
        _size, collapse_method="none", rotate_every_block=False,
        if_cls_token=True, use_middle_cls_token=True)
    # plain Vim: full-length scan, no cls token
    _name = (f"{_stem}_baseline_final_pool_mean_abs_pos_embed_with_"
             "noclstok_div2")
    _REGISTRY[_name] = _REGISTRY[f"vim_{_size}"] = _factory(
        _size, collapse_method="none")


def create_model(name: str, *, device: Union[str, torch.device, None] = None,
                 generator: Optional[torch.Generator] = None,
                 **kwargs) -> nn.Module:
    """Build a registered model, initialize it on the CPU from
    ``generator`` (seed 0 if None), move it to ``device`` and return it
    in eval mode. ``device=None`` means the first CUDA device, and raises
    where there is none: the CPU is used only when asked for
    (``device="cpu"``). Other keyword arguments override the model's
    fields (``dtype``, ``img_size``, ``layer_fused``, ...)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(_REGISTRY)}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "create_model: no CUDA device; pass device='cpu' to build "
                "the model on the CPU")
        device = torch.device("cuda", 0)
    model = _REGISTRY[name](**kwargs)
    model.reset_parameters(generator if generator is not None
                           else torch.Generator().manual_seed(0))
    return model.to(device).eval()


def list_models():
    return sorted(_REGISTRY)
