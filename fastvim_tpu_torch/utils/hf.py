"""Load a Mamba language model from a local Hugging Face snapshot.

Counterpart of ``fastvim_tpu/utils/hf.py`` (the reference's
``MambaLMHeadModel.from_pretrained``): read ``config.json`` and
``pytorch_model.bin`` (or ``model.safetensors``) from a local directory,
such as a downloaded snapshot of ``state-spaces/mamba-130m``, and build a
:class:`~fastvim_tpu_torch.models.lm.MambaLMHeadModel` with those
weights. Only local directories are read; nothing is downloaded. The
port's parameters already carry the reference's names, so the state dict
loads as it is; ``lm_head.weight`` is tied to the embedding and dropped.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Union

import torch

from fastvim_tpu_torch.models.lm import MambaLMHeadModel


def load_config_hf(path: str) -> dict:
    """``config.json`` of a local checkpoint directory."""
    cfg = os.path.join(path, "config.json")
    if not os.path.isfile(cfg):
        raise FileNotFoundError(
            f"no config.json under {path!r}: pass a local Hugging Face "
            "snapshot directory (nothing is downloaded)")
    with open(cfg) as f:
        return json.load(f)


def load_state_dict_hf(path: str) -> Dict[str, torch.Tensor]:
    """The weights of a local checkpoint directory as float32 CPU tensors,
    from ``pytorch_model.bin`` (``torch.load(weights_only=True)``) or else
    ``model.safetensors`` (the ``safetensors`` package, imported here)."""
    bin_path = os.path.join(path, "pytorch_model.bin")
    st_path = os.path.join(path, "model.safetensors")
    if os.path.isfile(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    elif os.path.isfile(st_path):
        from safetensors.torch import load_file

        sd = load_file(st_path)
    else:
        raise FileNotFoundError(
            f"no pytorch_model.bin or model.safetensors under {path!r}")
    return {k: v.detach().float() for k, v in sd.items()}


def lm_from_pretrained(path: str, dtype: torch.dtype = torch.float32,
                       device: Union[str, torch.device, None] = None
                       ) -> MambaLMHeadModel:
    """A local checkpoint directory → :class:`MambaLMHeadModel` with its
    weights, on ``device`` (the first CUDA device if None, which raises
    where there is none) in eval mode. The config's keys are the
    reference's: ``d_model``, ``n_layer``, ``vocab_size``,
    ``ssm_cfg.d_state``, ``rms_norm``, ``norm_epsilon`` and
    ``pad_vocab_size_multiple``; the checkpoint's embedding must already
    hold the padded vocabulary, as the reference pads at construction."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("lm_from_pretrained: no CUDA device; pass "
                               "device='cpu' to load on the CPU")
        device = torch.device("cuda", 0)
    cfg = load_config_hf(path)
    sd = load_state_dict_hf(path)
    ssm_cfg = cfg.get("ssm_cfg") or {}
    multiple = int(cfg.get("pad_vocab_size_multiple", 8))
    model = MambaLMHeadModel(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        n_layer=cfg["n_layer"], d_state=int(ssm_cfg.get("d_state", 16)),
        rms_norm=bool(cfg.get("rms_norm", True)),
        norm_eps=float(cfg.get("norm_epsilon", 1e-5)),
        pad_vocab_multiple=multiple, dtype=dtype)
    rows = sd["backbone.embedding.weight"].shape[0]
    if rows != model.padded_vocab:
        raise ValueError(
            f"embedding rows {rows} != padded vocab {model.padded_vocab} "
            f"(vocab_size={cfg['vocab_size']}, multiple={multiple})")
    sd.pop("lm_head.weight", None)  # tied to the embedding
    model.load_state_dict(sd)
    return model.to(device).eval()
