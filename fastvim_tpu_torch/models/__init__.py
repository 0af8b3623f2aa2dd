from fastvim_tpu_torch.models.blocks import Block, rotate_grid
from fastvim_tpu_torch.models.channel import (
    ChannelVisionMamba,
    PatchEmbedPerChannel,
    hcs_sample,
)
from fastvim_tpu_torch.models.detection import (
    CascadeMaskRCNN,
    FCNMaskHead,
    RPNHead,
    Shared2FCBBoxHead,
)
from fastvim_tpu_torch.models.heads import ChannelLayerNorm, SimpleFPN
from fastvim_tpu_torch.models.lm import MambaLM, MambaLMHeadModel, create_lm
from fastvim_tpu_torch.models.mae import MaskedAutoencoderVim
from fastvim_tpu_torch.models.mixer import MambaMixer
from fastvim_tpu_torch.models.patch_embed import PatchEmbed
from fastvim_tpu_torch.models.registry import create_model, list_models
from fastvim_tpu_torch.models.upernet import (
    FCNHead,
    PSPModule,
    UPerHead,
    UperNetSegmentor,
)
from fastvim_tpu_torch.models.vision_mamba import VisionMamba

__all__ = [
    "Block",
    "CascadeMaskRCNN",
    "ChannelLayerNorm",
    "ChannelVisionMamba",
    "FCNHead",
    "FCNMaskHead",
    "MambaLM",
    "MambaLMHeadModel",
    "MambaMixer",
    "MaskedAutoencoderVim",
    "PSPModule",
    "PatchEmbed",
    "PatchEmbedPerChannel",
    "RPNHead",
    "Shared2FCBBoxHead",
    "SimpleFPN",
    "UPerHead",
    "UperNetSegmentor",
    "VisionMamba",
    "create_lm",
    "create_model",
    "hcs_sample",
    "list_models",
    "rotate_grid",
]
