from fastvim_tpu_torch.models.blocks import Block, rotate_grid
from fastvim_tpu_torch.models.mixer import MambaMixer
from fastvim_tpu_torch.models.patch_embed import PatchEmbed
from fastvim_tpu_torch.models.registry import create_model, list_models
from fastvim_tpu_torch.models.vision_mamba import VisionMamba

__all__ = [
    "Block",
    "MambaMixer",
    "PatchEmbed",
    "VisionMamba",
    "create_model",
    "list_models",
    "rotate_grid",
]
