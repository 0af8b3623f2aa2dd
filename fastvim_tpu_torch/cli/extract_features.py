"""Feature-extractor entry point for segmentation / detection backbones.

Counterpart of ``fastvim_tpu/cli/extract_features.py``: build the
config's backbone in feature mode (``out_indices``), load a checkpoint
(the EMA copy first, the pos-embed resized from the 224 px grid to the
task's), and print the shapes of its NHWC feature maps, and with
``--with_fpn`` those of the SimpleFPN pyramid on the last map:

  python -m fastvim_tpu_torch.cli.extract_features \
      --config_name upernet_FastVimT_ade20k [--images a.png b.jpg] \
      [--checkpoint ckpt/step_N] [--with_fpn] [--device cpu]

Without ``--images`` one random image (a normal draw from seed 1) goes
through. The backbone is built from seed 0, the FPN from seed 2. Under
``torchrun`` rank r takes images r, r+N, ... (a rank without one prints
and returns nothing).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fastvim_tpu_torch.cli.common import cli_device, setup_mesh
from fastvim_tpu_torch.config import load_config


def build_backbone(cfg, device: torch.device, checkpoint=None):
    """The config's backbone with ``out_indices``, on ``device`` in eval
    mode, with ``checkpoint`` (or the config's
    ``pretrained_checkpoint_path``) loaded into it."""
    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.train.checkpoint import load_pretrained_backbone

    model = create_model(
        cfg["model"], device=device,
        generator=torch.Generator().manual_seed(0), img_size=cfg["img_size"],
        num_classes=0, drop_path_rate=0.0,
        out_indices=tuple(cfg["out_indices"]),
        layer_fused=cfg.get("layer_fused", "auto"))
    ckpt = checkpoint or cfg.get("pretrained_checkpoint_path")
    if ckpt:
        g = cfg["img_size"] // cfg["patch_size"]
        model.load_state_dict(load_pretrained_backbone(
            ckpt, model.state_dict(), prefer_ema=cfg.get("load_ema", True),
            new_grid=(g, g), old_grid=(224 // cfg["patch_size"],) * 2))
    return model


@torch.no_grad()
def main(argv=None):
    """Returns {"features": the maps, "pyramid": the FPN's maps or
    None}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config_name", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--images", nargs="*", default=None)
    p.add_argument("--with_fpn", action="store_true",
                   help="apply the SimpleFPN neck (detection)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the first CUDA device)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    cfg = load_config(args.config_name, overrides=args.overrides)
    device = cli_device(args.device)
    mesh, _ = setup_mesh(device)

    model = build_backbone(cfg, device, args.checkpoint)
    size = cfg["img_size"]
    if args.images:
        from PIL import Image

        from fastvim_tpu_torch.data.transforms import eval_transform

        arrs = []
        for f in args.images:
            with Image.open(f) as img:
                arrs.append(eval_transform(img, size))
        x = torch.from_numpy(np.stack(arrs).astype(np.float32))
    else:
        x = torch.randn(1, size, size, 3,
                        generator=torch.Generator().manual_seed(1))
    x = x[mesh.data_index::mesh.data]
    if not len(x):
        return {"features": [], "pyramid": None}
    feats = model(x.to(device))
    print("feature maps:", [tuple(f.shape) for f in feats])
    pyramid = None
    if args.with_fpn:
        from fastvim_tpu_torch.models.heads import SimpleFPN

        neck_cfg = cfg.get("neck", {})
        fpn = SimpleFPN(model.embed_dim,
                        out_channels=neck_cfg.get("out_channels", 256),
                        num_outs=neck_cfg.get("num_outs", 5))
        fpn.reset_parameters(torch.Generator().manual_seed(2))
        pyramid = fpn.to(device)(feats[-1])
        print("fpn pyramid:", [tuple(f.shape) for f in pyramid])
    return {"features": feats, "pyramid": pyramid}


if __name__ == "__main__":
    main()
