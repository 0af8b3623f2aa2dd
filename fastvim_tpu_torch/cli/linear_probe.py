"""MAE linear probe: a frozen backbone, then BatchNorm without affine and
a linear head.

Counterpart of ``fastvim_tpu/cli/linear_probe.py``:
  python -m fastvim_tpu_torch.cli.linear_probe --config_name \
      linear_FastVimL pretrained_checkpoint_path=out/ckpt/step_N \
      [model=fastvim_base batch_size=128] [--device cpu]

The backbone (the config's model without its head) takes the checkpoint's
raw weights through ``load_pretrained_backbone`` and runs in eval mode
under ``torch.no_grad()``; only the head is trained, by SGD with momentum
over the MAE recipe's loader. The returned state's ``backbone`` is that
model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
from torch import nn

from fastvim_tpu_torch.cli.common import (
    base_parser,
    cli_device,
    load_cli_config,
    setup_mesh,
    world_size,
)
from fastvim_tpu_torch.models.layers import trunc_normal_init_
from fastvim_tpu_torch.parallel import batch_moments
from fastvim_tpu_torch.train.state import TrainState


class ProbeBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(use_bias=False, use_scale=False,
    momentum=0.9, epsilon=1e-6)`` over the batch axis: in training, the
    batch's mean and its biased variance E[x²] − E[x]² (clamped at 0),
    and running statistics r ← 0.9·r + 0.1·s; in eval, the running
    statistics. (``nn.BatchNorm1d`` would update its running variance with
    the unbiased one.) Over several ranks the moments are the global
    batch's (``parallel.batch_moments``)."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-6):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, mean_sq = batch_moments(x.float(), (0,))
            var = (mean_sq - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return ((x - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class ProbeHead(nn.Module):
    """BatchNorm (no affine) → Linear, the head initialized truncated
    normal 0.01 and the bias 0."""

    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.bn = ProbeBatchNorm(dim)
        self.head = nn.Linear(dim, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_init_(self.head.weight, 0.01, generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.head(self.bn(feats))


@dataclass
class ProbeState(TrainState):
    """The head's train state, with the frozen backbone beside it (not
    saved in checkpoints)."""
    backbone: Optional[nn.Module] = None


def make_probe_eval_step(backbone: nn.Module, head: nn.Module):
    """``eval_step(batch) -> {"loss", "acc"}`` of the probe,
    both models in eval mode."""
    from fastvim_tpu_torch.train import accuracy, cross_entropy

    @torch.no_grad()
    def eval_step(batch: Mapping[str, torch.Tensor]):
        backbone.eval()
        head.eval()
        logits = head(backbone(batch["image"], return_features=True))
        return {"loss": cross_entropy(logits, batch["label"]),
                "acc": accuracy(logits, batch["label"])}

    return eval_step


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    cfg = load_cli_config(args, "mae")
    device = cli_device(args.device)
    setup_mesh(device)

    from fastvim_tpu_torch.data import create_imagenet_loader
    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.parallel import replicate
    from fastvim_tpu_torch.train import (
        cosine_with_warmup,
        make_linear_probe_step,
        make_sgd,
    )
    from fastvim_tpu_torch.train.checkpoint import load_pretrained_backbone
    from fastvim_tpu_torch.train.loop import run_training

    backbone = create_model(
        cfg["model"], device=device,
        generator=torch.Generator().manual_seed(cfg["seed"] + 1),
        img_size=cfg["img_size"], num_classes=0,
        **({"patch_size": cfg["patch_size"]} if "patch_size" in cfg else {}),
        drop_path_rate=0.0, scaling_factor=cfg.get("scaling_factor", 0.25),
        layer_fused=cfg.get("layer_fused", "auto"))
    if cfg.get("pretrained_checkpoint_path"):
        backbone.load_state_dict(load_pretrained_backbone(
            cfg["pretrained_checkpoint_path"], backbone.state_dict(),
            prefer_ema=False))
    backbone.requires_grad_(False)
    head = ProbeHead(backbone.embed_dim, cfg["num_classes"])
    head.reset_parameters(torch.Generator().manual_seed(cfg["seed"] + 2))
    head.to(device)
    replicate(backbone)
    replicate(head)

    train_loader = create_imagenet_loader(
        cfg["data"].get("dir"), "train", cfg["batch_size"],
        cfg["img_size"], training=True, mae=True, seed=cfg["seed"],
        synthetic_samples=args.synthetic_samples)
    val_loader = create_imagenet_loader(
        cfg["data"].get("dir"), "val", cfg["batch_size"], cfg["img_size"],
        training=False, synthetic_samples=args.synthetic_samples)

    steps_per_epoch = max(len(train_loader), 1)
    base_lr = cfg["blr"] * cfg["batch_size"] * world_size() / 256.0
    lr_schedule = cosine_with_warmup(
        base_lr, cfg.get("min_lr", 0.0),
        cfg["training_epochs"] * steps_per_epoch,
        cfg["warmup_epochs"] * steps_per_epoch)
    tx = make_sgd(lr_schedule, momentum=cfg.get("momentum", 0.9),
                  weight_decay=cfg.get("weight_decay", 0.0), params=head)
    state = ProbeState(model=head, tx=tx, backbone=backbone)
    return run_training(
        state=state, train_step=make_linear_probe_step(backbone),
        train_loader=train_loader, epochs=cfg["training_epochs"],
        eval_step=make_probe_eval_step(backbone, head),
        eval_loader=val_loader, save_dir=args.model_save_dir,
        resume=args.resume)


if __name__ == "__main__":
    main()
