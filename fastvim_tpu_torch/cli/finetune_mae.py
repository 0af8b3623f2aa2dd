"""MAE → supervised finetuning, with layer-wise LR decay and
``scaling_factor`` 0.25.

Counterpart of ``fastvim_tpu/cli/finetune_mae.py``:
  python -m fastvim_tpu_torch.cli.finetune_mae --config_name \
      finetune_FastVimB --model_save_dir out/ \
      pretrained_checkpoint_path=out_pretrain/ckpt/step_N [--device cpu]

The classifier takes the pretrain checkpoint's raw weights through
``load_pretrained_backbone`` (its ``pos_embed`` is filled with the
sin-cos table, resized when the grids differ: ``pretrain_img_size``
names the pretrain resolution, 224 unless given; the head keeps its
init). Mixup / cutmix are off when both alphas are 0. ``remat=true``
recomputes each block in the backward pass.
"""

from __future__ import annotations

import torch

from fastvim_tpu_torch.cli.common import (
    base_parser,
    cli_device,
    load_cli_config,
    setup_mesh,
    world_size,
)


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    cfg = load_cli_config(args, "mae")
    device = cli_device(args.device)
    setup_mesh(device)

    from fastvim_tpu_torch.data import create_imagenet_loader
    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.parallel import replicate
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
        make_supervised_eval_step,
        make_supervised_train_step,
    )
    from fastvim_tpu_torch.train.checkpoint import load_pretrained_backbone
    from fastvim_tpu_torch.train.loop import run_training

    model = create_model(
        cfg["model"], device=device,
        generator=torch.Generator().manual_seed(cfg["seed"] + 1),
        img_size=cfg["img_size"], num_classes=cfg["num_classes"],
        **({"patch_size": cfg["patch_size"]} if "patch_size" in cfg else {}),
        drop_path_rate=cfg.get("drop_path_rate", 0.3),
        scaling_factor=cfg.get("scaling_factor", 0.25),
        scanpath_type=cfg.get("scanpath_type", "rowwise"),
        collapse_method=cfg.get("collapse_method", "mean"),
        layer_fused=cfg.get("layer_fused", "auto"),
        remat=cfg.get("remat", False))

    ckpt = cfg.get("pretrained_checkpoint_path")
    if ckpt:
        patch = cfg["patch_size"]
        grid = cfg["img_size"] // patch
        pre = cfg.get("pretrain_img_size", 224) // patch
        model.load_state_dict(load_pretrained_backbone(
            ckpt, model.state_dict(), prefer_ema=False,
            new_grid=(grid, grid), old_grid=(pre, pre),
            scanpath_type=cfg.get("scanpath_type", "rowwise")))
    replicate(model)

    train_loader = create_imagenet_loader(
        cfg["data"].get("dir"), "train", cfg["batch_size"],
        cfg["img_size"], training=True, seed=cfg["seed"],
        synthetic_samples=args.synthetic_samples)
    val_loader = create_imagenet_loader(
        cfg["data"].get("dir"), "val", cfg["batch_size"], cfg["img_size"],
        training=False, synthetic_samples=args.synthetic_samples)

    steps_per_epoch = max(len(train_loader), 1)
    base_lr = cfg["blr"] * cfg["batch_size"] * world_size() / 256.0
    lr_schedule = cosine_with_warmup(
        base_lr, cfg.get("min_lr", 1e-5),
        cfg["training_epochs"] * steps_per_epoch,
        cfg["warmup_epochs"] * steps_per_epoch)
    clip = cfg.get("gradient_clip_val", -1)
    tx = make_optimizer(
        lr_schedule, weight_decay=cfg["weight_decay"], params=model,
        layer_decay=cfg.get("layer_decay", 0.65), depth=len(model.layers),
        grad_clip=None if clip is None or clip < 0 else clip)
    state = TrainState.create(model, tx, ema=False)

    # beta(0, 0) draws are NaN: mixup and cutmix are off when both are 0
    mixup_cfg = None
    if cfg.get("mixup", 0.8) or cfg.get("cutmix", 1.0):
        mixup_cfg = dict(mixup_alpha=cfg.get("mixup", 0.8),
                         cutmix_alpha=cfg.get("cutmix", 1.0),
                         prob=cfg.get("mixup_prob", 1.0),
                         switch_prob=cfg.get("mixup_switch_prob", 0.5))
    train_step = make_supervised_train_step(
        model, cfg["num_classes"], mixup_config=mixup_cfg,
        label_smoothing=cfg.get("label_smoothing", 0.1), ema_decay=None,
        generator=torch.Generator(device=device).manual_seed(cfg["seed"]))
    return run_training(
        state=state, train_step=train_step, train_loader=train_loader,
        epochs=cfg["training_epochs"],
        eval_step=make_supervised_eval_step(model), eval_loader=val_loader,
        save_dir=args.model_save_dir, resume=args.resume)


if __name__ == "__main__":
    main()
