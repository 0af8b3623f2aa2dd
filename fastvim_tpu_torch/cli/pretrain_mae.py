"""MAE (FastMaskVim) pretraining.

Counterpart of ``fastvim_tpu/cli/pretrain_mae.py``:
  python -m fastvim_tpu_torch.cli.pretrain_mae --config_name \
      pretrain_FastVimB --model_save_dir out/ [--data_dir /imagenet] \
      [--resume] [--device cpu] [key=value ...]

AdamW with betas (0.9, 0.95) over the MAE recipe's loader
(``mae=True``), lr = blr · effective batch / 256 with ``accum_iter``
steps accumulated. The model is built from ``seed + 1``; the mask
generator is seeded with ``seed`` and re-seeded from (``seed``, step)
before every step, so that ``--resume`` continues a run exactly.
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
        make_mae_train_step,
        make_optimizer,
    )
    from fastvim_tpu_torch.train.loop import run_training

    model = create_model(
        cfg["model"], device=device,
        generator=torch.Generator().manual_seed(cfg["seed"] + 1),
        img_size=cfg["img_size"],
        **({"patch_size": cfg["patch_size"]} if "patch_size" in cfg else {}),
        norm_pix_loss=cfg.get("norm_pix_loss", True),
        scanpath_type=cfg.get("scanpath_type", "rowwise"),
        rotate_every_block=cfg.get("rotate_every_block", True),
        collapse_method=cfg.get("collapse_method", "mean"),
        use_norm_after_ssm=cfg.get("use_norm_after_ssm", True),
        remat=cfg.get("remat", False))
    replicate(model)

    loader = create_imagenet_loader(
        cfg["data"].get("dir"), "train", cfg["batch_size"],
        cfg["img_size"], training=True, mae=True,
        num_workers=cfg.get("num_workers", 4), seed=cfg["seed"],
        synthetic_samples=args.synthetic_samples)

    steps_per_epoch = max(len(loader), 1)
    accum = cfg.get("accum_iter", 1)
    eff_batch = cfg["batch_size"] * world_size() * accum
    base_lr = cfg["blr"] * eff_batch / 256.0
    lr_schedule = cosine_with_warmup(
        base_lr, cfg.get("min_lr", 0.0),
        cfg["training_epochs"] * steps_per_epoch // accum,
        cfg["warmup_epochs"] * steps_per_epoch // accum)
    tx = make_optimizer(lr_schedule, weight_decay=cfg["weight_decay"],
                        params=model, betas=(0.9, 0.95), accum_steps=accum)
    state = TrainState.create(model, tx)
    train_step = make_mae_train_step(
        model, mask_ratio=cfg.get("mask_ratio", 0.75),
        generator=torch.Generator(device=device).manual_seed(cfg["seed"]))
    return run_training(
        state=state, train_step=train_step, train_loader=loader,
        epochs=cfg["training_epochs"], save_dir=args.model_save_dir,
        resume=args.resume)


if __name__ == "__main__":
    main()
