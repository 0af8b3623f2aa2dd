"""Supervised ImageNet-1k classification training.

Counterpart of ``fastvim_tpu/cli/train_classification.py``:
  python -m fastvim_tpu_torch.cli.train_classification --config_name \
      FastVimT --model_save_dir out/ [--data_dir /imagenet] \
      [--device cpu] [key=value ...]

Two data paths, as in the JAX package: the threaded host loader
(``data/loader.py``), and with ``data.device_resident`` the digits set
held on the device (``data/device.py``). The model is built from
``seed + 1``; the mixup / DropPath generator is seeded with ``seed`` and
the train step re-seeds it from (``seed``, step) before every step, so
that ``--resume`` continues a run exactly.

Data parallel over N ranks: ``torchrun --standalone --nproc_per_node N
-m fastvim_tpu_torch.cli.train_classification --config_name FastVimT
...``; ``batch_size`` is the global batch, the LR is scaled by
(``batch_size``, world size) as the JAX CLI scales it, and
``grad_allreduce_dtype: bfloat16`` averages the gradients over ranks in
bf16 (``train/trainer.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from fastvim_tpu_torch.cli.common import (
    base_parser,
    cli_device,
    load_cli_config,
    setup_mesh,
    world_size,
)


def create_classifier(cfg: Dict[str, Any], device: torch.device,
                      drop_path_rate: float):
    """The config's model, in fp32, initialized from ``seed + 1``."""
    from fastvim_tpu_torch.models import create_model

    return create_model(
        cfg["model"], device=device,
        generator=torch.Generator().manual_seed(cfg["seed"] + 1),
        img_size=cfg["img_size"], patch_size=cfg.get("patch_size", 16),
        num_classes=cfg["num_classes"], drop_path_rate=drop_path_rate,
        scanpath_type=cfg.get("scanpath_type", "rowwise"),
        rotate_every_block=cfg.get("rotate_every_block", True),
        collapse_method=cfg.get("collapse_method", "mean"),
        use_norm_after_ssm=cfg.get("use_norm_after_ssm", True),
        layer_fused=cfg.get("layer_fused", "auto"),
        remat=cfg.get("remat", False))


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    cfg = load_cli_config(args, "classification")
    device = cli_device(args.device)
    setup_mesh(device)

    from fastvim_tpu_torch.data import create_imagenet_loader
    from fastvim_tpu_torch.parallel import replicate
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
        make_supervised_eval_step,
        make_supervised_train_step,
        scale_lr,
    )
    from fastvim_tpu_torch.train.loop import run_training

    model = replicate(create_classifier(cfg, device, cfg["drop_path_rate"]))

    device_resident = bool(cfg["data"].get("device_resident", False))
    train_loader = val_loader = None
    if device_resident:
        if cfg["data"].get("dir") != "digits":
            raise ValueError("data.device_resident supports data.dir="
                             "digits (in-memory datasets) for now")
        from fastvim_tpu_torch.data.device import load_device_digits

        dev_data = load_device_digits(cfg["img_size"], device,
                                      seed=cfg["seed"])
        steps_per_epoch = max(
            int(dev_data[0].shape[0]) // cfg["batch_size"], 1)
    else:
        train_loader = create_imagenet_loader(
            cfg["data"].get("dir"), "train", cfg["batch_size"],
            cfg["img_size"], training=True,
            num_workers=cfg.get("num_workers", 4), seed=cfg["seed"],
            synthetic_samples=args.synthetic_samples)
        val_loader = create_imagenet_loader(
            cfg["data"].get("dir"), "val", cfg["batch_size"],
            cfg["img_size"], training=False,
            synthetic_samples=args.synthetic_samples)
        steps_per_epoch = max(len(train_loader), 1)
    base_lr = scale_lr(cfg["lr"], cfg["batch_size"], world_size(),
                       cfg.get("scaling_rule", "deit"))
    lr_schedule = cosine_with_warmup(
        base_lr, cfg["min_lr"],
        cfg["training_epochs"] * steps_per_epoch,
        cfg["warmup_epochs"] * steps_per_epoch,
        cfg.get("warmup_initial_lr", 0.0))
    tx = make_optimizer(lr_schedule, weight_decay=cfg["weight_decay"],
                        params=model)
    state = TrainState.create(model, tx,
                              ema=cfg.get("use_ema_weights", True))

    mixup_cfg = None
    if cfg.get("mixup", 0) or cfg.get("cutmix", 0):
        mixup_cfg = dict(mixup_alpha=cfg.get("mixup", 0.8),
                         cutmix_alpha=cfg.get("cutmix", 1.0),
                         prob=cfg.get("mixup_prob", 1.0),
                         switch_prob=cfg.get("mixup_switch_prob", 0.5))
    # "bfloat16": the compressed gradient all-reduce of several ranks
    gard = cfg.get("grad_allreduce_dtype")
    train_step = make_supervised_train_step(
        model, cfg["num_classes"], mixup_config=mixup_cfg,
        label_smoothing=cfg.get("label_smoothing", 0.1),
        ema_decay=cfg.get("ema_decay", 0.9999)
        if cfg.get("use_ema_weights", True) else None,
        generator=torch.Generator(device=device).manual_seed(cfg["seed"]),
        grad_allreduce_dtype=getattr(torch, gard) if gard else None)

    if device_resident:
        from fastvim_tpu_torch.data.device import (
            make_device_augment,
            make_device_epoch_fn,
            make_device_eval_fn,
        )

        tr_u8, tr_y, val_x, val_y, _ = dev_data
        epoch_fn, spe = make_device_epoch_fn(
            train_step, tr_u8, tr_y, cfg["batch_size"],
            make_device_augment(cfg["img_size"]), seed=cfg["seed"])
        eval_fn = make_device_eval_fn(model, val_x, val_y,
                                      cfg["batch_size"])
        return run_training(
            state=state, epochs=cfg["training_epochs"], epoch_fn=epoch_fn,
            eval_fn=eval_fn, steps_per_epoch=spe,
            save_dir=args.model_save_dir, resume=args.resume)

    return run_training(
        state=state, train_step=train_step, train_loader=train_loader,
        epochs=cfg["training_epochs"],
        eval_step=make_supervised_eval_step(model), eval_loader=val_loader,
        save_dir=args.model_save_dir, resume=args.resume)


if __name__ == "__main__":
    main()
