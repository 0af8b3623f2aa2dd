"""JUMP-CP cell-imaging classification (FastChannelVim).

Counterpart of ``fastvim_tpu/cli/train_cells.py``:
  python -m fastvim_tpu_torch.cli.train_cells --config_name \
      FastChannelVimS --model_save_dir out/ [--device cpu] \
      [data.manifest=/path/manifest.csv] [key=value ...]

Without ``data.manifest`` it trains on synthetic 8-channel images
(``--synthetic_samples`` for training, a quarter as many for eval). HCS
(hierarchical channel sampling) runs on the host: each training batch
keeps the channels of one ``hcs_sample`` draw, seeded from the stream
``np.random.default_rng(seed)``; eval batches keep every channel. The
model is built from ``seed + 1`` and the DropPath / dropout generator is
seeded with ``seed``. On ``--resume`` the HCS stream is advanced by the
steps already taken, so that a resumed run draws the channels an
uninterrupted one would (the JAX CLI restarts it). Under ``torchrun``
``batch_size`` is the global batch, split over the ranks, with the same
channels on every rank.

Note: the model fields from the config override the registry's, as in
the JAX package; so ``ChannelVimS.yaml``, which names the unpooled
``channelvim_small_ps16_baseline``, trains a mean-pooled model
(``collapse_method: mean``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fastvim_tpu_torch.cli.common import (
    base_parser,
    cli_device,
    load_cli_config,
    setup_mesh,
    world_size,
)


class HCSLoader:
    """A loader whose batches, in training, keep one ``hcs_sample`` draw
    of the channels each, with their ids as "channel_ids". ``epoch``
    passes through to the wrapped loader; setting it on a fresh wrapper
    first advances the channel draws past the epochs before it. Every
    rank draws the same channels: the stream is seeded alike and takes
    one draw a batch."""

    def __init__(self, loader, num_channels: int, seed: Optional[int]):
        self.loader = loader
        self.num_channels = num_channels
        self.rng = None if seed is None else np.random.default_rng(seed)
        self.draws = 0

    def __len__(self):
        return len(self.loader)

    @property
    def epoch(self) -> int:
        return self.loader.epoch

    @epoch.setter
    def epoch(self, epoch: int) -> None:
        self.loader.epoch = epoch
        if self.rng is not None:
            for _ in range(epoch * len(self) - self.draws):
                self._draw()

    def _draw(self) -> int:
        self.draws += 1
        return int(self.rng.integers(2 ** 31))

    def __iter__(self):
        from fastvim_tpu_torch.models.channel import hcs_sample

        for batch in self.loader:
            if self.rng is not None:
                chans = hcs_sample(self._draw(), self.num_channels)
                batch = {"image": batch["image"][..., chans],
                         "label": batch["label"],
                         "channel_ids": np.asarray(chans, np.int32)}
            yield batch


def create_channel_model(cfg, device: torch.device):
    """The config's ChannelVim model, in fp32, from ``seed + 1``."""
    from fastvim_tpu_torch.models import create_model

    return create_model(
        cfg["model"], device=device,
        generator=torch.Generator().manual_seed(cfg["seed"] + 1),
        img_size=cfg["img_size"], num_classes=cfg["num_classes"],
        channels=cfg.get("channels", 8),
        drop_path_rate=cfg.get("drop_path_rate", 0.05),
        scan_order=cfg.get("scan_order", "Channel-First"),
        scanpath_type=cfg.get("scanpath_type", "rowwise"),
        collapse_method=cfg.get("collapse_method", "mean"),
        remat=cfg.get("remat", False))


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    cfg = load_cli_config(args, "cells")
    device = cli_device(args.device)
    setup_mesh(device)

    from fastvim_tpu_torch.data.cells import (
        CellDataset,
        CellLoader,
        SyntheticCellDataset,
    )
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
        make_supervised_eval_step,
        make_supervised_train_step,
        scale_lr,
    )
    from fastvim_tpu_torch.parallel import replicate
    from fastvim_tpu_torch.train.loop import run_training

    num_ch = cfg.get("channels", 8)
    model = replicate(create_channel_model(cfg, device))

    manifest = cfg["data"].get("manifest")
    if manifest:
        train_ds = CellDataset(manifest, "train", cfg["seed"])
        val_ds = CellDataset(manifest, "val", cfg["seed"])
    else:
        train_ds = SyntheticCellDataset(
            args.synthetic_samples, cfg["img_size"], num_ch,
            cfg["num_classes"])
        val_ds = SyntheticCellDataset(
            args.synthetic_samples // 4, cfg["img_size"], num_ch,
            cfg["num_classes"])
    mean = cfg["data"].get("normalization_mean")
    std = cfg["data"].get("normalization_std")
    train_loader = CellLoader(train_ds, cfg["batch_size"], cfg["img_size"],
                              training=True, seed=cfg["seed"],
                              mean=mean, std=std)
    val_loader = CellLoader(val_ds, cfg["batch_size"], cfg["img_size"],
                            training=False, mean=mean, std=std)

    steps_per_epoch = max(len(train_loader), 1)
    base_lr = scale_lr(cfg["lr"], cfg["batch_size"], world_size(),
                       cfg.get("scaling_rule", "linear"))
    total = cfg["training_epochs"] * steps_per_epoch
    lr_schedule = cosine_with_warmup(
        base_lr, cfg["min_lr"], total,
        cfg["warmup_epochs"] * steps_per_epoch,
        cfg.get("warmup_initial_lr", 0.0))
    # weight decay on a cosine schedule too
    wd_schedule = cosine_with_warmup(
        cfg["weight_decay"],
        cfg.get("weight_decay_end", cfg["weight_decay"]), total)
    tx = make_optimizer(lr_schedule, params=model, wd_schedule=wd_schedule)
    state = TrainState.create(model, tx, ema=False)

    train_step = make_supervised_train_step(
        model, cfg["num_classes"], mixup_config=None,
        label_smoothing=cfg.get("label_smoothing", 0.0), ema_decay=None,
        generator=torch.Generator(device=device).manual_seed(cfg["seed"]),
        channel_model=True)
    eval_step = make_supervised_eval_step(model, channel_model=True)

    hcs_seed = cfg["seed"] if cfg.get("hcs", True) else None
    return run_training(
        state=state, train_step=train_step,
        train_loader=HCSLoader(train_loader, num_ch, hcs_seed),
        epochs=cfg["training_epochs"], eval_step=eval_step,
        eval_loader=val_loader, save_dir=args.model_save_dir,
        resume=args.resume)


if __name__ == "__main__":
    main()
