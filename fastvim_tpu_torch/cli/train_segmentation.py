"""ADE20K semantic segmentation training (UperNet over FastVim).

Counterpart of ``fastvim_tpu/cli/train_segmentation.py``:
  python -m fastvim_tpu_torch.cli.train_segmentation \
      --config_name upernet_FastVimT_ade20k --model_save_dir out/ \
      [--data_dir /data/ADEChallengeData2016] [--total_iters N] \
      [--eval_every N] [--eval_only] [--resume] [--device cpu] \
      [pretrained_checkpoint_path=/ckpt] [key=value ...]

The ADE20K folder when ``--data_dir`` (or ``data.dir``) holds one, else
synthetic images (``--synthetic_samples`` for training, at most 8 for
eval). Poly LR with linear warmup, AdamW (weight decay on the tensors of
more than one dimension outside the no-decay names, as the JAX CLI: the
config's ``no_decay_keys`` and ``betas`` are not read), the FCN aux loss
at 0.4, and every ``--eval_every`` iterations (and at the last) a
slide-inference mIoU eval (crop = ``img_size``, stride 2/3 of it; the
config's ``test.stride`` is not read either), a row of ``log.csv``
(iter, train_loss, steps_per_sec of the iterations since the last row,
mIoU) and a checkpoint. ``pretrained_checkpoint_path`` loads a standalone
backbone checkpoint under ``backbone.``; entries of another shape (a
224 px ``pos_embed``) keep their init. The model is built from ``seed``
(default 0) and the dropout generator is re-seeded from (``seed``, step)
before every step, so ``--resume`` continues a run where it stopped:
the loader at the same batch of the same epoch, the same log rows.
``--eval_only`` prints the mIoU of the newest checkpoint (or of the
init).

Each stretch of training iterations between two evals runs under
``torch.profiler.record_function("train_iters")``: a profiler trace reads
the device's idle share over it.

Under ``torchrun`` ``batch_size`` is the global batch, split over the
ranks; the gradients and the logged loss are averaged over ranks, the
``head_norm: bn`` statistics are the global batch's, each rank evaluates
its share of the val batches and the confusion matrices are summed over
ranks, and rank 0 alone writes ``log.csv`` and the checkpoints.
"""

from __future__ import annotations

import os
import time

import torch

from fastvim_tpu_torch.cli.common import (
    base_parser,
    cli_device,
    load_cli_config,
    setup_mesh,
)


def poly_schedule(base_lr: float, total_iters: int, power: float = 1.0,
                  min_lr: float = 0.0, warmup_iters: int = 1500,
                  warmup_ratio: float = 1e-6):
    """lr(step): linear warmup from ``warmup_ratio · base_lr`` over
    ``warmup_iters``, then ``(base_lr − min_lr) · (1 − t)^power + min_lr``
    with t = step / total_iters clipped to [0, 1]."""

    def schedule(step: float) -> float:
        step = float(step)
        if step < warmup_iters:
            return base_lr * (warmup_ratio + (1 - warmup_ratio) * step
                              / max(warmup_iters, 1))
        t = min(max(step / total_iters, 0.0), 1.0)
        return (base_lr - min_lr) * (1 - t) ** power + min_lr

    return schedule


def build_segmentor(cfg, device: torch.device):
    """The config's UperNet segmentor: the registry's backbone in feature
    mode (``out_indices``, no drop path) and the heads, all initialized
    from ``torch.Generator().manual_seed(seed)``, in eval mode on
    ``device``."""
    from fastvim_tpu_torch.models import UperNetSegmentor, create_model

    gen = torch.Generator().manual_seed(cfg.get("seed", 0))
    backbone = create_model(
        cfg["model"], device=device, generator=gen, img_size=cfg["img_size"],
        num_classes=0, drop_path_rate=0.0,
        out_indices=tuple(cfg["out_indices"]),
        layer_fused=cfg.get("layer_fused", "auto"))
    # "bn" = the reference's SyncBN decode-head recipe; "ln" the default
    seg = UperNetSegmentor(backbone, num_classes=cfg["num_classes"],
                           aux_index=cfg.get("aux_index", 2),
                           norm=cfg.get("head_norm", "ln"))
    seg.decode_head.reset_parameters(gen)
    seg.aux_head.reset_parameters(gen)
    return seg.to(device).eval()


@torch.no_grad()
def evaluate_miou(seg, val_loader, num_classes: int, crop: int) -> float:
    """Slide-inference mIoU over a loader: images larger than ``crop``
    go through ``slide_inference`` (stride 2/3 of the crop), the others
    through one forward; the confusion matrix sums over the batches."""
    from fastvim_tpu_torch.models.upernet import slide_inference
    from fastvim_tpu_torch.parallel import sum_over_ranks
    from fastvim_tpu_torch.train.loop import to_device
    from fastvim_tpu_torch.train.metrics import (
        confusion_matrix,
        miou_from_confusion,
    )

    seg.eval()
    device = next(seg.parameters()).device
    cm = torch.zeros(num_classes, num_classes, dtype=torch.float64,
                     device=device)
    for batch in val_loader:
        batch = to_device(batch, device)
        images = batch["image"]
        H, W = images.shape[1:3]
        if H > crop or W > crop:
            logits = slide_inference(seg, images, crop=crop,
                                     stride=int(crop * 2 / 3),
                                     num_classes=num_classes)
        else:
            logits = seg(images)
        cm += confusion_matrix(logits.argmax(-1), batch["label"],
                               num_classes).double()
    sum_over_ranks(cm)
    return float(miou_from_confusion(cm.float().cpu()))


def make_seg_train_step(seg, generator: torch.Generator):
    """``train_step(state, batch) -> 0-d loss``: the segmentor in training
    mode with its aux head, ``segmentation_loss``, the gradients averaged
    over ranks, one optimizer update; the loss is the global batch's.
    ``generator`` (on the model's device) feeds the dropouts; it is
    re-seeded from (its seed, state.step) before every step."""
    from fastvim_tpu_torch.models.upernet import segmentation_loss
    from fastvim_tpu_torch.parallel import allreduce_grads, mean_over_ranks
    from fastvim_tpu_torch.train.trainer import fold_seed

    seed = generator.initial_seed()
    seg.set_drop_path_generator(generator)

    def train_step(state, batch):
        seg.train()
        generator.manual_seed(fold_seed(seed, state.step))
        logits, aux = seg(batch["image"], with_aux=True)
        loss = segmentation_loss(logits, batch["label"], aux)
        params = state.params
        grads = torch.autograd.grad(loss, list(params.values()))
        state.apply_gradients(allreduce_grads(dict(zip(params, grads))))
        return mean_over_ranks({"loss": loss.detach()})["loss"]

    return train_step


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--total_iters", type=int, default=None)
    p.add_argument("--eval_only", action="store_true",
                   help="checkpoint-in → mIoU-out, no training")
    p.add_argument("--eval_every", type=int, default=16000,
                   help="iterations between mIoU evals (schedule_160k.py"
                   " CheckpointHook interval)")
    args = p.parse_args(argv)
    cfg = load_cli_config(args, "segmentation")
    device = cli_device(args.device)
    setup_mesh(device)

    from fastvim_tpu_torch.data.segmentation import create_segmentation_loader
    from fastvim_tpu_torch.parallel import barrier, is_writer, replicate
    from fastvim_tpu_torch.train import TrainState, make_optimizer
    from fastvim_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_pretrained_backbone,
        restore_checkpoint,
        save_checkpoint,
    )
    from fastvim_tpu_torch.train.loop import CSVLogger, to_device

    seg = build_segmentor(cfg, device)
    ckpt = cfg.get("pretrained_checkpoint_path")
    if ckpt:
        seg.load_state_dict(load_pretrained_backbone(
            ckpt, seg.state_dict(), prefer_ema=cfg.get("load_ema", True),
            subtree="backbone"))
    replicate(seg)

    size, num_classes = cfg["img_size"], cfg["num_classes"]
    data_dir = cfg.get("data", {}).get("dir")
    num_workers = cfg.get("num_workers", 2)
    val_loader = create_segmentation_loader(
        data_dir, "validation", cfg.get("eval_batch_size", 1), size,
        training=False, num_classes=num_classes, num_workers=num_workers,
        synthetic_samples=min(args.synthetic_samples, 8))
    ckpt_dir = (os.path.join(args.model_save_dir, "ckpt")
                if args.model_save_dir else None)

    if args.eval_only:
        path = latest_checkpoint(ckpt_dir) if ckpt_dir else None
        if path:
            seg.load_state_dict(restore_checkpoint(path, device)["params"])
        miou = evaluate_miou(seg, val_loader, num_classes, size)
        if is_writer():
            print({"mIoU": miou})
        return miou

    train_loader = create_segmentation_loader(
        data_dir, "training", cfg.get("batch_size", 2), size, training=True,
        num_classes=num_classes, num_workers=num_workers,
        synthetic_samples=args.synthetic_samples)
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        raise ValueError("the training set holds less than one batch")

    total = args.total_iters or cfg.get("total_iters", 160000)
    opt_cfg = cfg.get("optimizer", {})
    sched_cfg = cfg.get("lr_schedule", {})
    lr = poly_schedule(opt_cfg.get("lr", 6e-5), total,
                       sched_cfg.get("power", 1.0),
                       sched_cfg.get("min_lr", 0.0),
                       sched_cfg.get("warmup_iters", 1500),
                       sched_cfg.get("warmup_ratio", 1e-6))
    tx = make_optimizer(lr, weight_decay=opt_cfg.get("weight_decay", 0.01),
                        params=seg)
    state = TrainState.create(seg, tx)
    writer = is_writer()
    logger = (CSVLogger(os.path.join(args.model_save_dir, "log.csv"))
              if args.model_save_dir and writer else None)
    if args.resume and ckpt_dir:
        path = latest_checkpoint(ckpt_dir)
        if path:
            state.load_state_dict(restore_checkpoint(path, device))
            print(f"resumed from {path} at iteration {state.step}")
            if logger is not None:
                logger.truncate_from(state.step + 1, column="iter")
    train_loader.epoch, train_loader.start_batch = divmod(state.step,
                                                          steps_per_epoch)

    train_step = make_seg_train_step(
        seg, torch.Generator(device=device).manual_seed(cfg.get("seed", 0)))
    batches = _endless(train_loader)
    while state.step < total:
        stop = min((state.step // args.eval_every + 1) * args.eval_every,
                   total)
        n, t0 = stop - state.step, time.perf_counter()
        with torch.profiler.record_function("train_iters"):
            for _ in range(n):
                loss = train_step(state, to_device(next(batches), device))
                if state.step % 50 == 0 and state.step != stop and writer:
                    print({"iter": state.step, "train_loss": float(loss)})
            train_loss = float(loss)  # waits for the device
        row = {"iter": state.step, "train_loss": train_loss,
               "steps_per_sec": n / (time.perf_counter() - t0)}
        row["mIoU"] = evaluate_miou(seg, val_loader, num_classes, size)
        if writer:
            print(row)
        if logger:
            logger.log(row)
        if ckpt_dir:
            if writer:
                save_checkpoint(ckpt_dir, state)
            barrier()
    batches.close()
    return state


def _endless(loader):
    """The loader's batches, one pass (epoch) after another."""
    while True:
        yield from loader


if __name__ == "__main__":
    main()
