"""COCO detection training: a FastVim backbone under the ViTDet cascade
Mask R-CNN.

Counterpart of ``fastvim_tpu/cli/train_detection.py``:
  python -m fastvim_tpu_torch.cli.train_detection --config_name \
      vitdet_FastVimT_coco --model_save_dir out/ [--data_dir /data/coco] \
      [--epochs N] [--synthetic_samples N] [--eval_only] [--resume] \
      [--device cpu] [key=value ...]

The COCO folder (``<dir>/train2017`` and
``<dir>/annotations/instances_train2017.json``) when ``--data_dir`` (or
``data.dir``) holds one, else synthetic LSJ data (``--synthetic_samples``
for training, at most 8 for eval). AdamW with the config's weight decay
and the ViTDet per-layer LR decay (``optimizer.layer_decay``, 0.7), a
linear warmup over ``warmup_iters`` (250) and ×0.1 at each of
``milestones``; ``total_iters`` (184,375) sets the number of epochs
unless ``--epochs`` does. ``pretrained_checkpoint_path`` loads a
standalone backbone checkpoint under ``backbone.``. The model is built
from ``seed`` (default 0); before every step each image's sampler, a
CPU generator, is seeded from (``seed``, step, 2, the image's index in
the global batch) and the DropPath generator from (``seed``, step, 1), so
a ``--resume``d run draws what an uninterrupted one would, on any number
of ranks. ``--eval_only`` prints box and mask AP at IoU 0.5
(``box_ap50``, ``mask_ap50``) of the newest checkpoint (or of the init)
on the val split, each rank predicting its share of it. Under
``torchrun`` with more than one rank, the config's ``grad_compression:
bf16`` averages the gradients over ranks in bf16 (as the JAX CLI does on
a mesh of more than one device); on one rank it is inert.

Each epoch's training runs under ``torch.profiler.record_function(
"train_epoch")`` (``train/loop.py``).
"""

from __future__ import annotations

import os

import torch

from fastvim_tpu_torch.cli.common import (
    base_parser,
    cli_device,
    load_cli_config,
    setup_mesh,
)


def build_model(cfg, device: torch.device):
    """(the config's ``CascadeMaskRCNN``, the backbone's depth): the
    registry's backbone in feature mode (``out_indices``) and the heads,
    initialized from ``torch.Generator().manual_seed(seed)``, in eval
    mode on ``device``. ``dtype: bf16`` builds the backbone and every head
    to compute in bf16 over fp32 parameters, as the JAX CLI does."""
    from fastvim_tpu_torch.models import create_model
    from fastvim_tpu_torch.models.detection import CascadeMaskRCNN

    dtype = torch.bfloat16 if cfg.get("dtype") == "bf16" else torch.float32
    gen = torch.Generator().manual_seed(cfg.get("seed", 0))
    out_indices = cfg.get("out_indices")
    backbone = create_model(
        cfg["model"], device=device, generator=gen, img_size=cfg["img_size"],
        patch_size=cfg.get("patch_size", 16), num_classes=0,
        drop_path_rate=cfg.get("drop_path_rate", 0.0),
        layer_fused=cfg.get("layer_fused", "auto"), dtype=dtype,
        out_indices=tuple(out_indices) if out_indices else None)
    depth = cfg.get("depth") or len(backbone.layers)
    det_cfg = cfg.get("det", {})
    model = CascadeMaskRCNN(
        backbone, num_classes=cfg.get("num_classes", 80),
        backbone_channel=backbone.embed_dim, img_size=cfg["img_size"],
        rpn_sample=det_cfg.get("rpn_sample", 256),
        nms_pre=det_cfg.get("nms_pre", 1000),
        num_proposals=det_cfg.get("num_proposals", 512),
        rcnn_sample=det_cfg.get("rcnn_sample", 512), dtype=dtype)
    model.reset_parameters(gen)
    return model.to(device).eval(), depth


def make_det_train_step(model, seed: int, grad_compression=None):
    """``train_step(state, batch) -> (state, metrics)``: the detector in
    training mode on a loader batch ("image", "boxes", "labels", "masks",
    "gt_valid" on the model's device: this rank's rows of the global
    batch), its 11 losses summed, the gradients averaged over ranks (in
    bf16 with ``grad_compression`` "bf16" and more than one rank), one
    optimizer update. metrics: ``train_{loss name}`` and ``train_loss``,
    0-d tensors, over the global batch."""
    from fastvim_tpu_torch.parallel import (
        allreduce_grads,
        get_mesh,
        mean_over_ranks,
    )
    from fastvim_tpu_torch.train.trainer import fold_seed

    device = next(model.parameters()).device
    drop = torch.Generator(device=device)
    model.set_drop_path_generator(drop)
    mesh = get_mesh()
    compress = (torch.bfloat16 if grad_compression == "bf16"
                and mesh.sharded else None)

    def train_step(state, batch):
        model.train()
        first = mesh.rows(batch["image"].shape[0] * mesh.data).start
        samplers = [torch.Generator().manual_seed(
            fold_seed(seed, state.step, 2, first + i))
            for i in range(batch["image"].shape[0])]
        drop.manual_seed(fold_seed(seed, state.step, 1))
        losses = model(batch["image"], batch["boxes"], batch["labels"],
                       batch["masks"], batch["gt_valid"], generator=samplers)
        params = state.params
        grads = torch.autograd.grad(losses["loss"], list(params.values()))
        state.apply_gradients(allreduce_grads(dict(zip(params, grads)),
                                              compress))
        return state, mean_over_ranks(
            {f"train_{k}": v.detach() for k, v in losses.items()})

    return train_step


@torch.no_grad()
def evaluate_box_ap(model, val_loader, num_classes: int,
                    iou_thr: float = 0.5) -> dict:
    """Box and mask AP at ``iou_thr`` over a loader (the single-threshold
    counterpart of mmdet's CocoMetric): {"box_ap50", "mask_ap50"}. Over
    several ranks each predicts its share of the batches, and the AP is
    taken over every rank's predictions."""
    from fastvim_tpu_torch.parallel import gather_objects
    from fastvim_tpu_torch.train.metrics import (
        box_average_precision,
        mask_average_precision,
    )

    model.eval()
    device = next(model.parameters()).device
    preds, gts = [], []
    for batch in val_loader:
        images = torch.as_tensor(batch["image"]).to(device)
        out = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
               for k, v in model(images).items()}
        for i in range(images.shape[0]):
            preds.append({k: out[k][i] for k in ("boxes", "scores", "labels",
                                                 "valid", "masks")})
            gts.append({"boxes": batch["boxes"][i],
                        "labels": batch["labels"][i],
                        "masks": batch["masks"][i],
                        "valid": batch["gt_valid"][i]})
    preds, gts = gather_objects(preds), gather_objects(gts)
    return {
        "box_ap50": box_average_precision(preds, gts, iou_thr, num_classes),
        "mask_ap50": mask_average_precision(preds, gts, iou_thr,
                                            num_classes),
    }


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--eval_only", action="store_true",
                   help="checkpoint-in → box-AP-out, no training")
    args = p.parse_args(argv)
    cfg = load_cli_config(args, "detection")
    device = cli_device(args.device)
    setup_mesh(device)

    from fastvim_tpu_torch.data.detection import create_detection_loader
    from fastvim_tpu_torch.parallel import is_writer, replicate
    from fastvim_tpu_torch.train import (
        TrainState,
        make_optimizer,
        vitdet_layer_decay_scales,
        warmup_multistep,
    )
    from fastvim_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_pretrained_backbone,
        restore_checkpoint,
    )
    from fastvim_tpu_torch.train.loop import run_training

    model, depth = build_model(cfg, device)
    if cfg.get("pretrained_checkpoint_path"):
        model.load_state_dict(load_pretrained_backbone(
            cfg["pretrained_checkpoint_path"], model.state_dict(),
            prefer_ema=cfg.get("load_ema", True), subtree="backbone"))
    replicate(model)

    max_gt = cfg.get("max_gt", 32)
    data_dir = cfg.get("data", {}).get("dir")
    num_classes = cfg.get("num_classes", 80)
    num_workers = cfg.get("num_workers", 4)
    if args.eval_only:
        if args.model_save_dir:
            path = latest_checkpoint(os.path.join(args.model_save_dir,
                                                  "ckpt"))
            if path:
                model.load_state_dict(
                    restore_checkpoint(path, device)["params"])
        val_loader = create_detection_loader(
            data_dir, "val", cfg.get("eval_batch_size", 1), cfg["img_size"],
            training=False, max_gt=max_gt, num_workers=num_workers,
            synthetic_samples=min(args.synthetic_samples, 8),
            num_classes=num_classes)
        metrics = evaluate_box_ap(model, val_loader, num_classes)
        if is_writer():
            print(metrics)
        return metrics

    train_loader = create_detection_loader(
        data_dir, "train", cfg["batch_size"], cfg["img_size"], training=True,
        max_gt=max_gt, num_workers=num_workers, seed=cfg.get("seed", 0),
        synthetic_samples=args.synthetic_samples, num_classes=num_classes)
    steps_per_epoch = max(len(train_loader), 1)
    total_iters = cfg.get("total_iters", 184375)
    epochs = cfg.get("training_epochs") or -(-total_iters // steps_per_epoch)
    opt = cfg.get("optimizer", {})
    lr_schedule = warmup_multistep(
        opt.get("lr", 1e-4), warmup_steps=cfg.get("warmup_iters", 250),
        milestones=cfg.get("milestones", [163889, 177546]))
    scales = vitdet_layer_decay_scales(model, opt.get("layer_decay", 0.7),
                                       num_layers=depth)
    tx = make_optimizer(lr_schedule,
                        weight_decay=opt.get("weight_decay", 0.05),
                        params=model, layer_scales=scales)
    state = TrainState.create(model, tx)
    return run_training(
        state=state, train_step=make_det_train_step(
            model, cfg.get("seed", 0), cfg.get("grad_compression")),
        train_loader=train_loader, epochs=epochs,
        save_dir=args.model_save_dir, resume=args.resume)


if __name__ == "__main__":
    main()
