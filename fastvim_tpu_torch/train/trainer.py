"""Supervised classification train and eval steps.

Counterpart of ``make_supervised_train_step`` / ``make_supervised_eval_step``
of ``fastvim_tpu/train/trainer.py``: mixup → forward → soft-target cross
entropy (smoothed cross entropy without mixup) → AdamW update → EMA. The
steps run eagerly on the device the model and the batch lie on.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from fastvim_tpu_torch.train.mixup import (
    accuracy,
    cross_entropy,
    mixup_cutmix,
    one_hot_smooth,
    soft_target_cross_entropy,
)
from fastvim_tpu_torch.train.optim import global_norm
from fastvim_tpu_torch.train.state import TrainState


def make_supervised_train_step(
        model: nn.Module, num_classes: int,
        mixup_config: Optional[Dict[str, Any]] = None,
        label_smoothing: float = 0.1, ema_decay: Optional[float] = 0.9999,
        generator: Optional[torch.Generator] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {"image": (B, H, W, C), "label": (B,) int64} on the model's
    device. ``generator`` (on that device) feeds mixup and DropPath; it is
    needed only when ``mixup_config`` is given or the model drops paths.
    metrics: "train_loss" and "grad_norm" (before clipping), 0-d tensors.
    The state is updated in place."""
    if mixup_config and generator is None:
        raise ValueError("mixup needs a generator")
    if hasattr(model, "set_drop_path_generator"):
        model.set_drop_path_generator(generator)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model.train()
        images, labels = batch["image"], batch["label"]
        if mixup_config:
            images, soft = mixup_cutmix(generator, images, labels,
                                        num_classes,
                                        smoothing=label_smoothing,
                                        **mixup_config)
        else:
            soft = one_hot_smooth(labels, num_classes, label_smoothing)
        params = state.params
        loss = soft_target_cross_entropy(model(images), soft)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        metrics = {"train_loss": loss.detach(),
                   "grad_norm": global_norm(grads.values())}
        state.apply_gradients(grads, ema_decay=ema_decay)
        return state, metrics

    return train_step


def make_supervised_eval_step(model: nn.Module) -> Callable:
    """Returns ``eval_step(batch, params=None) -> {"loss", "acc"}``: the
    model in eval mode on its own parameters or, with ``params`` (name →
    tensor, e.g. the EMA copy), on those."""

    @torch.no_grad()
    def eval_step(batch: Mapping[str, torch.Tensor],
                  params: Optional[Mapping[str, torch.Tensor]] = None):
        model.eval()
        if params is None:
            logits = model(batch["image"])
        else:
            logits = torch.func.functional_call(model, dict(params),
                                                (batch["image"],))
        return {"loss": cross_entropy(logits, batch["label"]),
                "acc": accuracy(logits, batch["label"])}

    return eval_step
