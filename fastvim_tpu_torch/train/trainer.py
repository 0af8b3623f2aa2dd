"""Train and eval steps: supervised classification, MAE pretraining and
the linear probe.

Counterpart of ``fastvim_tpu/train/trainer.py``. The supervised step is
mixup → forward → soft-target cross entropy (smoothed cross entropy
without mixup) → AdamW update → EMA; the MAE step draws the mask, takes
the reconstruction loss and updates; the linear-probe step trains a head
on a frozen backbone's features. The steps run eagerly on the device the
model and the batch lie on.

Over several ``torchrun`` ranks (``fastvim_tpu_torch.parallel``) each
rank takes its rows of the global batch, and after the backward pass the
gradients are averaged over ranks by an explicit all-reduce
(``parallel.allreduce_grads``), optionally in bf16 (the counterpart of
the JAX package's ``make_compressed_grads_fn``): the steps compute their
gradients with ``torch.autograd.grad``, which fires none of
``DistributedDataParallel``'s reducer hooks, and an all-reduce after the
backward pass is the same whatever the backward ran (the fused layer's
``FusedMixerCoreFn``, remat's recomputation). The metrics are averaged
over ranks, and every rank applies the same update, so the parameters
and the EMA copy stay equal on every rank. Over a ``(data, seq)`` mesh
the ranks of a seq group hold the same rows and shard the model's tokens
(``parallel/tokens.py``); the all-reduce over the whole world then gives
the data-parallel mean, the S factor of each seq group cancelling (see
that module).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from fastvim_tpu_torch.parallel import (
    allreduce_grads,
    get_mesh,
    mean_over_ranks,
)
from fastvim_tpu_torch.train.mixup import (
    accuracy,
    cross_entropy,
    mixup_cutmix,
    one_hot_smooth,
    soft_target_cross_entropy,
)
from fastvim_tpu_torch.train.optim import global_norm
from fastvim_tpu_torch.train.state import TrainState


def fold_seed(seed: int, *parts: int) -> int:
    """A generator seed for (``seed``, ``parts``...): the same numbers
    give the same seed in every process."""
    return hash((seed, *parts)) & (2 ** 63 - 1)


def make_supervised_train_step(
        model: nn.Module, num_classes: int,
        mixup_config: Optional[Dict[str, Any]] = None,
        label_smoothing: float = 0.1, ema_decay: Optional[float] = 0.9999,
        generator: Optional[torch.Generator] = None,
        channel_model: bool = False,
        grad_allreduce_dtype: Optional[torch.dtype] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {"image": (B, H, W, C), "label": (B,) int64} on the model's
    device, and with ``channel_model`` (ChannelVim) optionally
    "channel_ids" (C,), the channels the images hold, passed to the model.
    ``generator`` (on that device) feeds mixup, DropPath and dropout; it is
    needed only when ``mixup_config`` is given or the model drops paths.
    Each step first re-seeds it from (its seed when the step was made,
    state.step), as the JAX step folds the step count into one key: a run
    resumed from a checkpoint then draws what an uninterrupted one would.
    metrics: "train_loss" and "grad_norm" (before clipping), 0-d tensors,
    over the global batch. ``grad_allreduce_dtype`` (torch.bfloat16):
    the gradient all-reduce of several ranks in that dtype, cast back
    before the fp32 update (without a process group there is no
    all-reduce, and nothing is cast); it raises on a mesh with a seq axis,
    as the JAX package's compressed all-reduce does (a DP-only comm hook).
    The state is updated in place."""
    if mixup_config and generator is None:
        raise ValueError("mixup needs a generator")
    seq = get_mesh().seq
    if grad_allreduce_dtype is not None and seq > 1:
        raise ValueError(f"the compressed gradient all-reduce is data "
                         f"parallel only; use seq=1 (got seq={seq})")
    seed = generator.initial_seed() if generator is not None else None
    if hasattr(model, "set_drop_path_generator"):
        model.set_drop_path_generator(generator)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model.train()
        if generator is not None:
            generator.manual_seed(fold_seed(seed, state.step))
        images, labels = batch["image"], batch["label"]
        if mixup_config:
            images, soft = mixup_cutmix(generator, images, labels,
                                        num_classes,
                                        smoothing=label_smoothing,
                                        **mixup_config)
        else:
            soft = one_hot_smooth(labels, num_classes, label_smoothing)
        params = state.params
        loss = soft_target_cross_entropy(
            model(images, **_channel_kwargs(batch, channel_model)), soft)
        grads = allreduce_grads(dict(zip(params, torch.autograd.grad(
            loss, list(params.values())))), grad_allreduce_dtype)
        metrics = {**mean_over_ranks({"train_loss": loss.detach()}),
                   "grad_norm": global_norm(grads.values())}
        state.apply_gradients(grads, ema_decay=ema_decay)
        return state, metrics

    return train_step


def _channel_kwargs(batch: Mapping[str, torch.Tensor],
                    channel_model: bool) -> Dict[str, torch.Tensor]:
    if channel_model and "channel_ids" in batch:
        return {"channel_ids": batch["channel_ids"]}
    return {}


def make_supervised_eval_step(model: nn.Module,
                              channel_model: bool = False) -> Callable:
    """Returns ``eval_step(batch, params=None) -> {"loss", "acc"}``: the
    model in eval mode on its own parameters or, with ``params`` (name →
    tensor, e.g. the EMA copy), on those; with ``channel_model`` the
    batch's "channel_ids", where it has them, go to the model."""

    @torch.no_grad()
    def eval_step(batch: Mapping[str, torch.Tensor],
                  params: Optional[Mapping[str, torch.Tensor]] = None):
        model.eval()
        kwargs = _channel_kwargs(batch, channel_model)
        if params is None:
            logits = model(batch["image"], **kwargs)
        else:
            logits = torch.func.functional_call(model, dict(params),
                                                (batch["image"],), kwargs)
        return {"loss": cross_entropy(logits, batch["label"]),
                "acc": accuracy(logits, batch["label"])}

    return eval_step


def make_mae_train_step(model: nn.Module, mask_ratio: float = 0.75,
                        ema_decay: Optional[float] = None, *,
                        generator: torch.Generator) -> Callable:
    """Returns ``train_step(state, batch) -> (state, {"train_loss"})`` for
    a ``MaskedAutoencoderVim``. The mask is drawn from ``generator`` (on
    the model's device), re-seeded before each step from (its seed when
    the step was made, state.step), as the JAX step folds the step count
    into its key: a resumed run masks as an uninterrupted one does."""
    seed = generator.initial_seed()

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model.train()
        generator.manual_seed(fold_seed(seed, state.step))
        params = state.params
        loss, _, _ = model(batch["image"], mask_ratio, generator=generator)
        grads = allreduce_grads(dict(zip(params, torch.autograd.grad(
            loss, list(params.values())))))
        state.apply_gradients(grads, ema_decay=ema_decay)
        return state, mean_over_ranks({"train_loss": loss.detach()})

    return train_step


def make_linear_probe_step(backbone: nn.Module) -> Callable:
    """Returns ``train_step(state, batch) -> (state, {"train_loss",
    "train_acc"})``, where ``state.model`` is the probe's head: the frozen
    ``backbone`` (eval mode, no gradient) gives the pooled features, and
    only the head is trained, by cross entropy."""

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        backbone.eval()
        with torch.no_grad():
            feats = backbone(batch["image"], return_features=True)
        head = state.model.train()
        logits = head(feats)
        loss = cross_entropy(logits, batch["label"])
        params = state.params
        grads = allreduce_grads(dict(zip(params, torch.autograd.grad(
            loss, list(params.values())))))
        state.apply_gradients(grads)
        return state, mean_over_ranks({
            "train_loss": loss.detach(),
            "train_acc": accuracy(logits.detach(), batch["label"])})

    return train_step
