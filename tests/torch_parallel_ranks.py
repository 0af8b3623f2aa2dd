"""The rank side of tests/test_torch_port_parallel.py: train steps that
run the same in one process (the whole global batch) and in each of N
spawned gloo ranks (its rows), and the spawner.

This module imports no JAX: spawned ranks import it, and only it. Each
scenario takes the inputs the test wrote (weights, batches, as numpy
arrays) and returns what the test compares, as numpy arrays and floats.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.multiprocessing as mp

from fastvim_tpu_torch.parallel import (
    allreduce_grads,
    init_distributed,
    make_mesh,
    reset_mesh,
    shard_batch,
)

# the models: img 32, patch 16, depth 2, embed 64 (the classifier);
# ChannelVim, UperNet, MAE and the detector at their tests' sizes
VIM = dict(img_size=32, patch_size=16, depth=2, embed_dim=64,
           num_classes=10, ssm_cfg=dict(d_state=8))
CLASSES = 10


def _numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def _tensors(batch) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


def _as_torch(tree):
    """Nested dicts and lists of arrays as the same of tensors (which
    ``torch.save`` writes fast and ``weights_only`` loads)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_torch(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


def _build(make: Callable[[bool], torch.nn.Module],
           weights: Optional[Dict[str, np.ndarray]],
           meta: bool = False) -> torch.nn.Module:
    """``make(init)``'s module: initialized (seed 1) where ``weights`` is
    None, else given ``weights``; with ``meta`` built uninitialized on the
    meta device first, which skips the cost of the init (for a model
    whose buffers are all in its state_dict)."""
    if weights is None:
        torch.manual_seed(1)  # the heads' constructor init
        return make(True)
    if not meta:
        model = make(False)
    else:
        with torch.device("meta"):
            model = make(False)
        model.to_empty(device="cpu")
    model.load_state_dict(_tensors(weights))
    return model


def _registry(name: str, **kw):
    """A registry model's maker: ``init`` runs its ``reset_parameters``
    from seed 1."""
    from fastvim_tpu_torch.models.registry import _REGISTRY

    def make(init: bool):
        model = _REGISTRY[name](**kw)
        if init:
            model.reset_parameters(torch.Generator().manual_seed(1))
        return model

    return make


def _upernet():
    """UperNet with BatchNorm heads of 32 channels; the heads keep their
    constructor init (PyTorch's), which is cheaper than flax's truncated
    normal."""
    from unittest import mock

    from fastvim_tpu_torch.models import upernet as up

    backbone = _registry("fastvim_tiny", img_size=32, patch_size=8, depth=4,
                         embed_dim=64, num_classes=0,
                         out_indices=(0, 1, 2, 3), ssm_cfg=dict(d_state=4))

    def make(init: bool):
        with mock.patch.object(up, "UPerHead", partial(up.UPerHead,
                                                       channels=32)), \
                mock.patch.object(up, "FCNHead", partial(up.FCNHead,
                                                         channels=32)):
            return up.UperNetSegmentor(backbone(init), num_classes=6,
                                       norm="bn")

    return make


def _detector():
    """The tiny cascade Mask R-CNN; the heads keep their constructor
    init."""
    from fastvim_tpu_torch.models.detection import CascadeMaskRCNN

    backbone = _registry("fastvim_tiny", img_size=64, patch_size=16,
                         depth=2, embed_dim=32, num_classes=0,
                         out_indices=(1,), drop_path_rate=0.1,
                         ssm_cfg=dict(d_state=4))
    return lambda init: CascadeMaskRCNN(
        backbone(init), num_classes=3, backbone_channel=32, fpn_channels=32,
        img_size=64, rpn_sample=16, nms_pre=32, num_proposals=16,
        rcnn_sample=16)


# each scenario's model
MODELS = {
    "supervised": lambda: _registry("fastvim_tiny", drop_path_rate=0.0,
                                    **VIM),
    "compressed_grads": lambda: _registry("fastvim_tiny", drop_path_rate=0.0,
                                          **VIM),
    # the fused layer's two backward routes: its adjoint kernels' plain
    # versions, and remat's recomputation (with remat=True each block's
    # too, its DropPath draws replayed)
    "mixup": lambda: _registry("fastvim_tiny", drop_path_rate=0.3,
                               layer_fused_bwd="fused", **VIM),
    "remat": lambda: _registry("fastvim_tiny", drop_path_rate=0.3,
                               layer_fused_bwd="remat", remat=True, **VIM),
    "mae": lambda: _registry(
        "mae_FastVim_tiny_dec512d2b", img_size=32, patch_size=8, depth=2,
        embed_dim=64, decoder_embed_dim=64, ssm_cfg=dict(d_state=4)),
    "cells": lambda: _registry(
        "fastchannelvim_small_ps16", img_size=16, patch_size=8, depth=2,
        embed_dim=32, channels=5, num_classes=7, drop_path_rate=0.2,
        ssm_cfg=dict(d_state=4)),
    "upernet": _upernet,
    "detection": _detector,
}


def init_weights() -> Dict[str, Dict[str, np.ndarray]]:
    """Every scenario model's initial weights."""
    return {name: _numpy(_build(make(), None).state_dict())
            for name, make in MODELS.items()}


def _model(name: str, inp) -> torch.nn.Module:
    return _build(MODELS[name](), inp["weights"][name],
                  meta=name in ("upernet", "detection")).train()


def _adamw(model, ema: bool):
    from fastvim_tpu_torch.train import (
        TrainState,
        cosine_with_warmup,
        make_optimizer,
    )

    tx = make_optimizer(cosine_with_warmup(2e-3, 1e-5, 20, 3, 5e-4),
                        weight_decay=0.05, params=model)
    return TrainState.create(model, tx, ema=ema)


def _sgd(model, ema: bool = False):
    """Plain SGD: the step moves each parameter by lr times its gradient,
    so that the parameters after it compare the gradients (AdamW's first
    step is lr · sign(g), which rounding flips where g is near 0)."""
    from fastvim_tpu_torch.train import TrainState, constant, make_sgd

    tx = make_sgd(constant(0.5), momentum=0.0, params=model)
    return TrainState.create(model, tx, ema=ema)


def _outcome(state, metrics: Dict[str, torch.Tensor]) -> dict:
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": _numpy(state.model.state_dict())}
    if state.ema_params is not None:
        out["ema"] = _numpy(state.ema_params)
    return out


def supervised(inp) -> dict:
    """One AdamW step with EMA, without mixup or DropPath, from the
    weights the test gives (the step it runs in JAX over a 2-device
    mesh)."""
    from fastvim_tpu_torch.train import make_supervised_train_step

    model = _model("supervised", inp)
    state = _adamw(model, ema=True)
    step = make_supervised_train_step(model, CLASSES, label_smoothing=0.1,
                                      ema_decay=0.9)
    state, metrics = step(state, shard_batch(_tensors(inp["batch"])))
    return _outcome(state, metrics)


def compressed_grads(inp) -> dict:
    """This rank's gradients of the smoothed cross entropy, averaged over
    ranks in bf16 and in fp32."""
    from fastvim_tpu_torch.train import (
        one_hot_smooth,
        soft_target_cross_entropy,
    )

    model = _model("compressed_grads", inp).eval()
    batch = shard_batch(_tensors(inp["batch"]))
    loss = soft_target_cross_entropy(
        model(batch["image"]), one_hot_smooth(batch["label"], CLASSES, 0.1))
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(model.parameters()))))
    return {"bf16": _numpy(allreduce_grads(grads, torch.bfloat16)),
            "fp32": _numpy(allreduce_grads(grads))}


def mixup(inp, name: str = "mixup") -> dict:
    """Two steps with DropPath 0.3 and EMA: mixup (switch 0), then
    cutmix (switch 1)."""
    from fastvim_tpu_torch.train import make_supervised_train_step

    model = _model(name, inp)
    state = _sgd(model, ema=True)
    batch = shard_batch(_tensors(inp["batch"]))
    metrics = {}
    for switch in (0.0, 1.0):
        step = make_supervised_train_step(
            model, CLASSES, mixup_config=dict(
                mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=switch),
            label_smoothing=0.1, ema_decay=0.9,
            generator=torch.Generator().manual_seed(5))
        state, m = step(state, batch)
        metrics.update({f"{k}_{switch}": v for k, v in m.items()})
    return _outcome(state, metrics)


def remat(inp) -> dict:
    """``mixup`` with the remat backward and ``remat=True``."""
    return mixup(inp, "remat")


def mae(inp) -> dict:
    """One MAE pretraining step (the mask drawn over the global batch)."""
    from fastvim_tpu_torch.train import make_mae_train_step

    model = _model("mae", inp)
    state = _sgd(model)
    step = make_mae_train_step(model, 0.75,
                               generator=torch.Generator().manual_seed(6))
    state, metrics = step(state, shard_batch(_tensors(inp["batch"])))
    return _outcome(state, metrics)


def cells(inp) -> dict:
    """One ChannelVim step on 3 of 5 channels ("channel_ids", held whole
    on every rank), DropPath 0.2."""
    from fastvim_tpu_torch.train import make_supervised_train_step

    model = _model("cells", inp)
    state = _sgd(model)
    step = make_supervised_train_step(
        model, 7, label_smoothing=0.1, ema_decay=None,
        generator=torch.Generator().manual_seed(7), channel_model=True)
    state, metrics = step(state, shard_batch(_tensors(inp["cells"])))
    return _outcome(state, metrics)


def upernet(inp) -> dict:
    """A segmentation step of UperNet with BatchNorm heads (their
    running statistics are in the state_dict compared) on labels with
    ignored pixels, dropout 0.1."""
    from fastvim_tpu_torch.cli.train_segmentation import make_seg_train_step

    seg = _model("upernet", inp)
    state = _sgd(seg)
    step = make_seg_train_step(seg, torch.Generator().manual_seed(8))
    batch = shard_batch(_tensors(inp["seg"]))
    return _outcome(state, {"loss": step(state, batch)})


def detection(inp) -> dict:
    """One step of the tiny cascade Mask R-CNN through the detection
    CLI's train step (per-image samplers; DropPath 0.1)."""
    from fastvim_tpu_torch.cli.train_detection import make_det_train_step

    model = _model("detection", inp)
    state = _sgd(model)
    step = make_det_train_step(model, seed=3)
    state, metrics = step(state, shard_batch(_tensors(inp["det"])))
    return _outcome(state, metrics)


SCENARIOS: Dict[str, Callable[[dict], dict]] = {
    f.__name__: f for f in (supervised, compressed_grads, mixup, remat, mae,
                            cells, upernet, detection)}


def cli_digits(inp) -> dict:
    """``train_classification`` with ``inp["argv"]``, the registry cut to
    depth 2, width 64; returns the final state's parameters and EMA
    copy."""
    from fastvim_tpu_torch.cli import train_classification
    from fastvim_tpu_torch.models import registry

    for name, factory in list(registry._REGISTRY.items()):
        registry._REGISTRY[name] = (lambda f=factory, **kw: f(**dict(
            kw, depth=2, embed_dim=64)))
    state = train_classification.main(list(inp["argv"]))
    return {"params": _numpy(state.model.state_dict()),
            "ema": _numpy(state.ema_params), "step": state.step}


def _rank_main(rank: int, world: int, store: str, names: List[str],
               inputs: str, out: str, env: Optional[dict]) -> None:
    """Rank ``rank``: the scenarios in a process group joined through a
    file store, then, with ``env``, "cli_digits" in a group the CLI joins
    by itself from the env as ``torchrun`` sets it."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    inp = torch.load(inputs, weights_only=True)
    results = {}
    scenarios = [n for n in names if n in SCENARIOS]
    if scenarios:
        init_distributed("cpu", init_method=f"file://{store}",
                         world_size=world, rank=rank)
        make_mesh(data=world)
        results.update((n, SCENARIOS[n](inp)) for n in scenarios)
        dist.destroy_process_group()
    reset_mesh()
    if env is not None:
        os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(world))
        results["cli_digits"] = cli_digits(inp)
        dist.destroy_process_group()
        reset_mesh()
    torch.save(_as_torch(results), os.path.join(out, f"rank{rank}.pt"))


def spawn(world: int, names: List[str], inputs: dict, tmp: str,
          env: Optional[dict] = None,
          meanwhile: Optional[Callable[[], object]] = None):
    """Run the scenarios ``names`` in ``world`` spawned gloo ranks, then,
    with ``env`` (as torchrun sets it), the CLI run that
    ``inputs["argv"]`` describes, and ``meanwhile()`` here while they
    run. Returns (each rank's results in rank order, what ``meanwhile``
    returned)."""
    path = os.path.join(tmp, "inputs.pt")
    torch.save(_as_torch(inputs), path)
    ctx = mp.spawn(_rank_main, args=(world, os.path.join(tmp, "store"),
                                     names, path, tmp, env),
                   nprocs=world, join=False)
    try:
        here = meanwhile() if meanwhile is not None else None
    finally:
        while not ctx.join():
            pass
    return [_as_numpy(torch.load(os.path.join(tmp, f"rank{r}.pt"),
                                 weights_only=True))
            for r in range(world)], here


def run_here(names: List[str], inputs: dict) -> dict:
    """The scenarios in this process: one rank, no process group."""
    return {name: SCENARIOS[name](inputs) for name in names}
