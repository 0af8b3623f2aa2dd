"""Device-resident dataset pipeline: whole epochs without the host loader.

Counterpart of ``fastvim_tpu/data/device.py``. For a dataset that fits
in device memory (the digits set: 1,797 8×8 images) the dataset is a
uint8 tensor on the card, and an epoch is a Python loop of steps in which
the permutation, the batch gather, the random-resized crop and the
photometric jitter all run on the device; the host only launches. (The
JAX package compiles the epoch into one program; eager PyTorch has no
such program, so the loop stays in Python.)

Augmentation follows ``data/digits.py``'s PIL pipeline (gentle RRC, no
hflip, brightness/contrast jitter, ImageNet-stat normalization) with the
JAX package's resampling: bilinear, crop and resize in one
``scale_and_translate`` (``ops/resize.py``), without antialiasing. The
random part is split from the pure part, as in ``train/mixup.py``:
:func:`sample_augment_draws` draws from a ``torch.Generator`` and
:func:`apply_device_augment` is a function of the draws.

Over several ``torchrun`` ranks each holds the whole dataset, walks the
same permutation and takes its contiguous rows of each global batch;
the augment draws are made for the global batch and cut to those rows,
so N ranks compute what one process computes. The eval deals the val
batches round-robin and sums the results over ranks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastvim_tpu_torch.ops.resize import resize, scale_and_translate
from fastvim_tpu_torch.parallel import get_mesh, sum_over_ranks
from fastvim_tpu_torch.train.trainer import fold_seed

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _normalize(img01: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=img01.dtype,
                        device=img01.device)
    std = torch.tensor(IMAGENET_STD, dtype=img01.dtype, device=img01.device)
    return (img01 - mean) / std


class AugmentDraws(NamedTuple):
    """One draw per image, each a (batch,) tensor."""
    area: torch.Tensor   # crop area as a share of the image, in scale
    logr: torch.Tensor   # log aspect ratio, in log(ratio)
    ux: torch.Tensor     # crop offsets as a share of the free room, [0, 1)
    uy: torch.Tensor
    flip: torch.Tensor   # bool: mirror (with hflip only)
    fb: torch.Tensor     # brightness factor, in 1 ± jitter
    fc: torch.Tensor     # contrast factor, in 1 ± jitter


def sample_augment_draws(generator: torch.Generator, batch: int,
                         scale: Tuple[float, float] = (0.64, 1.0),
                         ratio: Tuple[float, float] = (0.8, 1.25),
                         jitter: float = 0.2) -> AugmentDraws:
    u = torch.rand((7, batch), generator=generator, device=generator.device)
    span = lambda v, lo, hi: lo + v * (hi - lo)
    lr0, lr1 = math.log(ratio[0]), math.log(ratio[1])
    return AugmentDraws(span(u[0], *scale), span(u[1], lr0, lr1), u[2], u[3],
                        u[4] < 0.5, span(u[5], 1 - jitter, 1 + jitter),
                        span(u[6], 1 - jitter, 1 + jitter))


def apply_device_augment(imgs_u8: torch.Tensor, draws: AugmentDraws,
                         img_size: int, jitter: float = 0.2,
                         hflip: bool = False) -> torch.Tensor:
    """(batch, H, W, 3) uint8 → (batch, S, S, 3) float32 normalized: each
    image's crop box resampled straight to the output grid (crop and
    resize in one step), then the jitter."""
    H, W = imgs_u8.shape[1], imgs_u8.shape[2]
    area = draws.area * (H * W)
    ratio = torch.exp(draws.logr)
    w = torch.clamp(torch.sqrt(area * ratio), 1.0, float(W))
    h = torch.clamp(torch.sqrt(area / ratio), 1.0, float(H))
    x0 = draws.ux * (W - w)
    y0 = draws.uy * (H - h)
    # output pixel o samples input at (o+0.5-t)/s - 0.5: with
    # s = S/w, t = -x0·S/w the output grid spans [x0, x0+w).
    sy, sx = img_size / h, img_size / w
    out = scale_and_translate(
        imgs_u8, (img_size, img_size), torch.stack([sy, sx], 1),
        torch.stack([-y0 * sy, -x0 * sx], 1), "linear", antialias=False)
    if hflip:
        out = torch.where(draws.flip[:, None, None, None], out.flip(2), out)
    if jitter:
        out = out * draws.fb[:, None, None, None]
        # PIL ImageEnhance.Contrast pivots on the mean L-channel gray
        luma = torch.tensor([0.299, 0.587, 0.114], device=out.device)
        gray = (out @ luma).mean((1, 2))[:, None, None, None]
        fc = draws.fc[:, None, None, None]
        out = (1 - fc) * gray + fc * out
    return _normalize(torch.clamp(out, 0.0, 255.0) / 255.0)


def make_device_augment(img_size: int,
                        scale: Tuple[float, float] = (0.64, 1.0),
                        ratio: Tuple[float, float] = (0.8, 1.25),
                        jitter: float = 0.2,
                        hflip: bool = False) -> Callable:
    """``augment(imgs_u8, generator)``: (batch, H, W, 3) uint8 on the
    device → (batch, S, S, 3) float32, the draws from ``generator``; over
    several ranks ``imgs_u8`` is this rank's rows of the global batch,
    and the draws are the global batch's rows."""

    def augment(imgs_u8: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        mesh = get_mesh()
        n = imgs_u8.shape[0] * mesh.data
        draws = sample_augment_draws(generator, n, scale, ratio, jitter)
        if mesh.sharded:
            draws = AugmentDraws(*(d[mesh.rows(n)] for d in draws))
        return apply_device_augment(imgs_u8, draws, img_size, jitter, hflip)

    return augment


def resize_eval_batch(imgs_u8: torch.Tensor, img_size: int) -> torch.Tensor:
    """Eval transform on device: bilinear resize (crop_pct=1.0, as
    data/digits.py) + normalize."""
    out = resize(imgs_u8, (img_size, img_size), "linear")
    return _normalize(torch.clamp(out, 0.0, 255.0) / 255.0)


def make_device_epoch_fn(train_step: Callable, images_u8: torch.Tensor,
                         labels: torch.Tensor, batch_size: int,
                         augment: Callable,
                         seed: int = 0) -> Tuple[Callable, int]:
    """Returns (epoch_fn, steps_per_epoch); ``epoch_fn(state, epoch) ->
    (state, metric_means)``. Per epoch: a permutation on the device; per
    step: the next ``batch_size`` indices, the gather and the augment of
    the batch, ``train_step``, and the metric sums, which stay on the
    device. The permutation and the augment draws come from a generator
    seeded from (``seed``, epoch), so that a resumed run draws what an
    uninterrupted one would; the last partial batch is dropped. Over
    several ranks ``batch_size`` is the global batch, and each rank
    steps on its rows of it."""
    n = int(images_u8.shape[0])
    steps = n // batch_size
    if steps == 0:
        raise ValueError(f"dataset ({n}) smaller than batch {batch_size}")
    generator = torch.Generator(device=images_u8.device)
    mesh = get_mesh()
    if batch_size % mesh.data:
        raise ValueError(f"the global batch of {batch_size} does not split "
                         f"over {mesh.data} ranks")
    rows = mesh.rows(batch_size)

    def epoch_fn(state, epoch: int):
        generator.manual_seed(fold_seed(seed, 17, epoch))
        perm = torch.randperm(n, generator=generator,
                              device=images_u8.device)
        sums: Dict[str, torch.Tensor] = {}
        for i in range(steps):
            idx = perm[i * batch_size:(i + 1) * batch_size][rows]
            batch = {"image": augment(images_u8[idx], generator),
                     "label": labels[idx]}
            state, metrics = train_step(state, batch)
            for k, v in metrics.items():
                sums[k] = v.float() if k not in sums else sums[k] + v.float()
        return state, {k: v / steps for k, v in sums.items()}

    return epoch_fn, steps


def make_device_eval_fn(model: nn.Module, val_images: torch.Tensor,
                        val_labels: torch.Tensor,
                        batch_size: int) -> Callable:
    """``eval_fn(params=None) -> {"loss", "acc"}`` (0-d tensors) over the
    whole device-resident, already transformed val set, in batches of
    ``batch_size``: the model's own parameters, or ``params`` (name →
    tensor, e.g. the EMA copy). Over several ranks each data index takes
    every data-th batch, and the sums are added over the data group."""
    n = int(val_images.shape[0])

    @torch.no_grad()
    def eval_fn(params: Optional[Dict[str, torch.Tensor]] = None):
        model.eval()
        mesh = get_mesh()
        sums = torch.zeros(2, device=val_images.device)  # loss, acc
        for i in range(mesh.data_index * batch_size, n,
                       batch_size * mesh.data):
            x = val_images[i:i + batch_size]
            y = val_labels[i:i + batch_size]
            logits = (model(x) if params is None else
                      torch.func.functional_call(model, dict(params), (x,)))
            logp = F.log_softmax(logits.float(), -1)
            sums[0] += -logp.gather(1, y[:, None]).sum()
            sums[1] += (logits.argmax(-1) == y).float().sum()
        sum_over_ranks(sums)
        return {"loss": sums[0] / n, "acc": sums[1] / n}

    return eval_fn


def load_device_digits(img_size: int, device: torch.device,
                       val_per_class: int = 30, seed: int = 0):
    """The digits dataset on ``device``: raw uint8 train images (the
    augment upsamples them per step) and transformed val images.

    Returns (train_images_u8 (n, 8, 8, 3), train_labels, val_images
    (m, S, S, 3) float32 normalized, val_labels, num_classes); labels
    int64."""
    from fastvim_tpu_torch.data.digits import _load_arrays, _split_indices

    imgs, labels = _load_arrays()
    tr, va = _split_indices(labels, val_per_class, seed)
    rgb = np.repeat(imgs[..., None], 3, axis=-1)
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    val_images = resize_eval_batch(as_dev(rgb[va]), img_size)
    return (as_dev(rgb[tr]), as_dev(labels[tr]), val_images,
            as_dev(labels[va]), int(labels.max()) + 1)
