"""Mixup / CutMix augmentation and the soft-target cross entropy.

Counterpart of ``fastvim_tpu/train/mixup.py`` (timm ``Mixup`` semantics:
one mix per batch, the batch paired with its reverse, label smoothing into
soft targets). ``mixup_cutmix`` is split in two: :func:`sample_mixup_draws`
draws ``(apply, use_cutmix, lam_m, lam_c, cy, cx)`` from a
``torch.Generator``, and :func:`apply_mixup_cutmix` is a pure function of
those draws, so that two implementations can be fed the same ones.

Over several ranks the batch's partner is the reverse of the global
batch (the JAX package's ``images[::-1]`` over the sharded batch): rank
r mixes its rows with rank (N-1-r)'s, reversed (``parallel.mirror_rows``),
and every rank draws the same λ, switch and box from its generator,
which all ranks seed alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from fastvim_tpu_torch.parallel import mirror_rows


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels, num_classes).float() * (on - off) + off


class MixupDraws(NamedTuple):
    apply: bool        # mix this batch at all
    use_cutmix: bool   # CutMix (True) or Mixup (False)
    lam_m: float       # Mixup weight of the unpermuted batch
    lam_c: float       # CutMix target area ratio of the unpermuted batch
    cy: int            # CutMix box centre
    cx: int


def _uniform(generator: torch.Generator) -> float:
    return torch.rand((), generator=generator,
                      device=generator.device).item()


def _gamma(alpha: float, generator: torch.Generator) -> float:
    """One Gamma(alpha, 1) draw (Marsaglia-Tsang), from ``generator``."""
    if alpha < 1.0:
        return (_gamma(alpha + 1.0, generator)
                * _uniform(generator) ** (1.0 / alpha))
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = torch.randn((), generator=generator,
                        device=generator.device).item()
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = max(_uniform(generator), 1e-300)
        if math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v


def _beta(alpha: float, generator: torch.Generator) -> float:
    a, b = _gamma(alpha, generator), _gamma(alpha, generator)
    return a / (a + b)


def sample_mixup_draws(generator: torch.Generator, H: int, W: int,
                       mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                       prob: float = 1.0,
                       switch_prob: float = 0.5) -> MixupDraws:
    """The random part of one batch's mix. A mode whose alpha is 0 is
    never drawn or selected (Beta(0, 0) is undefined); with both 0 the mix
    is the identity."""
    lam_m = _beta(mixup_alpha, generator) if mixup_alpha > 0 else 1.0
    lam_c = _beta(cutmix_alpha, generator) if cutmix_alpha > 0 else 1.0
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_cutmix = _uniform(generator) < switch_prob
    else:
        use_cutmix = cutmix_alpha > 0
    randint = lambda high: int(torch.randint(
        high, (), generator=generator, device=generator.device).item())
    cy, cx = randint(H), randint(W)
    return MixupDraws(_uniform(generator) < prob, use_cutmix, lam_m, lam_c,
                      cy, cx)


def _cutmix_box(H: int, W: int, lam_c: float, cy: int,
                cx: int) -> Tuple[int, int, int, int]:
    """CutMix box with area ratio 1 − lam (timm), in float32 as the JAX
    package computes it."""
    ratio = torch.sqrt(1.0 - torch.tensor(lam_c, dtype=torch.float32))
    cut_h, cut_w = int(H * ratio), int(W * ratio)
    clip = lambda v, hi: min(max(v, 0), hi)
    return (clip(cy - cut_h // 2, H), clip(cy + cut_h // 2, H),
            clip(cx - cut_w // 2, W), clip(cx + cut_w // 2, W))


def apply_mixup_cutmix(images: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, draws: MixupDraws,
                       smoothing: float = 0.1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (batch, H, W, C), labels (batch,) int → (mixed images, soft
    targets (batch, num_classes)), given the draws. The partner of row i
    is row B-1-i of the global batch."""
    _, H, W, _ = images.shape
    y1 = one_hot_smooth(labels, num_classes, smoothing)
    if not draws.apply:
        return images, y1
    perm = mirror_rows(images)
    if draws.use_cutmix:
        by1, by2, bx1, bx2 = _cutmix_box(H, W, draws.lam_c, draws.cy,
                                         draws.cx)
        mixed = images.clone()
        mixed[:, by1:by2, bx1:bx2] = perm[:, by1:by2, bx1:bx2]
        lam = 1.0 - ((by2 - by1) * (bx2 - bx1)) / (H * W)
    else:
        lam = draws.lam_m
        mixed = images * lam + perm * (1 - lam)
    return mixed.to(images.dtype), y1 * lam + mirror_rows(y1) * (1 - lam)


def mixup_cutmix(generator: torch.Generator, images: torch.Tensor,
                 labels: torch.Tensor, num_classes: int,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 smoothing: float = 0.1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-level mixup/cutmix with draws from ``generator``."""
    draws = sample_mixup_draws(generator, images.shape[1], images.shape[2],
                               mixup_alpha, cutmix_alpha, prob, switch_prob)
    return apply_mixup_cutmix(images, labels, num_classes, draws, smoothing)


def soft_target_cross_entropy(logits: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of −Σ t·log_softmax(logits), in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(targets * logp).sum(-1).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    return soft_target_cross_entropy(
        logits, one_hot_smooth(labels, logits.shape[-1], smoothing))


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             k: int = 1) -> torch.Tensor:
    if k == 1:
        return (logits.argmax(-1) == labels).float().mean()
    topk = logits.topk(k, dim=-1).indices
    return (topk == labels[:, None]).any(-1).float().mean()
