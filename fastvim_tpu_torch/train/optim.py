"""AdamW with decay / no-decay groups, alternate-layer LR decay, gradient
clipping, accumulation and scheduled LR / WD; and the EMA update.

Counterpart of ``fastvim_tpu/train/optim.py``. The optax chain there
(clip → Adam moments → + wd·p on the masked leaves → · per-leaf scale →
· −lr) is decoupled AdamW with the decay multiplied by the learning rate
and the leaf's scale, which is what ``torch.optim.AdamW`` computes with
``lr = lr(step) · scale`` and ``weight_decay = wd`` per parameter group.
So :class:`ScheduledAdamW` groups the parameters by (decays, scale),
and sets each group's ``lr`` and ``weight_decay`` from the schedules
before every update. The names it reads are the port's
(``layers.3.mixer.dt_proj.bias``, ...).
"""

from __future__ import annotations

import re
from typing import (Callable, Dict, Iterable, Mapping, Optional, Sequence,
                    Union)

import torch
from torch import nn

NO_DECAY_NAMES = re.compile(
    r"(pos_embed|A_log|A_b_log|\bD\b|D_b|dt_proj\.bias|dt_proj_b\.bias|"
    r"mask_token|channel_embed|gamma)")

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """√Σ‖t‖² over all tensors, in float32 (a 0-d tensor)."""
    return torch.nn.utils.get_total_norm([t.float() for t in tensors])


def named_params(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def wd_mask(params: Params) -> Dict[str, bool]:
    """True where weight decay applies: more than one dimension and not
    in the no-decay set (pos_embed, A_log, D, dt_proj biases, ...)."""
    return {name: p.dim() > 1 and not NO_DECAY_NAMES.search(name)
            for name, p in named_params(params).items()}


def layer_id_from_path(name: str, num_layers: int) -> int:
    """BEiT-style layer id: embeddings and patch embed → 0, ``layers.i``
    → i + 1, everything else (head, final norm) → num_layers."""
    if "pos_embed" in name or "cls_token" in name:
        return 0
    if name.startswith("patch_embed") or ".patch_embed" in name:
        return 0
    m = re.search(r"layers\.(\d+)", name)
    if m:
        return int(m.group(1)) + 1
    return num_layers


def layer_decay_scales(params: Params, layer_decay: float,
                       depth: int) -> Dict[str, float]:
    """Per-parameter LR scale with the alternate-layer rule:
    scale(layer k) = decay^((N−k)//2 + (N−k)%2), N = depth + 1, so that
    consecutive pairs of Mamba layers share a power."""
    num_layers = depth + 1

    def scale_for(k: int) -> float:
        n = num_layers - k
        return layer_decay ** (n // 2 + n % 2)

    return {name: scale_for(layer_id_from_path(name, num_layers))
            for name in named_params(params)}


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """g with exactly p's strides, which the fused update compares: a
    contiguous gradient may still differ from its contiguous parameter in
    the stride of a size-1 dimension."""
    if g.stride() == p.stride():
        return g
    if p.is_contiguous():
        g = g.contiguous()
        return g.as_strided(p.shape, p.stride(), g.storage_offset())
    return torch.empty_like(p).copy_(g)


class ScheduledAdamW:
    """``torch.optim.AdamW`` over (decays, scale) groups, with the
    schedules, the global-norm clip and the gradient accumulation of the
    JAX package's ``make_optimizer``. ``apply(grads)`` takes one
    gradient per parameter, by name; every ``accum_steps``-th call
    updates the parameters in place with the mean of the gradients since
    the last update, the others only accumulate. The schedules count
    updates, not calls."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 lr_schedule: Callable[[float], float],
                 weight_decay: float, betas: Sequence[float], eps: float,
                 scales: Optional[Dict[str, float]],
                 grad_clip: Optional[float],
                 wd_schedule: Optional[Callable[[float], float]],
                 accum_steps: int):
        self.params = params
        self.lr_schedule = lr_schedule
        self.wd_schedule = wd_schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.accum_steps = accum_steps
        self.count = 0       # parameter updates done
        self.mini_step = 0   # calls since the last update
        self._acc: Optional[Dict[str, torch.Tensor]] = None
        mask = wd_mask(params)
        groups: Dict[tuple, list] = {}
        for name, p in params.items():
            key = (mask[name], 1.0 if scales is None else scales[name])
            groups.setdefault(key, []).append(p)
        # on the card, one fused update kernel per group instead of a dozen
        # foreach launches: the step is host-bound otherwise
        self.opt = torch.optim.AdamW(
            [dict(params=ps, decays=decays, scale=scale)
             for (decays, scale), ps in groups.items()],
            lr=lr_schedule(0), betas=tuple(betas), eps=eps, weight_decay=0.0,
            fused=all(p.is_cuda for p in params.values()))

    def apply(self, grads: Mapping[str, torch.Tensor]) -> bool:
        """Returns True when the parameters were updated."""
        k = self.accum_steps
        if k > 1:
            if self._acc is None:
                self._acc = {n: torch.zeros_like(g) for n, g in grads.items()}
            for n, g in grads.items():
                self._acc[n].add_(g, alpha=1.0 / k)
            self.mini_step += 1
            if self.mini_step < k:
                return False
            grads, self._acc, self.mini_step = self._acc, None, 0
        if self.grad_clip is not None:
            # optax.clip_by_global_norm: g · max_norm / ‖g‖ above max_norm
            norm = global_norm(grads.values())
            coef = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                               self.grad_clip / norm)
            grads = {n: g * coef.to(g.dtype) for n, g in grads.items()}
        lr = self.lr_schedule(self.count)
        wd = (self.wd_schedule(self.count) if self.wd_schedule is not None
              else self.weight_decay)
        for group in self.opt.param_groups:
            group["lr"] = lr * group["scale"]
            group["weight_decay"] = wd if group["decays"] else 0.0
        for n, p in self.params.items():
            p.grad = _laid_out_as(grads[n].to(p.dtype), p)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return True


def make_optimizer(lr_schedule: Callable[[float], float],
                   weight_decay: float = 0.05,
                   betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                   params: Optional[Params] = None,
                   layer_decay: Optional[float] = None,
                   depth: Optional[int] = None,
                   grad_clip: Optional[float] = None,
                   wd_schedule: Optional[Callable[[float], float]] = None,
                   accum_steps: int = 1) -> ScheduledAdamW:
    """AdamW with the reference's grouping rules over ``params`` (a model
    or a name → parameter mapping; required). ``wd_schedule`` overrides
    the constant ``weight_decay``; ``layer_decay`` needs ``depth``."""
    if params is None:
        raise ValueError("make_optimizer needs params (a model or a "
                         "name → parameter mapping)")
    scales = None
    if layer_decay is not None:
        if depth is None:
            raise ValueError("layer_decay needs depth")
        scales = layer_decay_scales(params, layer_decay, depth)
    return ScheduledAdamW(named_params(params), lr_schedule, weight_decay,
                          betas, eps, scales, grad_clip, wd_schedule,
                          accum_steps)


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor],
               params: Mapping[str, torch.Tensor],
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """One EMA step, in place: ema ← d·ema + (1 − d)·p."""
    for name, e in ema_params.items():
        e.mul_(decay).add_(params[name].to(e.dtype), alpha=1.0 - decay)
    return ema_params
