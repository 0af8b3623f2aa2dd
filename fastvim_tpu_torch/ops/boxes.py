"""Static-shape box operations for the detection harness.

Counterpart of ``fastvim_tpu/ops/boxes.py`` (the mmdetection primitives of
the ViTDet cascade Mask R-CNN recipe: AnchorGenerator,
DeltaXYWHBBoxCoder, MaxIoUAssigner, RandomSampler, NMS and RoIAlign) in
plain torch; torchvision is not used. Box sets keep fixed sizes with
validity masks, as in the JAX package, and every function computes what
its JAX namesake computes:

* sorts are stable (``torch.sort(..., stable=True)``), as ``jnp.argsort``
  is, and where JAX takes ``jax.lax.top_k`` (the lower index first among
  equal values) the port takes the first k of a stable descending sort;
  ties are common (the ``-inf`` scores of invalid boxes, the sampler's
  priorities);
* the packing of kept indices scatters only the selected ranks (the
  others go to a spare slot that is cut off), as ``.at[].set(mode="drop")``
  does;
* ``random_sample`` draws its two uniform vectors from a
  ``torch.Generator`` and hands them to ``sample_from_draws``, which holds
  the selection: given JAX's own draws it selects what JAX selects;
* ``nms`` iterates its suppression fixpoint in a Python loop whose exit
  test reads the device (one sync a round, at most ``max_rounds``, forced
  odd);
* ``roi_align`` contracts two hat-function matrices with the features, as
  the JAX package does (its default order, x first, and without its
  chunking over RoIs: the intermediate is transient here), in an
  ``autograd.Function`` that keeps only the two small matrices for the
  backward (the RoIs carry no gradient).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------
# anchors (mmdet AnchorGenerator: scales=[8], ratios=[0.5,1,2],
# strides=[4,8,16,32,64])
# --------------------------------------------------------------------


def generate_anchors(featmap_sizes: Sequence[Tuple[int, int]],
                     strides: Sequence[int],
                     scales: Sequence[float] = (8,),
                     ratios: Sequence[float] = (0.5, 1.0, 2.0)
                     ) -> np.ndarray:
    """Concatenated (sum_i Hi*Wi*A, 4) xyxy anchors over pyramid levels,
    float32 numpy. Centers at stride/2 offsets; base size = scale ·
    stride."""
    all_anchors = []
    for (H, W), stride in zip(featmap_sizes, strides):
        base = []
        for r in ratios:
            for s in scales:
                size = s * stride
                w = size * math.sqrt(1.0 / r)
                h = size * math.sqrt(r)
                base.append([-w / 2, -h / 2, w / 2, h / 2])
        base = np.asarray(base, np.float32)  # (A, 4)
        ys = (np.arange(H, dtype=np.float32) + 0.5) * stride
        xs = (np.arange(W, dtype=np.float32) + 0.5) * stride
        cx, cy = np.meshgrid(xs, ys)  # (H, W)
        centers = np.stack([cx, cy, cx, cy], -1).reshape(-1, 1, 4)
        anchors = (centers + base[None]).reshape(-1, 4)
        all_anchors.append(anchors)
    return np.concatenate(all_anchors, 0)


# --------------------------------------------------------------------
# DeltaXYWH box coder (mmdet DeltaXYWHBBoxCoder)
# --------------------------------------------------------------------

def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def delta_encode(boxes: torch.Tensor, gt: torch.Tensor,
                 means=(0.0, 0.0, 0.0, 0.0),
                 stds=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """(…, 4) xyxy source/target boxes → normalized dx, dy, dw, dh."""
    pw = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-6)
    ph = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
    px = (boxes[..., 0] + boxes[..., 2]) * 0.5
    py = (boxes[..., 1] + boxes[..., 3]) * 0.5
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-6)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-6)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    d = torch.stack([(gx - px) / pw, (gy - py) / ph,
                     torch.log(gw / pw), torch.log(gh / ph)], -1)
    return (d - _vec(means, d)) / _vec(stds, d)


def delta_decode(boxes: torch.Tensor, deltas: torch.Tensor,
                 means=(0.0, 0.0, 0.0, 0.0),
                 stds=(1.0, 1.0, 1.0, 1.0),
                 max_shape: Optional[Tuple[int, int]] = None,
                 wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """Apply (…, 4) deltas to (…, 4) xyxy boxes; clipped to ``max_shape``
    (H, W) when given."""
    d = deltas * _vec(stds, deltas) + _vec(means, deltas)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    pw = boxes[..., 2] - boxes[..., 0]
    ph = boxes[..., 3] - boxes[..., 1]
    px = (boxes[..., 0] + boxes[..., 2]) * 0.5
    py = (boxes[..., 1] + boxes[..., 3]) * 0.5
    gx = px + pw * d[..., 0]
    gy = py + ph * d[..., 1]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    out = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                       gx + gw * 0.5, gy + gh * 0.5], -1)
    if max_shape is not None:
        H, W = max_shape
        out = torch.stack([out[..., 0].clamp(0, W), out[..., 1].clamp(0, H),
                           out[..., 2].clamp(0, W), out[..., 3].clamp(0, H)],
                          -1)
    return out


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (N, 4) and (M, 4) xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(1e-9)


# --------------------------------------------------------------------
# static NMS
# --------------------------------------------------------------------

def _finite_or_neg_inf(scores: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(scores), scores,
                       torch.full_like(scores, -math.inf))


def _descending(scores: torch.Tensor) -> torch.Tensor:
    """Indices of ``scores`` from the largest down, equal values in index
    order (``jnp.argsort(-scores)``)."""
    return torch.sort(-scores, stable=True).indices


def top_k_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k(values, k)[1]`` on a 1-D tensor: the k largest,
    the lower index first among equal values."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


def nms_scan(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS as the literal sequential recurrence: ``max_out`` rounds
    of argmax + suppress, the parity oracle of :func:`nms`. Returns
    (indices (max_out,) int64, valid (max_out,) bool); an exhausted slot
    has index 0 and valid False."""
    n = boxes.shape[0]
    iou = box_iou(boxes, boxes)
    live = _finite_or_neg_inf(scores)
    ar = torch.arange(n, device=boxes.device)
    idx, valid = [], []
    for _ in range(max_out):
        best = torch.argmax(live)
        keep = live[best] > -math.inf
        suppress = (iou[best] > iou_threshold) | (ar == best)
        live = torch.where(suppress & keep, torch.full_like(live, -math.inf),
                           live)
        idx.append(torch.where(keep, best, torch.zeros_like(best)))
        valid.append(keep)
    return torch.stack(idx), torch.stack(valid)


def _pack(keep: torch.Tensor, order: torch.Tensor, max_out: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``max_out`` kept entries of ``order`` (sorted order =
    selection order) into (indices (max_out,), valid (max_out,))."""
    rank = torch.cumsum(keep, 0) - 1
    sel = keep & (rank < max_out)
    out = torch.zeros(max_out + 1, dtype=torch.long, device=order.device)
    slot = torch.where(sel, rank, torch.full_like(rank, max_out))
    out.scatter_(0, slot, order)  # the spare last slot takes the rest
    valid = torch.arange(max_out, device=order.device) < sel.sum()
    return out[:max_out], valid


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, max_rounds: int = 65
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS as a suppression fixpoint (the JAX package's
    ``nms``): in descending score order, keep ← finite ∧ ¬any_i(tri_ij ∧
    keep_i), iterated from keep = finite until nothing changes or
    ``max_rounds`` rounds (forced odd, so that a capped exit keeps a
    subset of what greedy NMS keeps) have run. Each round's exit test
    reads the device once. Returns what :func:`nms_scan` returns."""
    n = boxes.shape[0]
    max_rounds |= 1  # odd ⇒ capped exit is a subset of the fixpoint
    finite = torch.isfinite(scores)
    order = _descending(torch.where(finite, scores,
                                    torch.full_like(scores, -math.inf)))
    b = boxes[order]
    tri = torch.triu(box_iou(b, b) > iou_threshold, diagonal=1)
    fin = finite[order]

    def body(k):
        return fin & ~(tri & k[:, None]).any(0)

    k = body(fin)
    changed, rounds = bool((k != fin).any()), 1
    while changed and rounds < min(n, max_rounds):
        k_new = body(k)
        changed, k = bool((k_new != k).any()), k_new
        rounds += 1
    return _pack(k, order, max_out)


def fast_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot matrix NMS (YOLACT "Fast NMS"): box i is kept iff no
    higher-scored box overlaps it above the threshold, suppressed or not;
    the training path's proposal NMS. Same contract as :func:`nms`."""
    scores = _finite_or_neg_inf(scores)
    order = _descending(scores)
    b = boxes[order]
    tri = torch.triu(box_iou(b, b), diagonal=1)
    suppressed = (tri > iou_threshold).any(0)
    keep = ~suppressed & torch.isfinite(scores[order])
    return _pack(keep, order, max_out)


# --------------------------------------------------------------------
# MaxIoUAssigner and RandomSampler (mmdet semantics)
# --------------------------------------------------------------------

def max_iou_assign(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, pos_iou_thr: float,
                   neg_iou_thr: float, min_pos_iou: float = 0.0,
                   match_low_quality: bool = False) -> torch.Tensor:
    """Returns assigned_gt (N,) int64: -1 = negative, -2 = ignore, >= 0 =
    the matched gt index. ``gt_valid`` masks padded gt rows. With
    ``match_low_quality`` each gt claims its best-overlapping boxes (at
    IoU >= ``min_pos_iou``), the highest-index gt winning ties."""
    iou = box_iou(boxes, gt_boxes)  # (N, G)
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    max_iou = iou.max(1).values
    argmax = iou.argmax(1)
    assigned = torch.full_like(argmax, -2)
    assigned = torch.where(max_iou < neg_iou_thr,
                           torch.full_like(assigned, -1), assigned)
    assigned = torch.where(max_iou >= pos_iou_thr, argmax, assigned)
    if match_low_quality:
        gt_best = iou.max(0).values  # (G,)
        claim = ((iou == gt_best[None, :]) & (iou >= min_pos_iou)
                 & gt_valid[None, :])
        gt_ids = torch.arange(gt_boxes.shape[0], device=boxes.device)
        claimed = torch.where(claim, gt_ids[None, :],
                              torch.full_like(claim, -1, dtype=torch.long)
                              ).max(1).values
        assigned = torch.where(claimed >= 0, claimed, assigned)
    return assigned


def sample_from_draws(assigned: torch.Tensor, u_pos: torch.Tensor,
                      u_neg: torch.Tensor, num: int, pos_fraction: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RandomSampler's selection given its two (n,) uniform draws:
    up to num·pos_fraction positives (those ranked first by ``u_pos``),
    negatives fill the rest (ranked by ``u_neg``). Returns (indices
    (num,), is_pos (num,) bool, valid (num,) bool); valid falls short
    only when the candidates run out."""
    num_pos_max = int(num * pos_fraction)
    pos_mask = assigned >= 0
    neg_mask = assigned == -1
    pos_rand = torch.where(pos_mask, u_pos, torch.full_like(u_pos, -1.0))
    order = _descending(pos_rand)
    pos_rank = torch.empty_like(order)
    pos_rank[order] = torch.arange(order.numel(), device=order.device)
    eligible_pos = pos_mask & (pos_rank < num_pos_max)
    # priority: quota positives (2+u) > negatives (1+u) > excluded (-inf)
    priority = torch.where(eligible_pos, 2.0 + u_neg,
                           torch.where(neg_mask, 1.0 + u_neg,
                                       torch.full_like(u_neg, -math.inf)))
    idx = top_k_indices(priority, num)
    valid = priority[idx] > 0.0
    is_pos = pos_mask[idx] & valid
    return idx, is_pos, valid


def random_sample(generator: torch.Generator, assigned: torch.Tensor,
                  num: int, pos_fraction: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mmdet's RandomSampler (neg_pos_ub=-1): draws u_pos, then u_neg,
    each (n,) uniform on ``generator``'s device, moves them to
    ``assigned``'s and selects with :func:`sample_from_draws`."""
    n = assigned.shape[0]
    u_pos = torch.rand(n, generator=generator, device=generator.device)
    u_neg = torch.rand(n, generator=generator, device=generator.device)
    dev = assigned.device
    return sample_from_draws(assigned, u_pos.to(dev), u_neg.to(dev), num,
                             pos_fraction)


# --------------------------------------------------------------------
# RoIAlign (mmdet RoIAlign, aligned=True, a fixed 2×2 sample grid per bin)
# --------------------------------------------------------------------

def hat_matrices(rois: torch.Tensor, height: int, width: int, out_size: int,
                 spatial_scale: float, sampling: int = 2
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RoIs' bilinear sampling as two float32 hat-function matrices,
    Y (R, out_size, height) and X (R, out_size, width): the sample
    centers (``sampling`` per bin and axis, half-pixel offset, clipped to
    the map) weighted by max(0, 1 − |coordinate − pixel|) and averaged
    over each bin's samples."""
    boxes = rois.float() * spatial_scale
    x1, y1, x2, y2 = boxes.unbind(-1)
    bw = (x2 - x1).clamp_min(1e-6)
    bh = (y2 - y1).clamp_min(1e-6)
    s = out_size * sampling
    steps = (torch.arange(s, dtype=torch.float32, device=rois.device)
             + 0.5) / s
    ys = (y1[:, None] + steps[None, :] * bh[:, None] - 0.5).clamp(
        0, height - 1)
    xs = (x1[:, None] + steps[None, :] * bw[:, None] - 0.5).clamp(
        0, width - 1)
    iy = torch.arange(height, dtype=torch.float32, device=rois.device)
    ix = torch.arange(width, dtype=torch.float32, device=rois.device)
    Y = (1 - (ys[..., None] - iy).abs()).clamp_min(0)  # (R, s, H)
    X = (1 - (xs[..., None] - ix).abs()).clamp_min(0)  # (R, s, W)
    R = rois.shape[0]
    return (Y.reshape(R, out_size, sampling, height).mean(2),
            X.reshape(R, out_size, sampling, width).mean(2))


def _contract(feat, Y, X):
    """out[r, i, j, c] = Σ_h Σ_w Y[r, i, h] X[r, j, w] feat[h, w, c]: the
    contraction over w first (the JAX package's default order), as two
    GEMMs."""
    H, W, C = feat.shape
    R, o = Y.shape[:2]
    tmp = X.reshape(R * o, W) @ feat.transpose(0, 1).reshape(W, H * C)
    # (R, j, H, C); out[r, j, i, c] = Σ_h Y[r, i, h] tmp[r, j, h, c]
    return (Y[:, None] @ tmp.reshape(R, o, H, C)).transpose(1, 2)


class _HatContraction(torch.autograd.Function):
    """:func:`_contract`, keeping only Y and X for the backward (the
    (R, out, H, C) intermediate is transient): the gradient flows to the
    features only."""

    @staticmethod
    def forward(ctx, feat, Y, X):
        ctx.save_for_backward(Y, X)
        return _contract(feat, Y, X)

    @staticmethod
    def backward(ctx, g):
        Y, X = ctx.saved_tensors
        R, o, _, C = g.shape
        H, W = Y.shape[2], X.shape[2]
        # t[r, j, h, c] = Σ_i Y[r, i, h] g[r, i, j, c]
        t = Y.transpose(1, 2)[:, None] @ g.transpose(1, 2)
        d = X.reshape(R * o, W).T @ t.reshape(R * o, H * C)
        return d.reshape(W, H, C).transpose(0, 1), None, None


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out_size: int,
              spatial_scale: float, sampling: int = 2) -> torch.Tensor:
    """feat (H, W, C); rois (R, 4) xyxy in image coordinates (no
    gradient) → (R, out_size, out_size, C) by bilinear sampling,
    ``sampling``² samples a bin averaged. The coordinates and hat weights
    are float32 whatever ``feat``'s dtype; the matrices are cast to it
    for the contraction."""
    H, W, _ = feat.shape
    Y, X = hat_matrices(rois.detach(), H, W, out_size, spatial_scale,
                        sampling)
    return _HatContraction.apply(feat, Y.to(feat.dtype), X.to(feat.dtype))


def roi_levels(rois: torch.Tensor, num_levels: int,
               finest_scale: float = 56.0) -> torch.Tensor:
    """mmdet SingleRoIExtractor's level of each RoI: floor(log2(√area /
    finest_scale + 1e-6)) clamped to [0, num_levels − 1]."""
    scale = torch.sqrt(((rois[:, 2] - rois[:, 0])
                        * (rois[:, 3] - rois[:, 1])).clamp_min(1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         out_size: int, strides: Sequence[int],
                         finest_scale: float = 56.0) -> torch.Tensor:
    """FPN-level-routed RoIAlign over per-level (H_l, W_l, C) maps of one
    image: RoIAlign on every level, then each RoI's row from its level
    (:func:`roi_levels`)."""
    lvl = roi_levels(rois, len(feats), finest_scale)
    outs = torch.stack([
        roi_align(f, rois, out_size, 1.0 / s)
        for f, s in zip(feats, strides)])  # (L, R, o, o, C)
    return outs[lvl, torch.arange(rois.shape[0], device=rois.device)]
