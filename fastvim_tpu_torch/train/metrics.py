"""Evaluation metrics beyond top-1: the confusion matrix and its mean IoU
(ADE20K).

Counterpart of the segmentation half of ``fastvim_tpu/train/metrics.py``;
the COCO half comes with detection.
"""

from __future__ import annotations

import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int, ignore_index: int = 255
                     ) -> torch.Tensor:
    """(num_classes, num_classes) float32 counts, rows = label, columns =
    prediction, over the pixels whose label is not ``ignore_index``."""
    valid = (label != ignore_index).reshape(-1)
    lbl = torch.where(valid, label.reshape(-1), 0).long()
    idx = torch.where(valid, lbl * num_classes + pred.reshape(-1).long(), 0)
    cm = torch.bincount(idx, weights=valid.float(),
                        minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def _ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of a 1-D tensor in the order XLA's CPU backend takes: while
    32 or more values remain, zero-pad them evenly on both ends to a
    multiple of 32 and add each run of 32 from left to right; then add what
    remains from left to right. ``Tensor.sum`` takes another order, which
    can move a float32 mean IoU by its last bit."""
    import torch.nn.functional as F

    def left_to_right(m):
        s = torch.zeros(m.shape[:-1], dtype=m.dtype, device=m.device)
        for i in range(m.shape[-1]):
            s = s + m[..., i]
        return s

    while v.numel() >= 32:
        pad = -v.numel() % 32
        v = left_to_right(F.pad(v, (pad // 2, pad - pad // 2)).reshape(-1, 32))
    return left_to_right(v)


def miou_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Mean IoU over the classes present in the labels (a 0-d tensor),
    bitwise equal to the JAX package's on the CPU."""
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    present = cm.sum(1) > 0
    iou = torch.where(union > 0, inter / union.clamp_min(1), 0.0)
    return _ordered_sum(iou * present) / present.sum().clamp_min(1)
