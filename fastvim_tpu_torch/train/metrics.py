"""Evaluation metrics beyond top-1: the confusion matrix and its mean IoU
(ADE20K), and COCO-style box and mask AP.

Counterpart of ``fastvim_tpu/train/metrics.py``. The AP functions run on
the host in numpy, on the detector's padded predictions, as the JAX
package's do; ``box_iou`` is the torch one of ``ops/boxes.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from fastvim_tpu_torch.ops.boxes import box_iou


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


# ---------------------------------------------------------------------
# COCO-style AP (the mmdet CocoMetric bbox/segm counterparts): one
# matching/AP core; bbox and segm differ only in how a class's candidate
# rows and their IoU vectors are built.
# ---------------------------------------------------------------------

def _ap_from_rows(rows, gt_counts, iou_thr: float) -> float:
    """COCO 101-point-interpolated AP of one class (pycocotools'
    COCOeval.accumulate, which mmdet's CocoMetric reports: the precision
    envelope sampled at recall 0:.01:1 by searchsorted).

    rows: score-descending list of (img_idx, ious over that image's gts
    of the class); gt_counts: {img_idx: n_gt}. A row matches the best
    unmatched gt at IoU >= ``iou_thr``."""
    matched = {i: np.zeros(n, bool) for i, n in gt_counts.items()}
    n_gt = sum(gt_counts.values())
    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for k, (i, ious) in enumerate(rows):
        m = matched.get(i)
        cand = (np.where((ious >= iou_thr) & ~m)[0]
                if m is not None and ious.size else np.empty(0, int))
        if cand.size:
            j = int(cand[np.argmax(ious[cand])])
            tp[k] = 1
            matched[i][j] = True
        else:
            fp[k] = 1
    if not len(rows):
        return 0.0
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / (ctp + cfp + np.spacing(1))
    for k in range(len(precision) - 1, 0, -1):
        if precision[k] > precision[k - 1]:
            precision[k - 1] = precision[k]
    rec_thrs = np.linspace(0.0, 1.0, 101)
    inds = np.searchsorted(recall, rec_thrs, side="left")
    q = np.zeros(101)
    valid = inds < len(precision)
    q[valid] = precision[inds[valid]]
    return float(q.mean())


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _valid_mask(d, key="boxes"):
    return _np(d.get("valid", np.ones(len(_np(d[key])), bool)))


def _box_class_rows(predictions, ground_truths, c):
    """(rows, gt_counts) of class c with box IoUs (float32, computed
    once a prediction), or None when no image holds a gt of c."""
    gt_boxes, gt_counts = [], {}
    for i, g in enumerate(ground_truths):
        m = (_np(g["labels"]) == c) & _valid_mask(g)
        gt_boxes.append(_np(g["boxes"])[m])
        if m.sum():
            gt_counts[i] = int(m.sum())
    if not gt_counts:
        return None
    rows = []
    for i, p in enumerate(predictions):
        m = (_np(p["labels"]) == c) & _valid_mask(p)
        boxes, scores = _np(p["boxes"])[m], _np(p["scores"])[m]
        g = gt_boxes[i]
        ious_all = (box_iou(torch.as_tensor(boxes, dtype=torch.float32),
                            torch.as_tensor(g, dtype=torch.float32)).numpy()
                    if len(boxes) and len(g)
                    else np.zeros((len(boxes), len(g))))
        for k, s in enumerate(scores):
            rows.append((float(s), i, ious_all[k]))
    rows.sort(key=lambda r: -r[0])
    return [(i, iou) for _, i, iou in rows], gt_counts


def _mask_class_rows(predictions, ground_truths, c):
    """As :func:`_box_class_rows`, with the IoUs of pasted masks."""
    gt_masks, gt_counts = [], {}
    for i, g in enumerate(ground_truths):
        m = (_np(g["labels"]) == c) & _valid_mask(g)
        gt_masks.append(_np(g["masks"])[m].astype(bool))
        if m.sum():
            gt_counts[i] = int(m.sum())
    if not gt_counts:
        return None

    def mask_iou(a, b):
        union = np.logical_or(a, b).sum()
        return np.logical_and(a, b).sum() / max(union, 1)

    rows = []
    for i, p in enumerate(predictions):
        m = (_np(p["labels"]) == c) & _valid_mask(p)
        H, W = _np(ground_truths[i]["masks"]).shape[-2:]
        for b, s, pm in zip(_np(p["boxes"])[m], _np(p["scores"])[m],
                            _np(p["masks"])[m]):
            pmask = paste_mask(pm, b, H, W)
            ious = np.array([mask_iou(pmask, gm) for gm in gt_masks[i]])
            rows.append((float(s), i, ious))
    rows.sort(key=lambda r: -r[0])
    return [(i, iou) for _, i, iou in rows], gt_counts


def box_average_precision(predictions, ground_truths,
                          iou_thr: float = 0.5,
                          num_classes: int = 80) -> float:
    """COCO-style single-IoU mean box AP over the classes that have a gt.

    predictions: per image {"boxes" (N, 4), "scores" (N,), "labels"
    (N,), optional "valid" (N,)}, the detector's padded prediction;
    ground_truths: per image {"boxes" (G, 4), "labels" (G,), optional
    "valid"}; numpy arrays."""
    aps = []
    for c in range(num_classes):
        rg = _box_class_rows(predictions, ground_truths, c)
        if rg is not None:
            aps.append(_ap_from_rows(*rg, iou_thr))
    return float(np.mean(aps)) if aps else 0.0


def mask_average_precision(predictions, ground_truths,
                           iou_thr: float = 0.5,
                           num_classes: int = 80) -> float:
    """Instance-segmentation AP at one IoU threshold: the predicted (m, m)
    RoI masks pasted at their boxes (:func:`paste_mask`) and matched to
    the gt masks by mask IoU. predictions also hold "masks" (N, m, m)
    probabilities; ground_truths "masks" (G, H, W) {0, 1}."""
    aps = []
    for c in range(num_classes):
        rg = _mask_class_rows(predictions, ground_truths, c)
        if rg is not None:
            aps.append(_ap_from_rows(*rg, iou_thr))
    return float(np.mean(aps)) if aps else 0.0


def paste_mask(mask28, box, H: int, W: int, thr: float = 0.5) -> np.ndarray:
    """A (m, m) RoI mask probability map pasted into a (H, W) bool canvas
    at ``box`` (mmdet FCNMaskHead paste, bilinear), clipped to the
    canvas; a box off the canvas gives an empty mask."""
    x1, y1, x2, y2 = [float(v) for v in box]
    w = max(int(round(x2 - x1)), 1)
    h = max(int(round(y2 - y1)), 1)
    m = _np(mask28).astype(np.float32)
    ys = (np.arange(h) + 0.5) / h * m.shape[0] - 0.5
    xs = (np.arange(w) + 0.5) / w * m.shape[1] - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, m.shape[0] - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, m.shape[1] - 1)
    y1i = np.clip(y0 + 1, 0, m.shape[0] - 1)
    x1i = np.clip(x0 + 1, 0, m.shape[1] - 1)
    wy = np.clip(ys, 0, m.shape[0] - 1) - y0
    wx = np.clip(xs, 0, m.shape[1] - 1) - x0
    patch = (m[np.ix_(y0, x0)] * (1 - wy)[:, None] * (1 - wx)[None]
             + m[np.ix_(y0, x1i)] * (1 - wy)[:, None] * wx[None]
             + m[np.ix_(y1i, x0)] * wy[:, None] * (1 - wx)[None]
             + m[np.ix_(y1i, x1i)] * wy[:, None] * wx[None])
    canvas = np.zeros((H, W), bool)
    ox, oy = int(round(x1)), int(round(y1))
    oy2, ox2 = max(oy, 0), max(ox, 0)
    ey, ex = min(oy + h, H), min(ox + w, W)
    if ey > oy2 and ex > ox2:
        canvas[oy2:ey, ox2:ex] = \
            patch[oy2 - oy:ey - oy, ox2 - ox:ex - ox] >= thr
    return canvas


def coco_map(predictions, ground_truths, num_classes: int = 80) -> dict:
    """COCO mAP@[.5:.95] with AP50 and AP75 (mmdet CocoMetric's bbox
    headline numbers); a class's IoUs are computed once and matched again
    at each threshold."""
    thrs = np.arange(0.5, 1.0, 0.05)
    per_thr = [[] for _ in thrs]
    for c in range(num_classes):
        rg = _box_class_rows(predictions, ground_truths, c)
        if rg is None:
            continue
        rows, gt_counts = rg
        for t, thr in enumerate(thrs):
            per_thr[t].append(_ap_from_rows(rows, gt_counts, float(thr)))
    if not per_thr[0]:
        return {"mAP": 0.0, "AP50": 0.0, "AP75": 0.0}
    aps = [float(np.mean(a)) for a in per_thr]
    return {"mAP": float(np.mean(aps)), "AP50": aps[0], "AP75": aps[5]}
