"""Detection data pipeline: a COCO-format folder reader, LSJ-1024
augmentation and synthetic data.

Counterpart of ``fastvim_tpu/data/detection.py`` (the reference's mmdet
pipeline, lsj-100e_coco-instance.py: RandomFlip 0.5 → keep-ratio
RandomResize at scale 0.1-2.0 → RandomCrop 1024 → FilterAnnotations (min
1e-2 wh) → Pad to 1024 with 114). Batches keep fixed shapes: boxes,
labels and masks padded to ``max_gt`` with a validity mask. For the same
seed, epoch and dataset the batches are bitwise the JAX package's (the
shuffle and the per-sample ``random.Random(hash((seed, epoch, j)))`` of
``data/loader.py``). PIL is imported inside the functions that use it.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from fastvim_tpu_torch.data.loader import DataLoader

PAD_VALUE = 114.0
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


class SyntheticDetectionDataset:
    """Deterministic random rectangles with box-fill masks."""

    def __init__(self, num_samples: int, img_size: int = 1024,
                 num_classes: int = 80, max_objects: int = 6):
        self.num_samples = num_samples
        self.img_size = img_size
        self.num_classes = num_classes
        self.max_objects = max_objects

    def __len__(self):
        return self.num_samples

    def load(self, idx: int):
        rng = np.random.default_rng(idx)
        S = self.img_size
        img = rng.integers(0, 256, (S, S, 3), np.uint8)
        n = int(rng.integers(1, self.max_objects + 1))
        boxes, labels, masks = [], [], []
        for _ in range(n):
            x1, y1 = rng.uniform(0, S * 0.7, 2)
            w, h = rng.uniform(S * 0.1, S * 0.3, 2)
            box = [x1, y1, min(x1 + w, S - 1), min(y1 + h, S - 1)]
            boxes.append(box)
            labels.append(int(rng.integers(0, self.num_classes)))
            m = np.zeros((S, S), np.uint8)
            m[int(box[1]):int(box[3]), int(box[0]):int(box[2])] = 1
            masks.append(m)
            # paint the object so the task is learnable
            img[int(box[1]):int(box[3]), int(box[0]):int(box[2])] = \
                (40 * (labels[-1] % 5) + 30)
        return (img, np.asarray(boxes, np.float32),
                np.asarray(labels, np.int32),
                np.stack(masks))


class CocoDetectionDataset:
    """Minimal COCO-format reader: ``instances_*.json`` + image folder.

    Polygon segmentations are rasterized with PIL; RLE masks are not
    supported (raises with a clear message). Categories remap to a
    contiguous [0, C) range sorted by original id."""

    def __init__(self, img_dir: str, ann_file: str):
        self.img_dir = img_dir
        with open(ann_file) as f:
            coco = json.load(f)
        cat_ids = sorted(c["id"] for c in coco["categories"])
        self.cat_remap = {cid: i for i, cid in enumerate(cat_ids)}
        self.num_classes = len(cat_ids)
        anns_by_img: Dict[int, list] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.items = []
        for im in coco["images"]:
            anns = anns_by_img.get(im["id"], [])
            if anns:  # filter_empty_gt=True (lsj config :52)
                self.items.append((im, anns))

    def __len__(self):
        return len(self.items)

    def load(self, idx: int):
        from PIL import Image, ImageDraw

        im, anns = self.items[idx]
        path = os.path.join(self.img_dir, im["file_name"])
        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB"), np.uint8)
        H, W = arr.shape[:2]
        boxes, labels, masks = [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            labels.append(self.cat_remap[a["category_id"]])
            seg = a.get("segmentation")
            m = Image.new("L", (W, H), 0)
            if isinstance(seg, list):
                d = ImageDraw.Draw(m)
                for poly in seg:
                    d.polygon([tuple(poly[i:i + 2])
                               for i in range(0, len(poly), 2)], fill=1)
            elif seg is not None:
                raise NotImplementedError(
                    "RLE segmentation masks are not supported — "
                    "use polygon annotations")
            masks.append(np.asarray(m, np.uint8))
        return (arr, np.asarray(boxes, np.float32),
                np.asarray(labels, np.int32), np.stack(masks))


def lsj_transform(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                  masks: np.ndarray, rng: random.Random, out_size: int,
                  scale_range: Tuple[float, float] = (0.1, 2.0),
                  training: bool = True):
    """Large-scale-jitter: flip → keep-ratio resize by a random factor →
    random crop/pad to (out_size, out_size) → filter degenerate boxes.
    Eval: keep-ratio resize to fit out_size + pad."""
    from PIL import Image

    H, W = img.shape[:2]
    if training and rng.random() < 0.5:
        img = img[:, ::-1]
        masks = masks[:, :, ::-1]
        boxes = boxes.copy()
        boxes[:, [0, 2]] = W - boxes[:, [2, 0]]

    if training:
        s = rng.uniform(*scale_range) * min(out_size / H, out_size / W)
    else:
        s = min(out_size / H, out_size / W)
    nh, nw = max(1, int(round(H * s))), max(1, int(round(W * s)))
    pil = Image.fromarray(img)
    img_r = np.asarray(pil.resize((nw, nh), Image.BILINEAR), np.float32)
    masks_r = np.stack([
        np.asarray(Image.fromarray(m * 255).resize((nw, nh),
                                                   Image.NEAREST))
        for m in masks]) > 127
    boxes = boxes * s

    # crop (train, absolute_range up to out_size) / top-left place (eval)
    if training:
        oy = rng.randint(0, max(nh - out_size, 0)) if nh > out_size else 0
        ox = rng.randint(0, max(nw - out_size, 0)) if nw > out_size else 0
    else:
        oy = ox = 0
    img_c = img_r[oy:oy + out_size, ox:ox + out_size]
    masks_c = masks_r[:, oy:oy + out_size, ox:ox + out_size]
    boxes = boxes - np.array([ox, oy, ox, oy], np.float32)

    ch, cw = img_c.shape[:2]
    canvas = np.full((out_size, out_size, 3), PAD_VALUE, np.float32)
    canvas[:ch, :cw] = img_c
    mcanvas = np.zeros((masks.shape[0], out_size, out_size), bool)
    mcanvas[:, :ch, :cw] = masks_c

    boxes = np.stack([np.clip(boxes[:, 0], 0, cw),
                      np.clip(boxes[:, 1], 0, ch),
                      np.clip(boxes[:, 2], 0, cw),
                      np.clip(boxes[:, 3], 0, ch)], -1)
    keep = ((boxes[:, 2] - boxes[:, 0]) > 1e-2) & \
        ((boxes[:, 3] - boxes[:, 1]) > 1e-2)
    image = (canvas - IMAGENET_MEAN) / IMAGENET_STD
    return image, boxes[keep], labels[keep], mcanvas[keep]


class DetectionLoader(DataLoader):
    """Batches padded to ``max_gt``: {"image" (B,S,S,3), "boxes"
    (B,G,4), "labels" (B,G), "masks" (B,G,S,S) uint8, "gt_valid" (B,G)}."""

    def __init__(self, dataset, batch_size: int, img_size: int,
                 max_gt: int = 32, training: bool = True,
                 scale_range=(0.1, 2.0), **kw):
        super().__init__(dataset, batch_size, transform=None, **kw)
        self.img_size = img_size
        self.max_gt = max_gt
        self.training = training
        self.scale_range = scale_range

    def _load_batch(self, batch_idx, epoch: int) -> dict:
        G, S = self.max_gt, self.img_size
        B = len(batch_idx)
        out = {
            "image": np.zeros((B, S, S, 3), np.float32),
            "boxes": np.zeros((B, G, 4), np.float32),
            "labels": np.zeros((B, G), np.int32),
            "masks": np.zeros((B, G, S, S), np.uint8),
            "gt_valid": np.zeros((B, G), bool),
        }
        for bi, j in enumerate(batch_idx):
            img, boxes, labels, masks = self.dataset.load(int(j))
            rng = random.Random(hash((self.seed, epoch, int(j))))
            image, boxes, labels, masks = lsj_transform(
                img, boxes, labels, masks, rng, S, self.scale_range,
                self.training)
            n = min(len(boxes), G)
            out["image"][bi] = image
            out["boxes"][bi, :n] = boxes[:n]
            out["labels"][bi, :n] = labels[:n]
            out["masks"][bi, :n] = masks[:n]
            out["gt_valid"][bi, :n] = True
        return out


def create_detection_loader(data_dir: Optional[str], split: str,
                            batch_size: int, img_size: int,
                            training: bool, max_gt: int = 32,
                            num_workers: int = 4, seed: int = 0,
                            synthetic_samples: int = 64,
                            num_classes: int = 80):
    """COCO folder layout (``<dir>/<split>2017`` +
    ``<dir>/annotations/instances_<split>2017.json``) if present, else
    synthetic LSJ data."""
    if data_dir:
        img_dir = os.path.join(data_dir, f"{split}2017")
        ann = os.path.join(data_dir, "annotations",
                           f"instances_{split}2017.json")
        if os.path.isdir(img_dir) and os.path.exists(ann):
            ds = CocoDetectionDataset(img_dir, ann)
            return DetectionLoader(ds, batch_size, img_size, max_gt,
                                   training, shuffle=training,
                                   num_workers=num_workers, seed=seed,
                                   drop_last=training)
    ds = SyntheticDetectionDataset(synthetic_samples, img_size,
                                   num_classes)
    return DetectionLoader(ds, batch_size, img_size, max_gt, training,
                           shuffle=training, num_workers=num_workers,
                           seed=seed, drop_last=training)
