"""ADE20K semantic-segmentation data pipeline.

Counterpart of ``fastvim_tpu/data/segmentation.py``, the same operations
in the same order on the host (numpy and PIL, which is imported inside
the functions that decode or resize), so that for the same seed and
epoch the batches are bitwise the JAX package's. It follows the
reference's mmseg dataset config
(segmentation/configs/_base_/datasets/ade20k.py): train = RandomResize
(short-side 512, ratio 0.5–2.0) → RandomCrop 512 (cat_max_ratio 0.75) →
flip 0.5 → normalize → pad to 512 (label pad 255); eval = keep-ratio
resize to short side 512 (slide inference handles the long side).
ADE20K label PNGs use 0 = ignore, 1..150 = classes → reduce_zero_label
(shift −1, ignore 255).

Folder layout (standard ADEChallengeData2016):
  <root>/images/{training,validation}/*.jpg
  <root>/annotations/{training,validation}/*.png
"""

from __future__ import annotations

import itertools
import os
import random
from typing import Optional, Tuple

import numpy as np

from fastvim_tpu_torch.data.loader import DataLoader
from fastvim_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

IGNORE = 255


class ADE20KDataset:
    def __init__(self, root: str, split: str = "training"):
        img_dir = os.path.join(root, "images", split)
        ann_dir = os.path.join(root, "annotations", split)
        self.pairs = []
        for fname in sorted(os.listdir(img_dir)):
            stem, ext = os.path.splitext(fname)
            if ext.lower() not in (".jpg", ".jpeg", ".png"):
                continue
            ann = os.path.join(ann_dir, stem + ".png")
            if os.path.exists(ann):
                self.pairs.append((os.path.join(img_dir, fname), ann))
        if not self.pairs:
            raise FileNotFoundError(f"no image/annotation pairs under "
                                    f"{img_dir} / {ann_dir}")

    def __len__(self):
        return len(self.pairs)

    def load(self, idx: int):
        from PIL import Image

        img_path, ann_path = self.pairs[idx]
        with Image.open(img_path) as im:
            img = np.asarray(im.convert("RGB"), np.uint8)
        with Image.open(ann_path) as am:
            ann = np.asarray(am, np.uint8)
        # reduce_zero_label: 0 (unlabeled) → 255, classes 1..150 → 0..149
        label = ann.astype(np.int32) - 1
        label[ann == 0] = IGNORE
        return img, label


class SyntheticSegDataset:
    def __init__(self, n: int, size: int, num_classes: int):
        self.n, self.size, self.num_classes = n, size, num_classes

    def __len__(self):
        return self.n

    def load(self, idx: int):
        rng = np.random.default_rng(idx)
        img = rng.integers(0, 256, (self.size, self.size, 3), np.uint8)
        lbl = rng.integers(0, self.num_classes,
                           (self.size, self.size)).astype(np.int32)
        return img, lbl


def _resize(img: np.ndarray, label: np.ndarray, scale: float):
    from PIL import Image

    H, W = label.shape
    nh, nw = max(1, int(round(H * scale))), max(1, int(round(W * scale)))
    im = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR),
                    np.uint8)
    lb = np.asarray(Image.fromarray(label.astype(np.uint16)).resize(
        (nw, nh), Image.NEAREST)).astype(np.int32)
    return im, lb


def seg_train_transform(img: np.ndarray, label: np.ndarray,
                        rng: random.Random, crop: int = 512,
                        ratio_range: Tuple[float, float] = (0.5, 2.0),
                        cat_max_ratio: float = 0.75):
    """mmseg pipeline: RandomResize(512·ratio) → RandomCrop(crop,
    cat_max_ratio) → flip → normalize → pad (ade20k.py train_pipeline)."""
    H, W = label.shape
    base = crop / min(H, W)  # short side to crop size
    img, label = _resize(img, label, base * rng.uniform(*ratio_range))
    H, W = label.shape
    # RandomCrop with cat_max_ratio: retry up to 10 crops so no single
    # class fills >75% of the crop (mmseg RandomCrop)
    best = None
    for _ in range(10):
        oy = rng.randint(0, max(H - crop, 0)) if H > crop else 0
        ox = rng.randint(0, max(W - crop, 0)) if W > crop else 0
        lb = label[oy:oy + crop, ox:ox + crop]
        counts = np.bincount(lb[lb != IGNORE].reshape(-1),
                             minlength=1).astype(np.float64)
        total = counts.sum()
        best = (oy, ox)
        if total == 0 or counts.max() / max(total, 1) < cat_max_ratio:
            break
    oy, ox = best
    img = img[oy:oy + crop, ox:ox + crop]
    label = label[oy:oy + crop, ox:ox + crop]
    if rng.random() < 0.5:
        img = img[:, ::-1]
        label = label[:, ::-1]
    out_img = np.full((crop, crop, 3), 0.0, np.float32)
    out_lbl = np.full((crop, crop), IGNORE, np.int32)
    h, w = label.shape
    out_img[:h, :w] = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) \
        / IMAGENET_STD
    out_lbl[:h, :w] = label
    return out_img, out_lbl


def seg_eval_transform(img: np.ndarray, label: np.ndarray,
                       short_side: int = 512, max_long: int = 2048):
    """Keep-ratio resize: short side to 512, long side capped at 2048
    (ade20k.py test_pipeline Resize scale=(2048, 512) keep_ratio)."""
    H, W = label.shape
    scale = min(short_side / min(H, W), max_long / max(H, W))
    img, label = _resize(img, label, scale)
    image = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return image, label


class SegmentationLoader(DataLoader):
    """Batches: {"image" (B,S,S,3) float32, "label" (B,S,S) int32}. Each
    sample draws from ``random.Random(hash((seed, epoch, j)))``. To resume
    mid-epoch, set ``epoch`` and ``start_batch``: the next pass over the
    loader starts at that batch of that epoch (the ones before it are not
    loaded), and the passes after it are whole."""

    def __init__(self, dataset, batch_size: int, crop: int = 512,
                 training: bool = True, **kw):
        super().__init__(dataset, batch_size, transform=None, **kw)
        self.crop = crop
        self.training = training
        self.start_batch = 0

    def _batches(self):
        start, self.start_batch = self.start_batch, 0
        return itertools.islice(super()._batches(), start, None)

    def _load_batch(self, batch_idx, epoch: int) -> dict:
        imgs, lbls = [], []
        for j in batch_idx:
            img, lbl = self.dataset.load(int(j))
            rng = random.Random(hash((self.seed, epoch, int(j))))
            if self.training:
                im, lb = seg_train_transform(img, lbl, rng, self.crop)
            else:
                im, lb = seg_eval_transform(img, lbl, self.crop)
            imgs.append(im)
            lbls.append(lb)
        if not self.training:
            # pad the whole batch to ONE canvas (the per-batch max,
            # 32-aligned) so variable-aspect eval images stack; slide
            # inference averages over the valid region, padded labels
            # are IGNORE
            S = max([self.crop]
                    + [((im.shape[k] + 31) // 32) * 32
                       for im in imgs for k in (0, 1)])
            out_i, out_l = [], []
            for im, lb in zip(imgs, lbls):
                canvas = np.zeros((S, S, 3), np.float32)
                lcanvas = np.full((S, S), IGNORE, np.int32)
                canvas[:im.shape[0], :im.shape[1]] = im
                lcanvas[:lb.shape[0], :lb.shape[1]] = lb
                out_i.append(canvas)
                out_l.append(lcanvas)
            imgs, lbls = out_i, out_l
        return {"image": np.stack(imgs), "label": np.stack(lbls)}


def create_segmentation_loader(data_dir: Optional[str], split: str,
                               batch_size: int, crop: int, training: bool,
                               num_classes: int = 150,
                               num_workers: int = 2, seed: int = 0,
                               synthetic_samples: int = 16):
    """ADE20K folder if present, else synthetic."""
    if data_dir and os.path.isdir(os.path.join(data_dir, "images", split)):
        ds = ADE20KDataset(data_dir, split)
    else:
        ds = SyntheticSegDataset(synthetic_samples, crop, num_classes)
    return SegmentationLoader(ds, batch_size, crop, training,
                              shuffle=training, num_workers=num_workers,
                              seed=seed, drop_last=training)
