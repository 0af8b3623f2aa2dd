"""Offline real-image dataset: scikit-learn's bundled handwritten digits.

Counterpart of ``fastvim_tpu/data/digits.py``: 1,797 grayscale 8x8
images of 10 classes, split per class into train and val with a seed,
upsampled to the model's ``img_size`` by the transforms. Augmentation
suits digits: a gentle random-resized crop and NO horizontal flip
(mirroring changes a digit), plus mild brightness/contrast jitter; the
ImageNet statistics normalize. The table is read from scikit-learn's
package data (the file its ``load_digits`` reads), without importing
scikit-learn, whose import takes seconds; PIL is imported inside the
functions that need it.
"""

from __future__ import annotations

import gzip
import importlib.util
import os
import random
from typing import Tuple

import numpy as np

from fastvim_tpu_torch.data.transforms import (
    center_crop_resize,
    normalize,
    random_resized_crop,
)

_CACHE = {}


def _load_arrays() -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N,8,8), labels int64 (N,)) — cached per process."""
    if "digits" not in _CACHE:
        spec = importlib.util.find_spec("sklearn")
        if spec is None:
            raise ImportError("the digits set ships with scikit-learn, which "
                              "is not installed")
        path = os.path.join(spec.submodule_search_locations[0], "datasets",
                            "data", "digits.csv.gz")
        with gzip.open(path, "rt", encoding="utf-8") as f:
            table = np.loadtxt(f, delimiter=",")  # 64 pixels, then the label
        imgs = table[:, :-1].reshape(-1, 8, 8).astype(np.float32)  # 0..16
        imgs = np.clip(imgs * (255.0 / 16.0), 0, 255).astype(np.uint8)
        _CACHE["digits"] = (imgs, table[:, -1].astype(np.int64))
    return _CACHE["digits"]


def _split_indices(labels: np.ndarray, val_per_class: int,
                   seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic stratified split: `val_per_class` held out per
    class, the rest train."""
    rng = np.random.default_rng(seed)
    train, val = [], []
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        val.append(idx[:val_per_class])
        train.append(idx[val_per_class:])
    return np.sort(np.concatenate(train)), np.sort(np.concatenate(val))


class DigitsDataset:
    """DataLoader-compatible dataset over the sklearn digits images.

    split: "train" | "val" (stratified, deterministic in `seed`).
    `load` returns (PIL RGB image at native 8x8, label) — the transform
    pipeline handles crop/resize exactly as for ImageFolder images.
    """

    def __init__(self, split: str = "train", val_per_class: int = 30,
                 seed: int = 0):
        imgs, labels = _load_arrays()
        tr, va = _split_indices(labels, val_per_class, seed)
        self.indices = tr if split == "train" else va
        self.images = imgs
        self.labels = labels
        self.num_classes = int(labels.max()) + 1

    def __len__(self):
        return len(self.indices)

    def load(self, idx: int):
        from PIL import Image

        j = int(self.indices[idx])
        arr = np.repeat(self.images[j][..., None], 3, axis=-1)
        return Image.fromarray(arr), int(self.labels[j])


def digits_train_transform(img, size: int, rng: random.Random,
                           jitter: float = 0.2) -> np.ndarray:
    """RRC (gentle, aspect near 1) + brightness/contrast jitter +
    normalize. No hflip: digits are chiral."""
    from PIL import ImageEnhance

    img = img.convert("RGB")
    img = random_resized_crop(img, size, rng, scale=(0.64, 1.0),
                              ratio=(0.8, 1.25))
    if jitter:
        for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast):
            img = enh(img).enhance(rng.uniform(1 - jitter, 1 + jitter))
    arr = np.asarray(img, np.float32) / 255.0
    return normalize(arr)


def digits_eval_transform(img, size: int) -> np.ndarray:
    img = img.convert("RGB")
    img = center_crop_resize(img, size, crop_pct=1.0)
    arr = np.asarray(img, np.float32) / 255.0
    return normalize(arr)


def create_digits_loader(split: str, batch_size: int, img_size: int,
                         training: bool, num_workers: int = 2,
                         seed: int = 0):
    from fastvim_tpu_torch.data.loader import DataLoader

    ds = DigitsDataset(split=split, seed=seed)
    tf = ((lambda img, rng: digits_train_transform(img, img_size, rng))
          if training else
          (lambda img, rng: digits_eval_transform(img, img_size)))
    return DataLoader(ds, batch_size, tf, shuffle=training,
                      num_workers=num_workers, seed=seed,
                      drop_last=training)
