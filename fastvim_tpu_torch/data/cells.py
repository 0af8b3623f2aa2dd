"""JUMP-CP cell-imaging dataset (the FastChannelVim workload).

Counterpart of ``fastvim_tpu/data/cells.py``: a manifest maps rows to
8-channel ``.npy`` crops and compound-target labels; the splits are a
seeded 60/20/20 permutation; the augmentation is flip / pad-crop /
coarse dropout with per-channel normalization. Reads retry with a wait,
and a sample that still fails is dropped from its batch. A synthetic
multi-channel dataset stands in where there is no manifest.

The manifest is a CSV file with columns ``path`` and ``label``, read
without pandas; a ``.parquet`` manifest needs pandas, imported only
then. ``CellLoader`` augments as the JAX package's does: where the
native augment library is there, a batch of images already at ``size``
goes through the C++ ``cell_augment_batch`` (flips, a reflect-padded
shift, normalization: no coarse dropout, as in the JAX package's native
path), and an image of another size first through the Python
``cell_augment``; without the library every image takes the Python
``cell_augment``, image by image. On either path its batches are
bitwise the JAX loader's on the same path.
"""

from __future__ import annotations

import csv
import random
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from fastvim_tpu_torch import native
from fastvim_tpu_torch.parallel import get_mesh


def split_indices(n: int, split: str, seed: int = 42) -> np.ndarray:
    """Seeded 60/20/20 train/val/test split."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(0.6 * n)
    n_val = int(0.2 * n)
    if split == "train":
        return perm[:n_train]
    if split == "val":
        return perm[n_train:n_train + n_val]
    if split == "test":
        return perm[n_train + n_val:]
    raise ValueError(split)


def cell_augment(arr: np.ndarray, rng: random.Random, size: int,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None,
                 coarse_dropout: float = 0.5,
                 training: bool = True) -> np.ndarray:
    """Flip / pad-crop / coarse dropout / per-channel normalize, on an
    HWC array, with the draws of ``rng`` in the JAX package's order."""
    H, W, C = arr.shape
    if training:
        if rng.random() < 0.5:
            arr = arr[:, ::-1]
        if rng.random() < 0.5:
            arr = arr[::-1, :]
        pad = size // 16
        arr = np.pad(arr, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
        y = rng.randint(0, 2 * pad)
        x = rng.randint(0, 2 * pad)
        arr = arr[y:y + H, x:x + W]
        if rng.random() < coarse_dropout:
            for _ in range(rng.randint(1, 4)):
                h = rng.randint(H // 16, H // 8)
                w = rng.randint(W // 16, W // 8)
                yy = rng.randint(0, H - h)
                xx = rng.randint(0, W - w)
                arr = arr.copy()
                arr[yy:yy + h, xx:xx + w] = 0.0
    if arr.shape[0] != size:
        # center crop or pad to size
        if arr.shape[0] > size:
            off = (arr.shape[0] - size) // 2
            arr = arr[off:off + size, off:off + size]
        else:
            pad = size - arr.shape[0]
            arr = np.pad(arr, ((0, pad), (0, pad), (0, 0)))
    arr = arr.astype(np.float32)
    if mean is not None:
        arr = (arr - mean[None, None]) / std[None, None]
    return arr


def read_manifest(manifest: str) -> list:
    """The manifest's rows as dicts with "path" and "label"."""
    if manifest.endswith(".parquet"):
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError(f"reading {manifest} needs pandas; give a CSV "
                              "manifest (columns path,label) instead") from e
        return pd.read_parquet(manifest).to_dict("records")
    with open(manifest, newline="") as f:
        return list(csv.DictReader(f))


class CellDataset:
    """Manifest-driven ``.npy`` dataset with retrying reads."""

    def __init__(self, manifest: str, split: str = "train", seed: int = 42,
                 retries: int = 3, retry_wait: float = 2.0):
        rows = read_manifest(manifest)
        self.rows = [rows[i] for i in split_indices(len(rows), split, seed)]
        self.retries = retries
        self.retry_wait = retry_wait
        self.num_classes = max(int(r["label"]) for r in rows) + 1

    def __len__(self):
        return len(self.rows)

    def load(self, idx: int) -> Optional[Tuple[np.ndarray, int]]:
        """(HWC array, label), or None once every retry failed."""
        row = self.rows[idx]
        for _ in range(self.retries):
            try:
                arr = np.load(row["path"])
            except (OSError, ValueError):
                time.sleep(self.retry_wait)
                continue
            if arr.ndim == 3 and arr.shape[0] < arr.shape[-1]:
                arr = arr.transpose(1, 2, 0)  # CHW → HWC
            return arr, int(row["label"])
        return None


class SyntheticCellDataset:
    def __init__(self, num_samples: int = 256, size: int = 128,
                 channels: int = 8, num_classes: int = 161):
        self.num_samples = num_samples
        self.size = size
        self.channels = channels
        self.num_classes = num_classes

    def __len__(self):
        return self.num_samples

    def load(self, idx: int) -> Tuple[np.ndarray, int]:
        rng = np.random.default_rng(idx)
        arr = rng.standard_normal(
            (self.size, self.size, self.channels)).astype(np.float32)
        return arr, idx % self.num_classes


class CellLoader:
    """Batches of {"image" (B, H, W, C) float32, "label" (B,) int64};
    drops failed reads. Each epoch shuffles with (seed + epoch); the
    native batch augment draws from ``seed * 10007 + (epoch + 1) * 101 +
    i`` (i the batch's first position), the Python one each image's from
    ``hash((seed, epoch + 1, index))``; a caller may set ``epoch`` before
    iterating (a resumed run). Over several ranks a training batch is the
    global batch and each rank reads and augments its contiguous rows of
    it, with the draws they have in the one-process loader (where no read
    fails: a failed read shifts the native draws of the rank's later
    rows); an eval loader deals whole batches round-robin."""

    def __init__(self, dataset, batch_size: int, size: int,
                 training: bool = True, seed: int = 0,
                 mean: Optional[Sequence[float]] = None,
                 std: Optional[Sequence[float]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.size = size
        self.training = training
        self.seed = seed
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)
        self.epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        use_native = native.available("augment")
        idxs = np.arange(len(self.dataset))
        if self.training:
            np.random.default_rng(self.seed + self.epoch).shuffle(idxs)
        self.epoch += 1
        mesh = get_mesh()
        if self.training and self.batch_size % mesh.data:
            raise ValueError(f"the global batch of {self.batch_size} does "
                             f"not split over {mesh.data} ranks")
        starts = range(0, len(idxs) - self.batch_size + 1, self.batch_size)
        for n, i in enumerate(starts):
            rows = (mesh.rows(self.batch_size) if self.training
                    else slice(0, self.batch_size))
            if not self.training and n % mesh.data != mesh.data_index:
                continue
            imgs, labels = [], []
            for j in idxs[i:i + self.batch_size][rows]:
                out = self.dataset.load(int(j))
                if out is None:
                    continue
                arr, label = out
                if use_native and arr.shape[:2] == (self.size, self.size):
                    imgs.append(arr.astype(np.float32))
                else:
                    rng = random.Random(hash((self.seed, self.epoch,
                                              int(j))))
                    imgs.append(cell_augment(
                        arr, rng, self.size, self.mean, self.std,
                        training=self.training))
                labels.append(label)
            if not imgs:
                continue
            batch = np.stack(imgs).astype(np.float32)
            if use_native and batch.shape[1] == self.size:
                # the threaded C++ flip / shift / normalize
                batch = native.cell_augment_batch(
                    batch, seed=native.row_seed(
                        self.seed * 10007 + self.epoch * 101 + i,
                        rows.start),
                    training=self.training, mean=self.mean, std=self.std)
            yield {"image": batch, "label": np.asarray(labels, np.int64)}
