"""Host data loading: folder datasets, threaded prefetch, synthetic data.

Counterpart of ``fastvim_tpu/data/loader.py``: an ImageFolder-style
dataset decoded with PIL, a thread-pool prefetching loader producing NHWC
float32 numpy batches, a synthetic dataset for smoke runs, and the native
path (``fastvim_tpu_torch.native``): the MAE train recipe's per-image
augment in C++, and ``NativeJpegDataLoader``, whose batches are decoded
and augmented by one threaded C++ call. ``create_imagenet_loader`` routes
as the JAX package's does. For the same seed, epoch and dataset the
batches are bitwise the JAX package's on the same path: the same shuffle
(``default_rng(seed + epoch)``), the same per-image
``random.Random(hash((seed, epoch, j)))`` and the same native seeds and
arithmetic. The training loop sets ``epoch`` before each epoch, so a
resumed run draws what an uninterrupted one would. PIL is imported
inside the functions that decode.

Over several ``torchrun`` ranks every rank walks the same global batches
(the shuffle is seeded alike). A shuffled (training) loader's batch is
the global batch of a train step: each rank decodes only its contiguous
rows of it (``parallel.Mesh.rows``; the batch must split evenly), each
image with the draws it has in the one-process loader. An unshuffled
(eval) loader's batches are units of work: rank r takes batches r, r+N,
r+2N, ... whole.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from fastvim_tpu_torch import native
from fastvim_tpu_torch.parallel import get_mesh

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolderDataset:
    """<root>/<class_name>/<image> layout, classes sorted alphabetically."""

    def __init__(self, root: str):
        self.root = root
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append(
                        (os.path.join(cdir, fname), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def load(self, idx: int):
        from PIL import Image

        path, label = self.samples[idx]
        with Image.open(path) as img:
            return img.convert("RGB"), label


class SyntheticDataset:
    """Deterministic fake images for smoke tests and benchmarks."""

    def __init__(self, num_samples: int, size: int, channels: int = 3,
                 num_classes: int = 1000):
        self.num_samples = num_samples
        self.size = size
        self.channels = channels
        self.num_classes = num_classes

    def __len__(self):
        return self.num_samples

    def load(self, idx: int):
        from PIL import Image

        rng = np.random.default_rng(idx)
        arr = rng.integers(0, 256, (self.size, self.size, self.channels),
                           dtype=np.uint8)
        img = Image.fromarray(arr[..., :3] if self.channels >= 3 else
                              np.repeat(arr, 3, axis=-1))
        return img, idx % self.num_classes


class DataLoader:
    """Threaded prefetching loader → NHWC float32 numpy batches."""

    def __init__(self, dataset, batch_size: int,
                 transform: Callable, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0,
                 drop_last: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _batches(self) -> Iterator[List[int]]:
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idxs)
        for i in range(0, len(idxs), self.batch_size):
            chunk = idxs[i : i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield list(chunk)

    def _local_batches(self) -> List[Tuple[np.ndarray, slice]]:
        """This rank's (global batch, its rows) pairs: its rows of each
        batch when shuffling (training), else every data-th batch whole
        (by data index: the ranks of a seq group take the same)."""
        mesh = get_mesh()
        chunks = [np.asarray(c) for c in self._batches()]
        if not self.shuffle:
            return [(c, slice(0, len(c)))
                    for c in chunks[mesh.data_index::mesh.data]]
        for c in chunks:
            if len(c) % mesh.data:
                raise ValueError(f"the global batch of {len(c)} does not "
                                 f"split over {mesh.data} ranks")
        return [(c, mesh.rows(len(c))) for c in chunks]

    def _load_rows(self, chunk: np.ndarray, rows: slice, epoch: int) -> dict:
        """This rank's ``rows`` of the global batch ``chunk``."""
        return self._load_batch(list(chunk[rows]), epoch)

    def _load_batch(self, batch_idx: List[int], epoch: int) -> dict:
        """Decode + transform one batch → dict of stacked arrays.
        Subclasses (e.g. detection) override this collate."""
        imgs, labels = [], []
        for j in batch_idx:
            img, label = self.dataset.load(int(j))
            rng = random.Random(hash((self.seed, epoch, int(j))))
            imgs.append(self.transform(img, rng))
            labels.append(label)
        return {"image": np.stack(imgs).astype(np.float32),
                "label": np.asarray(labels, np.int64)}

    def __iter__(self):
        """num_workers decode+augment threads over whole batches; results
        are yielded in deterministic batch order regardless of worker
        completion order, with a ``prefetch``-deep backpressure window so
        at most prefetch+num_workers batches are in flight. PIL's decode
        and resampling and the native library's calls release the GIL, so
        the threads overlap there."""
        batches = self._local_batches()
        self.epoch += 1
        epoch = self.epoch
        if not batches:
            return

        cond = threading.Condition()
        results: dict = {}
        next_in = [0]     # next batch index a worker should claim
        next_out = [0]    # next batch index the consumer will yield
        error: list = [None]

        def worker():
            while True:
                with cond:
                    if error[0] is not None or next_in[0] >= len(batches):
                        return
                    bi = next_in[0]
                    next_in[0] += 1
                    # backpressure: stay within the prefetch window
                    while (error[0] is None
                           and bi - next_out[0] > self.prefetch
                           + self.num_workers):
                        cond.wait(timeout=0.5)
                    if error[0] is not None:
                        return
                try:
                    batch = self._load_rows(*batches[bi], epoch)
                except BaseException as e:  # propagate to the consumer
                    with cond:
                        error[0] = e
                        cond.notify_all()
                    return
                with cond:
                    results[bi] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_workers, len(batches)))]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with cond:
                    while bi not in results and error[0] is None:
                        cond.wait(timeout=0.5)
                    if error[0] is not None:
                        raise error[0]
                    item = results.pop(bi)
                    next_out[0] = bi + 1
                    cond.notify_all()
                yield item
        finally:
            with cond:
                if error[0] is None:
                    error[0] = GeneratorExit("loader closed")
                cond.notify_all()


class NativeJpegDataLoader(DataLoader):
    """DataLoader whose batch collate sends the raw JPEG bytes through the
    native fused decode + augment (``native/csrc/decode.cpp``): one C++
    call per batch decodes (DCT-scaled), crops, flips, resizes and
    normalizes it with the GIL released. A batch holding a non-JPEG file
    takes the PIL path whole, and an image the library fails to decode
    takes it alone, as in the JAX package."""

    def __init__(self, dataset, batch_size, img_size: int, training: bool,
                 scale=(0.2, 1.0), pil_transform: Optional[Callable] = None,
                 **kw):
        from fastvim_tpu_torch.data import transforms as T

        if pil_transform is None:
            pil_transform = (
                (lambda img, rng: T.mae_transform(img, img_size, rng))
                if training else
                (lambda img, rng: T.eval_transform(img, img_size)))
        super().__init__(dataset, batch_size, pil_transform, **kw)
        self.img_size = img_size
        self.training = training
        self.scale = scale

    def _load_rows(self, chunk: np.ndarray, rows: slice, epoch: int) -> dict:
        from fastvim_tpu_torch.data import transforms as T

        batch_idx = list(chunk[rows])
        paths, labels, jpegs = [], [], []
        for j in batch_idx:
            path, label = self.dataset.samples[int(j)]
            paths.append(path)
            labels.append(label)
        if not all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
            return super()._load_rows(chunk, rows, epoch)
        for p in paths:
            with open(p, "rb") as f:
                jpegs.append(f.read())
        # the global batch's seed mixes (loader seed, epoch, its first
        # index): the per-image native draws are deterministic and vary by
        # epoch; each image draws by its row in the global batch, so this
        # rank's call starts from its first row's seed
        seed = hash((self.seed, epoch, int(chunk[0]))) & (2**63 - 1)
        imgs, fail = native.decode_augment_batch(
            jpegs, self.img_size, native.row_seed(seed, rows.start),
            self.training, T.IMAGENET_MEAN, T.IMAGENET_STD, scale=self.scale,
            num_threads=1)
        for i in np.nonzero(fail)[0]:  # a stream libjpeg refused: PIL
            img, _ = self.dataset.load(int(batch_idx[i]))
            rng = random.Random(hash((self.seed, epoch, int(batch_idx[i]))))
            imgs[i] = self.transform(img, rng)
        return {"image": imgs.astype(np.float32),
                "label": np.asarray(labels, np.int64)}


def make_native_rgb_transform(img_size: int, training: bool,
                              scale=(0.2, 1.0)) -> Optional[Callable]:
    """Per-image transform through ``native.augment_batch`` (random
    resized crop or center crop, flip, bilinear resize, normalize), or
    None where the augment library is unavailable. It computes the MAE
    train recipe and the eval crop; the supervised train recipe needs
    RandAugment and stays in Python."""
    from fastvim_tpu_torch.data import transforms as T

    if not native.available("augment"):
        return None

    def tf(img, rng):
        arr = np.asarray(img.convert("RGB"), np.uint8)[None]
        seed = rng.getrandbits(63) if rng is not None else 0
        out = native.augment_batch(
            arr, img_size, seed, training, T.IMAGENET_MEAN, T.IMAGENET_STD,
            scale=scale, num_threads=1)
        return out[0]

    return tf


def create_imagenet_loader(
    data_dir: Optional[str], split: str, batch_size: int, img_size: int,
    training: bool, mae: bool = False, num_workers: int = 4, seed: int = 0,
    synthetic_samples: int = 512, use_native: bool = True,
):
    """Folder loader if ``data_dir/split`` exists, else synthetic.
    ``data_dir="digits"`` selects the offline digits dataset
    (data/digits.py). ``mae`` takes the MAE pretrain recipe for training
    (random resized crop at scale 0.2-1, flip, normalize). With
    ``use_native`` the MAE train recipe runs in the native augment
    library, on synthetic data too, and an ImageFolder's eval and MAE
    train batches go through ``NativeJpegDataLoader`` where the decode
    library is available; the supervised train recipe (RandAugment) stays
    on PIL. Without it, or without the libraries, every path is PIL's
    (``transforms.mae_transform`` for MAE)."""
    from fastvim_tpu_torch.data import transforms as T

    if data_dir == "digits":
        from fastvim_tpu_torch.data.digits import create_digits_loader

        return create_digits_loader(
            "train" if split == "train" else "val", batch_size, img_size,
            training=training, num_workers=num_workers, seed=seed)

    if not training:
        tf = lambda img, rng: T.eval_transform(img, img_size)
    elif not mae:
        tf = lambda img, rng: T.train_transform(img, img_size, rng)
    else:  # the MAE recipe, in C++ where the augment library is there
        tf = (make_native_rgb_transform(img_size, True, (0.2, 1.0))
              if use_native else None)
        if tf is None:
            tf = lambda img, rng: T.mae_transform(img, img_size, rng)

    if data_dir and os.path.isdir(os.path.join(data_dir, split)):
        ds = ImageFolderDataset(os.path.join(data_dir, split))
        if (use_native and (not training or mae)
                and native.available("decode")):
            return NativeJpegDataLoader(
                ds, batch_size, img_size, training, scale=(0.2, 1.0),
                pil_transform=tf, shuffle=training,
                num_workers=num_workers, seed=seed)
    else:
        ds = SyntheticDataset(synthetic_samples, img_size)
    return DataLoader(ds, batch_size, tf, shuffle=training,
                      num_workers=num_workers, seed=seed)
