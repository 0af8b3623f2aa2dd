"""Image augmentation pipeline (host-side, PIL/numpy).

Counterpart of ``fastvim_tpu/data/transforms.py``, the same operations in
the same order, so that the same image and the same ``random.Random``
give the same array: train = RandomResizedCrop + hflip +
RandAugment(rand-m9-mstd0.5-inc1) + normalize + RandomErasing(0.25);
eval = resize (crop_pct 0.875) + center crop + normalize; MAE =
RandomResizedCrop(0.2-1.0) + hflip + normalize. PIL is imported inside
the functions that use it, so that importing this module needs numpy
only.
"""

from __future__ import annotations

import math
import random
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def random_resized_crop(img: Image.Image, size: int, rng: random.Random,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    from PIL import Image

    W, H = img.size
    area = W * H
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(log_r)
        w = int(round(math.sqrt(target * ar)))
        h = int(round(math.sqrt(target / ar)))
        if w <= W and h <= H:
            x = rng.randint(0, W - w)
            y = rng.randint(0, H - h)
            return img.resize((size, size), Image.BICUBIC,
                              box=(x, y, x + w, y + h))
    # fallback: center crop
    s = min(W, H)
    x, y = (W - s) // 2, (H - s) // 2
    return img.resize((size, size), Image.BICUBIC, box=(x, y, x + s, y + s))


def center_crop_resize(img: Image.Image, size: int,
                       crop_pct: float = 0.875):
    from PIL import Image

    scale_size = int(math.floor(size / crop_pct))
    W, H = img.size
    if W < H:
        img = img.resize((scale_size, int(H * scale_size / W)),
                         Image.BICUBIC)
    else:
        img = img.resize((int(W * scale_size / H), scale_size),
                         Image.BICUBIC)
    W, H = img.size
    x, y = (W - size) // 2, (H - size) // 2
    return img.crop((x, y, x + size, y + size))


# --- RandAugment (timm rand-m9-mstd0.5-inc1 subset) ----------------------

_MAX_LEVEL = 10.0


def _ra_ops(rng: random.Random):
    from PIL import Image, ImageEnhance, ImageOps

    def shear_x(img, level):
        v = 0.3 * level / _MAX_LEVEL * rng.choice([-1, 1])
        return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0),
                             Image.BILINEAR)

    def shear_y(img, level):
        v = 0.3 * level / _MAX_LEVEL * rng.choice([-1, 1])
        return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0),
                             Image.BILINEAR)

    def translate_x(img, level):
        v = int(0.45 * level / _MAX_LEVEL * img.size[0]) * rng.choice([-1, 1])
        return img.transform(img.size, Image.AFFINE, (1, 0, v, 0, 1, 0),
                             Image.BILINEAR)

    def translate_y(img, level):
        v = int(0.45 * level / _MAX_LEVEL * img.size[1]) * rng.choice([-1, 1])
        return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v),
                             Image.BILINEAR)

    def rotate(img, level):
        return img.rotate(30.0 * level / _MAX_LEVEL * rng.choice([-1, 1]))

    def color(img, level):
        return ImageEnhance.Color(img).enhance(
            1 + 0.9 * level / _MAX_LEVEL * rng.choice([-1, 1]))

    def contrast(img, level):
        return ImageEnhance.Contrast(img).enhance(
            1 + 0.9 * level / _MAX_LEVEL * rng.choice([-1, 1]))

    def brightness(img, level):
        return ImageEnhance.Brightness(img).enhance(
            1 + 0.9 * level / _MAX_LEVEL * rng.choice([-1, 1]))

    def sharpness(img, level):
        return ImageEnhance.Sharpness(img).enhance(
            1 + 0.9 * level / _MAX_LEVEL * rng.choice([-1, 1]))

    def posterize(img, level):
        bits = max(1, 8 - int(4 * level / _MAX_LEVEL))
        return ImageOps.posterize(img, bits)

    def solarize(img, level):
        thresh = int(256 - 256 * level / _MAX_LEVEL)
        return ImageOps.solarize(img, thresh)

    def auto_contrast(img, level):
        return ImageOps.autocontrast(img)

    def equalize(img, level):
        return ImageOps.equalize(img)

    return [shear_x, shear_y, translate_x, translate_y, rotate, color,
            contrast, brightness, sharpness, posterize, solarize,
            auto_contrast, equalize]


def rand_augment(img: Image.Image, rng: random.Random, num_ops: int = 2,
                 magnitude: float = 9.0, mag_std: float = 0.5):
    ops = _ra_ops(rng)
    for _ in range(num_ops):
        op = rng.choice(ops)
        level = max(0.0, min(_MAX_LEVEL, rng.gauss(magnitude, mag_std)))
        img = op(img, level)
    return img


def random_erasing(arr: np.ndarray, rng: random.Random, prob: float = 0.25,
                   scale=(0.02, 1 / 3), ratio=(0.3, 3.3)):
    """timm 'pixel'-mode random erasing on a normalized HWC array."""
    if rng.random() > prob:
        return arr
    H, W, C = arr.shape
    area = H * W
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        h = int(round(math.sqrt(target * ar)))
        w = int(round(math.sqrt(target / ar)))
        if h < H and w < W:
            y = rng.randint(0, H - h)
            x = rng.randint(0, W - w)
            arr[y:y + h, x:x + w] = np.random.default_rng(
                rng.randint(0, 2**31)).standard_normal((h, w, C))
            return arr
    return arr


def normalize(arr: np.ndarray, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> np.ndarray:
    return (arr - mean[None, None]) / std[None, None]


def train_transform(img: Image.Image, size: int, rng: random.Random,
                    use_randaug: bool = True, color_jitter: float = 0.4,
                    reprob: float = 0.25,
                    scale=(0.08, 1.0)) -> np.ndarray:
    from PIL import Image, ImageEnhance

    img = img.convert("RGB")
    img = random_resized_crop(img, size, rng, scale=scale)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if use_randaug:
        img = rand_augment(img, rng)
    elif color_jitter:
        for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                    ImageEnhance.Color):
            img = enh(img).enhance(rng.uniform(1 - color_jitter,
                                               1 + color_jitter))
    arr = np.asarray(img, np.float32) / 255.0
    arr = normalize(arr)
    if reprob:
        arr = random_erasing(arr, rng, prob=reprob)
    return arr


def eval_transform(img: Image.Image, size: int,
                   crop_pct: float = 0.875) -> np.ndarray:
    img = img.convert("RGB")
    img = center_crop_resize(img, size, crop_pct)
    arr = np.asarray(img, np.float32) / 255.0
    return normalize(arr)


def mae_transform(img: Image.Image, size: int,
                  rng: random.Random) -> np.ndarray:
    """MAE pretrain: RRC(0.2–1.0) + hflip + normalize (mae/datasets_mae.py)."""
    from PIL import Image

    img = img.convert("RGB")
    img = random_resized_crop(img, size, rng, scale=(0.2, 1.0))
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img, np.float32) / 255.0
    return normalize(arr)
