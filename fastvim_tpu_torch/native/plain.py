"""Plain numpy versions of the native entry points, from the same seeds.

Each computes what its C++ counterpart in ``csrc/`` computes: the splitmix
``Rng`` (``common.h``), the crop choice, the bilinear
resize-crop-normalize in float32 in the C++ order of operations, the cell
flip / shift / normalize, and, for the decode, PIL's full-size decode
followed by the same crop rectangle chosen in the original coordinates.
The tests and ``chip_smoke.py`` hold the libraries against these; the
loaders never call them. The C++ code is compiled with ``-march=native``,
where g++ may fuse a multiply and an add (C++ allows it), so the resize
agrees within :func:`resize_tol`, not bit for bit; the cell augment only
copies, subtracts and divides, and agrees exactly; the decode differs by
what libjpeg's DCT scaling changes.
"""

from __future__ import annotations

import io
import math
from typing import Optional, Sequence, Tuple

import numpy as np

MASK = (1 << 64) - 1
Rect = Tuple[int, int, int, int]  # x, y, w, h
_LOG_LO, _LOG_HI = math.log(3.0 / 4.0), math.log(4.0 / 3.0)


def mix(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK
    return z ^ (z >> 31)


class Rng:
    """``fastvim::Rng``: splitmix64 steps from a 64-bit seed."""

    def __init__(self, seed: int):
        self.s = mix(seed & MASK)

    def next(self) -> int:
        self.s = mix(self.s)
        return self.s

    def uniform(self) -> float:
        return (self.next() >> 11) * (1.0 / 9007199254740992.0)

    def randint(self, lo: int, hi: int) -> int:  # lo inclusive, hi not
        return lo + int(self.uniform() * (hi - lo))


def sample_seed(seed: int, i: int) -> int:
    """Image ``i``'s seed within a batch call given ``seed``."""
    return (seed * 1000003 + i) & MASK


def _lround(x: float) -> int:
    """``std::lround`` of x >= 0: halves away from zero."""
    r = math.floor(x)
    return r + 1 if x - r >= 0.5 else r


def random_resized_crop_rect(rng: Rng, H: int, W: int, lo: float,
                             hi: float) -> Rect:
    area = float(H) * W
    for _ in range(10):
        target = (lo + rng.uniform() * (hi - lo)) * area
        ar = math.exp(_LOG_LO + rng.uniform() * (_LOG_HI - _LOG_LO))
        w = _lround(math.sqrt(target * ar))
        h = _lround(math.sqrt(target / ar))
        if w <= W and h <= H and w > 0 and h > 0:
            x = rng.randint(0, W - w + 1)
            y = rng.randint(0, H - h + 1)
            return x, y, w, h
    s = min(H, W)
    return (W - s) // 2, (H - s) // 2, s, s


def choose_crop(rng: Rng, H: int, W: int, training: bool,
                scale: Sequence[float]) -> Tuple[Rect, bool]:
    """The crop rectangle and the flip: random resized crop and a coin at
    train, the 0.875 center crop at eval. ``scale`` is passed to C++ as
    float32, so it is rounded to float32 here too."""
    if training:
        lo, hi = (float(np.float32(s)) for s in scale)
        rect = random_resized_crop_rect(rng, H, W, lo, hi)
        return rect, rng.uniform() < 0.5
    s = min(H, W)
    crop = int(s * 0.875)
    return ((W - crop) // 2, (H - crop) // 2, crop, crop), False


def _taps(start: int, extent: int, size: int, limit: int, flip: bool):
    """Source index pairs and weights along one axis, in float32."""
    f32 = np.float32
    step = f32(extent) / f32(size)
    o = np.arange(size)
    if flip:
        o = size - 1 - o
    f = (f32(start) + (o.astype(f32) + f32(0.5)) * step) - f32(0.5)
    f = np.maximum(f32(0), np.minimum(f, f32(limit - 1)))
    i0 = f.astype(np.int64)
    return i0, np.minimum(i0 + 1, limit - 1), f - i0.astype(f32)


def resize_crop_normalize(src: np.ndarray, rect: Rect, flip: bool,
                          size: int, mean: np.ndarray,
                          std: np.ndarray) -> np.ndarray:
    """Bilinear resize of ``rect`` of an HWC uint8 image to (size, size),
    flipped if asked, then /255 and normalized: (size, size, C) float32."""
    f32 = np.float32
    H, W, _ = src.shape
    x, y, w, h = rect
    x0, x1, wx = _taps(x, w, size, W, flip)
    y0, y1, wy = _taps(y, h, size, H, False)
    ns = (f32(1) / f32(255)) / np.asarray(std, f32)
    nm = np.asarray(mean, f32) / np.asarray(std, f32)
    img = src.astype(np.int32)
    wx = wx[None, :, None]

    def row(ys):
        a, b = img[ys][:, x0], img[ys][:, x1]
        return a.astype(f32) + (b - a).astype(f32) * wx

    top, bot = row(y0), row(y1)
    v = top + (bot - top) * wy[:, None, None]
    return v * ns - nm


def resize_tol(H: int, W: int, std) -> float:
    """How far ``augment_batch`` may differ from the library on an H × W
    source: a fused multiply-add moves a sample coordinate by up to one
    float32 ulp of the larger side, which moves a bilinear blend by up to
    that fraction of 255 grey levels, / (255 · std) once normalized, in
    each of the two axes; 1e-5 covers the few ulps of the blend itself."""
    ulp = float(np.spacing(np.float32(max(H, W))))
    return 2 * ulp / float(np.min(std)) + 1e-5


def augment_batch(images: np.ndarray, size: int, seed: int, training: bool,
                  mean: np.ndarray, std: np.ndarray,
                  scale=(0.08, 1.0)) -> np.ndarray:
    """``native.augment_batch``: (B, H, W, C) uint8 → (B, size, size, C)."""
    B, H, W, C = images.shape
    out = np.empty((B, size, size, C), np.float32)
    for i in range(B):
        rect, flip = choose_crop(Rng(sample_seed(seed, i)), H, W, training,
                                 scale)
        out[i] = resize_crop_normalize(images[i], rect, flip, size, mean, std)
    return out


def cell_augment_batch(images: np.ndarray, seed: int, training: bool,
                       mean: Optional[np.ndarray] = None,
                       std: Optional[np.ndarray] = None) -> np.ndarray:
    """``native.cell_augment_batch``: per image, a horizontal and a
    vertical flip coin and a shift of up to H // 16 with reflection at
    train, then (v - mean) / std per channel."""
    B, H, W, C = images.shape
    out = np.empty((B, H, W, C), np.float32)
    for i in range(B):
        rng = Rng(sample_seed(seed, i))
        fh = training and rng.uniform() < 0.5
        fv = training and rng.uniform() < 0.5
        pad = H // 16 if training else 0
        oy = rng.randint(-pad, pad + 1) if pad else 0
        ox = rng.randint(-pad, pad + 1) if pad else 0

        def index(n, off, flip):
            s = np.arange(n) + off
            s = np.where(s < 0, -s, np.where(s >= n, 2 * n - s - 2, s))
            return n - 1 - s if flip else s

        v = np.asarray(images[i], np.float32)[index(H, oy, fv)][
            :, index(W, ox, fh)]
        if mean is not None:
            v = (v - np.asarray(mean, np.float32)) / np.asarray(std,
                                                                np.float32)
        out[i] = v
    return out


def _decode_rgb(data: bytes) -> Optional[np.ndarray]:
    """PIL's full-size RGB decode of a JPEG stream, or None where libjpeg
    would fail: not a JPEG, or one whose colour space it cannot turn into
    RGB (CMYK and YCCK, which PIL opens as "CMYK")."""
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(io.BytesIO(data)) as img:
            if img.format != "JPEG" or img.mode not in ("L", "RGB"):
                return None
            return np.asarray(img.convert("RGB"), np.uint8)
    except (OSError, UnidentifiedImageError, SyntaxError, ValueError):
        return None


def jpeg_dims(data: bytes):
    """``native.jpeg_dims``: (H, W) of a JPEG stream, or None."""
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(io.BytesIO(data)) as img:
            return (img.height, img.width) if img.format == "JPEG" else None
    except (OSError, UnidentifiedImageError, SyntaxError, ValueError):
        return None


def decode_augment_batch(jpegs, size: int, seed: int, training: bool,
                         mean: np.ndarray, std: np.ndarray,
                         scale=(0.08, 1.0)):
    """``native.decode_augment_batch`` through PIL's full-size decode:
    (out (B, size, size, 3) float32, fail (B,) uint8), a failed stream's
    slot zero-filled."""
    out = np.zeros((len(jpegs), size, size, 3), np.float32)
    fail = np.zeros(len(jpegs), np.uint8)
    for i, data in enumerate(jpegs):
        rgb = _decode_rgb(data)
        if rgb is None:
            fail[i] = 1
            continue
        rect, flip = choose_crop(Rng(sample_seed(seed, i)), *rgb.shape[:2],
                                 training, scale)
        out[i] = resize_crop_normalize(rgb, rect, flip, size, mean, std)
    return out, fail
