"""ctypes bindings for the native (C++) host data pipeline.

Counterpart of ``fastvim_tpu/native``, with its own copy of the sources
(``csrc/``) and the same five entry points. The sources build into two
libraries (``_build.py``), each with g++ at its first use, never at
import: ``augment`` (``augment_batch``, ``cell_augment_batch``) and
``decode`` (``jpeg_dims``, ``decode_augment_batch``; libjpeg-turbo).
``available(library)`` says whether a library is there: False, with one
line on stderr naming what is missing, where the machine lacks its
prerequisite, and it raises where the build fails. An entry point whose
library is not there raises; the loaders ask ``available`` first, as the
JAX package's do. Each entry point adds one to its entry in ``CALLS``
when it calls into its library (under a lock: the loaders call from
several threads). ``plain.py`` holds numpy versions of the same
functions.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading
from typing import Dict, Optional, Union

import numpy as np

from fastvim_tpu_torch.native import _build

CALLS: Dict[str, int] = dict.fromkeys(
    ("augment_batch", "jpeg_dims", "decode_augment_batch",
     "cell_augment_batch"), 0)

_P8 = ctypes.POINTER(ctypes.c_uint8)
_PF = ctypes.POINTER(ctypes.c_float)
_I, _U64 = ctypes.c_int, ctypes.c_uint64
# library → {C entry point: (argument types, result type)}
SIGNATURES = {
    "augment": {
        "fastvim_augment_batch": (
            [_P8, _I, _I, _I, _I, _PF, _I, _U64, _I, _PF, _PF,
             ctypes.c_float, ctypes.c_float, _I], None),
        "fastvim_cell_augment_batch": (
            [_PF, _I, _I, _I, _I, _PF, _U64, _I, _PF, _PF, _I], None),
    },
    "decode": {
        "fastvim_jpeg_dims": (
            [_P8, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
        "fastvim_decode_augment_batch": (
            [_P8, ctypes.POINTER(ctypes.c_int64), _I, _PF, _I, _U64, _I, _PF,
             _PF, ctypes.c_float, ctypes.c_float, _P8, _I], ctypes.c_int),
    },
}

_lock = threading.Lock()
_count_lock = threading.Lock()
# library → its loaded CDLL, or the reason it cannot be built here
_libs: Dict[str, Union[ctypes.CDLL, str]] = {}


def _status(library: str) -> Union[ctypes.CDLL, str]:
    with _lock:
        if library not in _libs:
            reason = _build.missing(library)
            if reason is not None:
                print(f"fastvim_tpu_torch.native: the {library} library is "
                      f"unavailable: {reason}", file=sys.stderr, flush=True)
                _libs[library] = reason
            else:
                lib = ctypes.CDLL(str(_build.build(library)))
                for name, (argtypes, restype) in SIGNATURES[library].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                _libs[library] = lib
        return _libs[library]


def _lib(library: str) -> ctypes.CDLL:
    lib = _status(library)
    if isinstance(lib, str):
        raise RuntimeError(f"the native {library} library is unavailable: "
                           f"{lib}")
    return lib


def available(library: str = "augment") -> bool:
    """Whether ``library`` ("augment" or "decode") is built and loaded."""
    return not isinstance(_status(library), str)


def reset_call_counts() -> None:
    with _count_lock:
        for name in CALLS:
            CALLS[name] = 0


def call_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(CALLS)


def _count(name: str) -> None:
    with _count_lock:
        CALLS[name] += 1


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(_PF)


def _per_channel(name: str, arr, channels: int) -> np.ndarray:
    """``arr`` as contiguous float32, one entry per channel: the C code
    reads ``channels`` of them."""
    arr = np.ascontiguousarray(arr, np.float32)
    if arr.shape != (channels,):
        raise ValueError(f"{name} has shape {arr.shape}, expected "
                         f"({channels},)")
    return arr


def row_seed(seed: int, offset: int) -> int:
    """The seed of a batch call that starts at row ``offset`` of a batch
    seeded ``seed`` and draws, for its rows, what that batch's call draws
    for them: a call seeds image i with ``seed * 1000003 + i`` (mod
    2**64), and 1000003, odd, is invertible modulo 2**64. A rank that
    augments its rows of a global batch calls with this seed."""
    return (seed + offset * pow(1000003, -1, 2 ** 64)) % 2 ** 64


def augment_batch(images: np.ndarray, size: int, seed: int,
                  training: bool, mean: np.ndarray, std: np.ndarray,
                  scale=(0.08, 1.0), num_threads: Optional[int] = None
                  ) -> np.ndarray:
    """images (B, H, W, C) uint8 → (B, size, size, C) float32 normalized:
    random resized crop + flip at train, the 0.875 center crop at eval."""
    lib = _lib("augment")
    images = np.ascontiguousarray(images, np.uint8)
    B, H, W, C = images.shape
    out = np.empty((B, size, size, C), np.float32)
    mean = _per_channel("mean", mean, C)
    std = _per_channel("std", std, C)
    nt = num_threads or (os.cpu_count() or 1)
    _count("augment_batch")
    lib.fastvim_augment_batch(
        images.ctypes.data_as(_P8), B, H, W, C, _fptr(out), size, seed,
        int(training), _fptr(mean), _fptr(std), float(scale[0]),
        float(scale[1]), nt)
    return out


def jpeg_dims(data: bytes):
    """(H, W) of a JPEG byte stream, or None if not decodable."""
    lib = _lib("decode")
    buf = np.frombuffer(data, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    _count("jpeg_dims")
    rc = lib.fastvim_jpeg_dims(buf.ctypes.data_as(_P8), len(data),
                               ctypes.byref(h), ctypes.byref(w))
    return None if rc else (h.value, w.value)


def decode_augment_batch(jpegs, size: int, seed: int, training: bool,
                         mean: np.ndarray, std: np.ndarray,
                         scale=(0.08, 1.0),
                         num_threads: Optional[int] = None):
    """Fused JPEG decode + crop/flip/resize/normalize.

    jpegs: list of B ``bytes`` objects → (out (B, size, size, 3) float32,
    fail (B,) uint8 — 1 where the stream failed to decode and the output
    slot is zero-filled). The crop is chosen in the original image's
    coordinates, then only the DCT-scaled region it needs is decoded
    (``csrc/decode.cpp``).
    """
    lib = _lib("decode")
    offsets = np.zeros(len(jpegs) + 1, np.int64)
    np.cumsum([len(b) for b in jpegs], out=offsets[1:])
    data = np.frombuffer(b"".join(jpegs), np.uint8)
    B = len(jpegs)
    out = np.empty((B, size, size, 3), np.float32)
    fail = np.zeros(B, np.uint8)
    mean = _per_channel("mean", mean, 3)
    std = _per_channel("std", std, 3)
    nt = num_threads or (os.cpu_count() or 1)
    _count("decode_augment_batch")
    lib.fastvim_decode_augment_batch(
        data.ctypes.data_as(_P8),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, _fptr(out), size, seed, int(training), _fptr(mean), _fptr(std),
        float(scale[0]), float(scale[1]), fail.ctypes.data_as(_P8), nt)
    return out, fail


def cell_augment_batch(images: np.ndarray, seed: int, training: bool,
                       mean: Optional[np.ndarray] = None,
                       std: Optional[np.ndarray] = None,
                       num_threads: Optional[int] = None) -> np.ndarray:
    """(B, H, W, C) float32 → the same shape: flips, a reflect-padded
    shift of up to H // 16 at train, then per-channel normalization
    where ``mean`` is given. No coarse dropout, as in the JAX package's
    native path."""
    lib = _lib("augment")
    images = np.ascontiguousarray(images, np.float32)
    B, H, W, C = images.shape
    out = np.empty_like(images)
    if (mean is None) != (std is None):
        raise ValueError("give mean and std together, or neither")
    mp = sp = _PF()
    if mean is not None:
        mean = _per_channel("mean", mean, C)
        std = _per_channel("std", std, C)
        mp, sp = _fptr(mean), _fptr(std)
    nt = num_threads or (os.cpu_count() or 1)
    _count("cell_augment_batch")
    lib.fastvim_cell_augment_batch(
        _fptr(images), B, H, W, C, _fptr(out), seed, int(training), mp, sp,
        nt)
    return out
