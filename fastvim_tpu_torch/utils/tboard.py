"""Minimal TensorBoard event-file writer: no TF or tensorboard dependency.

Counterpart of ``fastvim_tpu/utils/tboard.py``, byte for byte the same
files for the same scalars: scalar summaries in the TF event-file wire
format (TFRecord of binary-serialized Event protos), readable by standard
TensorBoard. The protos involved are tiny and stable, so they are
hand-encoded here (varint/tag wire format) instead of pulling in protobuf.

Event wire layout (all proto2/3 compatible):
  Event{ wall_time=1(double) step=2(int64) summary=5(Summary) }
  Summary{ value=1(repeated Value) }
  Value{ tag=1(string) simple_value=2(float) }
TFRecord framing: len(u64 LE) + masked-crc32c(len) + payload +
masked-crc32c(payload).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# crc32c (software, table-driven) + TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # Castagnoli, reflected
    tbl = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tbl.append(c)
    _CRC_TABLE = tbl
    return tbl


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# tiny protobuf encoder (only what Event needs)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _f_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _f_int(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _scalar_event(step: int, scalars: Dict[str, float],
                  wall_time: Optional[float] = None) -> bytes:
    values = b"".join(
        _f_bytes(1, _f_bytes(1, tag.encode()) + _f_float(2, float(v)))
        for tag, v in scalars.items())
    return (_f_double(1, wall_time if wall_time is not None else time.time())
            + _f_int(2, int(step)) + _f_bytes(5, values))


def _file_version_event() -> bytes:
    return _f_double(1, time.time()) + _f_bytes(3, b"brain.Event:2")


class SummaryWriter:
    """Append-only scalar summary writer, TensorBoard-compatible.

    >>> w = SummaryWriter(log_dir)
    >>> w.add_scalars(step, {"train/loss": 0.5, "lr": 1e-3})
    >>> w.close()
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write_record(_file_version_event())

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, step: int, tag: str, value: float):
        self.add_scalars(step, {tag: value})

    def add_scalars(self, step: int, scalars: Dict[str, float]):
        scalars = {k: float(v.item() if hasattr(v, "item") else v)
                   for k, v in scalars.items()
                   if _is_number(v)}
        if scalars:
            self._write_record(_scalar_event(step, scalars))

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _is_number(v) -> bool:
    if hasattr(v, "item"):
        try:
            v = v.item()
        except Exception:
            return False
    return isinstance(v, (int, float)) and not isinstance(v, bool)
