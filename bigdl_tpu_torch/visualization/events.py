"""TensorBoard event files without TensorBoard
(``bigdl_tpu/visualization/events.py``).

The small part of the ``Event`` / ``Summary`` protobuf wire format that
scalars and histograms need (varints, fixed64, fixed32 and
length-delimited fields) is encoded by hand, and each record is framed
with masked CRC32C checksums, computed here in Python:

    len (8 bytes LE) | masked_crc32c(len) (4 LE) | data | masked_crc32c(data) (4 LE)
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Iterable, List, Optional, Tuple

# ---------------------------------------------------------------- crc32c ---

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding ---


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _f_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _f_int(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _f_bytes(num: int, b: bytes) -> bytes:
    return _field(num, 2) + _varint(len(b)) + b


def _f_str(num: int, s: str) -> bytes:
    return _f_bytes(num, s.encode("utf-8"))


def encode_scalar_summary(tag: str, value: float) -> bytes:
    # Summary{ value: [Summary.Value{ tag=1, simple_value=2 }] }
    v = _f_str(1, tag) + _f_float(2, value)
    return _f_bytes(1, v)


def encode_histogram_summary(tag: str, values) -> bytes:
    """Summary.Value{ tag, histo: HistogramProto } — HistogramProto fields:
    min=1, max=2, num=3, sum=4, sum_squares=5, bucket_limit=6 (packed),
    bucket=7 (packed)."""
    import numpy as np

    arr = np.asarray(values, np.float64).ravel()
    if arr.size == 0:
        arr = np.zeros(1)
    counts, edges = np.histogram(arr, bins=30)
    histo = (
        _f_double(1, float(arr.min()))
        + _f_double(2, float(arr.max()))
        + _f_double(3, float(arr.size))
        + _f_double(4, float(arr.sum()))
        + _f_double(5, float((arr * arr).sum()))
    )
    limits = b"".join(struct.pack("<d", float(e)) for e in edges[1:])
    buckets = b"".join(struct.pack("<d", float(c)) for c in counts)
    histo += _f_bytes(6, limits) + _f_bytes(7, buckets)
    v = _f_str(1, tag) + _f_bytes(7, histo)  # Value.histo = field 7
    return _f_bytes(1, v)


def encode_event(
    step: int, wall_time: Optional[float] = None, summary: Optional[bytes] = None,
    file_version: Optional[str] = None,
) -> bytes:
    # Event{ wall_time=1(double), step=2(int64), file_version=3, summary=5 }
    out = _f_double(1, wall_time if wall_time is not None else time.time())
    if step:
        out += _f_int(2, step)
    if file_version is not None:
        out += _f_str(3, file_version)
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


# ------------------------------------------------------------- file writer ---


class EventWriter:
    """Append CRC-framed events to a tfevents file, each flushed as it is
    written, under a lock."""

    def __init__(self, log_dir: str, suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"bigdl_tpu_torch{suffix}")
        self.path = os.path.join(log_dir, fname)
        self._fh = open(self.path, "ab")
        self._lock = threading.Lock()
        self.write_event(encode_event(0, file_version="brain.Event:2"))

    def write_event(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        rec = (
            header
            + struct.pack("<I", masked_crc32c(header))
            + event
            + struct.pack("<I", masked_crc32c(event))
        )
        with self._lock:
            self._fh.write(rec)
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            self._fh.close()


def read_events(path: str) -> List[Tuple[float, int, List[Tuple[str, float]]]]:
    """The scalar events of a tfevents file:
    ``[(wall_time, step, [(tag, simple_value)])]``."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        pos += 12  # len + len-crc
        event = data[pos : pos + length]
        pos += length + 4  # data + data-crc
        out.append(_decode_event(event))
    return out


def _decode_event(buf: bytes):
    wall, step, scalars = 0.0, 0, []

    def walk(buf, handlers):
        pos = 0
        while pos < len(buf):
            key, pos = _read_varint(buf, pos)
            num, wire = key >> 3, key & 7
            if wire == 0:
                val, pos = _read_varint(buf, pos)
            elif wire == 1:
                val = struct.unpack_from("<d", buf, pos)[0]
                pos += 8
            elif wire == 5:
                val = struct.unpack_from("<f", buf, pos)[0]
                pos += 4
            elif wire == 2:
                ln, pos = _read_varint(buf, pos)
                val = buf[pos : pos + ln]
                pos += ln
            else:
                raise ValueError(f"wire type {wire}")
            handlers.get(num, lambda v: None)(val)

    def on_summary(sbuf):
        def on_value(vbuf):
            tag = [None]
            sv = [None]
            walk(vbuf, {1: lambda v: tag.__setitem__(0, v.decode()), 2: lambda v: sv.__setitem__(0, v)})
            if tag[0] is not None and sv[0] is not None:
                scalars.append((tag[0], sv[0]))

        walk(sbuf, {1: on_value})

    holder = {"wall": 0.0, "step": 0}
    walk(
        buf,
        {
            1: lambda v: holder.__setitem__("wall", v),
            2: lambda v: holder.__setitem__("step", v),
            5: on_summary,
        },
    )
    return holder["wall"], holder["step"], scalars


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
