"""The checkpoint's byte format: the MessagePack subset that flax's
``serialization.to_bytes`` writes, encoded and decoded here so that the
port needs neither flax nor the ``msgpack`` package.

A value is a map with string keys, an int, a float, a bool, nil, a str,
bytes, an array (list or tuple), or a numpy array. A numpy array is the
extension type 1 (a numpy scalar, type 3) whose data is the packed triple
``(shape, dtype name, C-order bytes)``. An array of more than
``MAX_CHUNK_SIZE`` bytes is written, as flax writes it, as the map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": flat chunk, ...}}`` and read back whole. Ints and containers take
their shortest encoding, floats are float64 and maps keep their order, as
flax writes them through the ``msgpack`` package, so the bytes of a tree
of numpy arrays are the ones flax writes. ``pack_parts`` gives them as
buffers that view the arrays' memory. Arrays decode as writable views of
the input (a bytearray) or of one copy of it; a ``bfloat16`` array (numpy has no
such type) decodes widened to float32, exactly.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np

#: arrays above this many bytes are written in chunks (flax's limit)
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------- encoding ----

def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 128:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit in 64 bits")


def _pack_header(n: int, fix: int, fix_max: int, codes, out) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; None where the type has no 8-bit form)."""
    if n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit in 32 bits")


def _pack_bin(b: bytes, out) -> None:
    _pack_header(len(b), 0, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _pack_str(s: str, out) -> None:
    b = s.encode("utf-8")
    _pack_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
    out.append(b)


def _nbytes(part) -> int:
    return part.nbytes if isinstance(part, memoryview) else len(part)


def _pack_ext(code: int, data: List, out) -> None:
    """An extension value whose data is the parts ``data``."""
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = sum(_nbytes(p) for p in data)
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n < 1 << 8:
        out.append(bytes([0xC7, n, code]))
    elif n < 1 << 16:
        out.append(b"\xc8" + struct.pack(">H", n) + bytes([code]))
    else:
        out.append(b"\xc9" + struct.pack(">I", n) + bytes([code]))
    out.extend(data)


def _array_parts(arr: np.ndarray) -> List:
    """The packed triple ``(shape, dtype name, C-order bytes)``, the bytes
    as a view of the array's own memory (no copy of a C-contiguous
    array)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    out: List = [b"\x93"]
    _pack(tuple(arr.shape), out)
    _pack_str(arr.dtype.name, out)
    _pack_header(raw.nbytes, 0, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(memoryview(raw))
    return out


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(obj, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
        else:
            _pack_ext(_EXT_NDARRAY, _array_parts(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _array_parts(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        _pack_str(obj, out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(bytes(obj), out)
    elif isinstance(obj, dict):
        _pack_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            _pack_str(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__}")


def pack_parts(obj) -> List:
    """``obj`` as a list of byte buffers whose concatenation is its
    MessagePack encoding: each array's data is a view of the array, so a
    caller that writes or hashes the parts one by one never copies the
    arrays (and, in file writes and ``hashlib``, runs without the
    interpreter lock)."""
    out: List = []
    _pack(obj, out)
    return out


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes."""
    return b"".join(pack_parts(obj))


# ------------------------------------------------------------- decoding ----

class _Reader:
    def __init__(self, data, views: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.views = views    # bin values as views of the buffer

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MessagePack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        code = self.unpack("B")
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return self.array(code & 0x0F)
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in simple:
            return simple[code]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if code in sized:
            view = self.take(self.unpack(sized[code]))
            return view if self.views else bytes(view)
        strings = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if code in strings:
            return str(self.take(self.unpack(strings[code])), "utf-8")
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if code in numbers:
            return self.unpack(numbers[code])
        if code in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if code == 0xDC else ">I"))
        if code in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if code == 0xDE else ">I"))
        fixed_ext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if code in fixed_ext:
            return self.ext(fixed_ext[code])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if code in ext:
            return self.ext(self.unpack(ext[code]))
        raise ValueError(f"unsupported MessagePack type byte 0x{code:02x}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported MessagePack extension type {code}")
        inner = _Reader(data, views=True)
        shape, dtype, raw = inner.value()
        if dtype == "bfloat16":
            bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, np.dtype(dtype))
        arr = arr.reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """The value MessagePack ``data`` encodes, chunked arrays joined."""
    # arrays decode as views of a writable buffer: ``data`` itself when it
    # is a bytearray, else one copy
    reader = _Reader(data if isinstance(data, bytearray) else bytearray(data))
    value = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the MessagePack value")
    return _unchunk(value)
