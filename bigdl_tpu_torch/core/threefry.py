"""Threefry-2x32 keys: the draws of ``jax.random``, bit for bit.

The JAX package draws its dropout masks (and its sampling noise) from
threefry keys (``jax.random``, with ``jax_threefry_partitionable`` on,
the default of the JAX it runs on). The port draws the same bits from the
same keys, so a training step keyed like the JAX package's drops the same
units. What each function computes, with ``tf(k, (x0, x1))`` the
threefry-2x32 block cipher of the counter pair ``(x0, x1)`` under the key
words ``k``:

- ``key(s)``: the words ``(0, s & 0xFFFFFFFF)`` (JAX's 32-bit mode
  keeps the low word of a larger seed);
- ``fold_in(k, d)``: ``tf(k, (0, d))``;
- ``split(k, n)[i]``: ``tf(k, (0, i))``;
- ``bits(k, shape)``: the xor of the two words of ``tf(k, (0, i))`` for
  each flat row-major index ``i``;
- ``uniform(k, shape)``: ``((bits >> 9) | 0x3F800000)`` read as fp32,
  minus 1;
- ``bernoulli(k, p, shape)``: ``uniform(k, shape) < p``, with ``p`` in
  fp32;
- ``dropout(x, rate, k)``: ``where(bernoulli(k, 1 - rate, x.shape), x,
  0) / (1 - rate)``, the JAX package's inverted dropout.

A key is two Python integers (:class:`Key`): folding and splitting run on
the host, at the cost of a few microseconds, and never wait for a card.
The counter-mode draws (``bits`` and what builds on it) run as integer
torch ops on the device they are asked for. The words are held in int64
tensors and masked back to 32 bits after each add and shift, so every op
is exact and the CPU and a card give the same bits. A mask is ~170 eager
elementwise ops over its draws: on a card that is most of a dropout-heavy
training step's device time (``PERF.md``).
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from bigdl_tpu_torch.core.device import DeviceLike

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000          # 1.0f: exponent 127, mantissa 0
_MANTISSA_SHIFT = 32 - 23


class Key(NamedTuple):
    """A threefry key: its two 32-bit words, as ``jax.random.key_data``
    gives them."""
    k0: int
    k1: int


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k: Key, x0, x1):
    """The threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` under key ``k``. The words are Python ints or int64
    tensors holding values in [0, 2**32); so are the two results."""
    ks = (k.k0, k.k1, k.k0 ^ k.k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0, x1


def _pack(words: np.ndarray) -> int:
    """(N,) 32-bit words as one Python int, word i in bits [64 i, 64 i +
    32); the 32 bits above each word take the carries of an add and the
    bits a shift pushes out, and every op masks them off again."""
    return int.from_bytes(np.asarray(words, "<u8").tobytes(), "little")


def _unpack(v: int, n: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(8 * n, "little"), "<u8").astype(
        np.uint32)


def threefry2x32_words(keys: np.ndarray, x1) -> np.ndarray:
    """``threefry2x32(keys[i], 0, x1[i])`` for every row ``i`` at once:
    ``keys`` (N, 2) uint32 key words, ``x1`` (N,) counters (or one for
    every row) -> (N, 2) uint32. The N lanes ride in one Python integer
    64 bits apart, so each of the cipher's ~200 adds, shifts and xors is
    one big-integer op over every lane (a constant in every lane is the
    constant times ``ones``). The per-slot keys of sampling evolve here,
    on the host."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    n = keys.shape[0]
    ones = ((1 << (64 * n)) - 1) // ((1 << 64) - 1)     # 1 in every lane
    m = _M32 * ones
    k0, k1 = _pack(keys[:, 0]), _pack(keys[:, 1])
    ks = (k0, k1, k0 ^ k1 ^ (_PARITY * ones))
    x1 = (int(x1) * ones if np.ndim(x1) == 0
          else _pack(np.asarray(x1, np.uint64).reshape(n)))
    y0, y1 = k0, (x1 + k1) & m
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 = (y0 + y1) & m
            y1 = (((y1 << r) | (y1 >> (32 - r))) & m) ^ y0
        y0 = (y0 + ks[(i + 1) % 3]) & m
        y1 = (y1 + ks[(i + 2) % 3] + (i + 1) * ones) & m
    return np.stack([_unpack(y0, n), _unpack(y1, n)], axis=1)


def key(seed: int) -> Key:
    """The key of ``seed`` (``jax.random.key`` under JAX's default 32-bit
    mode): the high word 0, the low word ``seed & 0xFFFFFFFF``."""
    return Key(0, int(seed) & _M32)


def key_data(keys: Union[Key, Sequence[Key]]) -> np.ndarray:
    """The uint32 words of a key, (2,), or of a sequence of keys, (n, 2)."""
    if isinstance(keys, Key):
        return np.array(keys, np.uint32)
    return np.array([tuple(k) for k in keys], np.uint32).reshape(-1, 2)


def fold_in(k: Key, data: int) -> Key:
    """A key derived from ``k`` and the 32-bit integer ``data``."""
    data = int(data)
    if not 0 <= data <= _M32:
        raise ValueError(f"fold_in data {data} outside [0, 2**32)")
    return Key(*threefry2x32(k, 0, data))


def fold_in_str(k: Key, name: str) -> Key:
    """A key derived from ``k`` and a string: ``fold_in`` of its crc32,
    masked to 31 bits (``bigdl_tpu/core/rng.py::fold_in_str``)."""
    return fold_in(k, zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF)


def split(k: Key, num: int = 2) -> Tuple[Key, ...]:
    """``num`` new keys from ``k``."""
    return tuple(Key(*threefry2x32(k, 0, i)) for i in range(int(num)))


def bits(k: Key, shape: Sequence[int],
         device: DeviceLike = "cpu") -> torch.Tensor:
    """Random 32-bit words of ``shape`` on ``device``, as int64 tensors
    holding values in [0, 2**32)."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise ValueError(f"bits: {n} draws need a high counter word, "
                         f"which this port does not take")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k, 0, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(k: Key, shape: Sequence[int],
            device: DeviceLike = "cpu") -> torch.Tensor:
    """fp32 draws in [0, 1) of ``shape`` on ``device``: the high 23 bits of
    each word as the mantissa of a float in [1, 2), minus 1."""
    b = (bits(k, shape, device) >> _MANTISSA_SHIFT) | _ONE_F32_BITS
    return b.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k: Key, p: float, shape: Sequence[int],
              device: DeviceLike = "cpu") -> torch.Tensor:
    """A bool tensor of ``shape`` on ``device``, each entry true with
    probability ``p`` (rounded to fp32, as JAX rounds it)."""
    return uniform(k, shape, device) < float(np.float32(p))


def dropout(x: torch.Tensor, rate: float, k: Key) -> torch.Tensor:
    """``x`` with each entry kept with probability ``1 - rate`` (the mask
    ``bernoulli(k, 1 - rate, x.shape)``) and the kept ones divided by
    ``1 - rate`` in ``x``'s dtype. The divisor is a tensor on ``x``'s
    device: CUDA computes a division by a Python scalar as a multiply by
    its reciprocal, which is not bitwise the CPU's (or JAX's) division."""
    keep = 1.0 - rate
    mask = bernoulli(k, keep, x.shape, x.device)
    kept = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    return kept / torch.full((), keep, dtype=x.dtype, device=x.device)
