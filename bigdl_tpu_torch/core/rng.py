"""Deterministic randomness (``bigdl_tpu/core/rng.py`` counterpart).

The JAX package's ``RandomGenerator`` wraps a numpy ``default_rng`` for
host draws (shuffles, augmentation) beside a lazy threefry key for device
code. The port keeps the numpy half bit for bit — one seed gives the same
shuffle order in both packages — and draws device-side init from explicit
``torch.Generator``s instead of keys. The keyed draws that must match
the JAX package's bits (dropout masks) come from the threefry keys of
:mod:`~bigdl_tpu_torch.core.threefry`, re-exported here with the JAX
module's key helpers ``fold_in_str``, ``threefry_key_data`` and
``request_seed``. The in-step sampler's per-slot keys are raw ``(S, 2)``
uint32 words, as in the JAX engine; ``split_keys``, ``fold_in_keys`` and
``uniform_keys`` are ``jax.vmap`` of ``jax.random.split``, ``fold_in``
and 0-d ``uniform`` over them, bit for bit, computed on the host.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from bigdl_tpu_torch.core.threefry import (  # noqa: F401  (re-exports)
    Key,
    bernoulli,
    bits,
    fold_in,
    fold_in_str,
    key,
    key_data,
    split,
    threefry2x32_words,
    uniform,
)

_M64 = (1 << 64) - 1


def element_seed(base_seed: int, index: int, stream: int = 0) -> int:
    """Stable per-element seed: splitmix64 finalizer over the mixed inputs
    (pure integer operations; the same value as the JAX package's)."""
    x = (int(base_seed) * 0x9E3779B97F4A7C15
         + int(index) * 0xBF58476D1CE4E5B9
         + int(stream) * 0x94D049BB133111EB + 0x2545F4914F6CDD1D) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return x >> 1  # non-negative, < 2**63


def uniform01(seed: int, index: int, stream: int = 0) -> float:
    """Deterministic uniform draw in [0, 1) from the splitmix64 stream keyed
    on ``(seed, index, stream)``: :func:`element_seed` scaled to the unit
    interval. Fault plans draw their rate decisions and backoff jitter
    from it, and the metrics' reservoirs their replacement slots, so all
    of them replay exactly."""
    return element_seed(seed, index, stream) / float(1 << 63)


def np_rng(seed: int, index: int = 0, stream: int = 0) -> np.random.Generator:
    """``np.random.default_rng(seed)``, or with ``index``/``stream`` an
    independent keyed sub-stream through :func:`element_seed`."""
    if index or stream:
        seed = element_seed(seed, index, stream)
    return np.random.default_rng(int(seed))


def threefry_key_data(seed: int) -> np.ndarray:
    """The ``(2,)`` uint32 words ``[seed >> 32, seed & 0xFFFFFFFF]`` (both
    masked to 32 bits): the JAX package's host-side key words of a
    per-slot sampling seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def request_seed(base_seed: int, payload: bytes, stream: int = 0) -> int:
    """Per-request seed from an engine's ``base_seed`` and the request's
    identifying bytes: :func:`element_seed` with the payload's crc32 as
    the index, so the seed depends on the request's content alone."""
    return element_seed(base_seed, zlib.crc32(payload), stream)


def split_keys(keys, num: int = 2) -> np.ndarray:
    """``jax.vmap(lambda k: jax.random.split(k, num))`` over raw key words:
    (S, 2) uint32 -> (S, num, 2) uint32. The per-slot key state of the
    in-step sampler advances through this, one split per slot per step."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    s = keys.shape[0]
    out = threefry2x32_words(np.repeat(keys, num, axis=0),
                             np.tile(np.arange(num), s))
    return out.reshape(s, num, 2)


def fold_in_keys(keys, data) -> np.ndarray:
    """``jax.random.fold_in`` row by row: ``keys`` (..., 2) uint32 raw
    words and ``data`` integers in [0, 2**32), broadcast against each
    other -> (..., 2) uint32."""
    keys = np.asarray(keys, np.uint32)
    data = np.asarray(data, np.int64)
    lead = np.broadcast_shapes(keys.shape[:-1], data.shape)
    data = np.broadcast_to(data, lead).reshape(-1)
    if data.size and (data.min() < 0 or data.max() > 0xFFFFFFFF):
        raise ValueError("fold_in data outside [0, 2**32)")
    keys = np.broadcast_to(keys, lead + (2,)).reshape(-1, 2)
    return threefry2x32_words(keys, data).reshape(lead + (2,))


def uniform_keys(keys) -> np.ndarray:
    """``jax.random.uniform(k, (), float32)`` for each key of ``keys``
    (..., 2) uint32 -> (...) float32 in [0, 1)."""
    keys = np.asarray(keys, np.uint32)
    words = threefry2x32_words(keys.reshape(-1, 2), 0)
    b = ((words[:, 0] ^ words[:, 1]) >> np.uint32(9)) | np.uint32(0x3F800000)
    return (b.view(np.float32) - np.float32(1.0)).reshape(keys.shape[:-1])


class RandomGenerator:
    """Stateful host generator over numpy's ``default_rng(seed)``.

    ``default()`` is one process-wide instance, as in the JAX package;
    code that needs a reproducible order passes its own
    ``RandomGenerator(seed)``."""

    _default: Optional["RandomGenerator"] = None

    def __init__(self, seed: int = 1):
        self._seed = seed
        self._np = np.random.default_rng(seed)

    @classmethod
    def default(cls) -> "RandomGenerator":
        if cls._default is None:
            cls._default = RandomGenerator()
        return cls._default

    def reseed(self, seed: int) -> "RandomGenerator":
        """Deterministic reseed, the pipeline pool's per-element path: the
        PCG64 state and stream increment are both derived from ``seed``
        (the JAX package's formula), so ``reseed(s)`` draws the same
        whatever generator it lands on — chain copies on different
        workers draw alike for equal seeds. Other bit generators are
        rebuilt from the seed."""
        self._seed = seed
        bg = self._np.bit_generator
        st = bg.state
        if st.get("bit_generator") != "PCG64":
            self._np = np.random.default_rng(seed)
            return self
        mixed = (seed * 0x9E3779B97F4A7C15) & _M64
        inc = (seed * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) & _M64
        st["state"]["state"] = (mixed << 64) | (seed & _M64)
        st["state"]["inc"] = ((inc << 64) | (mixed ^ seed)) | 1
        st["has_uint32"] = 0
        st["uinteger"] = 0
        bg.state = st
        return self

    @property
    def seed(self) -> int:
        return self._seed

    def numpy(self) -> np.random.Generator:
        return self._np

    def permutation(self, n: int):
        return self._np.permutation(n)
