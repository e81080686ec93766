"""The port's threefry keys and draws against ``jax.random``, bit for bit.

``bigdl_tpu_torch.core.threefry`` computes keys on the host and draws on
a torch device with exact integer ops; every result here must equal
``jax.random``'s (threefry, ``jax_threefry_partitionable``) in every bit:
the keys' words, the 32-bit draws, the fp32 uniforms' bit patterns and
the Bernoulli masks. Then the helpers of ``bigdl_tpu/core/rng.py`` and
the dropout that draws from the keys, against the JAX ``Dropout``.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import run_fast

from bigdl_tpu.core import rng as jrng
from bigdl_tpu.nn.layers.dropout import Dropout as JaxDropout
from bigdl_tpu_torch.core import rng as trng
from bigdl_tpu_torch.core import threefry as tf
from bigdl_tpu_torch.nn import Dropout

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32 + 5, 2 ** 40 + 7]


def _words(jax_key) -> np.ndarray:
    return np.asarray(jax.random.key_data(jax_key))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in_match_jax(seed):
    jk, tk = jax.random.key(seed), tf.key(seed)
    np.testing.assert_array_equal(tf.key_data(tk), _words(jk))
    for n in (1, 2, 5):
        np.testing.assert_array_equal(tf.key_data(tf.split(tk, n)),
                                      _words(jax.random.split(jk, n)))
    for data in (0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(tf.key_data(tf.fold_in(tk, data)),
                                      _words(jax.random.fold_in(jk, data)))
    for name in ("", "embed_drop", "decoder_0/self_attention/inner"):
        np.testing.assert_array_equal(
            tf.key_data(tf.fold_in_str(tk, name)),
            _words(jrng.fold_in_str(jk, name)))


# (), a scalar; 77,100 draws, past 2**16; odd and even sizes
SHAPES = [(), (1,), (5, 7), (3, 4, 5), (300, 257)]
PROBS = [0.1, 0.5, 0.9, 1.0 - 0.1]


@pytest.fixture(scope="module")
def jax_draws():
    """``jax.random``'s bits, uniforms and Bernoulli masks for every shape,
    under the key of seed 42 split once: one jitted call per shape (the
    draws are integer ops and exact however they are compiled)."""
    k = jax.random.split(jax.random.key(42))[1]
    out = {}
    for shape in SHAPES:
        def draw(k, shape=shape):
            return (jax.random.bits(k, shape), jax.random.uniform(k, shape),
                    [jax.random.bernoulli(k, p, shape) for p in PROBS])
        out[shape] = run_fast(draw, k)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_bernoulli_match_jax(jax_draws, shape):
    bits, uniform, masks = jax_draws[shape]
    k = tf.split(tf.key(42))[1]
    got = tf.bits(k, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), bits)
    u = tf.uniform(k, shape)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  np.asarray(uniform).view(np.uint32))
    for p, mask in zip(PROBS, masks):
        np.testing.assert_array_equal(tf.bernoulli(k, p, shape).numpy(), mask)


def test_threefry_key_data_and_request_seed_match_jax():
    for seed in SEEDS:
        np.testing.assert_array_equal(trng.threefry_key_data(seed),
                                      jrng.threefry_key_data(seed))
    for base, payload, stream in ((0, b"", 0), (7, bytes(range(40)), 0),
                                  (2 ** 40, b"\x01\x02", 3)):
        assert trng.request_seed(base, payload, stream) == \
            jrng.request_seed(base, payload, stream)
    assert trng.request_seed(5, b"ab") == trng.element_seed(
        5, zlib.crc32(b"ab"))


@pytest.mark.parametrize("n", [1, 3, 40])
def test_lane_packed_cipher_equals_the_per_key_cipher(n):
    """``threefry2x32_words`` (every row's cipher in one big integer, the
    sampler's host-side key work) against ``threefry2x32`` row by row,
    with counters at 0 and at 2**32 - 1, and one counter for every row;
    ``fold_in_keys`` rejects data outside 32 bits as ``fold_in`` does."""
    rs = np.random.RandomState(n)
    keys = rs.randint(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    x1 = rs.randint(0, 2 ** 32, (n,), dtype=np.uint64)
    x1[0] = 2 ** 32 - 1
    for counters in (x1, 0, 2 ** 32 - 1):
        got = tf.threefry2x32_words(keys, counters)
        for i, (k0, k1) in enumerate(keys):
            c = counters if np.ndim(counters) == 0 else counters[i]
            want = tf.threefry2x32(tf.Key(int(k0), int(k1)), 0, int(c))
            assert tuple(got[i]) == want, (i, c)
    with pytest.raises(ValueError, match="32"):
        trng.fold_in_keys(keys, 2 ** 32)


def test_fold_in_rejects_data_outside_32_bits():
    with pytest.raises(ValueError, match="outside"):
        tf.fold_in(tf.key(0), -1)
    with pytest.raises(ValueError, match="outside"):
        tf.fold_in(tf.key(0), 2 ** 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_jax_bitwise(dtype, rate):
    """The module at the root of the call: its path is "" and its draw is
    the first, as ``Context.rng`` gives them; mask and scaled values equal
    the JAX ``Dropout``'s eager result in every bit."""
    x = np.random.RandomState(3).standard_normal((4, 6, 9)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want, _ = JaxDropout(rate).apply({}, jx, training=True,
                                     rng=jax.random.key(11))
    drop = Dropout(rate).train()
    got = drop(torch.from_numpy(x).to(getattr(torch, dtype)),
               rng=tf.key(11))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert 0 < int((want == 0).sum()) < want.size
    # evaluation mode and a rate of 0 draw nothing and need no key
    assert drop.eval()(torch.ones(3)).tolist() == [1.0] * 3
    assert Dropout(0.0).train()(torch.ones(3)).tolist() == [1.0] * 3
    with pytest.raises(ValueError, match="rng"):
        Dropout(rate).train()(torch.ones(3))
