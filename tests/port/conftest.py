"""Shared set-up for the PyTorch port's tests."""

import gc

import pytest


@pytest.fixture(scope="session")
def jax_lm():
    """The small language model the serving parity tests share: the JAX
    package's ``Transformer(64, 32, 4, 64, 2)`` and its params from
    ``init(key(2))``. Built once: its eager init is seconds of JAX
    compiles, and each module's executables are dropped after it."""
    import jax

    from bigdl_tpu.nn.layers.attention import Transformer

    model = Transformer(64, 32, 4, 64, 2)
    params, _ = model.init(jax.random.key(2))
    return model, params


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    """The parity tests compile many small JAX executables (the Pallas
    kernels in interpret mode, eager reference calls, the JAX engine).
    JAX keeps compiled executables in one process-wide cache of bounded
    size, and the JAX package's compile-once tests, which run later in the
    same process, read their functions' entries in it. Drop this module's
    entries when it is done, so the later tests see the cache as if the
    port's tests had not run. Collect the module's garbage too (models,
    engines, autograd graphs), so the later tests start from a heap that
    holds none of it."""
    yield
    import jax

    jax.clear_caches()
    gc.collect()
