"""Shared set-up for the PyTorch port's tests."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    """The parity tests compile many small JAX executables (the Pallas
    kernels in interpret mode, eager reference calls, the JAX engine).
    JAX keeps compiled executables in one process-wide cache of bounded
    size, and the JAX package's compile-once tests, which run later in the
    same process, read their functions' entries in it. Drop this module's
    entries when it is done, so the later tests see the cache as if the
    port's tests had not run."""
    yield
    import jax

    jax.clear_caches()
