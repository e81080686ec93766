"""Shared set-up for the PyTorch port's tests."""

import gc
from pathlib import Path

import pytest
import torch

PORT_TESTS = Path(__file__).resolve().parent
# the intra-op thread count the tests after the port's get back
TORCH_THREADS = torch.get_num_threads()


@pytest.fixture(scope="session")
def jax_lm():
    """The small language model the serving parity tests share: the JAX
    package's ``Transformer(64, 32, 4, 64, 2)`` and its params from
    ``init(key(2))``. Built once: its eager init is seconds of JAX
    compiles."""
    import jax

    from bigdl_tpu.nn.layers.attention import Transformer

    model = Transformer(64, 32, 4, 64, 2)
    params, _ = model.init(jax.random.key(2))
    return model, params


@pytest.fixture(scope="session")
def jax_paged_kernels(jax_lm):
    """One JAX kernel set over ``jax_lm``, its steps compiled at XLA level
    0 (``_jax_trees.fast_kernels``), shared by the JAX engines of the
    engine, prefix-cache and host-tier tests: at one engine shape (4
    slots, 32-token lanes, pages of 4) their steps compile once."""
    from _jax_trees import fast_kernels
    from bigdl_tpu.serving import PagedDecodeKernels

    return fast_kernels(PagedDecodeKernels(jax_lm[0]))


@pytest.fixture(scope="session")
def jax_spec(jax_lm):
    """The speculative tests' JAX draft, ``Transformer(64, 16, 2, 32, 1)``
    with seeded weights (``_jax_trees.seeded_trees``, seed 1), and one
    JAX ``SpeculativeKernels`` over ``jax_lm`` and it, compiled at XLA
    level 0 and shared by the speculative engine, trace and fault tests:
    its four steps compile once. -> ``(draft, draft params, kernels)``."""
    from _jax_trees import fast_kernels, seeded_trees
    from bigdl_tpu.nn.layers.attention import Transformer
    from bigdl_tpu.serving import SpeculativeKernels

    draft = Transformer(64, 16, 2, 32, 1)
    dparams, _ = seeded_trees(draft, seed=1)
    return draft, dparams, fast_kernels(SpeculativeKernels(jax_lm[0], draft))


@pytest.fixture(scope="session")
def real_tracker_lock():
    """The process pool hands results back through shared memory, whose
    blocks the stdlib's resource tracker registers under its module-level
    lock. The suite's lock sanitizer (``tests/_sanitizers.py``) keeps
    locks made before it was installed real, to keep foreign runtimes'
    internals out of its graph; the tracker is imported later, so its
    lock is a tracked wrapper that lacks the ``_recursion_count`` the
    tracker calls. Give the tracker a real lock, as if it had been
    imported first."""
    import _thread
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._lock = _thread.RLock()


@pytest.fixture(autouse=True)
def _reset_port_faults():
    """The port's fault injector is process-global by design: a site one
    test leaves armed must never fire inside another."""
    from bigdl_tpu_torch import faults

    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module", autouse=True)
def _collect_module_garbage():
    """Collect each module's garbage (models, engines, autograd graphs)
    when it is done, so the tests after it start from a heap that holds
    none of it. What is alive when a module starts (the imported
    packages, JAX's executables, the session fixtures) is frozen out of
    the collector's sight (``gc.freeze``), so each collection walks only
    what the modules since allocated: a full collection over JAX's kept
    executables took ~0.3-0.5 s a module. The last port test unfreezes
    it (``pytest_runtest_teardown``)."""
    gc.collect()
    gc.freeze()
    yield
    gc.collect()


def pytest_runtest_setup(item):
    """The port's tests run torch on one thread: their tensors are small,
    and on a host whose cores other work shares, the intra-op pool's
    hand-offs cost more than they save (a 77,100-draw threefry took
    0.2-1.0 s on 8 threads, 0.03 s on one)."""
    torch.set_num_threads(1)


def pytest_runtest_teardown(item, nextitem):
    """After the last of the port's tests, give the tests after them
    torch's thread count back and drop the JAX executables the port's
    tests compiled. The parity tests compile many small JAX executables
    (the Pallas kernels in interpret mode, eager reference calls, the JAX
    engine). JAX keeps compiled executables in one process-wide cache of
    bounded size, and the JAX package's compile-once tests, which run
    later in the same process, read their functions' entries in it: they
    must see the cache as if the port's tests had not run. Between the
    port's own modules the cache stays, so an executable one module
    compiled (an eager op at a shape, the shared LM's init) serves the
    next."""
    if nextitem is None or PORT_TESTS not in Path(
            str(nextitem.path)).resolve().parents:
        import jax

        torch.set_num_threads(TORCH_THREADS)
        gc.unfreeze()
        jax.clear_caches()
        gc.collect()
