"""Seeded numpy ``params``/``state`` trees for the parity tests, and the
fast-compiling jit they run their JAX references through.

The JAX package's ``init`` draws every weight through threefry, which is
slow on the CPU for a whole ResNet. The tests instead take the tree's
shapes from ``jax.eval_shape(model.init, key)`` (no computation) and fill
them from numpy with a seed: He-scaled weights, BN scales near 1 and
shifts near 0, running statistics near (0, 1). The same arrays then go to
the JAX model directly and to the port's through ``load_jax_params``.
"""

import jax
import numpy as np


def _leaf(rs, path, shape):
    name = path[-1]
    if name == "running_mean":
        return 0.1 * rs.standard_normal(shape)
    if name == "running_var":
        return 1.0 + 0.5 * rs.random_sample(shape)
    if name == "bias":
        return 0.1 * rs.standard_normal(shape)
    if len(shape) == 1:                       # a BN scale
        return 1.0 + 0.2 * rs.standard_normal(shape)
    # conv OIHW or linear (out, in): He normal over the fan-in (an HWIO
    # weight gets a smaller scale from the same rule; any scale will do)
    fan_in = int(np.prod(shape[1:]))
    return rs.standard_normal(shape) * np.sqrt(2.0 / fan_in)


def seeded_trees(model, seed=0):
    """(params, state) numpy float32 trees with the JAX model's structure."""
    shapes = jax.eval_shape(model.init, jax.random.key(0))
    rs = np.random.RandomState(seed)

    def fill(tree, path=()):
        if isinstance(tree, dict):
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        return _leaf(rs, path, tree.shape).astype(np.float32)

    return fill(shapes[0]), fill(shapes[1])


def flat(tree, prefix=""):
    """Nested dict -> {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = v
    return out


def assert_trees_close(got, want, rtol, atol, what):
    """Every leaf of ``want`` present in ``got`` and within tolerance:
    ``|got - want| <= atol * max(1, max|want leaf|) + rtol * |want|`` —
    the absolute part scales with the leaf's largest entry, since summation
    order moves an entry by ulps of the sums it came from, not of itself."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w)))
    for k in w:
        want_k = np.asarray(w[k])
        scale = max(1.0, float(np.abs(want_k).max(initial=0.0)))
        np.testing.assert_allclose(np.asarray(g[k]), want_k, rtol=rtol,
                                   atol=atol * scale, err_msg=f"{what} {k}")


# XLA's CPU backend at optimisation level 0: the same HLO and the same
# fusions, with LLVM's passes off. The reference models are small, so
# compiling them is most of what a parity test costs; compiled this way
# it costs a fraction. Results may move by ulps, inside every test's
# stated tolerance.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def compile_fast(fn, *args):
    """``jax.jit(fn)`` lowered for ``args`` and compiled with
    ``FAST_COMPILE``; call the result with ``args``."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def run_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with ``FAST_COMPILE``, as numpy."""
    return jax.device_get(compile_fast(fn, *args)(*args))


def fast_kernels(kernels):
    """A JAX engine's kernel set (``PagedDecodeKernels`` or
    ``SpeculativeKernels``) whose jitted steps compile with
    ``FAST_COMPILE``: each step lowers on its first call at a signature
    and keeps the executable for later calls at the same one. The same
    functions, arguments and donation; only LLVM's passes are off."""
    for name in ("_prefill", "_chunk", "_decode", "_draft_write", "_draft",
                 "_verify"):
        jitted = getattr(kernels, name, None)
        if jitted is not None:
            setattr(kernels, name, _FastJit(jitted))
    return kernels


class _FastJit:
    def __init__(self, jitted):
        self._jit = jax.jit(jitted.__wrapped__, donate_argnums=(1,))
        self._compiled = {}

    def __call__(self, *args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        sig = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        fn = self._compiled.get(sig)
        if fn is None:
            fn = self._compiled[sig] = self._jit.lower(*args).compile(
                FAST_COMPILE)
        return fn(*args)
