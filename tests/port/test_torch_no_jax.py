"""The port imports neither JAX nor the JAX package, nor the packages the
card's machine lacks: flax, msgpack, tensorboard, tensorboardX.

An AST scan of every module of ``bigdl_tpu_torch``, of the measurement
scripts ``port_perf/*.py`` and of ``chip_smoke.py`` (no subprocess: a fresh interpreter per check would make this a slow
test). It rejects ``jax``, ``jaxlib`` and anything else under a ``jax*``
top-level name, ``bigdl_tpu`` / ``bigdl_tpu.*`` — while accepting
``bigdl_tpu_torch``, which shares the ``bigdl_tpu`` prefix — and
``flax``, ``msgpack``, ``tensorboard`` and ``tensorboardX``.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


ABSENT_ON_THE_CARD = ("flax", "msgpack", "tensorboard", "tensorboardX")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return (top.startswith("jax") or top == "bigdl_tpu"
            or top in ABSENT_ON_THE_CARD)


def forbidden_imports(source: str):
    """(line, module) for every import of a forbidden module in
    ``source``, including ``importlib.import_module("...")`` and
    ``__import__("...")`` with a constant name."""
    found = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if fname in ("import_module", "__import__"):
                names = [node.args[0].value]
        found += [(node.lineno, n) for n in names if _forbidden(n)]
    return found


def _port_sources():
    files = sorted((REPO / "bigdl_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "port_perf").glob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def test_port_tree_is_scanned():
    files = _port_sources()
    assert (REPO / "chip_smoke.py").exists()
    assert REPO / "port_perf" / "variants.py" in files
    for module in ("core/threefry.py", "nn/layers/embedding.py",
                   "nn/module.py", "nn/criterion.py", "ops/sampling.py",
                   "core/rng.py", "serving/engine.py", "serving/paging.py",
                   "serving/prefix_cache.py", "serving/kv_tiers.py",
                   "serving/disagg.py", "grammar/__init__.py",
                   "grammar/automaton.py", "grammar/regex.py",
                   "grammar/schema.py", "obs/trace.py", "obs/endpoint.py",
                   "faults/injector.py", "faults/watchdog.py",
                   "utils/errors.py", "utils/msgpack_codec.py",
                   "utils/checkpoint.py", "ckpt/manager.py",
                   "ckpt/manifest.py", "visualization/events.py",
                   "serving/hot_reload.py", "optim/validation.py",
                   "parallel/__init__.py", "parallel/mesh.py",
                   "parallel/overlap.py", "core/engine.py",
                   "optim/distri_optimizer.py",
                   "dataset/parallel_pipeline.py", "dataset/image.py",
                   "nn/layers/beam_search.py"):
        assert REPO / "bigdl_tpu_torch" / module in files, module
    assert len(files) >= 15, files


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_bigdl_tpu_import(path):
    bad = forbidden_imports(path.read_text())
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("source, rejected", [
    ("import jax", True),
    ("import jax.numpy as jnp", True),
    ("from jax import lax", True),
    ("import jaxlib", True),
    ("import bigdl_tpu", True),
    ("from bigdl_tpu.serving import paging", True),
    ("import bigdl_tpu.nn.init", True),
    ("import importlib\nimportlib.import_module('jax.numpy')", True),
    ("__import__('bigdl_tpu.serving')", True),
    ("import bigdl_tpu_torch", False),
    ("from bigdl_tpu_torch.ops import flash_attention", False),
    ("import bigdl_tpu_torch.serving.engine as e", False),
    ("from . import paging", False),
    ("import torch, numpy", False),
    ("from flax import serialization", True),
    ("import msgpack", True),
    ("import tensorboard", True),
    ("from tensorboardX import SummaryWriter", True),
    ("from torch.utils import tensorboard", False),
    ("from bigdl_tpu_torch.utils import msgpack_codec", False),
])
def test_guard_accepts_port_rejects_jax(source, rejected):
    assert bool(forbidden_imports(source)) == rejected
