"""The port's checkpoint watcher (``serving/hot_reload.py``) through the
cases of ``tests/test_serving.py``'s watcher tests, on the port's
``InferenceService`` over a small MLP (``Linear(8, 16) - ReLU -
Linear(16, 4)``, seeded weights bridged in), and over a directory the JAX
package's ``CheckpointManager`` wrote. A reloaded service's outputs are
held against a port model loaded with the same tree, bitwise (same
model, same rows, same CPU kernels); the engine case against
``static_generate`` over the new weights."""

import time

import jax
import numpy as np
import pytest
import torch
from _jax_trees import seeded_trees

import bigdl_tpu.nn as jnn
from bigdl_tpu.ckpt import CheckpointManager as JaxCheckpointManager
from bigdl_tpu_torch import faults, nn
from bigdl_tpu_torch.ckpt import CheckpointManager
from bigdl_tpu_torch.ckpt.manifest import (
    load_manifest,
    sha256_bytes,
    write_manifest,
)
from bigdl_tpu_torch.faults import RetryPolicy
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.serving import (
    GenerationEngine,
    InferenceService,
    static_generate,
    watch_checkpoints,
)

WAIT = 10


def _port_mlp(params):
    return load_jax_params(nn.Sequential(
        nn.Linear(8, 16, device="cpu"), nn.ReLU(),
        nn.Linear(16, 4, device="cpu")), params)


@pytest.fixture(scope="module")
def setup():
    params, _ = seeded_trees(jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                                            jnn.Linear(16, 4)), 0)
    x = np.random.RandomState(0).rand(4, 8).astype(np.float32)
    return params, x


def _scaled(params, k):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) * k, params)


def _expected(params, x):
    with torch.no_grad():
        return _port_mlp(params)(torch.from_numpy(x[:1])).numpy()[0]


def _until(cond):
    deadline = time.monotonic() + WAIT
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _service(params):
    return InferenceService(_port_mlp(params), device="cpu", max_wait_ms=1.0)


@pytest.mark.parametrize("writer", [CheckpointManager, JaxCheckpointManager],
                         ids=["port_writer", "jax_writer"])
def test_watcher_reloads_on_each_new_commit(setup, tmp_path, writer):
    """An existing commit is adopted at start, a new one swapped in
    without a restart; ``reload_existing=False`` takes the tip as the
    baseline. Either package's manager may write the directory."""
    params, x = setup
    ckdir = str(tmp_path / "ck")
    with writer(ckdir, fsync=False) as mgr:
        mgr.save("model.iter1", _scaled(params, 3.0), {}, {},
                 meta={"iteration": 1}, blocking=True)
        svc = _service(params)
        watcher = watch_checkpoints(svc, ckdir, poll_interval=0.02)
        assert _until(lambda: watcher.reloads == 1)
        np.testing.assert_array_equal(svc.predict(x[0], timeout=30),
                                      _expected(_scaled(params, 3.0), x))
        mgr.save("model.iter2", _scaled(params, 5.0), {}, {},
                 meta={"iteration": 2}, blocking=True)
        assert _until(lambda: watcher.reloads == 2)
        assert watcher.last_entry.step == 2
        np.testing.assert_array_equal(svc.predict(x[0], timeout=30),
                                      _expected(_scaled(params, 5.0), x))
        watcher.stop(timeout=10)
        svc2 = _service(params)
        with watch_checkpoints(svc2, ckdir, poll_interval=0.02,
                               reload_existing=False) as w2:
            time.sleep(0.1)
            assert w2.reloads == 0 and w2.last_entry.tag == "model.iter2"
        svc2.close()
        svc.close()
    assert svc.metrics.snapshot()["reloads"] == 2


def test_watcher_memoizes_an_unloadable_tip(setup, tmp_path):
    params, x = setup
    ckdir = str(tmp_path / "ck")
    with CheckpointManager(ckdir, fsync=False) as mgr:
        mgr.save("model.iter1", {"alien": np.zeros((3, 3), np.float32)},
                 {}, {}, meta={"iteration": 1}, blocking=True)
        svc = _service(params)
        watcher = watch_checkpoints(svc, ckdir, poll_interval=0.01)
        assert _until(lambda: watcher.last_error is not None)
        assert isinstance(watcher.last_error, ValueError)
        time.sleep(0.05)
        assert watcher._skip_tag == "model.iter1" and watcher.reloads == 0
        assert svc.metrics.snapshot()["reloads"] == 0
        mgr.save("model.iter2", _scaled(params, 2.0), {}, {},
                 meta={"iteration": 2}, blocking=True)
        assert _until(lambda: watcher.reloads == 1)
        assert watcher.last_error is None
        watcher.stop(timeout=10)
        svc.close()


def test_watcher_waits_for_a_bad_shard_to_be_repaired(setup, tmp_path):
    params, x = setup
    ckdir = str(tmp_path / "ck")
    with CheckpointManager(ckdir, fsync=False) as mgr:
        mgr.save("model.iter1", _scaled(params, 3.0), {}, {},
                 meta={"iteration": 1}, blocking=True)
    good = b"per-host shard payload"
    entries = load_manifest(ckdir)
    entries[-1].shards = [{"path": "model.iter1.shard0", "size": len(good),
                           "sha256": sha256_bytes(good)}]
    write_manifest(ckdir, entries)
    (tmp_path / "ck" / "model.iter1.shard0").write_bytes(b"torn shard.....")
    svc = _service(params)
    watcher = watch_checkpoints(svc, ckdir, poll_interval=0.01)
    time.sleep(0.15)
    assert watcher.reloads == 0
    (tmp_path / "ck" / "model.iter1.shard0").write_bytes(good)
    assert _until(lambda: watcher.reloads == 1)
    np.testing.assert_array_equal(svc.predict(x[0], timeout=30),
                                  _expected(_scaled(params, 3.0), x))
    watcher.stop(timeout=10)
    svc.close()


def test_watcher_heals_a_transient_manifest_read(setup, tmp_path):
    params, x = setup
    ckdir = str(tmp_path / "ck")
    with CheckpointManager(ckdir, fsync=False) as mgr:
        mgr.save("model.iter1", _scaled(params, 3.0), {}, {},
                 meta={"iteration": 1}, blocking=True)
    spec = faults.arm("ckpt.watch_manifest", times=2, exc=OSError)
    svc = _service(params)
    watcher = watch_checkpoints(
        svc, ckdir, poll_interval=0.02,
        poll_backoff=RetryPolicy(max_attempts=1, base_delay=0.02,
                                 max_delay=0.2))
    assert _until(lambda: watcher.reloads == 1)
    assert spec.fired == 2 and watcher.last_entry.step == 1
    assert watcher._error_polls == 0
    watcher.stop(timeout=10)
    svc.close()


def test_watcher_reloads_a_generation_engine(jax_lm, tmp_path):
    """The engine takes the checkpoint's params (its module state is
    empty); its next stream is ``static_generate``'s over the new
    weights."""
    jm, params = jax_lm
    params2, _ = seeded_trees(jm, seed=7)
    model = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                            jax.device_get(params))
    eng = GenerationEngine(model, max_slots=2, max_len=32, max_prompt_len=8,
                           device="cpu")
    ckdir = str(tmp_path / "ck")
    with CheckpointManager(ckdir, fsync=False) as mgr:
        mgr.save("model.iter3", params2, {}, {}, meta={"iteration": 3},
                 blocking=True)
    watcher = watch_checkpoints(eng, ckdir, poll_interval=0.02)
    assert _until(lambda: watcher.reloads == 1)
    prompt = [5, 9, 2]
    got = eng.generate(prompt, max_new_tokens=4, timeout=60)
    fresh = load_jax_params(Transformer(64, 32, 4, 64, 2, device="cpu"),
                            params2)
    want, _ = static_generate(fresh, [(prompt, 4)], max_slots=2, max_len=32,
                              device="cpu")
    assert got == want[0]
    watcher.stop(timeout=10)
    eng.close()
