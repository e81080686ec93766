"""The port's ``CheckpointManager`` through the cases of
``tests/test_ckpt.py``: whatever point a save dies at, ``restore_latest``
returns the newest fully committed checkpoint; retention, in-flight
guards, backpressure, preemption, transient-IO healing and shard
verification behave as the JAX package's. The manifest and blobs each
package writes, the other reads (leaves bitwise)."""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from bigdl_tpu.ckpt import CheckpointManager as JaxCheckpointManager
from bigdl_tpu.ckpt import load_manifest as jax_load_manifest
from bigdl_tpu_torch import faults
from bigdl_tpu_torch.ckpt import (
    CheckpointInFlightError,
    CheckpointManager,
    load_manifest,
)
from bigdl_tpu_torch.ckpt.manifest import sha256_bytes, write_manifest
from bigdl_tpu_torch.faults import RetryPolicy
from bigdl_tpu_torch.utils.checkpoint import save_checkpoint


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {"dense": {"weight": rs.randn(8, 4).astype(np.float32),
                      "bias": rs.randn(8).astype(np.float32)},
            "head": {"weight": rs.randn(2, 8).astype(np.float32)}}


def _save_steps(mgr, steps, seed_base=0):
    for s in steps:
        mgr.save(f"model.iter{s}", _params(seed_base + s),
                 meta={"iteration": s, "epoch": 1})
    mgr.wait()


def test_async_and_blocking_saves_are_bit_identical(tmp_path):
    p = _params(3)
    tp = {k: {n: torch.from_numpy(a) for n, a in v.items()}
          for k, v in p.items()}
    with CheckpointManager(str(tmp_path / "a"), async_save=True) as ma, \
            CheckpointManager(str(tmp_path / "b"), async_save=False) as mb:
        ha = ma.save("model.iter7", tp, optim_state={
            "m": torch.from_numpy(p["head"]["weight"])}, meta={"iteration": 7})
        mb.save("model.iter7", p, optim_state={"m": p["head"]["weight"]},
                meta={"iteration": 7})
        ea, eb = ha.result(timeout=30), mb.entries()[-1]
        # the snapshot was taken at save(): a later in-place change to a
        # CPU tensor does not reach the blob
        tp["dense"]["weight"].add_(1.0)
    assert ea.sha256 == eb.sha256 and ea.size == eb.size
    payload, entry = CheckpointManager(str(tmp_path / "a")).restore_latest()
    assert entry.step == 7
    np.testing.assert_array_equal(payload["params"]["dense"]["weight"],
                                  _params(3)["dense"]["weight"])


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_restore_falls_back_past_a_damaged_newest_blob(tmp_path, damage):
    mgr = CheckpointManager(str(tmp_path))
    _save_steps(mgr, [2, 4])
    path = tmp_path / "model.iter4.ckpt"
    blob = bytearray(path.read_bytes())
    if damage == "truncate":
        blob = blob[:8]
    else:
        blob[len(blob) // 3] ^= 0xFF
    path.write_bytes(bytes(blob))
    payload, entry = mgr.restore_latest()
    assert entry.step == 2 and mgr.restore_fallbacks == 1
    np.testing.assert_array_equal(payload["params"]["head"]["weight"],
                                  _params(2)["head"]["weight"])
    mgr.close()


def test_tmp_survivor_is_ignored_and_collected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    _save_steps(mgr, [2])
    (tmp_path / "model.iter4.ckpt.tmp").write_bytes(b"abandoned")
    assert mgr.restore_latest()[1].step == 2
    _save_steps(mgr, [6])
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    mgr.close()


def test_restore_returns_none_when_nothing_is_committed(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest() is None
    _save_steps(mgr, [2])
    blob = bytearray((tmp_path / "model.iter2.ckpt").read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (tmp_path / "model.iter2.ckpt").write_bytes(bytes(blob))
    # every entry corrupt: no fall-through to the unverified scan
    assert mgr.restore_latest() is None
    mgr.close()


def test_legacy_directory_is_read_and_adopted(tmp_path):
    save_checkpoint(str(tmp_path), "model.iter3", _params(3),
                    meta={"iteration": 3})
    mgr = CheckpointManager(str(tmp_path))
    payload, entry = mgr.restore_latest()
    assert entry.step == 3 and entry.size == -1
    _save_steps(mgr, [5])
    assert [e.step for e in load_manifest(str(tmp_path))] == [3, 5]
    mgr.close()


def test_retention_keeps_last_n_plus_every_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2,
                            keep_every_k_steps=4)
    _save_steps(mgr, [1, 2, 3, 4, 5, 6, 7])
    assert [e.step for e in load_manifest(str(tmp_path))] == [4, 6, 7]
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith(".ckpt")) \
        == ["model.iter4.ckpt", "model.iter6.ckpt", "model.iter7.ckpt"]
    mgr.close()


def test_concurrent_save_of_one_tag_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    gate = threading.Event()
    with mgr._lock:
        mgr._ensure_pool().submit(gate.wait, 30)
    mgr.save("model.iter1", _params(), meta={"iteration": 1})
    with pytest.raises(CheckpointInFlightError):
        mgr.save("model.iter1", _params(), meta={"iteration": 1})
    gate.set()
    mgr.close()


def test_backpressure_bounds_pending_snapshots(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_pending=1)
    gate = threading.Event()
    with mgr._lock:
        mgr._ensure_pool().submit(gate.wait, 30)
    mgr.save("model.iter1", _params(), meta={"iteration": 1})
    threading.Timer(0.3, gate.set).start()
    mgr.save("model.iter2", _params(), meta={"iteration": 2})  # blocks
    assert gate.is_set()
    mgr.wait()
    assert [e.step for e in load_manifest(str(tmp_path))] == [1, 2]
    assert mgr._pool is None          # a drained manager holds no thread
    mgr.close()


def test_sigterm_hook_sets_the_flag_and_is_main_thread_only(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.install_preemption_hook()
    os.kill(os.getpid(), signal.SIGTERM)
    assert mgr.preemption_requested
    mgr.close()                       # uninstalls the handler
    other = CheckpointManager(str(tmp_path))
    result = []
    t = threading.Thread(target=lambda: result.append(
        other.install_preemption_hook()))
    t.start()
    t.join(10)
    assert result == [False] and not t.is_alive()
    other.close()


def test_mark_preempted_rewrites_only_the_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    _save_steps(mgr, [2])
    before = load_manifest(str(tmp_path))[-1]
    mtime = os.path.getmtime(tmp_path / before.file)
    mgr.mark_preempted("model.iter2")
    after = load_manifest(str(tmp_path))[-1]
    assert after.preempted and after.sha256 == before.sha256
    assert os.path.getmtime(tmp_path / after.file) == mtime
    mgr.close()


@pytest.mark.parametrize("site", ["ckpt.blob_write", "ckpt.manifest_write"])
def test_fail_once_heals_and_exhausted_retries_fail_loudly(tmp_path, site):
    spec = faults.arm(site, nth=1, exc=OSError)
    with CheckpointManager(str(tmp_path / "heal")) as mgr:
        mgr.save("model.iter3", _params(5),
                 meta={"iteration": 3}).result(timeout=30)
        payload, entry = mgr.restore_latest()
    assert spec.fired == 1 and entry.step == 3
    np.testing.assert_array_equal(payload["params"]["dense"]["weight"],
                                  _params(5)["dense"]["weight"])
    faults.disarm(site)

    mgr = CheckpointManager(
        str(tmp_path / "dead"),
        retry=RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0))
    _save_steps(mgr, [1])
    spec = faults.arm(site, exc=OSError("disk on fire"))
    h = mgr.save("model.iter2", _params(2), meta={"iteration": 2})
    with pytest.raises(OSError, match="disk on fire"):
        h.result(timeout=30)
    assert spec.fired == 3 and mgr.commit_failures == 1
    with pytest.raises(OSError):
        mgr.wait()
    faults.disarm(site)
    assert mgr.restore_latest()[1].step == 1
    mgr.close()


def test_permanent_error_is_not_retried(tmp_path):
    spec = faults.arm("ckpt.blob_write", exc=TypeError("not transient"))
    with CheckpointManager(str(tmp_path)) as mgr:
        h = mgr.save("model.iter1", _params(1), meta={"iteration": 1})
        with pytest.raises(TypeError):
            h.result(timeout=30)
    assert spec.fired == 1


def test_orphan_blob_is_collected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    _save_steps(mgr, [2])
    (tmp_path / "model.iter4.ckpt").write_bytes(b"orphan blob")
    (tmp_path / "model.iter4.meta.json").write_text("{}")
    _save_steps(mgr, [6])
    names = set(os.listdir(tmp_path))
    assert not {"model.iter4.ckpt", "model.iter4.meta.json"} & names
    assert {"model.iter2.ckpt", "model.iter6.ckpt"} <= names
    mgr.close()


@pytest.mark.parametrize("shard", ["corrupt", "missing"])
def test_restore_falls_back_past_a_bad_shard(tmp_path, shard):
    mgr = CheckpointManager(str(tmp_path))
    _save_steps(mgr, [2, 4])
    good = b"per-host shard"
    entries = load_manifest(str(tmp_path))
    entries[-1].shards = [{"path": "model.iter4.shard0", "size": len(good),
                           "sha256": sha256_bytes(good)}]
    write_manifest(str(tmp_path), entries)
    if shard == "corrupt":
        (tmp_path / "model.iter4.shard0").write_bytes(b"torn shard....")
    assert mgr.restore_latest()[1].step == 2
    (tmp_path / "model.iter4.shard0").write_bytes(good)
    assert mgr.restore_latest()[1].step == 4
    mgr.close()


def test_manifests_and_blobs_cross_between_the_packages(tmp_path):
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    with CheckpointManager(port, keep_last_n=2) as mgr:
        _save_steps(mgr, [2, 4, 6])
    with JaxCheckpointManager(jax_dir, fsync=False) as mgr:
        _save_steps(mgr, [3, 5])
    for directory, steps in ((port, [4, 6]), (jax_dir, [3, 5])):
        assert [e.step for e in jax_load_manifest(directory)] == steps
        assert [e.step for e in load_manifest(directory)] == steps
        assert [e.sha256 for e in jax_load_manifest(directory)] == \
            [e.sha256 for e in load_manifest(directory)]
    jp, je = JaxCheckpointManager(port).restore_latest()
    tp, te = CheckpointManager(jax_dir).restore_latest()
    assert je.step == 6 and te.step == 5
    for got, seed in ((jp, 6), (tp, 5)):
        for k, v in _params(seed).items():
            for n, a in v.items():
                assert np.asarray(got["params"][k][n]).tobytes() == \
                    a.tobytes()
    with CheckpointManager(jax_dir) as mgr:     # the port commits on top
        _save_steps(mgr, [7])
    assert [e.step for e in jax_load_manifest(jax_dir)] == [3, 5, 7]
