"""The port's checkpoint bytes (``utils/msgpack_codec.py``,
``utils/checkpoint.py``) against flax's, through the JAX package's
``serialize_payload`` / ``deserialize_payload``: each package reads the
other's bytes, leaves bitwise equal, the chunked form of a large leaf
included (``MAX_CHUNK_SIZE`` lowered in both codecs for the test only).
"""

import flax.serialization
import numpy as np
import pytest
import torch

from bigdl_tpu.utils import checkpoint as jckpt
from bigdl_tpu_torch.utils import checkpoint as tckpt
from bigdl_tpu_torch.utils import msgpack_codec


def _trees():
    rs = np.random.RandomState(0)
    params = {"0": {"weight": rs.randn(3, 4).astype(np.float32),
                    "bias": rs.randn(3).astype(np.float32)},
              "codes": {"q": rs.randint(-128, 128, (5, 2)).astype(np.int8),
                        "mask": rs.rand(6) > 0.5},
              "empty": {}}
    state = {"bn": {"running_mean": rs.randn(3).astype(np.float32)}}
    optim = {"__all__": {"step": np.asarray(7, np.int32),
                         "velocity": {"0": {"weight": rs.randn(3, 4).astype(
                             np.float32)}}}}
    return params, state, optim


def _assert_bitwise(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_bitwise(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


def test_port_codec_round_trips_every_leaf_kind():
    params, state, optim = _trees()
    extra = {"n": None, "t": True, "f": False, "i": [-1, -200, 70000,
                                                    2 ** 40], "x": 3.5,
             "s": "é" * 40, "b": b"q" * 300, "big": {str(i): i
                                                    for i in range(20)}}
    tree = {"params": params, "module_state": state, "optim_state": optim,
            **extra}
    back = msgpack_codec.unpackb(msgpack_codec.packb(tree))
    _assert_bitwise({k: back[k] for k in ("params", "module_state",
                                          "optim_state")},
                    {"params": params, "module_state": state,
                     "optim_state": optim})
    assert back["optim_state"]["__all__"]["step"].shape == ()
    assert {k: back[k] for k in extra} == extra
    assert back["params"]["empty"] == {}


def test_torch_leaves_serialize_as_their_numpy_arrays():
    params, state, optim = _trees()
    as_torch = {k: torch.from_numpy(v) for k, v in params["0"].items()}
    blob = tckpt.serialize_payload({"0": as_torch}, state, optim)
    want = jckpt.serialize_payload({"0": params["0"]}, state, optim)
    assert blob == want
    bf16 = torch.randn(4, dtype=torch.bfloat16)
    back = tckpt.deserialize_payload(tckpt.serialize_payload({"w": bf16}))
    assert back["params"]["w"].dtype == np.float32
    assert torch.equal(torch.from_numpy(back["params"]["w"].copy()),
                       bf16.float())


@pytest.mark.parametrize("template", [False, True])
def test_bytes_cross_between_the_packages(template):
    params, state, optim = _trees()
    tmpl = {"params": params, "module_state": state,
            "optim_state": optim} if template else None
    port_blob = tckpt.serialize_payload(params, state, optim)
    jax_blob = jckpt.serialize_payload(params, state, optim)
    assert port_blob == jax_blob          # the same bytes, in fact
    for got in (jckpt.deserialize_payload(port_blob, tmpl),
                tckpt.deserialize_payload(jax_blob, tmpl)):
        _assert_bitwise(got, {"params": params, "module_state": state,
                              "optim_state": optim})
    with pytest.raises(ValueError, match="lacks keys"):
        tckpt.deserialize_payload(jax_blob, {"params": {"other": 0}})


def test_chunked_leaves_read_both_ways(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(3)
    params = {"w": rs.randn(10, 7).astype(np.float32),
              "small": np.arange(3, dtype=np.int32)}
    port_blob = tckpt.serialize_payload(params)
    jax_blob = jckpt.serialize_payload(params)
    assert b"__msgpack_chunked_array__" in port_blob
    assert port_blob == jax_blob
    for got in (jckpt.deserialize_payload(port_blob)["params"],
                tckpt.deserialize_payload(jax_blob)["params"]):
        _assert_bitwise(got, params)


def test_legacy_trio_reads_the_jax_writers_files(tmp_path):
    params, state, optim = _trees()
    jckpt.save_checkpoint(str(tmp_path), "model.iter3", params, state, optim,
                          {"iteration": 3})
    tckpt.save_checkpoint(str(tmp_path), "model.iter5", params, state, optim,
                          {"iteration": 5})
    (tmp_path / "model.iter9.ckpt").write_bytes(b"no sidecar: torn")
    latest = tckpt.latest_checkpoint(str(tmp_path))
    assert latest == jckpt.latest_checkpoint(str(tmp_path))
    assert latest.endswith("model.iter5.ckpt")
    for load in (jckpt.load_checkpoint, tckpt.load_checkpoint):
        payload, meta = load(str(tmp_path / "model.iter3.ckpt"))
        _assert_bitwise(payload["params"], params)
        assert meta["iteration"] == 3
