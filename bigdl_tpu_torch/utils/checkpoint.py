"""The checkpoint format (``bigdl_tpu/utils/checkpoint.py``) and the
legacy single-file API.

A checkpoint is the ``{"params", "module_state", "optim_state"}`` triple
of nested dicts with numpy leaves, in the JAX package's layout (the
weight bridge's: module paths as keys), as flax msgpack bytes
(:mod:`bigdl_tpu_torch.utils.msgpack_codec`), plus a JSON sidecar of host
counters. Either package reads the other's bytes. Torch tensors are
fetched to the host here; a bfloat16 or float16 tensor is written as
float32 (numpy has no bfloat16).

``save_checkpoint`` / ``load_checkpoint`` / ``latest_checkpoint`` are the
legacy trio; the fault-tolerant tier above them is
:class:`bigdl_tpu_torch.ckpt.CheckpointManager`, which writes the same
blobs.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils import msgpack_codec


def host_array(x) -> np.ndarray:
    """One leaf as a numpy array (a torch tensor copied to the host, a
    low-precision float one widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def to_host_tree(tree) -> Any:
    """A nested dict with every leaf through :func:`host_array`, keys
    sorted (as the JAX package's tree maps sort them); empty dicts
    stay."""
    if isinstance(tree, Mapping):
        return {str(k): to_host_tree(tree[k])
                for k in sorted(tree, key=str)}
    return host_array(tree)


def serialize_parts(params: Any, module_state: Any = None,
                    optim_state: Any = None) -> list:
    """The checkpoint bytes of the (params, module_state, optim_state)
    triple as buffers to write in order (``msgpack_codec.pack_parts``:
    the arrays' data is not copied)."""
    return msgpack_codec.pack_parts({
        "params": to_host_tree(params),
        "module_state": to_host_tree(module_state or {}),
        "optim_state": to_host_tree(optim_state or {}),
    })


def serialize_payload(params: Any, module_state: Any = None,
                      optim_state: Any = None) -> bytes:
    """The (params, module_state, optim_state) triple as checkpoint
    bytes."""
    return b"".join(serialize_parts(params, module_state, optim_state))


def _restore_like(template, state, path="") -> Any:
    """``state`` in ``template``'s structure: every key of a template dict
    must be in the state's (extra state keys are dropped, as flax drops
    them); a leaf comes back as stored."""
    if not isinstance(template, Mapping):
        return state
    if not isinstance(state, Mapping):
        raise ValueError(f"checkpoint holds a leaf at '{path}', the "
                         "template a dict")
    missing = sorted(set(map(str, template)) - set(state))
    if missing:
        raise ValueError(f"checkpoint lacks keys {missing} at "
                         f"'{path or '/'}'")
    return {k: _restore_like(v, state[str(k)], f"{path}/{k}")
            for k, v in template.items()}


def deserialize_payload(blob: bytes,
                        template: Optional[Dict[str, Any]] = None):
    """Inverse of :func:`serialize_payload`: nested dicts of numpy
    arrays. With a ``template`` (trees of the expected structure) the
    payload comes back in its structure, and a key it lacks raises
    ``ValueError``."""
    payload = msgpack_codec.unpackb(blob)
    if not isinstance(payload, dict):
        raise ValueError("checkpoint bytes do not hold a dict")
    if template is None:
        return payload
    target = {"params": template.get("params"),
              "module_state": template.get("module_state") or {},
              "optim_state": template.get("optim_state") or {}}
    return _restore_like(target, payload)


def save_checkpoint(path: str, tag: str, params: Any,
                    module_state: Any = None, optim_state: Any = None,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<path>/<tag>.ckpt`` (and ``.meta.json``); returns the
    blob's path."""
    os.makedirs(path, exist_ok=True)
    blob = serialize_payload(params, module_state, optim_state)
    f = os.path.join(path, f"{tag}.ckpt")
    tmp = f + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, f)
    meta = dict(meta or {})
    meta.setdefault("wall_time", time.time())
    with open(os.path.join(path, f"{tag}.meta.json"), "w") as fh:
        json.dump(meta, fh)
    return f


def load_checkpoint(file: str, template: Optional[Dict[str, Any]] = None):
    """``(payload, meta)`` of one blob (``meta`` empty without a
    sidecar)."""
    with open(file, "rb") as fh:
        blob = fh.read()
    payload = deserialize_payload(blob, template)
    meta_path = file[: -len(".ckpt")] + ".meta.json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
    return payload, meta


def latest_checkpoint(path: str, prefix: str = "") -> Optional[str]:
    """The newest ``*.ckpt`` by the first number in its name, then mtime.
    Staging files (``*.tmp``) and blobs without a ``.meta.json`` sidecar
    (a torn legacy save) are skipped, and a file vanishing mid-scan is
    ignored."""
    if not os.path.isdir(path):
        return None
    try:
        names = os.listdir(path)
    except OSError:
        return None
    best: Tuple[int, float, Optional[str]] = (-1, -1.0, None)
    for name in names:
        if (name.endswith(".tmp") or not name.endswith(".ckpt")
                or not name.startswith(prefix)):
            continue
        full = os.path.join(path, name)
        if not os.path.exists(full[: -len(".ckpt")] + ".meta.json"):
            continue
        m = re.search(r"(\d+)", name)
        it = int(m.group(1)) if m else 0
        try:
            mtime = os.path.getmtime(full)
        except OSError:
            continue
        if (it, mtime) > (best[0], best[1]):
            best = (it, mtime, full)
    return best[2]
