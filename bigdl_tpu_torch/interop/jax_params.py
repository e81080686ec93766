"""Carry a JAX ``params``/``state`` tree into a port module by module
path, and the port's tensors back out as nested numpy trees.

The JAX package keys parameters and module state by module path
(``params["decoder_0"]["self_attention"]["inner"]["q_layer"]["weight"]``,
``state["layer1_0"]["0"]["0"]["1"]["running_mean"]``); the port's modules
carry the same child names, so each leaf lands on the parameter — or,
for state, the registered buffer — whose dotted name is that path.
Leaves arrive as numpy arrays (the caller runs ``jax.device_get`` on the
tree; this module never imports JAX). Every leaf must find its tensor
and every tensor its leaf, with equal shapes — anything else raises
before any copy happens. Layouts are copied as stored: an HWIO-stored
convolution weight stays HWIO, and the space-to-depth stem's weight keeps
the 7x7 stem's ``(64, 3, 7, 7)``, so every ResNet layout and stem of
``models/resnet.py`` takes the JAX package's parameters as they are
(the module paths do not depend on the layout). Integer leaves (the int8 weights of a
quantized serving tree) copy as they are, and only into integer tensors
of the same dtype; float leaves only into float tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.module import flatten_tree, unflatten_tree


def _match(kind: str, targets: Dict[str, torch.Tensor],
           tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    leaves = flatten_tree(tree)
    missing = sorted(set(targets) - set(leaves))
    extra = sorted(set(leaves) - set(targets))
    if missing or extra:
        raise ValueError(f"{kind} tree does not match the module: missing "
                         f"{missing}, extra {extra}")
    arrays = {}
    for name, leaf in leaves.items():
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)   # ml_dtypes bfloat16 -> float32
        target = targets[name]
        if target.is_floating_point():
            fits = arr.dtype.kind == "f"
        else:
            fits = arr.dtype == np.dtype(str(target.dtype).split(".")[-1])
        if not fits:
            raise ValueError(f"{name}: {kind} leaf has dtype {arr.dtype}, "
                             f"the module's {target.dtype}")
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{name}: {kind} leaf has shape {arr.shape}, "
                             f"the module's {tuple(target.shape)}")
        arrays[name] = arr
    return arrays


def load_jax_params(module: nn.Module, tree: Mapping[str, Any],
                    state: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Fill ``module``'s parameters from the nested-dict ``tree`` of numpy
    arrays and, given ``state``, its buffers from the JAX module state;
    returns ``module``. Raises ``ValueError`` on a missing leaf, an extra
    leaf or a shape mismatch, before copying anything."""
    params = dict(module.named_parameters())
    pairs = [(params, _match("params", params, tree))]
    if state is not None:
        buffers = dict(module.named_buffers())
        pairs.append((buffers, _match("state", buffers, state)))
    with torch.no_grad():
        for targets, arrays in pairs:
            for name, arr in arrays.items():
                t = targets[name]
                t.copy_(torch.tensor(arr, dtype=t.dtype))
    return module


def to_numpy_tree(tensors: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``{dotted name: tensor}`` -> nested dict of numpy arrays (fp32 for
    floating tensors), the JAX package's tree layout."""
    return unflatten_tree({
        name: t.detach().float().cpu().numpy() if t.is_floating_point()
        else t.detach().cpu().numpy()
        for name, t in tensors.items()})


def export_params(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters as a JAX-layout ``params`` tree."""
    return to_numpy_tree(dict(module.named_parameters()))


def export_state(module: nn.Module) -> Dict[str, Any]:
    """The module's buffers (BN running statistics) as a JAX-layout
    ``state`` tree."""
    return to_numpy_tree(dict(module.named_buffers()))


def export_optim_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """An optim method's state (``step`` and per-parameter buffers such as
    SGD's ``velocity``) in the JAX package's layout: ``step`` an int32
    0-d array, each buffer a params-shaped tree."""
    return {key: np.asarray(value, np.int32) if key == "step"
            else to_numpy_tree(value) if isinstance(value, Mapping)
            else np.asarray(value) for key, value in state.items()}


def load_optim_state(state: Dict[str, Any],
                     tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`export_optim_state`: copy a JAX-layout optim
    state (``step`` and params-shaped buffer trees, numpy leaves) into
    ``state``, an optim method's state of the port, in place: each buffer
    tensor keeps its identity, so whoever holds it sees the new values.
    Returns ``state``. Raises ``ValueError`` on a missing or extra buffer
    or leaf, or a shape or dtype mismatch, before copying anything."""
    buffers = {k for k, v in state.items() if isinstance(v, Mapping)}
    given = {k for k, v in tree.items() if isinstance(v, Mapping)}
    if buffers != given or "step" not in tree:
        raise ValueError(f"optim state does not match the method's: "
                         f"buffers {sorted(given)} and step "
                         f"{'step' in tree}, the method's "
                         f"{sorted(buffers)}")
    pairs = [(state[k], _match(f"optim {k}", state[k], tree[k]))
             for k in sorted(buffers)]
    with torch.no_grad():
        for targets, arrays in pairs:
            for name, arr in arrays.items():
                t = targets[name]
                t.copy_(torch.tensor(arr, dtype=t.dtype))
    state["step"] = int(np.asarray(tree["step"]))
    return state
