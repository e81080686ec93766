"""Copy a JAX ``params`` tree into a port module, by module path.

The JAX package keys parameters by module path
(``params["decoder_0"]["self_attention"]["inner"]["q_layer"]["weight"]``);
the port's modules carry the same child names, so each leaf lands on the
parameter whose dotted name is that path. Leaves arrive as numpy arrays
(the caller runs ``jax.device_get`` on the tree; this module never
imports JAX). Every leaf must find its parameter and every parameter its
leaf, with equal shapes — anything else raises before any copy happens.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.module import flatten_tree


def load_jax_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Fill ``module``'s parameters from the nested-dict ``tree`` of numpy
    arrays; returns ``module``. Raises ``ValueError`` on a missing leaf, an
    extra leaf or a shape mismatch."""
    leaves = flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise ValueError(f"params tree does not match the module: missing "
                         f"{missing}, extra {extra}")
    arrays = {}
    for name, leaf in leaves.items():
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)   # ml_dtypes bfloat16 -> float32
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: tree leaf has shape {arr.shape}, "
                             f"parameter {tuple(params[name].shape)}")
        arrays[name] = arr
    with torch.no_grad():
        for name, arr in arrays.items():
            p = params[name]
            p.copy_(torch.tensor(arr, dtype=p.dtype))
    return module
