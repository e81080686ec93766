"""Device choice for the port's entry points.

The JAX package lets XLA pick its default backend
(``bigdl_tpu/core/engine.py``). The port runs on an NVIDIA card: an entry
point given ``device=None`` means ``"cuda"``, and with no card that is an
error, never a silent fall back to the CPU. Callers that want the CPU —
the tests, a CPU reference run — say so with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is taken
    as given, except a ``cuda`` device on a machine without one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: bigdl_tpu_torch runs on an NVIDIA "
            "card by default; pass device='cpu' to run the plain PyTorch "
            "path on the CPU")
    return dev


def module_device(module, device: DeviceLike = None) -> torch.device:
    """The device ``module``'s parameters live on, checked against the
    entry point's ``device`` (default ``cuda``): a mismatch raises rather
    than moving the weights behind the caller's back."""
    dev = resolve_device(device)
    have = next(module.parameters()).device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"model parameters live on {have}, the entry "
                         f"point runs on {dev}: build the model with "
                         f"device={str(dev)!r} or move it with .to()")
    return have
