"""Containers (``bigdl_tpu/nn/containers.py``): ``Sequential`` and
``ConcatTable``.

Children are registered under the JAX package's names —
``name or child.get_name() or str(len(children))``, with ``_{len}``
appended on a clash (``Container.add``) — so a parameter's dotted name is
its path in the JAX ``params`` tree.
"""

from __future__ import annotations

from typing import Optional

from torch import nn


def named(module: nn.Module, name: str) -> nn.Module:
    """Give ``module`` the name a container registers it under (the JAX
    package's ``set_name``); returns ``module``."""
    module.bigdl_name = name
    return module


class Container(nn.Module):
    def __init__(self, *modules: nn.Module):
        super().__init__()
        for m in modules:
            self.add(m)

    def add(self, module: nn.Module, name: Optional[str] = None) -> "Container":
        name = name or getattr(module, "bigdl_name", None) \
            or str(len(self._modules))
        if name in self._modules:
            name = f"{name}_{len(self._modules)}"
        self.add_module(name, module)
        return self

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, i: int) -> nn.Module:
        return list(self._modules.values())[i]


class Sequential(Container):
    """Feed the children in registration order."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class ConcatTable(Container):
    """Apply every child to the same input; a tuple of their outputs."""

    def forward(self, x):
        return tuple(m(x) for m in self._modules.values())
