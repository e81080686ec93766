"""Parameter paths shared with the JAX package.

The JAX package keys its ``params`` tree by module path: a module's
parameters sit under the names of its ancestors
(``Context.child`` in ``bigdl_tpu/nn/module.py``), e.g.
``params["decoder_0"]["self_attention"]["inner"]["q_layer"]["weight"]``.
The port's layers are ``torch.nn.Module``s whose child attributes carry the
same names, so a parameter's dotted ``named_parameters()`` name is the JAX
path joined with dots. These helpers are that join.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

SEP = "."


def join_path(*names: str) -> str:
    return SEP.join(n for n in names if n)


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict of leaves -> ``{dotted path: leaf}``."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = join_path(prefix, str(key))
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{dotted path: leaf}`` -> nested dict; inverse of
    :func:`flatten_tree`."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split(SEP)
        for name in parents:
            node = node.setdefault(name, {})
        node[last] = leaf
    return tree


class Criterion:
    """Loss function base (``bigdl_tpu/nn/module.py::Criterion``):
    ``loss = criterion.forward(output, target)``, a scalar tensor that
    autograd differentiates."""

    def forward(self, output, target):
        raise NotImplementedError

    def __call__(self, output, target):
        return self.forward(output, target)
