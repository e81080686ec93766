"""Module paths shared with the JAX package, and the keyed context of a
training forward.

The JAX package keys its ``params`` tree by module path: a module's
parameters sit under the names of its ancestors
(``Context.child`` in ``bigdl_tpu/nn/module.py``), e.g.
``params["decoder_0"]["self_attention"]["inner"]["q_layer"]["weight"]``.
The port's layers are ``torch.nn.Module``s whose child attributes carry the
same names, so a parameter's dotted ``named_parameters()`` name is the JAX
path joined with dots. ``join_path``, ``flatten_tree`` and
``unflatten_tree`` are that join.

The same paths key the JAX package's random draws: ``Context.rng`` gives
the module at path ``p`` the key ``fold_in(fold_in_str(root, "/".join(p)),
n)``, where ``n`` counts the draws of the whole ``apply`` so far, in the
order the forward makes them. :class:`RngContext` is that counter for a
port forward.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

from torch import nn

from bigdl_tpu_torch.core.threefry import Key, fold_in, fold_in_str

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


class RngContext:
    """The keys of one forward (``Context.rng`` of the JAX package): the
    root key, each module's JAX path under ``root`` (its dotted
    ``named_modules`` name with ``/`` for ``.``) and the count of draws
    made so far. A module that draws asks :meth:`next_key` with itself;
    the forward that holds the root module makes the context."""

    def __init__(self, key: Key, root: nn.Module):
        self.key = key
        self.draws = 0
        self._paths = {id(m): name.replace(SEP, "/")
                       for name, m in root.named_modules()}

    @classmethod
    def of(cls, rng: Union[Key, "RngContext", None],
           module: nn.Module) -> Optional["RngContext"]:
        """``rng`` itself if it is a context already (``module`` runs inside
        a keyed forward), a new context rooted at ``module`` for a bare
        key, None for None."""
        if rng is None or isinstance(rng, RngContext):
            return rng
        if not isinstance(rng, Key):
            raise TypeError(f"rng must be a threefry Key, got "
                            f"{type(rng).__name__}")
        return cls(rng, module)

    def next_key(self, module: nn.Module) -> Key:
        """The key of ``module``'s next draw."""
        self.draws += 1
        path = fold_in_str(self.key, self._paths[id(module)])
        return fold_in(path, self.draws)


def draw_key(rng: Optional[RngContext], module: nn.Module) -> Key:
    """The key of a draw that ``module`` must make: raises, as the JAX
    package does, when the forward was given no key."""
    if rng is None:
        raise ValueError(f"{type(module).__name__} draws a random mask in "
                         f"training mode: pass rng=... (a threefry key) to "
                         f"the model's forward")
    return rng.next_key(module)
