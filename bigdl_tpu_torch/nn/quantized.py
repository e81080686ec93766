"""Post-training int8 transform of a serving ``Transformer``
(``quantize_for_serving`` / ``count_quantized_gemms`` of
``bigdl_tpu/nn/quantized.py``), in module form.

The JAX transform rewrites a params tree; here it rewrites a copy of the
module, and the copy's parameter names are that tree's paths, so
``load_jax_params`` fills a quantized port model from
``jax.device_get(quantize_for_serving(params))``:

- every 2-D GEMM ``Linear`` (q/k/v/output projections, FFN up/down)
  drops ``weight`` and holds ``weight_q`` (int8, (out, in)) and ``scale``
  (fp32, (out,)), plus its ``bias`` in fp32 if it has one;
- the ``Transformer`` root keeps its float ``embedding`` for the lookups
  and, when the embedding is also the lm head, gains ``embedding_q`` +
  ``lm_scale``, the int8 head (an untied model's head is its ``project``
  Linear, quantized as the others).

``Linear.forward`` and ``Transformer._logits`` see the quantized
parameters and run :func:`~bigdl_tpu_torch.nn.int8.int8_linear`. The
quantized tensors are parameters with ``requires_grad=False`` (an int8
tensor has no gradient), so the weight bridge and ``named_parameters``
see them as leaves of the tree.
"""

from __future__ import annotations

import copy

from torch import nn

from bigdl_tpu_torch.nn import int8 as _int8
from bigdl_tpu_torch.nn.layers.linear import Linear

_QUANTIZED_LEAVES = ("weight_q", "embedding_q")


def _frozen(t) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def quantize_for_serving(model: nn.Module) -> nn.Module:
    """A quantized copy of ``model`` (the caller's model is untouched):
    every ``Linear`` with a 2-D weight becomes an int8 GEMM, and a root
    with a float ``embedding`` (the shared-embedding lm head) gains its
    int8 twin."""
    model = copy.deepcopy(model)
    for module in model.modules():
        if isinstance(module, Linear) and "weight" in module._parameters \
                and module.weight.dim() == 2:
            wq, scale = _int8.quantize_weight(module.weight.detach())
            del module.weight
            module.weight_q = _frozen(wq)
            module.scale = _frozen(scale)
            if module.bias is not None:
                module.bias = nn.Parameter(module.bias.detach().float())
    emb = model._parameters.get("embedding")
    # the shared-embedding head only: an untied model's head is its
    # ``project`` Linear, quantized above
    if emb is not None and emb.dim() == 2 and "project" not in model._modules:
        eq, es = _int8.quantize_weight(emb.detach())
        model.embedding_q = _frozen(eq)
        model.lm_scale = _frozen(es)
    return model


def count_quantized_gemms(model: nn.Module) -> int:
    """Number of int8 GEMMs in a :func:`quantize_for_serving` model: the
    ``ServingMetrics.quantized_gemms`` gauge (6 per layer plus the head)."""
    return sum(name.rsplit(".", 1)[-1] in _QUANTIZED_LEAVES
               for name, _ in model.named_parameters())
