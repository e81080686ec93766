"""Token selection (``bigdl_tpu/ops/sampling.py``), greedy rows only.

The JAX package samples inside the decode step from per-slot threefry
keys (``sample_tokens``, temperature / top-k / top-p). This slice of the
port decodes greedily: fp32 argmax, first maximal index on ties, as
``jnp.argmax``. Sampling comes with a later slice of the port; until then
a temperature above 0 raises rather than quietly decoding greedily.
"""

from __future__ import annotations

import torch

SAMPLING_NOT_PORTED = (
    "temperature > 0 (sampling) is not ported yet: it comes with the "
    "port's sampling slice (threefry-keyed per-slot streams); this slice "
    "decodes greedily (temperature=0)")


def check_greedy(temperature: float) -> None:
    if temperature < 0.0:
        raise ValueError("temperature must be >= 0")
    if temperature > 0.0:
        raise NotImplementedError(SAMPLING_NOT_PORTED)


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...,) int32 argmax over the fp32 logits."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
