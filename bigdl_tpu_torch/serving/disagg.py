"""The device half of moving KV pages between pools and tiers
(``bigdl_tpu/serving/disagg.py``, ``PageBlockMover``).

The prefill/decode disaggregation that module also holds (the
``DisaggregatedEngine`` front door, ``PrefillWorker``, the engine's
``role=`` and its handoff) is not ported yet; the host tier's offload,
restore and swap-out run through this mover.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PageBlockMover"]

# a paged cache, or a block gathered from one: {layer: (K, V) or
# (K, V, K_scale, V_scale)}, every leaf indexed by page on axis 0
Block = Dict[str, Tuple[torch.Tensor, ...]]


def _index(idx, device: torch.device) -> torch.Tensor:
    """The page ids as an index on ``device``. On a card they go up from
    pinned memory without blocking: a copy from pageable memory would make
    the host wait for every kernel queued before it."""
    at = torch.as_tensor(np.asarray(idx, np.int64).reshape(-1))
    if device.type == "cuda":
        at = at.pin_memory().to(device, non_blocking=True)
    return at


class PageBlockMover:
    """The gather / scatter pair over a paged cache.

    ``gather(cache, idx)`` is a pure read: row ``i`` of every leaf of the
    block is ``leaf[idx[i]]`` (one ``index_select`` per leaf over the page
    axis; float pools have two leaves a layer, int8 pools four, the fp32
    scale rows included). Rows padded with the trash page gather trash.
    ``scatter(cache, block, idx)`` writes the block's rows back in place
    (``index_copy_``): the pools are never reallocated. Both run on the
    caller's current stream, in order with the engine's own kernels, so a
    gather finishes reading a page before its next owner writes it.
    ``gathers`` / ``scatters`` count the calls."""

    def __init__(self):
        self.gathers = 0
        self.scatters = 0

    def gather(self, cache: Block, idx: Sequence[int]) -> Block:
        self.gathers += 1
        device = next(iter(cache.values()))[0].device
        at = _index(idx, device)
        return {name: tuple(torch.index_select(leaf, 0, at)
                            for leaf in leaves)
                for name, leaves in cache.items()}

    def scatter(self, cache: Block, block: Block,
                idx: Sequence[int]) -> Block:
        self.scatters += 1
        device = next(iter(cache.values()))[0].device
        at = _index(idx, device)
        for name, leaves in cache.items():
            for leaf, rows in zip(leaves, block[name]):
                leaf.index_copy_(0, at, rows)
        return cache
