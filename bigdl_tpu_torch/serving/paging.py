"""Host-side page accounting for the paged KV cache
(``bigdl_tpu/serving/paging.py``).

The device side holds per-layer K/V pools of shape
``(num_pages + 1, heads, page_size, head_dim)`` and int32 page ids
(``Transformer.init_paged_cache``); all allocation policy lives here, on
the host, between decode steps:

- **full reservation at admission** — a request reserves pages for
  ``prompt_len + max_new_tokens - 1`` rows up front, so it can never run
  out mid-flight; early retirement returns the unused tail.
- **smallest-id-first** — frees push onto a heap and allocations pop the
  smallest ids, so the allocation sequence is a pure function of the
  admission/retirement sequence.
- **one trash page** — physical page ``num_pages`` exists in the pools but
  never in the free list: padding writes and idle slots' map rows point
  there, so garbage never lands in a page another sequence owns.
- **no double release** — releasing a page that is not reserved raises.
- **owner tags** — an allocation may name its owner (a speculative
  engine's ``"target"`` and ``"draft"`` lanes sit side by side in one
  pool); release looks the tag up by page id, and ``in_use_by(owner)`` is
  the per-lane drain gauge. Reference-counted sharing, export and adoption
  (prefix cache, disaggregation) come with later slices of the port.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import torch


def page_bytes(page_size: int, num_heads: int, head_dim: int,
               cache_dtype: torch.dtype = torch.float32) -> int:
    """Bytes ONE physical KV page costs per layer: its K and V pages plus,
    for int8, the per-token fp32 scale-pool rows beside them
    (``Transformer.init_paged_cache``)."""
    if cache_dtype == torch.int8:
        per_row = num_heads * head_dim + 4           # int8 row + f32 scale
    else:
        itemsize = torch.empty((), dtype=cache_dtype).element_size()
        per_row = num_heads * head_dim * itemsize
    return 2 * page_size * per_row                   # K and V


def pages_per_lane(max_len: int, page_size: int) -> int:
    """Logical pages covering one full-length lane (ceil division)."""
    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    return -(-int(max_len) // int(page_size))


class PagePool:
    """Free-list allocator over ``num_pages`` usable KV pages."""

    def __init__(self, num_pages: int, page_size: int, max_len: int):
        if num_pages < 1:
            raise ValueError("num_pages must be >= 1")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.pages_per_slot = pages_per_lane(max_len, self.page_size)
        self.trash = self.num_pages
        self._free: List[int] = list(range(self.num_pages))
        heapq.heapify(self._free)
        self.in_use = 0
        # owner tag per reserved page id ("" for an untagged alloc)
        self._owner: Dict[int, str] = {}
        self._owner_counts: Dict[str, int] = {}

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV rows (>= 1)."""
        return max(1, -(-int(n_tokens) // self.page_size))

    def can_reserve(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int, owner: Optional[str] = None) -> List[int]:
        """Reserve ``n`` pages, smallest ids first, optionally tagged with
        an ``owner`` label. Raises if the pool cannot satisfy it — callers
        gate on :meth:`can_reserve`, so this firing is an accounting bug."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"of {self.num_pages}")
        pages = [heapq.heappop(self._free) for _ in range(n)]
        self.in_use += n
        tag = owner or ""
        for p in pages:
            self._owner[p] = tag
        self._owner_counts[tag] = self._owner_counts.get(tag, 0) + n
        return pages

    def release(self, pages: Sequence[int]) -> None:
        """Return reserved pages to the free heap (and their owner's
        gauge)."""
        for p in pages:
            p = int(p)
            tag = self._owner.pop(p, None)
            if tag is None:
                raise RuntimeError(
                    f"page {p} released while not reserved (double "
                    f"release, or a page id that never came from alloc)")
            self._owner_counts[tag] -= 1
            heapq.heappush(self._free, p)
            self.in_use -= 1

    def in_use_by(self, owner: str) -> int:
        """Reserved pages tagged ``owner`` (0 for an unknown owner)."""
        return self._owner_counts.get(owner, 0) if owner else 0

    @property
    def free_pages(self) -> int:
        return len(self._free)
