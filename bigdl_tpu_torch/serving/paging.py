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
  Reference-counted sharing, export and adoption (prefix cache,
  disaggregation) come with later slices of the port.
"""

from __future__ import annotations

import heapq
from typing import List, Sequence, Set

import torch


def page_bytes(page_size: int, num_heads: int, head_dim: int,
               cache_dtype: torch.dtype = torch.float32) -> int:
    """Bytes ONE physical KV page costs per layer (its K and V pages)."""
    itemsize = torch.empty((), dtype=cache_dtype).element_size()
    return 2 * page_size * num_heads * head_dim * itemsize


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
        self._reserved: Set[int] = set()

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV rows (>= 1)."""
        return max(1, -(-int(n_tokens) // self.page_size))

    def can_reserve(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> List[int]:
        """Reserve ``n`` pages, smallest ids first. Raises if the pool cannot
        satisfy it — callers gate on :meth:`can_reserve`, so this firing is
        an accounting bug."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"of {self.num_pages}")
        pages = [heapq.heappop(self._free) for _ in range(n)]
        self.in_use += n
        self._reserved.update(pages)
        return pages

    def release(self, pages: Sequence[int]) -> None:
        """Return reserved pages to the free heap."""
        for p in pages:
            p = int(p)
            if p not in self._reserved:
                raise RuntimeError(
                    f"page {p} released while not reserved (double "
                    f"release, or a page id that never came from alloc)")
            self._reserved.remove(p)
            heapq.heappush(self._free, p)
            self.in_use -= 1

    @property
    def free_pages(self) -> int:
        return len(self._free)
