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
  the per-lane drain gauge.
- **reference counts** — ``alloc`` starts a page at one reference,
  :meth:`PagePool.share` adds one (the prefix cache publishing a page, a
  request attaching a cached one), ``release`` drops one and frees the
  page only at zero. ``in_use`` and the per-owner gauges count distinct
  pages: a shared page stays charged once, to its first owner.
- **handoff accounting** — every ``alloc`` bumps the page's write
  ``generation``, so ``(source, page id, generation)`` names a page's
  content. :meth:`PagePool.export_pages` drops the exporting request's
  references; :meth:`PagePool.adopt_pages` allocates a local page per
  source page, or shares the live local page a repeat of the same
  identity already adopted. The import index unwinds when the local
  page's last reference goes.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

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
        # owner tag per reserved page id (tagged allocs only)
        self._page_owner: Dict[int, str] = {}
        self._owner_counts: Dict[str, int] = {}
        # references per reserved page (absent = free)
        self._refs: Dict[int, int] = {}
        # write generation per page id, bumped on every alloc
        self._generation: Dict[int, int] = {}
        # (source, source page, source generation) -> local page, and back
        self._imports: Dict[Tuple[str, int, int], int] = {}
        self._import_by_dst: Dict[int, Tuple[str, int, int]] = {}
        self.pages_exported = 0      # pages handed to another pool
        self.pages_adopted = 0       # fresh local pages from adoption
        self.pages_adopt_shared = 0  # adoptions served by a live import

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV rows (>= 1)."""
        return max(1, -(-int(n_tokens) // self.page_size))

    def can_reserve(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int, owner: Optional[str] = None) -> List[int]:
        """Reserve ``n`` pages, smallest ids first, each at one reference,
        optionally tagged with an ``owner`` label. Raises if the pool
        cannot satisfy it — callers gate on :meth:`can_reserve`, so this
        firing is an accounting bug."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"of {self.num_pages}")
        pages = [heapq.heappop(self._free) for _ in range(n)]
        self.in_use += n
        for p in pages:
            self._refs[p] = 1
            self._generation[p] = self._generation.get(p, 0) + 1
        if owner is not None:
            for p in pages:
                self._page_owner[p] = owner
            self._owner_counts[owner] = self._owner_counts.get(owner, 0) + n
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one reference to each reserved page. The page keeps its
        owner tag and stays charged once. Raises on a free page."""
        for p in pages:
            p = int(p)
            refs = self._refs.get(p, 0)
            if refs < 1:
                raise RuntimeError(
                    f"page {p} is not reserved; share() can only add "
                    f"references to live pages")
            self._refs[p] = refs + 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the free heap
        (and leaves its owner's gauge) only when its last reference
        goes."""
        for p in pages:
            p = int(p)
            refs = self._refs.get(p)
            if refs is None:
                raise RuntimeError(
                    f"page {p} released while not reserved (double "
                    f"release, or a page id that never came from alloc)")
            if refs > 1:
                self._refs[p] = refs - 1
                continue
            del self._refs[p]
            heapq.heappush(self._free, p)
            self.in_use -= 1
            owner = self._page_owner.pop(p, None)
            if owner is not None:
                self._owner_counts[owner] -= 1
            key = self._import_by_dst.pop(p, None)
            if key is not None:
                del self._imports[key]

    def generation(self, page: int) -> int:
        """Write generation of ``page`` (0 = never allocated)."""
        return self._generation.get(int(page), 0)

    def export_pages(self, pages: Sequence[int]) -> None:
        """Hand ``pages`` to another pool (or to the host tier): drop the
        exporting request's references, as :meth:`release` does, and
        count them."""
        self.pages_exported += len(pages)
        self.release(pages)

    def adopt_pages(self, meta: Sequence[Tuple[int, int, int]], *,
                    source: str, owner: Optional[str] = None) -> List[int]:
        """The local page for each ``(source page id, source write
        generation, shareable)`` row, in order. A shareable row whose
        identity is live in the import index shares that local page;
        every other row allocates a fresh one for the caller to scatter
        its rows into. Callers gate on :meth:`can_reserve` for the full
        count."""
        out: List[int] = []
        for src_page, src_gen, shareable in meta:
            key = (str(source), int(src_page), int(src_gen))
            dst = self._imports.get(key) if shareable else None
            if dst is not None:
                self.share([dst])
                self.pages_adopt_shared += 1
            else:
                dst = self.alloc(1, owner=owner)[0]
                self.pages_adopted += 1
                if shareable:
                    self._imports[key] = dst
                    self._import_by_dst[dst] = key
            out.append(dst)
        return out

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 = free)."""
        return self._refs.get(int(page), 0)

    def in_use_by(self, owner: str) -> int:
        """Reserved pages tagged ``owner`` (0 for an unknown owner)."""
        return self._owner_counts.get(owner, 0)

    def snapshot(self) -> dict:
        """Occupancy, per-owner and handoff gauges (the JAX pool's keys,
        in its order)."""
        return {
            "pages_total": self.num_pages,
            "pages_in_use": self.in_use,
            "pages_free": len(self._free),
            "page_size": self.page_size,
            "pages_per_slot": self.pages_per_slot,
            "by_owner": {k: v for k, v in sorted(self._owner_counts.items())
                         if v},
            "pages_shared": sum(1 for r in self._refs.values() if r >= 2),
            "pages_exported": self.pages_exported,
            "pages_adopted": self.pages_adopted,
            "pages_adopt_shared": self.pages_adopt_shared,
            "tier": "hbm",
        }

    @property
    def free_pages(self) -> int:
        return len(self._free)
