"""Content-addressed KV prefix sharing over the paged cache
(``bigdl_tpu/serving/prefix_cache.py``).

Shared system prompts, few-shot templates and multi-turn chat re-prefill
the same prompt prefix again and again. With the paged cache the prefix's
K/V rows already sit in physical pages when a sequence retires; this
module is the index that finds them again, a radix tree over page-sized
token chunks:

- **entries are full, immutable pages.** A prompt's K/V rows depend only
  on its token ids and their absolute positions (prompts start at 0), so
  a completely written prompt page is a pure function of ``(model
  version, the page-aligned token prefix ending at it)``. Only full
  prompt pages are published, and a lookup never matches the whole
  prompt (at least one tail token re-prefills for the first-token
  logits): every write of an attaching request lands past the attached
  prefix, in pages it allocated itself. Copy-on-write reduces to the
  alignment assertion the engine makes at attach time.
- **a radix tree of page-sized chunks.** One node per cached page, keyed
  under its parent by the page's token tuple; a hit is always a chain of
  ancestors.
- **references, not copies.** The cache holds one
  :meth:`~bigdl_tpu_torch.serving.paging.PagePool.share` reference per
  cached page; an attaching request adds its own. The pool frees a page
  only at zero references.
- **LRU leaf eviction under page pressure**, leaf-first in rounds: a
  round drains the current evictable frontier (unreferenced leaves) in
  LRU order, and the parents it exposes form the next round's frontier,
  so a shared shorter prefix outlives one branch's deep tail.

All mutation happens on the engine loop thread; ``snapshot()`` reads
plain ints.
"""

from __future__ import annotations

import heapq
from typing import Callable, FrozenSet, List, Optional, Sequence, Tuple


class _PrefixNode:
    """One cached page: ``chunk`` is its page_size-token key under
    ``parent``, ``page`` the physical page the cache holds a reference
    for, ``stamp`` the LRU clock of its last touch."""

    __slots__ = ("chunk", "parent", "page", "children", "stamp")

    def __init__(self, chunk, parent, page, stamp=0):
        self.chunk = chunk
        self.parent = parent
        self.page = page
        self.children = {}
        self.stamp = stamp


class PrefixCache:
    """Radix index over the full, immutable KV pages of one paged lane.

    One instance per (engine, lane): a speculative engine keeps one for
    its target pools and one for the draft's, whose pages hold other K/V
    for the same tokens. ``version`` is the model identity the pages
    were written under; :meth:`clear` bumps it.
    """

    def __init__(self, pool, *, name: str = "prefix"):
        self._pool = pool
        self.page_size = int(pool.page_size)
        self.name = name
        self.version = 0
        self._root = _PrefixNode(None, None, None)
        self._pages = 0          # nodes == cached pages (gauge)
        self._clock = 0          # LRU stamp source
        self.hits = 0            # admissions that attached >= 1 page
        self.misses = 0
        self.hit_tokens = 0      # prompt tokens served from the cache
        self.published_pages = 0
        self.evicted_pages = 0
        self.deduped_pages = 0   # duplicate physicals retired at publish

    # ------------------------------------------------------- queries ----

    @property
    def pages(self) -> int:
        """Pages the cache currently holds references for (gauge)."""
        return self._pages

    def lookup(self, prompt: Sequence[int]
               ) -> Tuple[int, List[int], List[_PrefixNode]]:
        """Longest cached page-aligned prefix of ``prompt`` that leaves at
        least one tail token to prefill. Returns ``(matched token count,
        page ids, nodes)`` and touches the matched chain's LRU stamps."""
        ps = self.page_size
        limit = (len(prompt) - 1) // ps    # full pages, tail preserved
        node = self._root
        pages: List[int] = []
        nodes: List[_PrefixNode] = []
        for i in range(limit):
            child = node.children.get(
                tuple(int(t) for t in prompt[i * ps:(i + 1) * ps]))
            if child is None:
                break
            node = child
            pages.append(node.page)
            nodes.append(node)
        if nodes:
            self._clock += 1
            for nd in nodes:
                nd.stamp = self._clock
        return len(pages) * ps, pages, nodes

    def match_pages(self, prompt: Sequence[int], limit: int) -> List[int]:
        """Cached page ids for the first ``limit`` full chunks of
        ``prompt`` (fewer where the walk stops). A pure reader: no LRU
        touch and no tail clamp (publish-time dedup wants every full
        prompt chunk)."""
        ps = self.page_size
        node = self._root
        pages: List[int] = []
        for i in range(limit):
            child = node.children.get(
                tuple(int(t) for t in prompt[i * ps:(i + 1) * ps]))
            if child is None:
                break
            node = child
            pages.append(node.page)
        return pages

    def record_probe(self, hit: bool, n_tokens: int = 0) -> None:
        """Count one admission's probe outcome."""
        if hit:
            self.hits += 1
            self.hit_tokens += int(n_tokens)
        else:
            self.misses += 1

    # ------------------------------------------------------ mutators ----

    def publish(self, prompt: Sequence[int], page_row) -> int:
        """Index the full prompt pages of a retiring sequence:
        ``page_row[i]`` holds prompt tokens ``[i*ps, (i+1)*ps)``. Existing
        chains are descended; each new node takes one pool reference
        (before the request drops its own). Returns the pages newly
        published."""
        ps = self.page_size
        self._clock += 1
        node = self._root
        added = 0
        for i in range(len(prompt) // ps):
            key = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                page = int(page_row[i])
                self._pool.share([page])
                child = _PrefixNode(key, node, page, self._clock)
                node.children[key] = child
                self._pages += 1
                self.published_pages += 1
                added += 1
            child.stamp = self._clock
            node = child
        return added

    def node_prefix(self, nd: _PrefixNode) -> Tuple[int, ...]:
        """The page-aligned token prefix ending at ``nd``: its chain's
        chunks root to node, flattened (the key the host tier files an
        offloaded page under, with ``version``)."""
        chunks: List[Tuple[int, ...]] = []
        while nd is not None and nd is not self._root:
            chunks.append(nd.chunk)
            nd = nd.parent
        out: List[int] = []
        for chunk in reversed(chunks):
            out.extend(chunk)
        return tuple(out)

    def evict(self, n_pages: int,
              protect: FrozenSet[_PrefixNode] = frozenset(),
              on_evict: Optional[
                  Callable[[Tuple[int, ...], int], None]] = None) -> int:
        """Free up to ``n_pages`` pages by evicting least-recently-used
        unreferenced leaves (pool refcount exactly the cache's own, no
        children), leaf-first in rounds; ``protect`` shields the chain a
        pending admission matched. ``on_evict(prefix_tokens, page)`` runs
        per victim before its reference is released (the host tier's
        offload hook). Returns the pages freed."""
        if n_pages <= 0 or not self._pages:
            return 0

        def _evictable(nd: _PrefixNode) -> bool:
            return (not nd.children and nd not in protect
                    and self._pool.refcount(nd.page) == 1)

        frontier: List[_PrefixNode] = []
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            elif _evictable(nd):
                frontier.append(nd)
        freed = 0
        while frontier and freed < n_pages:
            heap: List[Tuple[int, int, _PrefixNode]] = [
                (nd.stamp, id(nd), nd) for nd in frontier]
            heapq.heapify(heap)
            exposed: List[_PrefixNode] = []
            while heap and freed < n_pages:
                _, _, leaf = heapq.heappop(heap)
                if on_evict is not None:
                    on_evict(self.node_prefix(leaf), leaf.page)
                parent = leaf.parent
                del parent.children[leaf.chunk]
                self._pool.release([leaf.page])
                self._pages -= 1
                self.evicted_pages += 1
                freed += 1
                if parent is not self._root and _evictable(parent):
                    exposed.append(parent)    # next round's, not this one's
            frontier = exposed
        return freed

    def clear(self) -> int:
        """Drop every cached page reference (engine close or failure).
        Returns the pages released; bumps ``version``."""
        released = 0
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            self._pool.release([nd.page])
            released += 1
        self._root = _PrefixNode(None, None, None)
        self._pages = 0
        self.evicted_pages += released
        self.version += 1
        return released

    # ------------------------------------------------------- readers ----

    def snapshot(self) -> dict:
        """Index size and probe/eviction counters (the JAX index's keys,
        in its order)."""
        probes = self.hits + self.misses
        return {
            "entries": self._pages,
            "shared_pages": self._pages,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / probes if probes else 0.0,
            "hit_tokens": self.hit_tokens,
            "published_pages": self.published_pages,
            "evicted_pages": self.evicted_pages,
            "deduped_pages": self.deduped_pages,
            "version": self.version,
        }
