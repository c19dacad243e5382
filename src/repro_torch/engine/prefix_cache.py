"""Radix prefix cache over the paged KV pool (DESIGN.md §13). Plain
Python and numpy: no tensor is touched here.

Production traffic is millions of users hitting the same system prompts
and few-shot templates; before this module every request prefilled and
stored its own pages. The cache is a radix tree keyed on hashed
*full-page token blocks*: node at depth ``i`` caches the KV page of a
prompt's ``i``-th ``page_size``-token block, so a path from the root is
exactly a shared prompt prefix at page granularity. Admission walks the
tree (`PagedKVCache.assign`), maps the request's shared prefix to the
cached pages (one ``incref`` per page — the block table is already
per-request indirection, so sharing is free), and prefills only the
unshared tail; TTFT drops to the tail and pages-per-request drops to
the unshared pages.

Lifecycle rules:

* **insert** — after a request's prefill, its prompt's full-page blocks
  enter the tree; each newly cached page takes a *cache reference*, so
  it survives the owning slot's release (``free`` is decref — a page
  returns to the free list only at refcount 0).
* **copy-on-write** — cached pages are never written again. The pool
  is written in place, so the engine keeps them so: a tail prefill
  writes only its slot's own pages (its padding rows write nothing,
  ``models/layers.py:paged_step``), and a request whose tail begins
  *inside* a cached block (a page-aligned full-prompt hit: the engine
  always recomputes at least the last prompt token to produce
  first-token logits) gets a private device copy of that page before
  the tail prefill writes into it (`PagedKVCache._copy_page`).
* **eviction** — under pool pressure, *unreferenced* cached prefixes
  (allocator refcount 1: only the cache holds them) are dropped
  leaf-first in LRU order: `PagedKVCache.can_admit` counts evictable
  pages as free, and ``assign`` evicts just enough to fit (the
  reference's resilience ladder, which reads the same count one rung
  before degrade/preempt, is ROADMAP A.5).

Hash keying: children are keyed by ``hash(block.tobytes())`` and
verified against the stored tokens, so a (vanishingly rare) collision
reads as a cache miss / stops an insert instead of aliasing two
different prefixes onto one page.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.engine.telemetry import MetricsRegistry


class _Node:
    """One cached full-page token block. ``page`` is a pool page id on
    which the cache holds one allocator reference."""
    __slots__ = ("tokens", "page", "children", "parent", "last_used")

    def __init__(self, tokens: Optional[np.ndarray], page: Optional[int],
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.page = page
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Radix tree of cached prompt-prefix pages (see module docstring).

    The cache never allocates pages itself: it adopts pages a slot's
    prefill already wrote (``insert`` increfs them) and returns them to
    the pool on eviction (``allocator.free`` — the plain decref path,
    so the allocator's conservation law stays exact, refcount-weighted)."""

    def __init__(self, page_size: int, allocator,
                 registry: Optional[MetricsRegistry] = None):
        self.page_size = page_size
        self.allocator = allocator
        self._root = _Node(None, None, None)
        self._clock = 0                   # monotonic LRU clock
        self._n_nodes = 0
        reg = registry if registry is not None else MetricsRegistry()
        self._c_inserted = reg.counter("prefix.inserted_pages")
        self._c_evicted = reg.counter("prefix.evicted_pages")
        self._g_cached = reg.gauge("prefix.cached_pages")

    @property
    def cached_pages(self) -> int:
        return self._n_nodes

    @staticmethod
    def _key(block: np.ndarray) -> int:
        return hash(block.tobytes())

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    # -- lookup / insert ----------------------------------------------------

    def match(self, prompt: np.ndarray, touch: bool = True) -> List[_Node]:
        """Longest cached chain of the prompt's full-page blocks (root
        first). ``touch`` refreshes LRU recency on the matched nodes —
        pass False for purely speculative checks (``can_admit``)."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        node, out = self._root, []
        for i in range(len(prompt) // ps):
            block = prompt[i * ps:(i + 1) * ps]
            child = node.children.get(self._key(block))
            if child is None or not np.array_equal(child.tokens, block):
                break
            if touch:
                self._touch(child)
            out.append(child)
            node = child
        return out

    def insert(self, prompt: np.ndarray, pages: Sequence[int]) -> int:
        """Cache the prompt's full-page blocks backed by ``pages`` (the
        owning slot's block-table order, so block ``i`` <-> ``pages[i]``
        — valid K/V for every block fully inside the prompt). Blocks
        already cached keep their existing page; each NEW node takes a
        cache reference on the slot's page. Returns nodes added."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        node, added = self._root, 0
        for i in range(min(len(prompt) // ps, len(pages))):
            block = prompt[i * ps:(i + 1) * ps]
            k = self._key(block)
            child = node.children.get(k)
            if child is not None:
                if not np.array_equal(child.tokens, block):
                    break                 # hash collision: stop extending
                node = child
                continue
            self.allocator.incref([pages[i]])
            child = _Node(block.copy(), int(pages[i]), node)
            self._touch(child)
            node.children[k] = child
            node = child
            added += 1
            self._n_nodes += 1
        if added:
            self._c_inserted.inc(added)
            self._g_cached.set(self._n_nodes)
        return added

    # -- eviction -----------------------------------------------------------

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def evictable_count(self, exclude: Sequence[_Node] = ()) -> int:
        """Pages an eviction cascade could return to the pool right now:
        nodes only the cache references (allocator refcount 1). A
        refcount-1 node's descendants are all refcount-1 too (a slot
        referencing a deep block references its whole ancestor chain),
        so leaf-first eviction can always realize this count."""
        ex = {id(n) for n in exclude}
        return sum(1 for n in self._iter_nodes()
                   if id(n) not in ex
                   and self.allocator.refcount(n.page) == 1)

    def evict_for(self, n_pages: int, exclude: Sequence[_Node] = ()) -> int:
        """Drop up to ``n_pages`` unreferenced cached prefixes,
        leaf-first in LRU order (evicting a leaf may expose its parent).
        ``exclude`` pins nodes an in-flight admission is about to
        reference. Returns pages actually returned to the pool."""
        ex = {id(n) for n in exclude}
        freed = 0
        while freed < n_pages:
            leaves = [n for n in self._iter_nodes()
                      if not n.children and id(n) not in ex
                      and self.allocator.refcount(n.page) == 1]
            if not leaves:
                break
            self._drop(min(leaves, key=lambda n: n.last_used))
            freed += 1
        return freed

    def _drop(self, node: _Node) -> None:
        del node.parent.children[self._key(node.tokens)]
        self.allocator.free([node.page])
        self._n_nodes -= 1
        self._c_evicted.inc()
        self._g_cached.set(self._n_nodes)

    def flush(self) -> int:
        """Drop every cache reference (shutdown / tests): pages still
        referenced by running slots survive with their slot reference;
        the rest return to the free list."""
        n = 0
        for node in list(self._iter_nodes()):
            self.allocator.free([node.page])
            n += 1
        self._root.children.clear()
        self._n_nodes = 0
        self._g_cached.set(0)
        return n
