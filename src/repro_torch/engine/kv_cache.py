"""Paged KV cache: a fixed pool of fixed-size pages + per-request block
tables + a refcounted free-list allocator (DESIGN.md §3.2, §13).

The device pool is allocated ONCE (``api.init_paged_cache``: torch tensors
[L, P, page_size, ...] on the model's device: K and V pages, or the MLA
latent pages) and never resized; the
prefill and decode steps write it IN PLACE. Requests borrow pages and
return them on completion, so cache memory is bounded and fragmentation-
free regardless of how many requests stream through. Block-table entries
that hold no page carry the out-of-range sentinel ``num_pages``: the model
code masks writes to it explicitly and clamps its reads (masked by the
per-slot length), so inactive slots cost nothing and corrupt nothing.

Pages carry **refcounts** (DESIGN.md §13): a page may be mapped into
several slots' block tables at once (shared prompt prefixes) and
referenced by the radix :class:`~repro_torch.engine.prefix_cache.
PrefixCache`; ``free`` is a decref and a page returns to the free list
only at refcount 0, so ``num_free + num_outstanding == num_pages`` holds
at every step (outstanding: refcount >= 1). Because the pool is written in
place, a page the cache holds is never written again: a page-aligned
full-prompt hit copies its last cached page to a private one first
(``_copy_page``, on the device).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.prefix_cache import PrefixCache
from repro_torch.engine.resilience.policy import OversizedRequest
from repro_torch.engine.telemetry import MetricsRegistry


class PageAllocator:
    """Refcounted free-list page allocator. O(1) alloc/free, pages are
    reused LIFO so recently-touched pages (warm in cache) are handed out
    first.

    ``alloc`` hands out pages at refcount 1; ``incref`` adds references
    (prefix sharing); ``free`` drops one reference per page and returns a
    page to the free list only at refcount 0. Invariant-hardened: every
    page is either in the free list (refcount 0) or in the outstanding
    set (refcount >= 1), never both. ``free`` rejects decrefs of
    non-outstanding pages and out-of-range ids with :class:`ValueError`
    *before* touching any state, so a buggy caller cannot corrupt the
    list (and ``num_free + num_outstanding`` stays an exact conservation
    law under preempt/re-admit/evict churn)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: deque = deque(range(num_pages))
        self._outstanding: set = set()
        self._refcount = [0] * num_pages
        self._n_shared = 0     # pages with refcount >= 2

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_outstanding(self) -> int:
        return len(self._outstanding)

    @property
    def num_shared(self) -> int:
        return self._n_shared

    def refcount(self, page: int) -> int:
        return self._refcount[page]

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if not self.can_alloc(n):
            raise RuntimeError(
                f"out of KV pages: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._outstanding.update(pages)
        for p in pages:
            self._refcount[p] = 1
        return pages

    def incref(self, pages: List[int]) -> None:
        """Add one reference per page (prefix sharing / cache adoption).
        Only outstanding pages can gain references: an incref of a free
        page would resurrect it under a future alloc."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(
                    f"incref of out-of-range page id {p} "
                    f"(pool has {self.num_pages} pages)")
            if p not in self._outstanding:
                raise ValueError(
                    f"incref of non-outstanding page {p}")
        for p in pages:
            self._refcount[p] += 1
            if self._refcount[p] == 2:
                self._n_shared += 1

    def free(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; pages reaching refcount 0 go back
        to the free list. Returns the pages actually freed (callers'
        telemetry must count returns, not decrefs)."""
        # validate the whole batch first: a partially-applied free would
        # itself corrupt the invariant it exists to protect
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(
                    f"free of out-of-range page id {p} "
                    f"(pool has {self.num_pages} pages)")
            if p not in self._outstanding:
                raise ValueError(
                    f"double-free of page {p}: not outstanding "
                    f"({len(self._outstanding)} pages are)")
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate page ids in free batch: {pages}")
        freed = []
        for p in pages:
            self._refcount[p] -= 1
            if self._refcount[p] == 1:
                self._n_shared -= 1
            elif self._refcount[p] == 0:
                self._outstanding.discard(p)
                self._free.append(p)
                freed.append(p)
        return freed


class PagedKVCache:
    """Host-side manager of the device page pool.

    ``data`` is the dict from ``api.init_paged_cache`` (leaves
    [L, P, page_size, ...] on the model's device); the engine's steps
    write it in place.

    With ``prefix_cache=True`` a radix :class:`PrefixCache` sits on top:
    ``assign`` maps a request's cached prompt prefix to existing pages
    (incref: the per-slot block table is the indirection that makes
    sharing free), copies on write the one page the tail prefill must
    write into, and evicts unreferenced cached prefixes when the free
    list alone cannot cover the unshared remainder (DESIGN.md §13).
    """

    def __init__(self, cfg, api, num_slots: int, max_seq: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 lookahead: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 prefix_cache: bool = False, device=None):
        if not api.supports_paged_cache:
            from repro_torch.models.registry import paged_families
            raise NotImplementedError(
                f"model family {cfg.family!r} has no paged-cache support "
                f"(supported: {', '.join(paged_families())})")
        self.page_size = page_size
        # ``lookahead``: extra writable positions past a slot's budget for
        # speculative decoding
        self.lookahead = lookahead
        self.max_pages_per_slot = -(-(max_seq + lookahead) // page_size)
        # default pool: every slot can grow to max_seq simultaneously
        self.num_pages = (num_slots * self.max_pages_per_slot
                          if num_pages is None else num_pages)
        self.sentinel = self.num_pages
        self.data = api.init_paged_cache(cfg, self.num_pages, page_size,
                                         device=device)
        self.device = next(iter(self.data.values())).device
        self.allocator = PageAllocator(self.num_pages)
        self.block_tables = np.full((num_slots, self.max_pages_per_slot),
                                    self.sentinel, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        # tokens of each slot's prompt served from cached pages (0: the
        # slot prefills its whole prompt); the engine prefills only the
        # tail past this point (DESIGN.md §13)
        self._slot_shared = [0] * num_slots
        reg = registry if registry is not None else MetricsRegistry()
        self._g_free = reg.gauge("kv.pages_free")
        self._g_occ = reg.gauge("kv.occupancy")
        self._g_shared = reg.gauge("kv.shared_pages")
        self._c_allocs = reg.counter("kv.page_allocs")
        self._c_frees = reg.counter("kv.page_frees")
        self._c_hits = reg.counter("prefix.hits")
        self._c_misses = reg.counter("prefix.misses")
        self._c_hit_tokens = reg.counter("prefix.hit_tokens")
        self._c_cow = reg.counter("prefix.cow_copies")
        reg.gauge("kv.num_pages").set(self.num_pages)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(page_size, self.allocator, reg) if prefix_cache
            else None)
        self._sync_gauges()

    def _sync_gauges(self) -> None:
        free = self.allocator.num_free
        self._g_free.set(free)
        self._g_occ.set(1.0 - free / max(self.num_pages, 1))
        self._g_shared.set(self.allocator.num_shared)

    def pages_needed(self, n_tokens: int,
                     lookahead: Optional[int] = None) -> int:
        """Worst-case pages for a request: prompt + budget + lookahead."""
        la = self.lookahead if lookahead is None else lookahead
        return -(-(n_tokens + la) // self.page_size)

    def _prefix_plan(self, prompt, touch: bool = True
                     ) -> Tuple[list, object, int]:
        """Resolve a prompt against the radix cache: ``(kept_nodes,
        cow_node, shared_tokens)``. ``kept_nodes`` are the cached blocks
        the slot maps as they are; ``shared_tokens`` is the prompt prefix
        those cover, clamped to ``prompt_len - 1`` so the tail prefill
        always recomputes at least one token (first-token logits). When
        the clamp lands *inside* a cached block (a page-aligned
        full-prompt hit), that block is the ``cow_node``: the tail writes
        into it, so admission must copy it on the device first."""
        if self.prefix is None or prompt is None:
            return [], None, 0
        nodes = self.prefix.match(prompt, touch=touch)
        if not nodes:
            return [], None, 0
        shared = min(len(nodes) * self.page_size, len(prompt) - 1)
        n_keep = shared // self.page_size
        cow = nodes[n_keep] if n_keep < len(nodes) else None
        return nodes[:n_keep], cow, shared

    def evictable_pages(self) -> int:
        """Cached-prefix pages an eviction cascade could return to the
        pool right now."""
        return 0 if self.prefix is None else self.prefix.evictable_count()

    def can_admit(self, n_tokens: int,
                  lookahead: Optional[int] = None, prompt=None) -> bool:
        need = self.pages_needed(n_tokens, lookahead)
        if need > self.max_pages_per_slot:
            # assign would reject it outright (OversizedRequest)
            return False
        if self.prefix is None or prompt is None:
            return self.allocator.can_alloc(need)
        kept, cow, _ = self._prefix_plan(prompt, touch=False)
        pinned = kept + ([cow] if cow is not None else [])
        n_own = need - len(kept)
        return (self.allocator.num_free
                + self.prefix.evictable_count(exclude=pinned)) >= n_own

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one pool page on the device (copy-on-write): every leaf
        is [L, P, page_size, ...] (K/V pages, int8 scale pages, latent
        pages), so copy index ``src`` to ``dst`` along the page axis of
        each, in place. It is enqueued on the current stream, behind the
        prefill that wrote ``src`` and before the tail that writes
        ``dst``; nothing is read on the host."""
        for leaf in self.data.values():
            leaf[:, dst].copy_(leaf[:, src])

    def assign(self, slot: int, n_tokens: int,
               lookahead: Optional[int] = None, prompt=None) -> None:
        """Reserve pages for a request's full lifetime (prompt + budget
        + lookahead), so decode can never hit OOM. With ``prompt`` and
        the prefix cache on, the cached prefix maps to existing pages
        (incref) and only the remainder is allocated. Raises
        :class:`OversizedRequest` when the reservation can never fit a
        slot's block table (validated before any allocator mutation: a
        failed assign leaves allocator, block table, counters and gauges
        as they were), and the allocator's ``RuntimeError`` when the
        pool cannot cover the remainder even after eviction (the
        prefix increfs rolled back)."""
        la = self.lookahead if lookahead is None else lookahead
        need = self.pages_needed(n_tokens, la)
        if need > self.max_pages_per_slot:
            raise OversizedRequest(
                f"request needs {need} pages ({n_tokens} tokens "
                f"+ lookahead {la}) but a slot's block table holds at "
                f"most {self.max_pages_per_slot}")
        kept_nodes, cow, shared = self._prefix_plan(prompt)
        kept = [n.page for n in kept_nodes]
        n_own = need - len(kept)
        # pin the shared chain first: the eviction below must never
        # reclaim pages this slot is adopting
        self.allocator.incref(kept)
        if self.prefix is not None and not self.allocator.can_alloc(n_own):
            pinned = kept_nodes + ([cow] if cow is not None else [])
            self.prefix.evict_for(n_own - self.allocator.num_free,
                                  exclude=pinned)
        try:
            own = self.allocator.alloc(n_own)
        except RuntimeError:
            self.allocator.free(kept)   # roll back the prefix increfs
            raise
        if cow is not None:
            # the tail prefill rewrites position `shared`, which lives in
            # this cached block: give the slot its own copy
            self._copy_page(cow.page, own[0])
            self._c_cow.inc()
        pages = kept + own
        self._slot_pages[slot] = pages
        self._slot_shared[slot] = shared
        self.block_tables[slot, :] = self.sentinel
        self.block_tables[slot, :len(pages)] = pages
        # telemetry only after every mutation above succeeded
        self._c_allocs.inc(len(own))
        if self.prefix is not None and prompt is not None:
            if shared > 0:
                self._c_hits.inc()
                self._c_hit_tokens.inc(shared)
            else:
                self._c_misses.inc()
        self._sync_gauges()

    def release(self, slot: int) -> None:
        freed = self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_shared[slot] = 0
        self.block_tables[slot, :] = self.sentinel
        # count the pages actually returned, and only after the free
        # succeeded: shared pages survive their other references
        self._c_frees.inc(len(freed))
        self._sync_gauges()

    def prefix_insert(self, slot: int, prompt) -> int:
        """Cache this slot's prompt prefix pages after its prefill wrote
        them (positions below the prompt length are never rewritten).
        No-op without the prefix cache."""
        if self.prefix is None or prompt is None:
            return 0
        return self.prefix.insert(prompt, self._slot_pages[slot])

    def slot_shared_tokens(self, slot: int) -> int:
        """Prompt tokens this slot serves from cached pages: the engine
        prefills only positions >= this (DESIGN.md §13)."""
        return self._slot_shared[slot]

    def slot_page_count(self, slot: int) -> int:
        """Pages a preemption of this slot would actually return to the
        pool: shared pages (refcount > 1) survive their other
        references, so only pages this slot holds alone count."""
        return sum(1 for p in self._slot_pages[slot]
                   if self.allocator.refcount(p) == 1)

    def slot_block_table(self, slot: int,
                         n_tokens: Optional[int] = None) -> np.ndarray:
        """One slot's block-table row, optionally clamped to the pages
        covering positions [0, n_tokens): entries past them carry the
        sentinel (the engine's chunked prefill dispatches a chunk against
        only the pages it can touch)."""
        row = self.block_tables[slot].copy()
        if n_tokens is not None:
            keep = -(-int(n_tokens) // self.page_size)
            row[keep:] = self.sentinel
        return row

    def device_block_tables(self) -> torch.Tensor:
        # a copy, never a view of the host table: ``assign``/``release``
        # mutate it in place while earlier steps may still be in flight
        return torch.tensor(self.block_tables, device=self.device)
