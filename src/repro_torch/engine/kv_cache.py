"""Paged KV cache: a fixed pool of fixed-size pages + per-request block
tables + a refcounted free-list allocator (DESIGN.md §3.2).

The device pool is allocated ONCE (``api.init_paged_cache``: torch tensors
[L, P, page_size, ...] on the model's device: K and V pages, or the MLA
latent pages) and never resized; the
prefill and decode steps write it IN PLACE. Requests borrow pages and
return them on completion, so cache memory is bounded and fragmentation-
free regardless of how many requests stream through. Block-table entries
that hold no page carry the out-of-range sentinel ``num_pages``: the model
code masks writes to it explicitly and clamps its reads (masked by the
per-slot length), so inactive slots cost nothing and corrupt nothing.

The shared-prefix cache of the reference is a later slice (ROADMAP A.4):
``prefix_cache=True`` raises.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.engine.resilience.policy import OversizedRequest
from repro_torch.engine.telemetry import MetricsRegistry


class PageAllocator:
    """Refcounted free-list page allocator. O(1) alloc/free, pages are
    reused LIFO so recently-touched pages (warm in cache) are handed out
    first.

    ``alloc`` hands out pages at refcount 1; ``free`` drops one reference
    per page and returns a page to the free list only at refcount 0 (the
    reference's ``incref``, for prefix sharing, comes with the prefix
    cache, ROADMAP A.4). Invariant-hardened: every
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

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_outstanding(self) -> int:
        return len(self._outstanding)

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
            if self._refcount[p] == 0:
                self._outstanding.discard(p)
                self._free.append(p)
                freed.append(p)
        return freed


class PagedKVCache:
    """Host-side manager of the device page pool.

    ``data`` is the dict from ``api.init_paged_cache`` (leaves
    [L, P, page_size, ...] on the model's device); the engine's steps
    write it in place.
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
        if prefix_cache:
            raise NotImplementedError(
                "the shared-prefix KV cache is not yet ported (ROADMAP A.4)")
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
        reg = registry if registry is not None else MetricsRegistry()
        self._g_free = reg.gauge("kv.pages_free")
        self._g_occ = reg.gauge("kv.occupancy")
        self._c_allocs = reg.counter("kv.page_allocs")
        self._c_frees = reg.counter("kv.page_frees")
        reg.gauge("kv.num_pages").set(self.num_pages)
        self._sync_gauges()

    def _sync_gauges(self) -> None:
        free = self.allocator.num_free
        self._g_free.set(free)
        self._g_occ.set(1.0 - free / max(self.num_pages, 1))

    def pages_needed(self, n_tokens: int,
                     lookahead: Optional[int] = None) -> int:
        """Worst-case pages for a request: prompt + budget + lookahead."""
        la = self.lookahead if lookahead is None else lookahead
        return -(-(n_tokens + la) // self.page_size)

    def can_admit(self, n_tokens: int,
                  lookahead: Optional[int] = None, prompt=None) -> bool:
        need = self.pages_needed(n_tokens, lookahead)
        if need > self.max_pages_per_slot:
            return False
        return self.allocator.can_alloc(need)

    def assign(self, slot: int, n_tokens: int,
               lookahead: Optional[int] = None, prompt=None) -> None:
        """Reserve pages for a request's full lifetime (prompt + budget
        + lookahead), so decode can never hit OOM. Raises
        :class:`OversizedRequest` when the reservation can never fit a
        slot's block table (validated before any allocator mutation).
        ``prompt`` is the prefix cache's (a later slice); unused here."""
        la = self.lookahead if lookahead is None else lookahead
        need = self.pages_needed(n_tokens, la)
        if need > self.max_pages_per_slot:
            raise OversizedRequest(
                f"request needs {need} pages ({n_tokens} tokens "
                f"+ lookahead {la}) but a slot's block table holds at "
                f"most {self.max_pages_per_slot}")
        pages = self.allocator.alloc(need)
        self._slot_pages[slot] = pages
        self.block_tables[slot, :] = self.sentinel
        self.block_tables[slot, :len(pages)] = pages
        self._c_allocs.inc(len(pages))
        self._sync_gauges()

    def release(self, slot: int) -> None:
        freed = self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.block_tables[slot, :] = self.sentinel
        self._c_frees.inc(len(freed))
        self._sync_gauges()

    def slot_page_count(self, slot: int) -> int:
        """Pages a preemption of this slot would return to the pool."""
        return sum(1 for p in self._slot_pages[slot]
                   if self.allocator.refcount(p) == 1)

    def device_block_tables(self) -> torch.Tensor:
        # a copy, never a view of the host table: ``assign``/``release``
        # mutate it in place while earlier steps may still be in flight
        return torch.tensor(self.block_tables, device=self.device)
