"""Port conformance, the shared-prefix KV cache's host side: the radix
tree (``engine/prefix_cache.py``) and the prefix half of the refcounted
allocator and ``PagedKVCache``, driven through the same sequence of
operations as the JAX reference's, state compared after every one.

Tolerances: none. Both sides are the same plain Python and numpy
bookkeeping, so every return value, tree node (tokens, page, LRU stamp),
refcount, free-list order, block table and counter must be equal; the
pool pages a copy-on-write duplicates must be bit-identical to their
source on every leaf (K/V, int8 scale and latent pages)."""
import dataclasses

import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.engine import PageAllocator as JPageAllocator  # noqa: E402
from repro.engine import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.engine import PrefixCache as JPrefixCache  # noqa: E402
from repro.engine.telemetry import MetricsRegistry as JRegistry  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.engine import (OversizedRequest, PageAllocator,  # noqa: E402
                                PagedKVCache, PrefixCache)
from repro_torch.engine.telemetry import MetricsRegistry  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

COUNTERS = ("kv.page_allocs", "kv.page_frees", "prefix.hits",
            "prefix.misses", "prefix.hit_tokens", "prefix.cow_copies",
            "prefix.inserted_pages", "prefix.evicted_pages")
GAUGES = ("kv.pages_free", "kv.occupancy", "kv.shared_pages",
          "prefix.cached_pages")


def _prompt_pool(vocab, seed, page):
    """Prompts over a few shared prefixes (whole pages and part pages),
    the bare prefixes (page-aligned hits) and unrelated prompts."""
    g = np.random.default_rng(seed)
    pre = [g.integers(0, vocab, n).astype(np.int32)
           for n in (2 * page, 3 * page)]
    out = [np.concatenate([p, g.integers(0, vocab, n).astype(np.int32)])
           for p in pre for n in (0, 1, page - 1, page + 3)]
    out += [pre[0][:page].copy(), np.concatenate([pre[1][:2 * page],
                                                  pre[0][:page]])]
    out += [g.integers(0, vocab, n).astype(np.int32) for n in (5, 2 * page)]
    return out


def _tree(pc):
    """A radix tree's state: (clock, node count, sorted (path, page,
    last_used) of every node)."""
    out, stack = [], [((), pc._root)]
    while stack:
        path, node = stack.pop()
        for child in node.children.values():
            p = path + (tuple(int(t) for t in child.tokens),)
            out.append((p, child.page, child.last_used))
            stack.append((p, child))
    return pc._clock, pc._n_nodes, sorted(out)


def _alloc(a):
    return (list(a._free), sorted(a._outstanding), list(a._refcount),
            a.num_shared, a.num_free, a.num_outstanding)


def _call(fn, *args, **kwargs):
    """(result, exception type) of one operation."""
    try:
        return fn(*args, **kwargs), None
    except (ValueError, RuntimeError) as e:
        return None, type(e).__name__


# ---------------------------------------------------------------------------
# the radix tree on a bare allocator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_tree_matches_reference_op_by_op(seed):
    """A seeded storm of alloc / insert / match (with and without an LRU
    touch) / slot frees / evict_for with pinned nodes / evictable_count,
    then a flush: every return value and both trees and allocators equal
    after every operation."""
    page, pages = 4, 40
    pool = _prompt_pool(1000, seed, page)
    rng = np.random.default_rng(100 + seed)
    sides = [(JPageAllocator(pages), JPrefixCache), (PageAllocator(pages),
                                                     PrefixCache)]
    sides = [(a, cls(page, a)) for a, cls in sides]
    held = []                          # per side: slot page lists
    for step in range(250):
        op = rng.random()
        prompt = pool[int(rng.integers(len(pool)))]
        pin = int(rng.integers(0, 3))
        n_evict = int(rng.integers(1, 4))
        outs = []
        for a, pc in sides:
            if op < 0.3:
                n = -(-len(prompt) // page)
                got, err = _call(a.alloc, n)
                if err is None:
                    held.append((id(a), got))
                    got = (got, pc.insert(prompt, got))
            elif op < 0.5:
                got, err = ([n.page for n in pc.match(
                    prompt, touch=bool(step % 2))], None)
            elif op < 0.7:
                mine = [h for h in held if h[0] == id(a)]
                got, err = (_call(a.free, mine[0][1]) if mine
                            else (None, None))
                if mine:
                    held.remove(mine[0])
            elif op < 0.9:
                nodes = pc.match(prompt, touch=False)[:pin]
                got = (pc.evictable_count(exclude=nodes),
                       pc.evict_for(n_evict, exclude=nodes))
                err = None
            else:
                got, err = pc.evictable_count(), None
            outs.append((got, err, _tree(pc), _alloc(a)))
        assert outs[0] == outs[1], step
    for a, pc in sides:
        for h in [h for h in held if h[0] == id(a)]:
            a.free(h[1])
    cached = sides[1][1].cached_pages
    assert [pc.flush() for _, pc in sides] == [cached, cached]
    assert _tree(sides[0][1]) == _tree(sides[1][1])
    assert _alloc(sides[0][0]) == _alloc(sides[1][0])
    assert sides[1][0].num_free == pages


def test_allocator_incref_and_free_errors_match_reference():
    """incref of a free, out-of-range or released page, and a third
    decref of a twice-referenced page, raise on both sides and leave both
    allocators equal."""
    sides = [JPageAllocator(6), PageAllocator(6)]
    outs = []
    for a in sides:
        p = a.alloc(2)
        log = [_call(a.incref, [5]), _call(a.incref, [99])]
        a.incref([p[0]])
        log.append((a.refcount(p[0]), a.num_shared))
        log.append(_call(a.free, p))
        log.append(_call(a.free, [p[0]]))
        log.append(_call(a.free, [p[0]]))
        log.append(_call(a.incref, [p[0]]))
        outs.append((log, _alloc(a)))
    assert outs[0] == outs[1]
    assert len(outs[1][0][3][0]) == 1          # the shared page survived


def test_lru_leaf_first_eviction_matches_reference():
    """Two cached chains, one touched: eviction takes the LRU leaf first,
    never a parent with a live child, on both sides alike."""
    outs = []
    for a, cls in ((JPageAllocator(16), JPrefixCache),
                   (PageAllocator(16), PrefixCache)):
        pc = cls(4, a)
        p1 = np.arange(100, 108, dtype=np.int32)
        p2 = np.arange(50, 58, dtype=np.int32)
        g1, g2 = a.alloc(2), a.alloc(2)
        pc.insert(p1, g1)
        pc.insert(p2, g2)
        a.free(g1)
        a.free(g2)
        pc.match(p1)
        log = [pc.evictable_count(), pc.evict_for(1),
               len(pc.match(p1)), len(pc.match(p2, touch=False)),
               _tree(pc), pc.evict_for(99), pc.cached_pages, a.num_free]
        outs.append(log)
    assert outs[0] == outs[1]
    assert outs[1][2:4] == [2, 1]


# ---------------------------------------------------------------------------
# PagedKVCache with prompt=
# ---------------------------------------------------------------------------

def _caches(arch="llama2_7b", num_slots=4, max_seq=32, page=4,
            num_pages=None, lookahead=0, kv_cache_dtype=None):
    """(reference, port) PagedKVCache of the reduced ``arch`` with the
    prefix cache on, each with its own registry."""
    out = []
    for get, getm, cls, reg, kw in (
            (jget_config, jget_model, JPagedKVCache, JRegistry(), {}),
            (get_config, get_model, PagedKVCache, MetricsRegistry(),
             {"device": "cpu"})):
        cfg = get(arch, reduced=True)
        if kv_cache_dtype is not None:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
        out.append((cls(cfg, getm(cfg), num_slots, max_seq, page,
                        num_pages, lookahead=lookahead, registry=reg,
                        prefix_cache=True, **kw), reg))
    return out


def _kv_state(kv, reg):
    slots = len(kv._slot_pages)
    return (kv.block_tables.tolist(), _alloc(kv.allocator), _tree(kv.prefix),
            [kv.slot_shared_tokens(s) for s in range(slots)],
            [kv.slot_page_count(s) for s in range(slots)],
            [kv.slot_block_table(s, 9).tolist() for s in range(slots)],
            kv.evictable_pages(),
            {c: reg.counter(c).value for c in COUNTERS},
            {g: reg.gauge(g).value for g in GAUGES})


@pytest.mark.parametrize("seed,num_pages", [(0, 24), (1, 14), (2, 40)])
def test_paged_kv_cache_matches_reference_op_by_op(seed, num_pages):
    """A seeded storm of can_admit / assign / prefix_insert / release
    with ``prompt=`` over shared-prefix prompts (partial hits, page-
    aligned hits that copy on write, misses), on a pool small enough to
    evict: block tables, refcounts, the tree, shared tokens, page counts,
    clamped table rows, counters and gauges equal after every
    operation, and at the end the pool drains to the cache's pages."""
    sides = _caches(num_pages=num_pages)
    pool = _prompt_pool(1000, seed, 4)
    rng = np.random.default_rng(200 + seed)
    live = {}
    for step in range(200):
        op = rng.random()
        free_slots = [s for s in range(4) if s not in live]
        slot = int(rng.choice(free_slots)) if free_slots else None
        prompt = pool[int(rng.integers(len(pool)))]
        n = len(prompt) + int(rng.integers(1, 6))
        victim = int(rng.choice(list(live))) if live else None
        n_evict = int(rng.integers(1, 3))
        outs = []
        for kv, reg in sides:
            if op < 0.55 and slot is not None:
                ok = kv.can_admit(n, prompt=prompt)
                res = (ok, _call(kv.assign, slot, n, prompt=prompt)[1]
                       if ok else None)
                if ok and res[1] is None:
                    res += (kv.prefix_insert(slot, prompt),)
            elif op < 0.9 and victim is not None:
                res = _call(kv.release, victim)
            else:
                res = kv.prefix.evict_for(n_evict)
            outs.append((res, _kv_state(kv, reg)))
        assert outs[0] == outs[1], step
        if op < 0.55 and slot is not None and outs[1][0][0] \
                and outs[1][0][1] is None:
            live[slot] = prompt
        elif 0.55 <= op < 0.9 and victim is not None:
            del live[victim]
    for s in list(live):
        for kv, _ in sides:
            kv.release(s)
    assert _kv_state(*sides[0]) == _kv_state(*sides[1])
    kv = sides[1][0]
    assert kv.allocator.num_outstanding == kv.prefix.cached_pages
    assert sides[1][1].counter("prefix.hits").value > 0
    assert sides[1][1].counter("prefix.cow_copies").value > 0
    assert sides[1][1].counter("prefix.evicted_pages").value > 0


@pytest.mark.parametrize("arch,kv_dtype", [("llama2_7b", None),
                                           ("llama2_7b", "int8"),
                                           ("deepseek_v2_236b", None)])
def test_copy_on_write_copies_every_leaf(arch, kv_dtype):
    """A page-aligned full-prompt hit maps the leading cached blocks,
    copies the last one to a private page on every leaf of the pool (K/V
    pages, int8 scale pages, the latent pages), bit-identical, in place,
    and leaves every other page as it was; the block tables, shared
    tokens and counters are the reference's."""
    sides = _caches(arch, num_slots=3, max_seq=32, page=4,
                    kv_cache_dtype=kv_dtype)
    kv, reg = sides[1]
    g = torch.Generator().manual_seed(0)
    for leaf in kv.data.values():
        leaf.copy_((torch.randn(leaf.shape, generator=g) * 50)
                   .to(leaf.dtype))
    prompt = np.arange(8, dtype=np.int32) + 7          # two full blocks
    long = np.concatenate([prompt, np.int32([3, 4, 5])])
    for k, _ in sides:
        k.assign(0, len(long) + 4, prompt=long)
        k.prefix_insert(0, long)
    before = {k: v.clone() for k, v in kv.data.items()}
    ptrs = {k: v.data_ptr() for k, v in kv.data.items()}
    for k, _ in sides:
        k.assign(1, len(prompt) + 4, prompt=prompt)
    assert _kv_state(*sides[0]) == _kv_state(*sides[1])
    assert kv.slot_shared_tokens(1) == 7
    assert reg.counter("prefix.cow_copies").value == 1
    src, dst = int(kv.block_tables[0, 1]), int(kv.block_tables[1, 1])
    assert kv.block_tables[1, 0] == kv.block_tables[0, 0] and src != dst
    for name, leaf in kv.data.items():
        assert leaf.data_ptr() == ptrs[name]
        assert torch.equal(leaf[:, dst], before[name][:, src]), name
        others = [p for p in range(leaf.shape[1]) if p != dst]
        assert torch.equal(leaf[:, others], before[name][:, others]), name


def test_assign_alloc_failure_rolls_back_increfs_as_the_reference():
    """A hit whose remainder cannot be allocated (nothing evictable: the
    owning slot still holds its pages) raises after the prefix incref on
    both sides, and both roll the incref back: allocator, tables and
    counters as before (the match's LRU touch stays, on both sides)."""
    sides = _caches(num_slots=2, max_seq=64, page=16, num_pages=4)
    prompt = np.arange(20, dtype=np.int32)
    outs = []
    for kv, reg in sides:
        kv.assign(0, 28, prompt=prompt)
        kv.prefix_insert(0, prompt)
        before = _kv_state(kv, reg)
        err = _call(kv.assign, 1, 64, prompt=prompt)[1]
        after = _kv_state(kv, reg)
        assert after[:2] + after[3:] == before[:2] + before[3:]
        outs.append((err, after))
    assert outs[0] == outs[1] and outs[1][0] == "RuntimeError"


def test_oversized_assign_and_release_counts_as_the_reference():
    """An oversized assign raises before any mutation; a release counts
    only the pages that really returned (the cache keeps its blocks)."""
    sides = _caches(num_slots=2, max_seq=32, page=16)
    prompt = np.arange(32, dtype=np.int32)
    outs = []
    for kv, reg in sides:
        with pytest.raises(ValueError) as err:
            kv.assign(0, 64, prompt=prompt)
        kv.assign(0, 32, prompt=prompt)
        kv.prefix_insert(0, prompt)
        kv.release(0)
        outs.append(_kv_state(kv, reg))
    assert outs[0] == outs[1] and err.type is OversizedRequest
    assert sides[1][1].counter("kv.page_frees").value == 0
    assert sides[1][0].allocator.num_outstanding == 2
