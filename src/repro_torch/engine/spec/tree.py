"""Token-TREE self-speculative decoding (DESIGN.md §8).

The tree is flattened in BFS order into one block of N+1 tokens (slot 0
is the pending token, the root; a level's nodes are contiguous, and so
are the children of a node). The block is written at cache positions
``pos .. pos + N``: storage is slot-sequential, but RoPE runs at each
token's tree depth and attention at its ancestor bitmap (bit i of
``anc[j]`` = BFS slot i is on j's root path), the tree mode of the
paged-attention kernel. A node's K/V is thus rotated for the position it
would hold in sequential decode, and the accepted root-to-leaf path is
compacted into the leading slots by pure row moves
(:func:`compact_accepted`).

One round is D+1 calls for 1..D+1 tokens (D = tree depth):

    draft:  1 root call + D-1 level calls (level l feeds its n_l nodes as
            one tree-attention block; top-f expansion stays on the device)
    verify: one T = N+1 tree-attention call with the target parameters;
            ``sampling.tree_verify`` walks the longest accepted path,
            whose K/V is then compacted, and the position advances by
            ``n_new``.

The draft writes its K/V into the pool in place (see ``drafter.py``):
the verify rewrites every slot ``pos .. pos + N`` the draft wrote.
A chain is the fanout-all-1 tree, bit-identical to the chain path.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.sampling import SamplingParams, tree_verify
from repro_torch.engine.spec.drafter import draft_config
from repro_torch.engine.spec.verify import advance
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import pool_geometry

# ancestor bitmaps are int32 lanes (the kernel and the plain mask shift by
# the in-window offset), so a tree block holds at most 31 fed tokens
MAX_TREE_TOKENS = 31


class TreeTemplate:
    """Static shape of a draft token tree: fanout per depth, BFS flat
    indexing, parent/child maps and per-node ancestor bitmaps.

    ``fanout = (4, 2, 2)``: the root proposes 4 children, each of those 2,
    each of those 2 — 28 nodes, 16 leaves, depth 3, a T = 29 verify
    block. ``(k,)`` and ``(1,) * K`` are chains."""

    def __init__(self, fanout: Tuple[int, ...]):
        if not fanout or any(f < 1 for f in fanout):
            raise ValueError(f"fanout must be positive per depth: {fanout}")
        self.fanout = tuple(int(f) for f in fanout)
        self.depth = len(self.fanout)
        sizes = []
        n = 1
        for f in self.fanout:
            n *= f
            sizes.append(n)
        self.level_sizes = tuple(sizes)            # nodes per level 1..D
        self.n_nodes = sum(sizes)                  # N (root excluded)
        if self.n_nodes + 1 > MAX_TREE_TOKENS:
            raise ValueError(
                f"tree {fanout} needs {self.n_nodes + 1} fed tokens "
                f"(> {MAX_TREE_TOKENS}: ancestor bitmaps are int32)")
        starts = [0, 1]                            # BFS index of level l
        for sz in sizes[:-1]:
            starts.append(starts[-1] + sz)
        self.level_starts = tuple(starts)          # length D + 1
        n1 = self.n_nodes + 1
        self.depths = np.zeros(n1, np.int32)
        self.parents = np.full(n1, -1, np.int32)
        self.child_start = np.full(n1, -1, np.int32)
        self.anc = np.zeros(n1, np.int32)
        self.anc[0] = 1                            # the root sees itself
        for lvl in range(1, self.depth + 1):
            st, sz = self.level_starts[lvl], sizes[lvl - 1]
            f_in = self.fanout[lvl - 1]            # branching into lvl
            for m in range(sz):
                i = st + m
                self.depths[i] = lvl
                self.parents[i] = (0 if lvl == 1
                                   else self.level_starts[lvl - 1]
                                   + m // f_in)
                self.anc[i] = self.anc[self.parents[i]] | (1 << i)
        for lvl in range(1, self.depth):           # child maps (non-leaf)
            st, sz = self.level_starts[lvl], sizes[lvl - 1]
            for m in range(sz):
                self.child_start[st + m] = self.level_starts[lvl + 1] \
                    + m * self.fanout[lvl]
        self.child_start[0] = 1
        self._on_device: Dict = {}

    def _tensors(self, device) -> Dict[str, torch.Tensor]:
        """depths, anc and child_start on ``device``, copied once: a
        host-to-device copy inside a round would wait for the device."""
        dev = torch.device("cpu" if device is None else device)
        key = str(dev)
        if key not in self._on_device:
            self._on_device[key] = {
                name: torch.from_numpy(getattr(self, name)).to(dev)
                for name in ("depths", "anc", "child_start")}
        return self._on_device[key]

    def level_tree(self, lvl: int, device=None) -> Dict:
        """The ``decode_step(tree=...)`` block for feeding level ``lvl``'s
        nodes: the window covers every BFS slot written so far."""
        st, sz = self.level_starts[lvl], self.level_sizes[lvl - 1]
        t = self._tensors(device)
        return {"depths": t["depths"][st:st + sz],
                "anc": t["anc"][st:st + sz], "window": st + sz, "start": st}

    def verify_tree(self, device=None) -> Dict:
        """The block of the full T = N+1 verify."""
        t = self._tensors(device)
        return {"depths": t["depths"], "anc": t["anc"],
                "window": self.n_nodes + 1, "start": 0}

    def child_start_on(self, device) -> torch.Tensor:
        return self._tensors(device)["child_start"]


def top_children(logits: torch.Tensor, f: int) -> torch.Tensor:
    """The ``f`` highest logits' indices along the last axis, ties toward
    the lower index as the reference's ``lax.top_k`` breaks them
    (``torch.topk`` promises no order among ties, so a stable descending
    sort picks them). f = 1 takes the argmax, as the chain drafter does."""
    if f == 1:
        return torch.argmax(logits, dim=-1, keepdim=True)
    return torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[..., :f]


def build_tree_draft_fn(cfg, api, tpl: TreeTemplate,
                        draft_layers: Optional[int] = None):
    """Returns draft_fn(draft_params, cache, tokens, positions,
    block_tables, max_live) -> tree tokens [B, N] int32 (BFS order).

    Level-by-level greedy top-k expansion: the root call is a plain
    decode step; level l's nodes are then fed as one tree-attention block
    (each node sees the committed prefix and its own root path) and each
    node's logits propose its top-f children, distinct by construction,
    which keeps the verify's sibling-set rejection sampling exact."""
    dcfg = draft_config(cfg, draft_layers)

    def draft_fn(draft_params, cache, tokens, positions, block_tables,
                 max_live=None):
        logits, _ = api.decode_step(draft_params, cache, tokens[:, None],
                                    positions, dcfg, block_tables,
                                    max_live_pages=max_live)
        levels = []
        for lvl, f in enumerate(tpl.fanout):
            top = top_children(logits, f)
            toks = top.reshape(top.shape[0], -1).to(torch.int32)
            levels.append(toks)
            if lvl + 1 == tpl.depth:
                break
            spec = tpl.level_tree(lvl + 1, tokens.device)
            logits, _ = api.decode_step(
                draft_params, cache, toks, positions + spec["start"], dcfg,
                block_tables, max_live_pages=max_live, tree=spec)
        return torch.cat(levels, dim=1)

    return draft_fn


def compact_accepted(cache: Dict, block_tables: torch.Tensor,
                     positions: torch.Tensor, path: torch.Tensor,
                     n_new: torch.Tensor, page_size: int) -> None:
    """Move the accepted root-to-leaf path's K/V into the leading slots,
    IN PLACE, in every pool of ``cache`` ([L, P, ps, ...] leaves: K/V
    pages, and the scale pages of an int8 pool).

    The verify wrote target K/V for BFS slot i at position ``pos + i``;
    sequential decode holds the path's i-th token at ``pos + 1 + i``, so
    token i of ``path [B, D]`` moves ``pos + path[:, i] -> pos + 1 + i``.
    K was rotated at its tree depth, which is that final position, so the
    move is a pure row copy. Every source is gathered before any row is
    written (sources lie at or right of their destinations). Rows past
    the accepted length, inactive slots and positions off the block table
    are dropped; the dropped writes are redirected as ``PageWrite`` does,
    so no host value is read."""
    b, dmax = path.shape
    num_pages = next(iter(cache.values())).shape[1]
    bt = block_tables.to(torch.int32)
    i = torch.arange(dmax, dtype=torch.int32, device=path.device)[None, :]
    keep = i < (n_new[:, None] - 1)                 # accepted drafts only
    pos = positions.to(torch.int32)[:, None]
    src, _ = L.page_slots(bt, pos + path.clamp_min(1), page_size,
                          num_pages)
    plan = L.plan_page_write(*L.page_slots(bt, pos + 1 + i, page_size,
                                           num_pages, keep=keep))
    src = src.reshape(-1)
    for buf in cache.values():
        rows = buf.view(buf.shape[0], -1, *buf.shape[3:])  # [L, P*ps, ...]
        moved = rows.index_select(1, src)                   # gather first
        vals = torch.where(plan.any_kept, moved.index_select(1, plan.src),
                           rows.index_select(1, plan.index))
        rows[:, plan.index] = vals


def build_tree_verify_fn(cfg, api, sampling: SamplingParams,
                         tpl: TreeTemplate):
    """Returns verify_fn(params, cache, tokens, tree_tokens, positions,
    block_tables, active, remaining, gen, max_live) -> (out [B, D+1],
    n_new [B], tokens', positions', remaining'): the tree analogue of
    ``verify.py:build_verify_fn``, plus the accepted-path compaction."""

    def verify_fn(params, cache, tokens, tree_tokens, positions,
                  block_tables, active, remaining, gen, max_live=None):
        dev = tokens.device
        feed = torch.cat([tokens[:, None], tree_tokens], dim=1)
        logits, _ = api.decode_step(params, cache, feed, positions, cfg,
                                    block_tables, max_live_pages=max_live,
                                    tree=tpl.verify_tree(dev))
        n_acc, out, path = tree_verify(logits, feed, tpl.fanout,
                                       tpl.child_start_on(dev), gen,
                                       sampling)
        n_new, tokens2, positions2, remaining2 = advance(
            out, n_acc, tokens, positions, active, remaining)
        compact_accepted(cache, block_tables, positions, path, n_new,
                         pool_geometry(cache)[1])
        return out, n_new, tokens2, positions2, remaining2

    return verify_fn


@functools.lru_cache(maxsize=32)
def tree_step_fns(cfg, sampling: SamplingParams, fanout: Tuple[int, ...],
                  draft_layers: Optional[int] = None):
    """(draft_fn, verify_fn, template), memoized per (model config,
    sampling, fanout, draft depth): the adaptive ladder flips between
    fanouts without rebuilding templates or their device tensors."""
    api = get_model(cfg)
    tpl = TreeTemplate(fanout)
    return (build_tree_draft_fn(cfg, api, tpl, draft_layers),
            build_tree_verify_fn(cfg, api, sampling, tpl), tpl)
