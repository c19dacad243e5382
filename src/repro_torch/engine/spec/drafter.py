"""The chain drafter: K greedy draft steps with the draft parameters.

The draft shares the target's paged KV pool (one pool, one block table
per slot) and reads the target-written history below each slot's
position. Unlike the reference, whose drafter writes a functional copy
of the pool and drops it, the drafter here writes its K/V into the pool
in place, at positions ``pos .. pos + K - 1``. That leaves the pool as
the reference leaves it: the verify step rewrites every position
``pos .. pos + K`` in every layer with target K/V, positions past the
accepted length are masked by length, and a depth-pruned draft touches
only its leading layer slices.

The K steps are a Python loop; the greedy argmax feedback stays on the
device, so a draft round reads nothing on the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.engine.sampling import SamplingParams
from repro_torch.engine.spec.verify import build_verify_fn
from repro_torch.models.registry import get_model


def draft_config(cfg, draft_layers: Optional[int]):
    """The drafter's config: ``cfg`` cut to ``draft_layers`` layers."""
    dl = draft_layers if draft_layers is not None else cfg.n_layers
    return dataclasses.replace(cfg, n_layers=dl) if dl != cfg.n_layers \
        else cfg


def build_draft_fn(cfg, api, k: int, draft_layers: Optional[int] = None):
    """Returns draft_fn(draft_params, cache, tokens, positions,
    block_tables, max_live) -> draft tokens [B, K] int32.

    ``tokens`` [B] is each slot's last sampled, not yet fed token;
    ``positions`` [B] its write position. Greedy: the draft distribution
    is a point mass, which keeps the verify's rejection sampling exact
    at any target temperature."""
    dcfg = draft_config(cfg, draft_layers)

    def draft_fn(draft_params, cache, tokens, positions, block_tables,
                 max_live=None):
        toks = tokens
        drafts = []
        for j in range(k):
            logits, _ = api.decode_step(draft_params, cache, toks[:, None],
                                        positions + j, dcfg, block_tables,
                                        max_live_pages=max_live)
            toks = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            drafts.append(toks)
        return torch.stack(drafts, dim=1)

    return draft_fn


@functools.lru_cache(maxsize=32)
def spec_step_fns(cfg, sampling: SamplingParams, k: int,
                  draft_layers: Optional[int] = None):
    """(draft_fn, verify_fn) of the chain, memoized per (model config,
    sampling, K, draft depth)."""
    api = get_model(cfg)
    return (build_draft_fn(cfg, api, k, draft_layers),
            build_verify_fn(cfg, api, sampling, k))
