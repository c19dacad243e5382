"""The verify step: one multi-token target pass over the K draft tokens.

Feeds ``[t_last, d_1 .. d_K]`` (K+1 tokens) at positions ``pos .. pos +
K`` through the target model in one call (``transformer.decode_step``
with T = K+1, the staircase mask). Position i's logits are the target
distribution after the first i drafts, so all K acceptance tests and the
bonus distribution come from one pass.

Rollback of a rejected suffix is positional: the new position is ``pos +
n_new``; the K/V written past it are masked by length and overwritten by
the next round, so no page is allocated or freed mid-request.
"""
from __future__ import annotations

import torch

from repro_torch.engine.sampling import SamplingParams, spec_verify


def advance(out, n_acc, tokens, positions, active, remaining):
    """The round's bookkeeping, on the device: ``n_new`` = tokens the
    round produced per slot (0 for inactive or budget-exhausted slots);
    the last produced token becomes the next feed; positions advance and
    budgets shrink by ``n_new``. Returns ``(n_new, tokens', positions',
    remaining')``."""
    n_new = torch.minimum(n_acc + 1, remaining) * active          # [B]
    nxt = torch.gather(out, 1, (n_new - 1).clamp_min(0)[:, None]
                       .long())[:, 0]
    tokens = torch.where(n_new > 0, nxt, tokens)
    return n_new, tokens, positions + n_new, remaining - n_new


def build_verify_fn(cfg, api, sampling: SamplingParams, k: int):
    """Returns verify_fn(params, cache, tokens, draft_tokens, positions,
    block_tables, active, remaining, gen, max_live) -> (out [B, K+1],
    n_new [B], tokens', positions', remaining'). The pool is written in
    place (every fed position, with target K/V)."""

    def verify_fn(params, cache, tokens, draft_tokens, positions,
                  block_tables, active, remaining, gen, max_live=None):
        feed = torch.cat([tokens[:, None], draft_tokens], dim=1)
        logits, _ = api.decode_step(params, cache, feed, positions, cfg,
                                    block_tables, max_live_pages=max_live)
        n_acc, out = spec_verify(logits, draft_tokens, gen, sampling)
        return (out,) + advance(out, n_acc, tokens, positions, active,
                                remaining)

    return verify_fn
