"""The static-batch serve steps: a greedy token per sequence from the
full-sequence forward (prefill) or from one decode step on the contiguous
cache (serve), as the reference's ``build_prefill_step`` and
``build_serve_step`` build them. The train step waits for the training
slice (ROADMAP A.6).

    cache = api.init_cache(cfg, batch, max_seq, device=device)
    serve = build_serve_step(cfg)
    tok, cache = serve(params, cache, tokens, pos)   # pos: [] or [B]

Both are plain functions on tensors; the device follows the parameters.
``plain=True`` sends the kernels' work through their plain versions
(kernel-vs-plain checks); ``with_logits=True`` also returns the logits
the token was taken from.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import get_model


def build_prefill_step(cfg, plain: bool = False,
                       with_logits: bool = False) -> Callable:
    """``prefill_step(params, batch) -> next tokens [B]`` (and the last
    position's logits [B, V]): ``batch`` {"tokens": [B, S]} through the
    full-sequence forward, logits at the last position only."""
    api = get_model(cfg)

    def prefill_step(params, batch):
        logits, _ = api.forward(params, batch, cfg, plain, last_only=True)
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        return (tok, logits[:, -1]) if with_logits else tok

    return prefill_step


def build_serve_step(cfg, plain: bool = False,
                     with_logits: bool = False) -> Callable:
    """``serve_step(params, cache, tokens [B, 1], pos) -> (next tokens
    [B, 1] int32, cache)`` (and the logits [B, V]): one decode step on the
    contiguous cache, written in place; ``pos`` a shared [] step index or
    [B] per-slot positions."""
    api = get_model(cfg)

    def serve_step(params, cache, tokens, pos):
        logits, cache = api.decode_step(params, cache, tokens, pos, cfg,
                                        plain=plain)
        tok = torch.argmax(logits[:, -1, :], dim=-1,
                           keepdim=True).to(torch.int32)
        return (tok, cache, logits[:, -1]) if with_logits else (tok, cache)

    return serve_step
