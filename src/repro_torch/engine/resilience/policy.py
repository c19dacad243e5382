"""Overload policy: admission rejection, deadline shedding, KV-pressure
degradation and preempt-and-recompute victim selection (DESIGN.md §12).

The engine's only answer to pressure used to be "queue forever": a burst
that exhausted the paged pool inflated every request's queue wait
unboundedly. This module decides *what gives* instead, in escalation
order (cheapest reversible action first):

1. **reject** — malformed requests (empty prompt, oversized, non-positive
   budget) never enter the queue: :class:`RejectedRequest` at submit.
2. **shed** — a queued request whose TTFT deadline has already expired
   provably cannot meet it no matter what the engine does next (prefill
   hasn't even been dispatched), so it is dropped *before* spending
   prefill FLOPs on it. Sheds are first-class SLO verdicts, not silent
   drops.
3. **degrade** — under KV-pool pressure, new admissions reserve a
   smaller speculative lookahead (full tree -> chain K=1 -> non-spec),
   freeing the tentative-verify pages per slot; the spec ladder clamps
   each segment to the smallest reservation among its active slots, so
   degraded and full slots coexist losslessly (greedy spec == non-spec
   is already pinned).
4. **preempt** — when the queue head *still* cannot reserve pages and a
   slot is free, a strictly-lower-priority running request releases its
   pages and re-enqueues with its generated tokens folded into the
   prompt for lossless recompute (DESIGN.md §12.1). Equal-priority
   traffic never preempts: every running request arrived before the
   blocked head (FIFO admission), so evicting one for the other only
   thrashes — plain overload is handled by 2 and 3.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.engine.resilience.chaos import ChaosConfig


class RejectedRequest(ValueError):
    """Typed submit-time rejection: the request can never be served
    (empty prompt, prompt/budget beyond ``max_seq``, ``max_new <= 0``).
    Subclasses ``ValueError`` for backward compatibility."""


class OversizedRequest(RejectedRequest):
    """The reservation (tokens + speculative lookahead) needs more pages
    than one slot's block table holds — no pool occupancy can admit it.
    Raised by ``PagedKVCache.assign`` *before* any allocator mutation
    (DESIGN.md §13 bugfix: the pre-fix path allocated first and died in
    the block-table write, leaking the pages); ``RejectedRequest``-
    compatible so submit-side callers surface it as a rejection."""


# pressure levels, in escalation order
PRESSURE_OK, PRESSURE_ELEVATED, PRESSURE_CRITICAL = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for the overload ladder. The defaults are safe for every
    existing workload: preemption needs a priority inversion to fire,
    shedding needs deadlines, chaos needs a spec — a default-configured
    engine behaves exactly as before until pressure or faults appear."""
    preempt: bool = True
    max_preemptions: int = 3       # per request; beyond this it is immune
    shed: bool = True              # deadline-expired queue entries drop
    # default TTFT deadline stamped on every submitted request (ms after
    # arrival); None leaves requests deadline-free unless submit() says
    # otherwise (the serve CLI wires --deadline / --slo here)
    deadline_ttft_ms: Optional[float] = None
    pressure_degrade: bool = True  # shrink spec lookahead under pressure
    pressure_occupancy: float = 0.85   # pool occupancy -> ELEVATED
    chaos: Optional[ChaosConfig] = None


def pressure_level(kv, head_blocked: bool,
                   occupancy_threshold: float) -> int:
    """Classify KV-pool pressure at a scheduling boundary.

    CRITICAL: the queue head cannot reserve pages right now (admission
    is actually blocked). ELEVATED: the pool is nearly full — new
    admissions should stop reserving speculative lookahead they may
    never use. OK otherwise."""
    if head_blocked:
        return PRESSURE_CRITICAL
    # unreferenced cached-prefix pages are reclaimable on demand
    # (DESIGN.md §13): a pool that is "full of cache" is not under
    # pressure, so count evictables as free before degrading admissions
    free = kv.allocator.num_free + getattr(
        kv, "evictable_pages", lambda: 0)()
    occ = 1.0 - free / max(kv.num_pages, 1)
    if occ >= occupancy_threshold:
        return PRESSURE_ELEVATED
    return PRESSURE_OK


def choose_victims(head, running: List, kv, lookahead: int,
                   max_preemptions: int) -> List:
    """Pick running requests to preempt so ``head`` can reserve pages.

    Eligibility: strictly lower priority than the head and not already
    preempted ``max_preemptions`` times (livelock guard: a request that
    keeps losing its slot eventually becomes immune and runs to
    completion). Victim order is lowest-priority first, then
    most-remaining-work (the least sunk prefill+decode investment per
    freed page), then latest arrival. Returns the *shortest prefix* of
    that order whose freed pages cover the head's reservation — or []
    when even preempting every eligible victim wouldn't (partial
    preemption is pure churn: pages freed, head still blocked)."""
    needed = kv.pages_needed(head.total_tokens, lookahead=lookahead)
    # prefix-cache eviction outranks preemption on the ladder: if
    # dropping unreferenced cached prefixes covers the reservation,
    # assign will evict them itself — no victim needed. slot_page_count
    # is refcount-aware, so shared pages a victim would NOT return to
    # the pool are never credited toward unblocking the head.
    free = kv.allocator.num_free + getattr(
        kv, "evictable_pages", lambda: 0)()
    if free >= needed:
        return []
    eligible = [r for r in running
                if r.priority < head.priority
                and r.preemptions < max_preemptions]
    eligible.sort(key=lambda r: (r.priority, -r.remaining, -r.rid))
    victims = []
    for r in eligible:
        victims.append(r)
        free += kv.slot_page_count(r.slot)
        if free >= needed:
            return victims
    return []
