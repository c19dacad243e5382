"""Task-centric continuous-batching scheduler (DESIGN.md §3.3, §12).

Request lifecycle::

    QUEUED --admit--> PREFILL --first token--> DECODE --budget--> FINISHED
      ^  ^               |                        |
      |  |               '--> PREFILLING ---------'   (chunked prefill,
      |  |                     |      ^ chunk          DESIGN.md §14: one
      |  '---- preempt <-------'------'--feeds---.     prompt chunk per
      |        (pages freed, tokens               |    boundary; the last
      |         folded into prompt)               |    chunk's sample is
      '--- submit                                 '--  the first token)
                                                  QUEUED --deadline--> SHED

Admission is FIFO within a priority band: the head of the queue is
admitted as soon as a slot AND its full page reservation (prompt +
generation budget + lookahead) are available; if the head doesn't fit,
nothing behind it jumps ahead (no head-of-line bypass — arrival order is
the service order within a band, pinned by a regression test). All
requests default to priority 0, so the historical pure-FIFO behaviour is
unchanged unless a workload opts into priorities. Slots are evicted and
refilled without stopping the decode loop: the other slots keep decoding
through every admission.

Resilience extensions (DESIGN.md §12): ``preempt`` returns a victim's
pages and re-enqueues it ahead of later same-band arrivals (its original
rid keeps its place), ``shed_expired`` drops queued requests whose TTFT
deadline already passed before prefill was dispatched, quarantined slots
sit out admission for a few boundaries after a poisoned-sampler fault,
and malformed submissions raise a typed :class:`RejectedRequest` instead
of failing deep inside prefill.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.engine.kv_cache import PagedKVCache
from repro_torch.engine.resilience import RejectedRequest, TransientAllocFailure
from repro_torch.engine.telemetry import MetricsRegistry

QUEUED, PREFILL, PREFILLING, DECODE, FINISHED, SHED = (
    "queued", "prefill", "prefilling", "decode", "finished", "shed")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [prompt_len] int32
    max_new_tokens: int
    state: str = QUEUED
    slot: Optional[int] = None
    produced: int = 0                  # generated tokens (incl. prefill's)
    output: Optional[np.ndarray] = None
    # indices into the engine's device-side token log (one per token in
    # plain decode; one per draft/verify round in speculative decode)
    log_entries: List[int] = dataclasses.field(default_factory=list)
    # speculative-decoding accounting (drafts proposed/accepted for this
    # request — per-request acceptance feeds the engine metrics)
    draft_proposed: int = 0
    draft_accepted: int = 0
    # true arrival timestamp (metrics.now() clock) under timed admission:
    # the loadgen source polls at scheduling boundaries, so the request
    # may have arrived well before submit() ran — queue wait and TTFT
    # are measured from here (None: arrival == submit, the offline path)
    arrival_t: Optional[float] = None
    # resilience (DESIGN.md §12): admission priority band (higher wins;
    # preemption requires a strict inversion), optional absolute TTFT
    # deadline on the metrics clock, and preempt-and-recompute state —
    # ``folded`` counts already-generated tokens folded into ``prompt``
    # so a re-prefill resumes the request exactly where it stopped
    priority: int = 0
    deadline_t: Optional[float] = None
    preemptions: int = 0
    folded: int = 0
    # chunked prefill (DESIGN.md §14): prompt tokens already fed into
    # the KV cache while the request is PREFILLING — the next chunk
    # starts here. Meaningless outside PREFILLING; reset on preemption
    # (re-prefill restarts the chunk ladder from the fold point).
    prefill_pos: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def orig_prompt_len(self) -> int:
        """Length of the prompt as submitted (before any preemption
        folded generated tokens into it)."""
        return self.prompt_len - self.folded

    @property
    def total_tokens(self) -> int:
        """Worst-case KV footprint: original prompt + full generation
        budget. Invariant under preemption: folding moves tokens from
        the "to generate" side to the prompt side, but the positions the
        request will ever write are the same."""
        return self.prompt_len + self.max_new_tokens - self.folded

    @property
    def remaining(self) -> int:
        """Generation budget left — the request's *draft budget*: a
        speculative round may propose at most ``remaining - 1`` useful
        drafts (the round always emits >= 1 token), and the device clamps
        acceptance to exactly this many tokens."""
        return max(self.max_new_tokens - self.produced, 0)

    def sort_key(self):
        """Queue order: priority band first (higher served earlier),
        then rid — a preempted request keeps its original rid, so it
        re-enters ahead of everything that arrived after it."""
        return (-self.priority, self.rid)


@dataclasses.dataclass
class Slot:
    request: Optional[Request] = None
    position: int = 0                  # next KV write position

    @property
    def free(self) -> bool:
        return self.request is None


class Scheduler:
    def __init__(self, num_slots: int, kv: PagedKVCache, max_seq: int,
                 registry: Optional[MetricsRegistry] = None):
        self.kv = kv
        self.max_seq = max_seq
        self.slots: List[Slot] = [Slot() for _ in range(num_slots)]
        self.waiting: Deque[Request] = deque()
        self._ids = itertools.count()
        self.admission_order: List[int] = []   # rids, in service order
        self.finished: List[Request] = []
        self.shed: List[Request] = []
        # slot id -> scheduling boundaries left in quarantine (poisoned
        # sampler cooldown, DESIGN.md §12.3)
        self._quarantine: Dict[int, int] = {}
        # queue depth / admissions / evictions into the shared registry
        # (telemetry, DESIGN.md §10)
        reg = registry if registry is not None else MetricsRegistry()
        self._g_queue = reg.gauge("sched.queue_depth")
        self._g_active = reg.gauge("sched.active_slots")
        self._c_submitted = reg.counter("sched.submitted")
        self._c_admissions = reg.counter("sched.admissions")
        self._c_evictions = reg.counter("sched.evictions")
        self._c_rejected = reg.counter("sched.rejected")
        self._c_shed = reg.counter("sched.shed")
        self._c_preemptions = reg.counter("sched.preemptions")
        self._c_quarantines = reg.counter("sched.quarantines")

    def _sync_gauges(self) -> None:
        self._g_queue.set(len(self.waiting))
        self._g_active.set(sum(not s.free for s in self.slots))

    # -- queue side ---------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               arrival_t: Optional[float] = None, priority: int = 0,
               deadline_t: Optional[float] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        max_new_tokens = int(max_new_tokens)
        # typed rejection BEFORE the request enters the queue: a request
        # that can never be served must not cost a slot, pages, or a
        # prefill dispatch to discover that (DESIGN.md §12)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            self._c_rejected.inc()
            raise RejectedRequest(
                f"empty or non-1D prompt (shape {prompt.shape})")
        if max_new_tokens <= 0:
            self._c_rejected.inc()
            raise RejectedRequest(
                f"max_new_tokens must be positive, got {max_new_tokens}")
        if prompt.shape[0] >= self.max_seq:
            self._c_rejected.inc()
            raise RejectedRequest(
                f"prompt length {prompt.shape[0]} leaves no room to "
                f"generate within max_seq {self.max_seq}")
        req = Request(rid=next(self._ids), prompt=prompt,
                      max_new_tokens=max_new_tokens, arrival_t=arrival_t,
                      priority=int(priority), deadline_t=deadline_t)
        if req.total_tokens > self.max_seq:
            self._c_rejected.inc()
            raise RejectedRequest(
                f"request {req.rid}: prompt+budget {req.total_tokens} "
                f"exceeds max_seq {self.max_seq}")
        self._enqueue(req)
        self._c_submitted.inc()
        self._sync_gauges()
        return req.rid

    def _enqueue(self, req: Request) -> None:
        """Insert keeping the queue sorted by (priority band, rid). The
        common case — everything priority 0, fresh rid — is a pure
        append, preserving the historical FIFO behaviour."""
        key = req.sort_key()
        if not self.waiting or self.waiting[-1].sort_key() < key:
            self.waiting.append(req)
            return
        for i, w in enumerate(self.waiting):
            if key < w.sort_key():
                self.waiting.insert(i, req)
                return
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(not s.free for s in self.slots)

    def shed_expired(self, now: float) -> List[Request]:
        """Drop queued requests whose TTFT deadline has already passed:
        prefill hasn't been dispatched, so TTFT >= now - arrival and the
        deadline is provably unmeetable — spending prefill FLOPs on the
        request only steals them from ones that can still meet theirs.
        Returns the shed requests (state SHED); the engine turns them
        into first-class SLO verdicts."""
        dropped = [r for r in self.waiting
                   if r.deadline_t is not None and now >= r.deadline_t]
        if dropped:
            keep = [r for r in self.waiting
                    if r.deadline_t is None or now < r.deadline_t]
            self.waiting = deque(keep)
            for r in dropped:
                r.state = SHED
                self.shed.append(r)
            self._c_shed.inc(len(dropped))
            self._sync_gauges()
        return dropped

    def shed_all(self) -> List[Request]:
        """Drop every queued request (graceful shutdown): the queue will
        never be served, so each entry becomes a shed verdict."""
        dropped = list(self.waiting)
        self.waiting.clear()
        for r in dropped:
            r.state = SHED
            self.shed.append(r)
        if dropped:
            self._c_shed.inc(len(dropped))
            self._sync_gauges()
        return dropped

    # -- slot side ----------------------------------------------------------

    def quarantine_slot(self, slot: int, boundaries: int) -> None:
        """Take a slot out of admission rotation for ``boundaries``
        scheduling boundaries (poisoned-sampler cooldown)."""
        self._quarantine[slot] = max(self._quarantine.get(slot, 0),
                                     int(boundaries))
        self._c_quarantines.inc()

    def tick_quarantine(self) -> None:
        """One scheduling boundary elapsed: count quarantines down."""
        for slot in list(self._quarantine):
            self._quarantine[slot] -= 1
            if self._quarantine[slot] <= 0:
                del self._quarantine[slot]

    def admit(self, lookahead: Optional[int] = None) -> List[Request]:
        """Move queue-head requests into free slots while pages last.

        ``lookahead`` overrides the cache-wide speculative lookahead for
        these reservations (pressure degrade, DESIGN.md §12.2); None
        reserves the full default. Returns the newly admitted requests
        (state PREFILL, slot set). Stops at the first request that
        doesn't fit — within a priority band arrival order is the
        service order, so nothing bypasses a blocked head
        (backpressure) — and at the first injected transient allocation
        failure (the head stays queued and retries next boundary).
        """
        admitted: List[Request] = []
        free_slots = [i for i, s in enumerate(self.slots)
                      if s.free and i not in self._quarantine]
        while self.waiting and free_slots:
            head = self.waiting[0]             # serve from the head
            # the prompt rides along so the prefix cache can map shared
            # full-page blocks to existing pages (DESIGN.md §13); for a
            # preempt-fold re-admit the folded prompt re-matches its
            # original prefix, so recompute shrinks to the tail
            if not self.kv.can_admit(head.total_tokens, lookahead,
                                     prompt=head.prompt):
                break                          # out-of-pages backpressure
            slot = free_slots[0]
            try:
                self.kv.assign(slot, head.total_tokens, lookahead,
                               prompt=head.prompt)
            except TransientAllocFailure:
                break                          # chaos: retry next boundary
            self.waiting.popleft()
            free_slots.pop(0)
            head.state = PREFILL
            head.slot = slot
            self.slots[slot].request = head
            self.slots[slot].position = head.prompt_len
            self.admission_order.append(head.rid)
            admitted.append(head)
        if admitted:
            self._c_admissions.inc(len(admitted))
        self._sync_gauges()
        return admitted

    def active(self) -> List[Request]:
        return [s.request for s in self.slots if not s.free]

    def step_decoded(self) -> List[Request]:
        """Account one decode token for every DECODE slot; returns requests
        that just hit their budget (still occupying their slot).
        PREFILLING slots (mid-chunk, DESIGN.md §14) sit the step out:
        their device rows are masked inactive, so no token advanced."""
        done = []
        for s in self.slots:
            if s.free or s.request.state != DECODE:
                continue
            r = s.request
            r.produced += 1
            s.position += 1
            if r.produced >= r.max_new_tokens or s.position >= self.max_seq:
                done.append(r)
        return done

    def step_spec_round(self, n_new: np.ndarray, k: int):
        """Account one speculative draft/verify round: slot ``i`` produced
        ``n_new[i]`` tokens (0 for free / budget-exhausted slots — the
        device clamps to the draft budget, so overshoot is impossible).
        ``k`` is the round's max accepted DRAFTS per slot: the chain
        length, or the tree depth (a token tree proposes one root-to-leaf
        path's worth of acceptable drafts however wide it fans out).
        A request with ``remaining`` budget can usefully accept at most
        ``remaining - 1`` drafts, so proposals are clamped to that when
        counting acceptance (a budget cut-off is not a rejection).
        Returns the round's ``(proposed, accepted)`` totals. Completion is
        detected by :meth:`collect_finished` after the segment's rounds
        are replayed (a request may finish mid-segment and idle until the
        boundary)."""
        proposed_t = accepted_t = 0
        for i, s in enumerate(self.slots):
            if s.free or s.request.state != DECODE:
                continue
            n = int(n_new[i])
            if n <= 0:
                continue
            r = s.request
            proposed = min(k, max(r.remaining - 1, 0))
            r.produced += n
            s.position += n
            r.draft_proposed += proposed
            r.draft_accepted += n - 1
            proposed_t += proposed
            accepted_t += n - 1
        return proposed_t, accepted_t

    def collect_finished(self) -> List[Request]:
        """Requests that hit their budget (still occupying their slot)."""
        return [s.request for s in self.slots
                if not s.free and s.request.state == DECODE
                and (s.request.produced >= s.request.max_new_tokens
                     or s.position >= self.max_seq)]

    def finish(self, req: Request) -> None:
        """Evict: free the slot + pages; the loop refills via admit()."""
        slot = req.slot
        self.kv.release(slot)
        self.slots[slot].request = None
        self.slots[slot].position = 0
        req.state = FINISHED
        self.finished.append(req)
        self._c_evictions.inc()
        self._sync_gauges()

    def preempt(self, req: Request) -> None:
        """Release a running request's slot and pages and re-enqueue it.
        The caller (engine) has already folded the generated tokens into
        ``req.prompt`` (DESIGN.md §12.1), so the re-prefill resumes it
        losslessly; its original rid puts it back ahead of later
        arrivals in its priority band."""
        slot = req.slot
        self.kv.release(slot)
        self.slots[slot].request = None
        self.slots[slot].position = 0
        req.slot = None
        req.state = QUEUED
        req.preemptions += 1
        req.prefill_pos = 0          # chunk ladder restarts on re-admit
        req.log_entries = []
        self._enqueue(req)
        self._c_preemptions.inc()
        self._sync_gauges()
