"""Serving metrics: TTFT, TPOT, tokens/s, p50/p99 request latency.

Timestamps are taken at *synchronization points* of the engine loop
(after the prefill block and after each decode segment's block), so they
measure completed device work, not async dispatch.

Rebased on the telemetry registry (DESIGN.md §10): every aggregate is a
registry counter and every latency distribution a streaming log-bucketed
histogram, so ``summary()`` quantiles cost O(buckets) memory regardless
of how many requests stream through — the per-request dict holds only
in-flight bookkeeping (the timestamps a later record call still needs),
and the ``summary()`` key set is unchanged from the pre-registry
implementation (plus ``queue_wait_ms_p50/p99``, the admission
backpressure signal). When the engine runs with tracing enabled the
record calls double as the per-request flow/async event source.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from repro_torch.engine.telemetry import MetricsRegistry, SpanTracer


@dataclasses.dataclass
class RequestTiming:
    enqueue_t: float = 0.0
    admit_t: float = 0.0
    first_token_t: float = 0.0       # TTFT reference: end of prefill
    finish_t: float = 0.0
    n_generated: int = 0
    # load shedding (DESIGN.md §12): a shed request never finishes —
    # ``shed_t`` set (with finish_t left 0) marks it for the SLO ledger's
    # first-class ``shed`` verdict
    shed_t: float = 0.0
    shed_reason: str = ""

    @property
    def queue_wait_s(self) -> float:
        return self.admit_t - self.enqueue_t

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.enqueue_t

    @property
    def tpot_s(self) -> float:
        """Mean time per output token after the first."""
        n = max(self.n_generated - 1, 1)
        return (self.finish_t - self.first_token_t) / n

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.enqueue_t


def _counter_property(attr):
    """Expose a registry counter as a ``+=``-able int attribute (the
    engine's accounting style predates the registry; keep it)."""

    def get(self):
        return getattr(self, attr).value

    def set_(self, v):
        getattr(self, attr).value = v

    return property(get, set_)


class EngineMetrics:
    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.tracer = tracer if tracer is not None else SpanTracer()
        self.requests: Dict[int, RequestTiming] = {}
        self.start_t: Optional[float] = None
        self.end_t: Optional[float] = None
        r = self.registry
        self._c_dispatches = r.counter("engine.dispatches")
        # batched prefill calls (each runs the target over every slot)
        # and prefix-cache tail dispatches (each a ragged multi-token
        # decode block over the slots that hit the cache)
        self._c_prefills = r.counter("engine.prefills")
        self._c_prefill_tails = r.counter("engine.prefill_tails")
        self._c_enqueued = r.counter("engine.requests_enqueued")
        self._c_finished = r.counter("engine.requests_finished")
        self._c_tokens = r.counter("engine.tokens_generated")
        # speculative decoding: rounds dispatched, drafts
        # proposed/accepted, per-slot verify dispatches and their total
        # fed-token budget (the tree/chain comparison currency: accepted
        # length PER verify dispatch at equal budget, DESIGN.md §8)
        self._c_spec_rounds = r.counter("spec.rounds")
        self._c_draft_proposed = r.counter("spec.draft_proposed")
        self._c_draft_accepted = r.counter("spec.draft_accepted")
        self._c_spec_slot_rounds = r.counter("spec.slot_rounds")
        self._c_spec_verify_tokens = r.counter("spec.verify_tokens")
        # decode-phase wall time + tokens -> mean inter-token latency
        # (the burst-aware latency speculative decoding actually changes:
        # TPOT per request divides by tokens arriving K+1 at a time)
        self._c_decode_time = r.counter("engine.decode_time_s")
        self._c_decode_tokens = r.counter("engine.decode_tokens")
        # resilience (DESIGN.md §12): sheds and preemptions are outcomes
        # a summary must account for, not silent drops
        self._c_shed = r.counter("engine.requests_shed")
        self._c_preemptions = r.counter("engine.preemptions")
        self._h_queue_wait = r.histogram("engine.queue_wait_ms")
        self._h_ttft = r.histogram("engine.ttft_ms")
        self._h_tpot = r.histogram("engine.tpot_ms")
        self._h_latency = r.histogram("engine.latency_ms")

    decode_steps = _counter_property("_c_dispatches")
    prefills = _counter_property("_c_prefills")
    prefill_tails = _counter_property("_c_prefill_tails")
    spec_rounds = _counter_property("_c_spec_rounds")
    draft_proposed = _counter_property("_c_draft_proposed")
    draft_accepted = _counter_property("_c_draft_accepted")
    spec_slot_rounds = _counter_property("_c_spec_slot_rounds")
    spec_verify_tokens = _counter_property("_c_spec_verify_tokens")
    decode_tokens = _counter_property("_c_decode_tokens")

    @property
    def decode_time_s(self) -> float:
        return self._c_decode_time.value

    def record_decode_segment(self, seconds: float, tokens: int) -> None:
        self._c_decode_time.value += seconds
        self._c_decode_tokens.inc(tokens)

    def record_spec_round(self, proposed: int, accepted: int,
                          slot_rounds: int = 0,
                          verify_tokens: int = 0) -> None:
        self._c_spec_rounds.inc()
        self._c_draft_proposed.inc(proposed)
        self._c_draft_accepted.inc(accepted)
        self._c_spec_slot_rounds.inc(slot_rounds)
        self._c_spec_verify_tokens.inc(verify_tokens)

    def now(self) -> float:
        return time.perf_counter()

    def record_enqueue(self, rid: int, t: Optional[float] = None) -> None:
        """``t`` backdates the enqueue to the request's true arrival
        (timed admission polls its source at scheduling boundaries, so
        submit can lag arrival) — queue wait and TTFT measure from it."""
        t = self.now() if t is None else t
        self.requests[rid] = RequestTiming(enqueue_t=t)
        self._c_enqueued.inc()
        if self.tracer.enabled:
            self.tracer.flow_point(rid, "enqueue", t=t)
            self.tracer.async_begin("queue_wait", rid, t=t)

    def record_admit(self, rid: int) -> None:
        t = self.now()
        rt = self.requests[rid]
        if rt.admit_t > 0:
            return       # re-admission after preemption: keep first admit
        rt.admit_t = t
        self._h_queue_wait.record(rt.queue_wait_s * 1e3)
        if self.tracer.enabled:
            self.tracer.async_end("queue_wait", rid, t=t)

    def record_first_token(self, rid: int, t: float) -> None:
        rt = self.requests[rid]
        if rt.first_token_t > 0:
            return       # resumed re-prefill: TTFT is the FIRST token
        rt.first_token_t = t
        self._h_ttft.record(rt.ttft_s * 1e3)

    def record_preempt(self, rid: int) -> None:
        self._c_preemptions.inc()
        if self.tracer.enabled:
            self.tracer.flow_point(rid, "preempt")

    def record_shed(self, rid: int, t: float, reason: str = "deadline") \
            -> None:
        """A queued request was dropped without service: marks the
        timing record so the SLO ledger emits a ``shed`` verdict."""
        rt = self.requests[rid]
        rt.shed_t = t
        rt.shed_reason = reason
        self._c_shed.inc()
        if self.tracer.enabled:
            self.tracer.async_end("queue_wait", rid, t=t)
            self.tracer.flow_point(rid, "shed", t=t, final=True)

    def record_finish(self, rid: int, t: float, n_generated: int) -> None:
        rt = self.requests[rid]
        rt.finish_t = t
        rt.n_generated = n_generated
        self._c_finished.inc()
        self._c_tokens.inc(n_generated)
        self._h_latency.record(rt.latency_s * 1e3)
        if n_generated > 1:
            self._h_tpot.record(rt.tpot_s * 1e3)
        if self.tracer.enabled:
            self.tracer.flow_point(rid, "finish", t=t, final=True)

    def run_started(self) -> None:
        if self.start_t is None:
            self.start_t = self.now()

    def run_finished(self) -> None:
        self.end_t = self.now()

    def summary(self) -> Dict[str, float]:
        toks = self._c_tokens.value
        dt = ((self.end_t or self.now()) - (self.start_t or 0.0)) \
            if self.start_t is not None else float("nan")
        proposed = self._c_draft_proposed.value
        slot_rounds = self._c_spec_slot_rounds.value
        return {
            "requests": self._c_finished.value,
            "shed": self._c_shed.value,
            "preemptions": self._c_preemptions.value,
            "tokens": toks,
            "seconds": dt,
            "tok_per_s": toks / max(dt, 1e-9),
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "prefill_tails": self.prefill_tails,
            "queue_wait_ms_p50": self._h_queue_wait.quantile(50),
            "queue_wait_ms_p99": self._h_queue_wait.quantile(99),
            "ttft_ms_p50": self._h_ttft.quantile(50),
            "ttft_ms_p99": self._h_ttft.quantile(99),
            "tpot_ms_p50": self._h_tpot.quantile(50),
            "tpot_ms_p99": self._h_tpot.quantile(99),
            "latency_ms_p50": self._h_latency.quantile(50),
            "latency_ms_p99": self._h_latency.quantile(99),
            "itl_ms_mean": (self.decode_time_s / self.decode_tokens * 1e3
                            if self.decode_tokens else float("nan")),
            "spec_rounds": self.spec_rounds,
            "draft_proposed": proposed,
            "draft_accepted": self.draft_accepted,
            "acceptance_rate": (self.draft_accepted / proposed
                                if proposed else float("nan")),
            # mean accepted DRAFTS per per-slot verify dispatch (the
            # emitted correction/bonus token is on top of this)
            "accepted_len_mean": (self.draft_accepted / slot_rounds
                                  if slot_rounds else float("nan")),
            "verify_tokens": self.spec_verify_tokens,
        }

    def format_summary(self) -> str:
        s = self.summary()
        line = (f"served {s['requests']} requests, {s['tokens']} tokens in "
                f"{s['seconds']:.2f}s -> {s['tok_per_s']:.1f} tok/s | "
                f"queue p50 {s['queue_wait_ms_p50']:.1f}ms "
                f"p99 {s['queue_wait_ms_p99']:.1f}ms | "
                f"TTFT p50 {s['ttft_ms_p50']:.1f}ms "
                f"p99 {s['ttft_ms_p99']:.1f}ms | "
                f"TPOT p50 {s['tpot_ms_p50']:.2f}ms "
                f"p99 {s['tpot_ms_p99']:.2f}ms | "
                f"latency p99 {s['latency_ms_p99']:.1f}ms")
        if self.spec_rounds:
            line += (f" | spec: {s['spec_rounds']} rounds, "
                     f"acceptance {s['acceptance_rate']:.0%}, "
                     f"accepted/verify {s['accepted_len_mean']:.2f}, "
                     f"ITL {s['itl_ms_mean']:.2f}ms")
        if s["shed"] or s["preemptions"]:
            line += (f" | resil: {int(s['shed'])} shed, "
                     f"{int(s['preemptions'])} preempted")
        return line

    def format_stats(self, interval=None) -> str:
        """One-line periodic snapshot for ``--stats-interval``: progress
        counters plus the live gauges other subsystems publish into the
        shared registry (queue depth, free pages, spec ladder).

        ``interval``: a ``(dt_s, counter_deltas)`` pair from a registry
        :class:`~repro_torch.engine.telemetry.SnapshotWindow` tick — appended
        as *interval rates* (tok/s, admissions/s over the window, not
        lifetime averages, which hide stalls on long runs)."""
        g = self.registry.gauge
        dt = (self.now() - self.start_t) if self.start_t else 0.0
        toks = self._c_tokens.value
        line = (f"t={dt:6.2f}s reqs {self._c_finished.value}"
                f"/{self._c_enqueued.value} toks {toks}"
                f" ({toks / max(dt, 1e-9):.1f}/s)"
                f" queue {int(g('sched.queue_depth').value)}"
                f" pages_free {int(g('kv.pages_free').value)}"
                f" dispatches {self.decode_steps}")
        if self.spec_rounds:
            p = self._c_draft_proposed.value
            acc = self._c_draft_accepted.value / p if p else float("nan")
            line += (f" spec_rounds {self.spec_rounds} accept {acc:.0%}"
                     f" rung {int(g('spec.ladder_rung').value)}")
        if interval is not None:
            dt_w, d = interval
            dt_w = max(dt_w, 1e-9)
            line += (f" | interval"
                     f" {d.get('engine.decode_tokens', 0) / dt_w:.1f} tok/s"
                     f" {d.get('sched.admissions', 0) / dt_w:.1f} adm/s"
                     f" {d.get('engine.dispatches', 0) / dt_w:.1f} disp/s")
        return line
