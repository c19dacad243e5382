"""Phase-span tracer with Chrome trace-event export (Perfetto-loadable).

The engine loop is host-driven and syncs only at segment boundaries
(DESIGN.md §3), so the tracer records two honest kinds of host span:

* spans that END at an existing device sync (``prefill``,
  ``decode_segment``/``spec_segment``, ``sync``) measure *completed
  device work* — the same convention ``EngineMetrics`` timestamps use;
* spans inside a segment (``draft``, ``verify`` rounds) bracket only the
  *dispatch* — they carry ``cat: "dispatch"`` so a trace reader knows
  the device work completes later, at the segment's ``sync`` span.

The tracer NEVER forces a sync of its own: enabling it changes
timestamps taken, not the dispatch structure.

Per-request *flow events* (``ph: s/t/f``, one id per request) tie a
request's enqueue -> prefill -> decode segments -> finish across slices,
and its queue wait is an async ``b``/``e`` pair on the request track —
both render as arrows/tracks in Perfetto (load the JSON at
https://ui.perfetto.dev or chrome://tracing).

When disabled (the default), every hook returns a shared no-op span and
records nothing — zero per-segment overhead beyond one attribute check.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

from torch.profiler import record_function as _TraceAnnotation

# thread ids of the exported trace (one process, two logical tracks)
TID_ENGINE = 0
TID_REQUESTS = 1


class _NullSpan:
    """Shared no-op span: context manager + ``set()`` sink. Returned by
    every tracer hook when tracing is off so call sites never branch."""

    __slots__ = ()
    t0 = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """Live span: ``set(**args)`` attaches args (token counts etc.) any
    time before exit; the complete event is recorded on ``__exit__``."""

    __slots__ = ("_tr", "name", "tid", "cat", "args", "t0")

    def __init__(self, tracer: "SpanTracer", name: str, tid: int, cat: str,
                 args: Optional[dict]):
        self._tr = tracer
        self.name = name
        self.tid = tid
        self.cat = cat
        self.args = dict(args) if args else {}
        self.t0 = 0.0

    def set(self, **args):
        self.args.update(args)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tr.record_span(self.name, self.t0, time.perf_counter(),
                             tid=self.tid, cat=self.cat, args=self.args)
        return False


class SpanTracer:
    def __init__(self, enabled: bool = False,
                 annotate_device: Optional[bool] = None):
        self.enabled = bool(enabled)
        # torch.profiler.record_function wrapping of the step dispatches:
        # rides the same flag by default so host spans and device traces
        # line up whenever a trace is being taken, and costs nothing
        # when off (the profiler hooks are never constructed)
        self.annotate_device = (self.enabled if annotate_device is None
                                else bool(annotate_device))
        self._t0 = time.perf_counter()
        self.events: List[dict] = []
        self._flow_seen: set = set()

    # -- time -----------------------------------------------------------

    @property
    def origin(self) -> float:
        """The perf_counter timestamp of the trace's t=0 — readers
        correlating trace ``ts`` values with engine timestamps (the SLO
        ledger's interference attribution) subtract this."""
        return self._t0

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    # -- host spans -----------------------------------------------------

    def span(self, name: str, tid: int = TID_ENGINE, cat: str = "phase",
             **args):
        """Context manager recording one complete ('X') event."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, tid, cat, args)

    def record_span(self, name: str, t_start: float, t_end: float,
                    tid: int = TID_ENGINE, cat: str = "phase",
                    args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": self._us(t_start),
            "dur": max(self._us(t_end) - self._us(t_start), 0.0),
            "pid": 0, "tid": tid, "args": args or {}})

    def instant(self, name: str, tid: int = TID_ENGINE, **args) -> None:
        if not self.enabled:
            return
        self.events.append({"name": name, "cat": "phase", "ph": "i",
                            "ts": self._us(time.perf_counter()), "pid": 0,
                            "tid": tid, "s": "t", "args": args})

    # -- per-request flow + async events --------------------------------

    def flow_point(self, rid: int, phase: str, t: Optional[float] = None,
                   final: bool = False) -> None:
        """One flow event on request ``rid``'s arrow: first call is the
        flow start ('s'), later ones steps ('t'), ``final=True`` the
        finish ('f') — Perfetto draws the request's arrow through every
        slice these land in."""
        if not self.enabled:
            return
        ph = "f" if final else ("t" if rid in self._flow_seen else "s")
        self._flow_seen.add(rid)
        ev = {"name": "request", "cat": "request", "ph": ph, "id": rid,
              "ts": self._us(t if t is not None else time.perf_counter()),
              "pid": 0, "tid": TID_ENGINE, "args": {"phase": phase}}
        if final:
            ev["bp"] = "e"
        self.events.append(ev)

    def async_begin(self, name: str, aid: int,
                    t: Optional[float] = None) -> None:
        """Async ('b'/'e') spans overlap freely — used for per-request
        phases (queue_wait) that can't nest on one thread track."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": "request", "ph": "b", "id": aid,
            "ts": self._us(t if t is not None else time.perf_counter()),
            "pid": 0, "tid": TID_REQUESTS, "args": {}})

    def async_end(self, name: str, aid: int,
                  t: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self.events.append({
            "name": name, "cat": "request", "ph": "e", "id": aid,
            "ts": self._us(t if t is not None else time.perf_counter()),
            "pid": 0, "tid": TID_REQUESTS, "args": {}})

    # -- device-trace annotation ----------------------------------------

    def annotate(self, name: str):
        """``torch.profiler.record_function`` around a dispatch so device
        profiler traces carry the engine's phase names. No-op (shared
        null span, nothing constructed) unless device annotation is on."""
        if not (self.enabled and self.annotate_device
                and _TraceAnnotation is not None):
            return NULL_SPAN
        return _TraceAnnotation(name)

    # -- reading / export -----------------------------------------------

    def phase_totals(self) -> Dict[str, Dict[str, float]]:
        """Aggregate the complete events: ``{name: {ms, count}}`` — the
        Table-6-style stage breakdown benchmarks emit per run."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events:
            if ev.get("ph") != "X":
                continue
            d = out.setdefault(ev["name"], {"ms": 0.0, "count": 0})
            d["ms"] += ev["dur"] / 1e3
            d["count"] += 1
        return out

    def export(self, path) -> Path:
        """Write Chrome trace-event JSON: ``{"traceEvents": [...]}`` with
        process/thread name metadata. Loadable by Perfetto as-is."""
        meta = [
            {"ph": "M", "pid": 0, "tid": TID_ENGINE, "name": "process_name",
             "args": {"name": "repro-engine"}},
            {"ph": "M", "pid": 0, "tid": TID_ENGINE, "name": "thread_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": 0, "tid": TID_REQUESTS, "name": "thread_name",
             "args": {"name": "requests"}},
        ]
        path = Path(path)
        path.write_text(json.dumps(
            {"traceEvents": meta + self.events, "displayTimeUnit": "ms"}))
        return path
