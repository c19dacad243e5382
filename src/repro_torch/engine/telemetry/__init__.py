"""Engine observability layer (DESIGN.md §10).

Three pieces, one facade:

* :class:`SpanTracer` — named phase spans at the engine's existing sync
  points, exported as Chrome trace-event JSON (Perfetto-loadable), with
  per-request flow events tying enqueue -> prefill -> segments -> finish
  together across slices.
* :class:`MetricsRegistry` — counters, gauges and streaming log-bucketed
  histograms (quantiles without storing samples) shared by the KV cache,
  scheduler, spec ladder and :class:`~repro_torch.engine.metrics.EngineMetrics`.
* profiler hooks — ``tracer.annotate`` wraps step dispatches in
  ``torch.profiler.record_function`` so device traces line up with the
  host spans.

Everything is off by default and adds no device syncs either way::

    from repro_torch.engine import InferenceEngine, EngineConfig
    from repro_torch.engine.telemetry import Telemetry
    tel = Telemetry(trace=True, stats_interval_s=5.0)
    eng = InferenceEngine(cfg, params, EngineConfig(), telemetry=tel)
    ...
    eng.run()
    tel.tracer.export("trace.json")     # -> ui.perfetto.dev
    tel.registry.snapshot()             # -> {name: value}
"""
from __future__ import annotations

import math
import time
from typing import Optional

from repro_torch.engine.telemetry.registry import (Counter, Gauge, MetricsRegistry,
                                             SnapshotWindow,
                                             StreamingHistogram)
from repro_torch.engine.telemetry.tracer import (NULL_SPAN, SpanTracer, TID_ENGINE,
                                           TID_REQUESTS)


class Telemetry:
    """The engine's observability bundle: one tracer + one registry +
    the periodic-stats policy. The default construction is fully
    disabled tracing with a live (but unexported) registry — counters
    and gauges are cheap enough to always record."""

    def __init__(self, trace: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 stats_interval_s: float = 0.0,
                 annotate_device: Optional[bool] = None):
        self.tracer = SpanTracer(enabled=trace,
                                 annotate_device=annotate_device)
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.stats_interval_s = float(stats_interval_s)
        # first boundary after enabling always emits one line (so short
        # runs still produce a stats line for smoke tests)
        self._last_stats = -math.inf
        # counter-delta window so periodic lines report interval rates
        # (tok/s, admissions/s since the previous line), not lifetime
        # cumulative averages that flatten stalls away
        self._window = self.registry.window() if self.stats_interval_s \
            else None

    def maybe_stats(self, metrics) -> None:
        """Called by the engine at segment boundaries: emit a one-line
        stats snapshot every ``stats_interval_s`` seconds of wall time
        (0 disables; never syncs — reads host counters only)."""
        if not self.stats_interval_s:
            return
        now = time.perf_counter()
        if now - self._last_stats >= self.stats_interval_s:
            self._last_stats = now
            print("[stats] " + metrics.format_stats(
                interval=self._window.tick()), flush=True)


__all__ = ["Telemetry", "SpanTracer", "MetricsRegistry", "Counter",
           "Gauge", "StreamingHistogram", "SnapshotWindow", "NULL_SPAN",
           "TID_ENGINE", "TID_REQUESTS"]
