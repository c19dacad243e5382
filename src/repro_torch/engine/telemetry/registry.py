"""Metrics registry: counters, gauges and *streaming* histograms.

The registry is the engine's one shared sink for runtime signals —
page-pool occupancy, scheduler queue depth, spec-ladder state, jit
retraces — that scheduling policies (chunked prefill, adaptive
speculation, dynamic sparsity) read online and operators read as a
snapshot. Everything here is plain host arithmetic: a counter increment
is an int add, a gauge set is an assignment, a histogram record is one
``math.log`` plus a dict increment. Nothing ever touches a device array
or forces a sync, so metrics can be recorded inside the engine loop
without perturbing its dispatch structure (DESIGN.md §10).

:class:`StreamingHistogram` keeps log-spaced buckets instead of samples,
so TTFT/TPOT/latency quantiles over millions of requests cost O(buckets)
memory with a bounded *relative* error: ``quantile(q)`` returns the
geometric midpoint of the bucket holding the ``floor(q/100 * (n-1))``-th
order statistic (numpy's ``method="lower"`` rank), which is within a
``rel_error_bound`` multiplicative factor of that sample (pinned by a
property test in ``tests/test_telemetry.py``).
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple


class Counter:
    """Monotonic (by convention) accumulator. ``value`` is directly
    readable and writable — :class:`~repro_torch.engine.metrics.EngineMetrics`
    exposes some counters through ``+=``-able properties."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (queue depth, free pages,
    acceptance EWMA, ladder rung)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)


class StreamingHistogram:
    """Log-bucketed streaming histogram for non-negative samples.

    Bucket ``i`` covers ``[growth**i, growth**(i+1))``; values ``<= 0``
    land in an exact zero bucket (negative inputs are clamp-counted
    there, with their true value still folded into min/max/sum).
    ``quantile`` answers are clamped into ``[min, max]`` so degenerate
    streams (empty, single sample, all-equal) stay exact at the edges.
    """

    __slots__ = ("name", "growth", "_log_g", "_buckets", "_zero",
                 "count", "sum", "min", "max")

    def __init__(self, name: str = "", growth: float = 1.1):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1: {growth}")
        self.name = name
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def rel_error_bound(self) -> float:
        """Guaranteed multiplicative quantile error vs the underlying
        order statistic. The geometric-midpoint representative is within
        ``sqrt(growth)`` of any sample in its bucket; ``growth - 1``
        leaves margin for float fuzz at bucket boundaries."""
        return self.growth - 1.0

    def record(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self._zero += 1
        else:
            i = math.floor(math.log(v) / self._log_g)
            self._buckets[i] = self._buckets.get(i, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """Approximate ``q``-th percentile (0..100): the bucket
        representative of the ``floor(q/100 * (count-1))``-th order
        statistic — numpy's ``np.percentile(xs, q, method="lower")``
        rank — within :attr:`rel_error_bound` relative error of it."""
        if self.count == 0:
            return float("nan")
        rank = int(math.floor(q / 100.0 * (self.count - 1)))
        rank = min(max(rank, 0), self.count - 1)
        if rank < self._zero:
            # the zero bucket is exact for the non-negative contract;
            # clamp covers the (discouraged) negative-input case
            return float(min(max(0.0, self.min), self.max))
        cum = self._zero
        for i in sorted(self._buckets):
            c = self._buckets[i]
            if rank < cum + c:
                try:
                    rep = math.exp((i + 0.5) * self._log_g)
                except OverflowError:
                    rep = math.inf
                return float(min(max(rep, self.min), self.max))
            cum += c
        return float(self.max)

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean,
                "p50": self.quantile(50), "p90": self.quantile(90),
                "p99": self.quantile(99),
                "min": self.min if self.count else float("nan"),
                "max": self.max if self.count else float("nan")}


class SnapshotWindow:
    """Delta view over a registry's counters for *interval* reporting.

    Cumulative counters answer "since the run started"; a periodic
    stats line wants "since the last line" (a stalled engine looks
    healthy forever on lifetime totals). :meth:`tick` returns
    ``(dt_seconds, {counter_name: delta})`` since the previous tick
    (or construction), then advances the window. Gauges are already
    instantaneous and histograms cumulative by design — only counters
    need the delta treatment.
    """

    __slots__ = ("_reg", "_last_t", "_last")

    def __init__(self, registry: "MetricsRegistry"):
        self._reg = registry
        self._last_t = time.perf_counter()
        self._last: Dict[str, float] = {
            n: c.value for n, c in registry._counters.items()}

    def tick(self) -> Tuple[float, Dict[str, float]]:
        now = time.perf_counter()
        dt = now - self._last_t
        cur = {n: c.value for n, c in self._reg._counters.items()}
        deltas = {n: v - self._last.get(n, 0) for n, v in cur.items()}
        self._last, self._last_t = cur, now
        return dt, deltas


class MetricsRegistry:
    """Get-or-create registry of named counters/gauges/histograms.

    Handles are cached by name, so hot paths fetch them once at
    construction and pay only the increment afterwards; ad-hoc readers
    (the --stats-interval line, tests) can resolve by name at any time.
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, StreamingHistogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  growth: Optional[float] = None) -> StreamingHistogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = StreamingHistogram(
                name, growth if growth is not None else 1.1)
        return h

    def window(self) -> SnapshotWindow:
        """A counter-delta window starting now (interval rates for the
        periodic stats line)."""
        return SnapshotWindow(self)

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name: value}`` view (histograms expand to
        ``name.count/.mean/.p50/.p90/.p99``)."""
        out: Dict[str, float] = {}
        for n, c in self._counters.items():
            out[n] = c.value
        for n, g in self._gauges.items():
            out[n] = g.value
        for n, h in self._hists.items():
            for k, v in h.snapshot().items():
                out[f"{n}.{k}"] = v
        return out
