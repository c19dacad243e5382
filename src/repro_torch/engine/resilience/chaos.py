"""Deterministic chaos injection for the serving engine (DESIGN.md §12.3).

Every fault the engine claims to survive must be *producible on demand*,
or the recovery path rots untested. This module injects four named,
rate-parameterized fault classes at the engine's existing decision
points:

* ``alloc_fail``  — transient KV-page allocation failure: the admission
  reservation (:meth:`PagedKVCache.assign`) raises
  :class:`TransientAllocFailure` before touching the free list, so the
  scheduler sees exactly the backpressure a fragmented/raced allocator
  would produce and the head request retries at a later boundary.
* ``latency``     — a latency spike at the dispatch boundary (a host
  sleep before the segment/prefill dispatch), modelling a slow host,
  GC pause or contended interconnect.
* ``device_err``  — a simulated device error raised at the dispatch
  boundary (:class:`ChaosDeviceError`); the engine retries with the
  bounded-backoff discipline of ``dist.fault.retrying``. Because every
  jitted step is functional (state is assigned only from its returns),
  a pre-dispatch failure is always safely retryable.
* ``nan_logits``  — a poisoned sampler (NaN/Inf logits) for one slot's
  decode segment: the engine drops that segment's tokens for the slot,
  *quarantines* the slot for a few boundaries and re-enqueues the
  request for lossless recompute (DESIGN.md §12.1).

Seeding contract: one master seed, one independent
``np.random.Generator`` stream per fault class (spawned from the master
``SeedSequence`` in ``FAULTS`` order). Faults are drawn one Bernoulli
trial per *injection-point visit*, never per wall-clock tick, so a run
whose scheduling decisions are wall-clock-free (the offline
submit-everything path) replays **bit-identically**: same seed, same
faults, same preemptions, same tokens — pinned by test and by the CI
chaos smoke. A fault class with rate 0 draws nothing, and streams are
independent, so enabling one fault never perturbs another's sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

FAULTS = ("alloc_fail", "latency", "device_err", "nan_logits")


class TransientAllocFailure(RuntimeError):
    """Injected transient KV-page allocation failure (retryable)."""


class ChaosDeviceError(RuntimeError):
    """Injected device error at a dispatch boundary (retryable)."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Rates are per injection-point visit (Bernoulli). Frozen (and
    therefore hashable) so it can ride inside ``EngineConfig``."""
    alloc_fail: float = 0.0
    latency: float = 0.0
    device_err: float = 0.0
    nan_logits: float = 0.0
    seed: int = 0
    latency_spike_s: float = 0.002      # injected sleep per latency fault
    device_max_retries: int = 4         # attempts before giving up
    device_backoff_s: float = 0.0       # exponential backoff base (host)
    quarantine_boundaries: int = 2      # slot cooldown after nan_logits

    def __post_init__(self):
        for f in FAULTS:
            r = getattr(self, f)
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"chaos rate {f}={r} outside [0, 1]")
        if self.device_max_retries < 1:
            raise ValueError("device_max_retries must be >= 1")

    @property
    def enabled(self) -> bool:
        return any(getattr(self, f) > 0.0 for f in FAULTS)

    @classmethod
    def parse(cls, arg: str, seed: int = 0) -> "ChaosConfig":
        """``alloc_fail=0.05,latency=0.02`` — any subset of fault rates,
        plus the optional knobs ``latency_spike_ms``, ``retries``,
        ``backoff_ms`` and ``quarantine``. ``seed`` is the master chaos
        seed (the serve CLI passes ``--seed`` through)."""
        vals: Dict[str, float] = {}
        for item in arg.split(","):
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"--chaos wants k=v items, got {item!r}")
            k, v = item.split("=", 1)
            k = k.strip()
            if k in FAULTS:
                vals[k] = float(v)
            elif k == "latency_spike_ms":
                vals["latency_spike_s"] = float(v) / 1e3
            elif k == "retries":
                vals["device_max_retries"] = int(v)
            elif k == "backoff_ms":
                vals["device_backoff_s"] = float(v) / 1e3
            elif k == "quarantine":
                vals["quarantine_boundaries"] = int(v)
            else:
                raise ValueError(f"unknown chaos fault {k!r} "
                                 f"(want {'/'.join(FAULTS)})")
        if not vals:
            raise ValueError("empty --chaos spec")
        return cls(seed=seed, **vals)


class ChaosInjector:
    """Seeded fault source shared by every injection point of one engine.

    One master seed fans out into one independent rng stream per fault
    class (``SeedSequence.spawn`` in ``FAULTS`` order), so the trial
    sequence each injection point sees depends only on the master seed
    and on how many times *that* point was visited — the replay
    invariant the chaos smoke pins. Injection counts are published into
    the shared telemetry registry as ``chaos.<fault>`` counters.
    """

    def __init__(self, cfg: ChaosConfig, registry=None):
        self.cfg = cfg
        children = np.random.SeedSequence(cfg.seed).spawn(len(FAULTS))
        self._rngs = {f: np.random.default_rng(ss)
                      for f, ss in zip(FAULTS, children)}
        self._counters = {}
        if registry is not None:
            self._counters = {f: registry.counter(f"chaos.{f}")
                              for f in FAULTS}
            self._c_retries = registry.counter("chaos.device_retries")
        else:
            self._c_retries = None

    def fires(self, fault: str) -> bool:
        """One Bernoulli trial on ``fault``'s stream. Rate-0 faults draw
        nothing (their stream stays untouched)."""
        rate = getattr(self.cfg, fault)
        if rate <= 0.0:
            return False
        hit = float(self._rngs[fault].random()) < rate
        if hit and fault in self._counters:
            self._counters[fault].inc()
        return hit

    def latency_spike_s(self) -> float:
        """Sleep seconds to inject at this dispatch boundary (0 = none)."""
        return self.cfg.latency_spike_s if self.fires("latency") else 0.0

    def count_retry(self) -> None:
        if self._c_retries is not None:
            self._c_retries.inc()

    def snapshot(self) -> Dict[str, int]:
        """Injected-fault counts so far (replay pin surface)."""
        return {f: int(c.value) for f, c in self._counters.items()}


def make_injector(cfg: Optional[ChaosConfig], registry=None) \
        -> Optional[ChaosInjector]:
    """None when chaos is absent or all rates are 0 — the engine's hot
    path stays injection-free unless faults were asked for."""
    if cfg is None or not cfg.enabled:
        return None
    return ChaosInjector(cfg, registry=registry)
