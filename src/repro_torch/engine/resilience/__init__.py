"""Overload resilience for the serving engine (DESIGN.md §12).

Three capabilities that turn the capacity cliff from a collapse into a
slope:

* **preempt-and-recompute** — KV-pressure preemption with lossless
  resume: a victim's pages return to the pool, its generated tokens
  fold into its prompt, and a later re-prefill continues it exactly
  where it stopped (greedy outputs bit-identical to the unpreempted
  run, pinned by test).
* **deadline-aware admission + shedding** — requests carry optional
  TTFT deadlines; queue entries that provably cannot meet them are
  shed before prefill is dispatched and become first-class SLO
  verdicts (``shed`` vs ``miss`` vs ``met``). Under pool pressure the
  spec ladder degrades (full tree -> chain K=1 -> non-spec) to shrink
  lookahead reservations before any preemption fires.
* **deterministic chaos injection** — seeded, rate-parameterized fault
  classes (transient alloc failure, latency spikes, simulated device
  errors with retry/backoff, NaN-logit slot quarantine) that replay
  bit-identically at a fixed seed, so every recovery path is testable
  on demand.
"""
from repro_torch.engine.resilience.chaos import (ChaosConfig, ChaosDeviceError,
                                           ChaosInjector, FAULTS,
                                           TransientAllocFailure,
                                           make_injector)
from repro_torch.engine.resilience.policy import (PRESSURE_CRITICAL,
                                            PRESSURE_ELEVATED, PRESSURE_OK,
                                            OversizedRequest,
                                            RejectedRequest,
                                            ResilienceConfig,
                                            choose_victims, pressure_level)

__all__ = ["ChaosConfig", "ChaosInjector", "ChaosDeviceError",
           "TransientAllocFailure", "FAULTS", "make_injector",
           "ResilienceConfig", "RejectedRequest", "OversizedRequest",
           "choose_victims", "pressure_level", "PRESSURE_OK",
           "PRESSURE_ELEVATED", "PRESSURE_CRITICAL"]
