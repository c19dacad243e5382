"""Continuous-batching inference engine, plain path (DESIGN.md §3).

Paged KV cache + task-centric scheduler + batched prefill / fused decode
on top of the GQSA-compressed model::

    from repro_torch.engine import InferenceEngine, EngineConfig
    eng = InferenceEngine(cfg, params, EngineConfig(num_slots=4))
    eng.submit(prompt_tokens, max_new_tokens=32)
    results = eng.run()
"""
from repro_torch.engine.engine import EngineConfig, InferenceEngine
from repro_torch.engine.kv_cache import PageAllocator, PagedKVCache
from repro_torch.engine.metrics import EngineMetrics
from repro_torch.engine.resilience import (OversizedRequest, RejectedRequest,
                                           ResilienceConfig)
from repro_torch.engine.sampling import SamplingParams, sample
from repro_torch.engine.scheduler import Request, Scheduler
from repro_torch.engine.telemetry import (MetricsRegistry, SpanTracer,
                                          StreamingHistogram, Telemetry)

__all__ = ["EngineConfig", "InferenceEngine", "PageAllocator",
           "PagedKVCache", "EngineMetrics", "SamplingParams", "sample",
           "Request", "Scheduler", "Telemetry", "MetricsRegistry",
           "SpanTracer", "StreamingHistogram", "ResilienceConfig",
           "RejectedRequest", "OversizedRequest"]
