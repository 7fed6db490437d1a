"""Serving-engine observability: metrics registry and request tracer.

- `repro_torch.obs.metrics` — a lightweight in-process metrics registry
  (counters, gauges, bucketed histograms) that the engine, scheduler,
  paged KV cache, and fused sampler publish into.  ``Engine.stats()``
  remains as a thin compat view over it.
- `repro_torch.obs.trace` — a per-request span tracer (queued -> prefill
  chunks -> decode ticks -> preempt/recompute -> finish, with COW
  copies and sampler dispatches as child events) with near-zero
  overhead when disabled and a Chrome trace-event JSON exporter
  viewable in Perfetto (https://ui.perfetto.dev).
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricView, MetricsRegistry,
    diff_snapshots)
from repro_torch.obs.trace import ENGINE_PID, REQUEST_PID, Tracer  # noqa: F401
