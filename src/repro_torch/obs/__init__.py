"""Observability for the port: metrics, traces, structured logs, per-request
cost accounting, and the opt-in profiler shim.

* :mod:`metrics` — the process-wide registry of counters, gauges and
  fixed-log-bucket histograms; rendered as Prometheus text on
  ``GET /metrics`` and snapshotted into ``/stats``.
* :mod:`trace` — contextvar-propagated span trees per request, served by
  ``GET /trace``.
* :mod:`cost` — the per-request ``CostEnvelope`` and the slow-mine log.
* :mod:`logs` — structured (optionally JSON) logging carrying the active
  ``trace_id``.
* :mod:`profile` — ``torch.profiler`` tracing and device-memory gauges
  around a mine (imported on use: it imports torch).

Import discipline: this package is a leaf like ``core/exec_cache.py`` —
nothing in it imports the rest of ``repro_torch`` at module scope.
"""

from . import cost, logs, metrics, trace
from .cost import CostEnvelope, SlowMineLog
from .metrics import REGISTRY, counter, gauge, histogram, lint_exposition
from .trace import TRACER, current_trace_id, device_sync, span, start_trace

__all__ = [
    "cost",
    "logs",
    "metrics",
    "trace",
    "CostEnvelope",
    "SlowMineLog",
    "REGISTRY",
    "TRACER",
    "counter",
    "gauge",
    "histogram",
    "lint_exposition",
    "current_trace_id",
    "device_sync",
    "span",
    "start_trace",
]
