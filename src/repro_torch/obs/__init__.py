"""Spans and metrics for the port: its own minimal copy of what the mining
path records (no cost envelope, flight recorder or logs yet)."""

from . import metrics, trace
from .metrics import counter, gauge, histogram
from .trace import TRACER, device_sync, span, start_trace

__all__ = [
    "metrics",
    "trace",
    "counter",
    "gauge",
    "histogram",
    "TRACER",
    "device_sync",
    "span",
    "start_trace",
]
