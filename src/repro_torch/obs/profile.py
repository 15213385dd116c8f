"""Opt-in device profiling around a mine.

:func:`profile` wraps a mining run in ``torch.profiler.profile`` (when a
dump directory is given: the run's activity is written there as a Chrome
trace, ``trace_<n>.json``, readable in Perfetto or ``chrome://tracing``)
and records device-health gauges either way:
executable-cache hit/miss deltas across the run, the run's
``peak_level_bytes``, its levels and wall time, and the placement device's
allocator figures (``torch.cuda.memory_allocated``,
``max_memory_allocated`` and ``memory_reserved``; zero on the CPU).

On a CUDA device the profiler records CUDA activity only (kernels, copies,
memsets and the runtime calls that launch them), not the host's torch ops,
whose recording would add its own host time to the window the trace shows.
On the CPU it records the CPU ops. The hand-written
kernels launch through ctypes, not as torch ops, so the trace lists them
under their CUDA symbol names (``intersect_indexed_kernel<...>``, the
kernels of ``coverage.cu``): match them by substring.

A profiler that cannot start or export does not fail the mine: its error is
logged, kept in ``ProfileRecord.error`` (the service puts it in the
request's ``info.profile_error``) and counted as ``profiler="failed"``.

    from repro_torch.obs import profile as obs_profile

    with obs_profile.profile(dump_dir="/tmp/prof", device=dev) as prof:
        result = mine(...)
        prof.set_result(result)
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from contextlib import contextmanager

__all__ = ["profile", "ProfileRecord"]

_seq = itertools.count()
_log = logging.getLogger(__name__)


class ProfileRecord:
    """Mutable handle the ``profile`` context yields; ``set_result`` feeds
    the mined ``MiningResult`` so the peak-memory and level gauges reflect
    the profiled run. ``trace_path`` names the written Chrome trace;
    ``wall_s`` runs from before the profiler starts to the end of the
    profiled body, ``start_s`` is the profiler's start within it, and
    ``export_s`` covers the profiler's stop, its event processing and the
    trace's write after it. ``error`` holds the
    profiler's own start or export error, if it had one."""

    def __init__(self, dump_dir: str | None):
        self.dump_dir = dump_dir
        self.result = None
        self.wall_s: float | None = None
        self.start_s = 0.0
        self.exec_cache_delta: dict | None = None
        self.profiler_active = False
        self.trace_path: str | None = None
        self.export_s: float | None = None
        self.device_memory: dict | None = None
        self.error: str | None = None

    def set_result(self, result) -> None:
        self.result = result


def _exec_totals():
    from ..core import exec_cache

    s = exec_cache.stats()
    return {"hits": s["hits"], "misses": s["misses"], "entries": s["entries"]}


def _device_memory(device) -> dict:
    """Allocator figures of a CUDA ``device`` in bytes; zeros elsewhere."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return {"allocated": 0, "max_allocated": 0, "reserved": 0}
    return {
        "allocated": int(torch.cuda.memory_allocated(device)),
        "max_allocated": int(torch.cuda.max_memory_allocated(device)),
        "reserved": int(torch.cuda.memory_reserved(device)),
    }


@contextmanager
def profile(dump_dir: str | None = None, *, device=None, registry=None):
    """Profile one mine. ``dump_dir`` enables the ``torch.profiler`` trace
    (CUDA activity when ``device`` is a CUDA device, else CPU activity);
    without it only the gauges are recorded. A profiler that cannot start or
    export records its error (``rec.error``) beside the gauges; errors of
    the profiled body propagate."""
    import torch

    from . import metrics as _m

    reg = registry or _m.REGISTRY
    g_wall = reg.gauge(
        "repro_profile_last_wall_seconds", "Wall time of the last profiled mine."
    )
    g_cache = reg.gauge(
        "repro_profile_exec_cache_delta",
        "Executable-cache activity during the last profiled mine.",
        ("event",),
    )
    g_peak = reg.gauge(
        "repro_profile_peak_level_bytes",
        "peak_level_bytes of the last profiled mine.",
    )
    g_levels = reg.gauge(
        "repro_profile_levels_retired", "Levels mined by the last profiled mine."
    )
    g_mem = reg.gauge(
        "repro_profile_device_memory_bytes",
        "Allocator figures of the placement's device after the last profiled mine.",
        ("stat",),
    )
    c_runs = reg.counter(
        "repro_profile_runs_total", "Profiled mines.", ("profiler",)
    )

    rec = ProfileRecord(dump_dir)
    before = _exec_totals()
    t0 = time.perf_counter()
    prof = None
    if dump_dir is not None:
        on_card = device is not None and torch.device(device).type == "cuda"
        act = torch.profiler.ProfilerActivity
        try:
            prof = torch.profiler.profile(activities=[act.CUDA if on_card else act.CPU])
            prof.__enter__()
            rec.profiler_active = True
            rec.start_s = time.perf_counter() - t0
        except Exception as exc:
            prof = None
            rec.error = f"start: {type(exc).__name__}: {exc}"
            _log.warning("profiler did not start: %s", rec.error)
    try:
        yield rec
    finally:
        rec.wall_s = time.perf_counter() - t0
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(dump_dir, exist_ok=True)
                path = os.path.join(dump_dir, f"trace_{os.getpid()}_{next(_seq)}.json")
                prof.export_chrome_trace(path)
                rec.trace_path = path
            except Exception as exc:
                rec.profiler_active = False
                rec.error = f"export: {type(exc).__name__}: {exc}"
                _log.warning("profiler trace not written: %s", rec.error)
            rec.export_s = time.perf_counter() - t0 - rec.wall_s
        after = _exec_totals()
        rec.exec_cache_delta = {k: after[k] - before[k] for k in after}
        rec.device_memory = _device_memory(device)
        g_wall.set(rec.wall_s)
        for event, delta in rec.exec_cache_delta.items():
            g_cache.set(delta, event=event)
        for stat, value in rec.device_memory.items():
            g_mem.set(value, stat=stat)
        if rec.result is not None:
            g_peak.set(getattr(rec.result, "peak_level_bytes", 0))
            g_levels.set(len(getattr(rec.result, "stats", ())))
        c_runs.inc(profiler="torch" if rec.profiler_active
                   else "failed" if rec.error else "off")
