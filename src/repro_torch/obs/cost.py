"""Per-request cost accounting (stdlib leaf).

Aggregate histograms say mining is *sometimes* slow; operators need
to know **which request** was expensive and **why**. A
:class:`CostEnvelope` rides the request context (the same
``contextvars.copy_context()`` hop the tracer uses across the scheduler's
worker thread), and the existing span seams fold their counters into it:
``core/frontier.py`` adds per-level candidate pairs / rows scanned / bytes,
``core/placement.py`` adds device dispatches, the service adds
compile-vs-reuse executable deltas and the cache path taken. The finished
envelope is attached to every ``/mine`` response under ``info.cost``,
observed into per-path histogram families, and — when wall time crosses
``--slow-mine-threshold-s`` — appended to the ring-buffered
:class:`SlowMineLog` served at ``GET /debug/slowlog``.

Zero-cost discipline: without an attached envelope, :func:`add` is one
ContextVar read and a ``None`` check — library callers that never attach
pay nothing (same contract as ``obs.trace``).
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from contextlib import contextmanager

from . import metrics as _om

__all__ = [
    "CostEnvelope",
    "SlowMineLog",
    "attach",
    "add",
    "note",
    "current",
    "publish",
    "SLOW_MINES",
]

_CTX: "contextvars.ContextVar[CostEnvelope | None]" = contextvars.ContextVar(
    "repro_torch_obs_cost", default=None
)

_COST_PAIRS = _om.histogram(
    "repro_mine_cost_candidate_pairs",
    "Candidate pairs generated per mine request, by serving path.",
    ("path",),
    buckets=_om.COUNT_BUCKETS,
)
_COST_ROWS = _om.histogram(
    "repro_mine_cost_rows_scanned",
    "Row-support scans per mine request (rows x levels), by serving path.",
    ("path",),
    buckets=_om.COUNT_BUCKETS,
)
_COST_BYTES = _om.histogram(
    "repro_mine_cost_device_bytes",
    "Device bytes moved per mine request, by serving path.",
    ("path",),
    buckets=_om.BYTE_BUCKETS,
)
SLOW_MINES = _om.counter(
    "repro_slow_mines_total",
    "Mine requests slower than the slow-mine threshold.",
    ("path",),
)


class CostEnvelope:
    """Accumulates one request's resource counters. Thread-safe: the
    scheduler worker and the submitting thread share the same object."""

    _FIELDS = (
        "rows_scanned",
        "candidate_pairs",
        "device_bytes",
        "device_dispatches",
        "levels",
        "itemsets_emitted",
        "executables_compiled",
        "executables_reused",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self.t0 = time.perf_counter()
        self.wall_s = 0.0
        self.device_s = 0.0
        # serving path: cold | incremental | approx | refined | cached
        self.path = "unknown"
        self.trace_id: str | None = None
        self._counters = dict.fromkeys(self._FIELDS, 0)
        self._notes: dict = {}

    def add(self, **counters) -> None:
        with self._lock:
            for k, v in counters.items():
                if k not in self._counters:
                    raise KeyError(f"unknown cost counter {k!r}")
                self._counters[k] += int(v)

    def add_device_time(self, seconds: float) -> None:
        with self._lock:
            self.device_s += float(seconds)

    def note(self, **fields) -> None:
        """Attach non-additive facts (path, dataset version, epsilon...)."""
        with self._lock:
            for k, v in fields.items():
                if k == "path":
                    self.path = str(v)
                elif k == "trace_id":
                    self.trace_id = v
                else:
                    self._notes[k] = v

    def finish(self) -> "CostEnvelope":
        self.wall_s = time.perf_counter() - self.t0
        return self

    def to_dict(self) -> dict:
        with self._lock:
            d = dict(self._counters)
            d.update(self._notes)
            d["path"] = self.path
            d["wall_s"] = round(self.wall_s, 6)
            d["device_s"] = round(self.device_s, 6)
            if self.trace_id:
                d["trace_id"] = self.trace_id
            return d

    def __getitem__(self, key: str) -> int:
        with self._lock:
            return self._counters[key]


@contextmanager
def attach(envelope: "CostEnvelope | None" = None):
    """Bind an envelope to the current context; the same object is visible
    across the scheduler hop (``contextvars.copy_context()`` copies the
    binding, not the envelope). Yields the bound envelope."""
    env = envelope if envelope is not None else CostEnvelope()
    token = _CTX.set(env)
    try:
        yield env
    finally:
        _CTX.reset(token)


def current() -> CostEnvelope | None:
    return _CTX.get()


def add(**counters) -> None:
    """Fold counters into the request's envelope; no-op without one."""
    env = _CTX.get()
    if env is not None:
        env.add(**counters)


def note(**fields) -> None:
    env = _CTX.get()
    if env is not None:
        env.note(**fields)


def publish(env: CostEnvelope) -> None:
    """Observe a finished envelope into the per-path cost histograms, with
    the owning trace_id as the Prometheus exemplar."""
    ex = {"trace_id": env.trace_id} if env.trace_id else None
    _COST_PAIRS.observe(env["candidate_pairs"], exemplar=ex, path=env.path)
    _COST_ROWS.observe(env["rows_scanned"], exemplar=ex, path=env.path)
    _COST_BYTES.observe(env["device_bytes"], exemplar=ex, path=env.path)


class SlowMineLog:
    """Ring buffer of the slowest / threshold-crossing mine envelopes."""

    def __init__(self, threshold_s: float = 1.0, maxlen: int = 64):
        self.threshold_s = float(threshold_s)
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(1, int(maxlen)))
        self.total = 0

    def offer(self, env: CostEnvelope, **extra) -> bool:
        """Record the envelope if it crossed the threshold. Returns whether
        it was recorded."""
        if env.wall_s < self.threshold_s:
            return False
        entry = env.to_dict()
        entry["at"] = time.time()
        entry.update(extra)
        with self._lock:
            self._ring.append(entry)
            self.total += 1
        SLOW_MINES.inc(path=env.path)
        return True

    def entries(self, n: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self._ring)
        if n is not None:
            out = out[-max(0, int(n)):]
        return out[::-1]  # newest first

    def stats(self) -> dict:
        with self._lock:
            return {
                "threshold_s": self.threshold_s,
                "stored": len(self._ring),
                "maxlen": self._ring.maxlen,
                "total": self.total,
            }
