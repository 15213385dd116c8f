"""Structural tracing for mining requests (stdlib only, apart from the
CUDA synchronisation in :func:`device_sync` — this module is a leaf).

A :class:`Trace` is one request's tree of :class:`Span` intervals
(trace_id / span_id / parent_id, wall-clock timing via ``perf_counter``),
threaded through ``MiningService`` → scheduler → ``mine_levels``'s
level/batch loop → placement dispatch and the WAL/snapshot path by plain
``with span("name"):`` blocks at the sites that already keep stage clocks.
Trace context propagates through ``contextvars`` — across the scheduler's
worker-thread hop via ``contextvars.copy_context()`` (see
``repro_torch.service.scheduler``).

When no trace is active every ``span(...)`` is a no-op costing one
context-variable read, so library callers that never start a trace pay
nothing. Finished traces land in a ring buffer (:meth:`Tracer.last` /
:meth:`Tracer.get`) served by ``GET /trace``.

Optional device-sync timing: :func:`device_sync` blocks on device arrays
inside a span *only* when ``TRACER.sync_devices`` is enabled, so a span's
wall time then includes the device work it dispatched (off by default —
syncing defeats the double-buffered pipeline and is a debugging mode).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

__all__ = [
    "Span",
    "Trace",
    "Tracer",
    "TRACER",
    "span",
    "start_trace",
    "current_trace_id",
    "current_span",
    "device_sync",
]

_CTX: "contextvars.ContextVar[tuple | None]" = contextvars.ContextVar(
    "repro_torch_obs_trace", default=None
)  # (Trace, Span) of the innermost open span

_ids = itertools.count(1)


def _new_span_id() -> str:
    return f"{next(_ids):08x}"


class Span:
    """One timed interval in a trace tree."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1", "attrs")

    def __init__(self, trace_id: str, parent_id: str | None, name: str,
                 attrs: dict | None = None):
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.t0 = time.perf_counter()
        self.t1: float | None = None
        self.attrs = attrs or {}

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else time.perf_counter()) - self.t0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.t0,
            "duration_s": self.duration,
            "attrs": dict(self.attrs),
        }


class Trace:
    """One request's span tree. ``spans`` holds finished spans in
    completion order (a flat list; :meth:`tree` rebuilds nesting)."""

    def __init__(self, trace_id: str, name: str, meta: dict | None = None):
        self.trace_id = trace_id
        self.name = name
        self.meta = meta or {}
        self.started_at = time.time()
        self.spans: list[Span] = []
        self.root: Span | None = None
        # ring position, assigned when the finished trace is appended to the
        # Tracer's buffer — the stable cursor `GET /trace?before=` pages on
        self.seq: int | None = None
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def find(self, name: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def children_of(self, span: Span) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.parent_id == span.span_id]

    def coverage(self, span: Span | None = None) -> float:
        """Fraction of ``span``'s (default: root's) wall time covered by its
        direct children — the "is the tree accounting for the run" metric."""
        top = span or self.root
        if top is None or not top.duration:
            return 0.0
        covered = sum(s.duration for s in self.children_of(top))
        return min(1.0, covered / top.duration)

    def _node(self, span: Span, by_parent: dict) -> dict:
        kids = by_parent.get(span.span_id, [])
        d = span.to_dict()
        d["self_time_s"] = max(0.0, span.duration - sum(k.duration for k in kids))
        d["children"] = [self._node(k, by_parent) for k in kids]
        return d

    def to_dict(self) -> dict:
        with self._lock:
            spans = list(self.spans)
        by_parent: dict[str | None, list[Span]] = {}
        for s in spans:
            by_parent.setdefault(s.parent_id, []).append(s)
        for kids in by_parent.values():
            kids.sort(key=lambda s: s.t0)
        roots = by_parent.get(None, [])
        return {
            "trace_id": self.trace_id,
            "seq": self.seq,
            "name": self.name,
            "started_at": self.started_at,
            "meta": dict(self.meta),
            "n_spans": len(spans),
            "duration_s": self.root.duration if self.root is not None else None,
            "coverage": self.coverage(),
            "spans": [self._node(r, by_parent) for r in roots],
        }


class _NullSpan:
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Trace lifecycle + the finished-trace ring buffer."""

    def __init__(self, max_traces: int = 64, sample_every: int = 1):
        self._lock = threading.Lock()
        self._traces: deque[Trace] = deque(maxlen=max_traces)
        self.sample_every = max(1, int(sample_every))
        self.sync_devices = False
        self._started = 0
        self._sampled_out = 0
        self._appended = 0  # monotone: doubles as the per-trace seq cursor
        self._dropped = 0  # traces evicted from the ring by newer arrivals
        # span-lifecycle listeners (the flight recorder): fn(event, span,
        # trace) with event "open" | "close". Zero-cost when empty — span()
        # only pays a truthiness check. Listener errors are swallowed; the
        # traced code must never fail because a recorder did.
        self._listeners: list = []

    def configure(self, *, max_traces: int | None = None,
                  sample_every: int | None = None,
                  sync_devices: bool | None = None) -> None:
        with self._lock:
            if max_traces is not None:
                self._traces = deque(self._traces, maxlen=max(1, int(max_traces)))
            if sample_every is not None:
                self.sample_every = max(1, int(sample_every))
            if sync_devices is not None:
                self.sync_devices = bool(sync_devices)

    # -- listeners -----------------------------------------------------------

    def add_listener(self, fn) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, event: str, sp: Span, trace: Trace) -> None:
        for fn in list(self._listeners):
            try:
                fn(event, sp, trace)
            except Exception:
                pass

    # -- lifecycle -----------------------------------------------------------

    @contextmanager
    def start(self, name: str, trace_id: str | None = None, meta: dict | None = None):
        """Open a trace with a root span of the same name. If a trace is
        already active on this context, nest a plain child span instead (the
        outer request owns the trace). Deterministic 1-in-N sampling applies
        only to fresh roots."""
        if _CTX.get() is not None:
            with self.span(name) as sp:
                yield sp
            return
        with self._lock:
            self._started += 1
            sampled = (self._started % self.sample_every) == 0
            if not sampled:
                self._sampled_out += 1
        if not sampled:
            yield _NULL_SPAN
            return
        trace = Trace(trace_id or uuid.uuid4().hex[:16], name, meta)
        root = Span(trace.trace_id, None, name)
        trace.root = root
        token = _CTX.set((trace, root))
        if self._listeners:
            self._notify("open", root, trace)
        try:
            yield root
        finally:
            root.t1 = time.perf_counter()
            trace.add(root)
            _CTX.reset(token)
            if self._listeners:
                self._notify("close", root, trace)
            with self._lock:
                if (self._traces.maxlen is not None
                        and len(self._traces) == self._traces.maxlen):
                    self._dropped += 1
                trace.seq = self._appended
                self._appended += 1
                self._traces.append(trace)

    @contextmanager
    def span(self, name: str, **attrs):
        """A child span of the current context; no-op without an active
        trace (one ContextVar read)."""
        ctx = _CTX.get()
        if ctx is None:
            yield _NULL_SPAN
            return
        trace, parent = ctx
        sp = Span(trace.trace_id, parent.span_id, name, attrs)
        token = _CTX.set((trace, sp))
        if self._listeners:
            self._notify("open", sp, trace)
        try:
            yield sp
        finally:
            sp.t1 = time.perf_counter()
            trace.add(sp)
            _CTX.reset(token)
            if self._listeners:
                self._notify("close", sp, trace)

    # -- queries -------------------------------------------------------------

    def get(self, trace_id: str) -> Trace | None:
        with self._lock:
            for t in reversed(self._traces):
                if t.trace_id == trace_id:
                    return t
        return None

    def last(self, n: int = 10) -> list[Trace]:
        with self._lock:
            return list(self._traces)[-max(0, int(n)):]

    def page(self, n: int = 10, before: int | None = None) -> tuple[list[Trace], int | None]:
        """Newest-first page of finished traces, keyed on the stable ring
        sequence number. ``before`` bounds the page to traces with
        ``seq < before`` so successive pages never repeat an entry even
        while new traces arrive. Returns ``(traces, next_before)`` where
        ``next_before`` is the cursor for the following page (None when
        the ring is exhausted)."""
        n = max(0, int(n))
        with self._lock:
            candidates = [t for t in reversed(self._traces)
                          if before is None or (t.seq is not None and t.seq < before)]
        pg = candidates[:n]
        next_before = pg[-1].seq if pg and len(candidates) > n else None
        return pg, next_before

    def stats(self) -> dict:
        with self._lock:
            return {
                "stored": len(self._traces),
                "max_traces": self._traces.maxlen,
                "started": self._started,
                "sampled_out": self._sampled_out,
                "appended": self._appended,
                "dropped": self._dropped,
                "sample_every": self.sample_every,
                "sync_devices": self.sync_devices,
            }

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._started = 0
            self._sampled_out = 0
            self._appended = 0
            self._dropped = 0


TRACER = Tracer()
span = TRACER.span
start_trace = TRACER.start


def current_trace_id() -> str | None:
    ctx = _CTX.get()
    return ctx[0].trace_id if ctx is not None else None


def current_span() -> "Span | _NullSpan":
    ctx = _CTX.get()
    return ctx[1] if ctx is not None else _NULL_SPAN


def device_sync(*tensors) -> bool:
    """Wait for the CUDA devices holding ``tensors`` to finish their queued
    work — only when tracing with ``TRACER.sync_devices`` on, so the
    enclosing span's wall time includes the dispatched device work. Returns
    True if it synchronised. A device fault raises here."""
    if not TRACER.sync_devices or _CTX.get() is None:
        return False
    devices = {t.device for t in tensors if t is not None and getattr(t, "is_cuda", False)}
    if not devices:
        return False
    import torch

    for d in devices:
        torch.cuda.synchronize(d)
    return True
