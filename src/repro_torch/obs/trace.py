"""Span traces for mining runs. Stdlib only, apart from the CUDA
synchronisation in :func:`device_sync`.

A :class:`Trace` is one run's tree of :class:`Span` intervals, opened with
``start_trace(name)`` and nested with ``span(name)``; the context travels in a
``contextvars`` variable. Without an active trace every ``span`` is a no-op
that costs one context-variable read. Finished traces land in a ring buffer
(:meth:`Tracer.last`).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

__all__ = ["Span", "Trace", "Tracer", "TRACER", "span", "start_trace", "device_sync"]

_CTX: "contextvars.ContextVar[tuple | None]" = contextvars.ContextVar(
    "repro_torch_obs_trace", default=None
)  # (Trace, Span) of the innermost open span

_ids = itertools.count(1)


class Span:
    """One timed interval in a trace tree."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1", "attrs")

    def __init__(self, trace_id: str, parent_id: str | None, name: str, attrs: dict | None = None):
        self.trace_id = trace_id
        self.span_id = f"{next(_ids):08x}"
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


class Trace:
    """One run's spans, in completion order."""

    def __init__(self, trace_id: str, name: str):
        self.trace_id = trace_id
        self.name = name
        self.spans: list[Span] = []
        self.root: Span | None = None
        self._lock = threading.Lock()

    def add(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)

    def find(self, name: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]


class _NullSpan:
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Trace lifecycle and the ring buffer of finished traces.

    ``sync_devices`` makes :func:`device_sync` block inside spans, so that a
    span's wall time includes the device work it launched (a debugging mode:
    it defeats the double-buffered pipeline).
    """

    def __init__(self, max_traces: int = 64):
        self._lock = threading.Lock()
        self._traces: deque[Trace] = deque(maxlen=max_traces)
        self.sync_devices = False

    @contextmanager
    def start(self, name: str):
        """Open a trace with a root span; nest a child span instead when a
        trace is already active on this context."""
        if _CTX.get() is not None:
            with self.span(name) as sp:
                yield sp
            return
        trace = Trace(uuid.uuid4().hex[:16], name)
        root = trace.root = Span(trace.trace_id, None, name)
        token = _CTX.set((trace, root))
        try:
            yield root
        finally:
            root.t1 = time.perf_counter()
            trace.add(root)
            _CTX.reset(token)
            with self._lock:
                self._traces.append(trace)

    @contextmanager
    def span(self, name: str, **attrs):
        ctx = _CTX.get()
        if ctx is None:
            yield _NULL_SPAN
            return
        trace, parent = ctx
        sp = Span(trace.trace_id, parent.span_id, name, attrs)
        token = _CTX.set((trace, sp))
        try:
            yield sp
        finally:
            sp.t1 = time.perf_counter()
            trace.add(sp)
            _CTX.reset(token)

    def last(self, n: int = 10) -> list[Trace]:
        with self._lock:
            return list(self._traces)[-max(0, int(n)):]


TRACER = Tracer()
span = TRACER.span
start_trace = TRACER.start


def device_sync(*tensors) -> bool:
    """Wait for the CUDA devices holding ``tensors`` to finish their queued
    work, only while tracing with ``TRACER.sync_devices`` on. Returns True if
    it synchronised. A device fault raises here."""
    if not TRACER.sync_devices or _CTX.get() is None:
        return False
    devices = {t.device for t in tensors if t is not None and t.is_cuda}
    if not devices:
        return False
    import torch

    for d in devices:
        torch.cuda.synchronize(d)
    return True
