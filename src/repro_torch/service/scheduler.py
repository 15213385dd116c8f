"""Request scheduler: coalesce identical concurrent mining requests.

Under burst traffic many clients ask the same ``(version, tau, kmax,
ordering)`` question at once. Mining it once is both mandatory (one device)
and sufficient (the answer is deterministic), so the scheduler keeps a map
of in-flight futures keyed like the result cache: the first request
schedules the work on a small worker pool, every concurrent duplicate rides
the same future ("request batching"), and all of them share the warm
``LevelPipeline`` executable buckets in ``kernels.intersect.ops.EXEC_CACHE``
because the work runs in one process-wide pool.

``max_workers`` defaults to 1: level mining saturates the device, so
distinct requests queue FIFO rather than thrash it.
"""

from __future__ import annotations

import contextvars
import threading
import time
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, TypeVar

__all__ = ["RequestScheduler"]

T = TypeVar("T")


class RequestScheduler:
    def __init__(self, max_workers: int = 1):
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="miner"
        )
        self._lock = threading.Lock()
        self._inflight: dict[tuple, Future] = {}
        self.scheduled = 0
        self.coalesced = 0
        self.failed = 0

    def submit(self, key: tuple, fn: Callable[[], T]) -> "Future[T]":
        """Run ``fn`` for ``key``, or join the in-flight run for the same key."""
        with self._lock:
            future = self._inflight.get(key)
            if future is not None:
                self.coalesced += 1
                return future
            # carry the submitter's context (the active obs trace span) across
            # the worker-thread hop, so the run's spans join the request's
            # trace tree; coalesced waiters ride the first submitter's trace
            ctx = contextvars.copy_context()
            future = self._pool.submit(ctx.run, fn)
            self._inflight[key] = future
            self.scheduled += 1

        def _done(f: Future, key=key) -> None:
            with self._lock:
                if self._inflight.get(key) is f:
                    del self._inflight[key]
                try:
                    failed = f.exception() is not None
                except CancelledError:
                    failed = True
                if failed:
                    # the exception is delivered to every coalesced waiter
                    # via the shared future; here we only count it — a dead
                    # worker run must never wedge the key for later requests
                    self.failed += 1

        future.add_done_callback(_done)
        return future

    def drain(self, timeout: float | None = None) -> dict:
        """Wait for in-flight work to finish (graceful shutdown).

        New submissions are still accepted during the drain — the HTTP
        layer stops feeding the scheduler before calling this. Returns
        counts of runs drained vs. abandoned at the deadline."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            pending = list(self._inflight.values())
        drained = abandoned = 0
        for fut in pending:
            remaining = (
                None if deadline is None else max(0.0, deadline - time.monotonic())
            )
            try:
                fut.exception(timeout=remaining)
                drained += 1
            except FutureTimeoutError:
                abandoned += 1
            except (CancelledError, Exception):
                drained += 1
        return {"inflight": len(pending), "drained": drained, "abandoned": abandoned}

    def stats(self) -> dict:
        with self._lock:
            return {
                "scheduled": self.scheduled,
                "coalesced": self.coalesced,
                "failed": self.failed,
                "inflight": len(self._inflight),
            }

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
