"""Retry policy for device-backed mining.

When a device dispatch fails with a CUDA-runtime-shaped error
(:func:`repro_torch.core.placement.is_device_failure`), the service retries
on the device with exponential backoff; once failures persist the
:class:`CircuitBreaker` opens and mines are refused
(``service.api.DeviceUnavailable``, HTTP 503) instead of being answered
from the host, which would hide a broken card. After ``cooldown_s`` the
breaker lets one request probe the device path again (implicit half-open):
success closes it, failure re-opens and restarts the cooldown.

Everything time-/sleep-shaped is injectable so chaos tests run in
milliseconds.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

from ..obs import metrics as _om

__all__ = ["ResilienceConfig", "CircuitBreaker"]

# process-wide beside the per-instance ``trips`` attribute (chaos tests
# assert on fresh-instance counts; /stats keeps the instance view)
_BREAKER_TRIPS = _om.counter(
    "repro_breaker_trips_total", "Circuit-breaker opens across all services."
)
_BREAKER_FAILURES = _om.counter(
    "repro_breaker_failures_total", "Device failures recorded by breakers."
)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for device-failure handling."""

    max_retries: int = 2          # device attempts after the first failure
    backoff_s: float = 0.05       # initial backoff; doubles per retry
    failure_threshold: int = 3    # consecutive failures that open the breaker
    cooldown_s: float = 30.0      # open duration before a probe is allowed
    sleep: Callable[[float], None] = time.sleep


class CircuitBreaker:
    """Consecutive-failure breaker with implicit half-open probing."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: float | None = None
        self.trips = 0
        # optional ``fn(state: str)`` fired outside the breaker lock on
        # open/closed transitions (the flight recorder); must never raise
        # into the mining path
        self.on_transition: Callable[[str], None] | None = None

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self._clock() - self._opened_at >= self.cooldown_s:
                return "half_open"
            return "open"

    def allow(self) -> bool:
        """May the device path be attempted right now?"""
        return self.state != "open"

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            reopened = self._opened_at is not None
            self._opened_at = None
        if reopened:
            self._fire("closed")

    def record_failure(self) -> None:
        _BREAKER_FAILURES.inc()
        tripped = False
        with self._lock:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                if self._opened_at is None:
                    self.trips += 1
                    tripped = True
                self._opened_at = self._clock()
        if tripped:
            # outside the breaker lock: the registry's scrape collectors read
            # breaker.stats() under the registry lock (reverse order)
            _BREAKER_TRIPS.inc()
            self._fire("open")

    def _fire(self, state: str) -> None:
        cb = self.on_transition
        if cb is not None:
            try:
                cb(state)
            except Exception:
                pass

    def stats(self) -> dict:
        with self._lock:
            opened = self._opened_at
            state = (
                "closed"
                if opened is None
                else (
                    "half_open"
                    if self._clock() - opened >= self.cooldown_s
                    else "open"
                )
            )
            return {
                "state": state,
                "consecutive_failures": self._failures,
                "failure_threshold": self.failure_threshold,
                "cooldown_s": self.cooldown_s,
                "trips": self.trips,
            }
