"""Fault injection for chaos-testing the mining service.

A :class:`FaultInjector` is a registry of named *sites* — well-known points
in the service where real deployments fail, such as device dispatch
(``placement.dispatch``, routed in by :func:`placement_faults`). Production
code calls
``injector.check(site)`` at each site; with nothing armed this is a dict
lookup and a no-op, so the seams stay in release builds.

Armed actions:

``raise``
    Raise the configured exception. With :class:`KillPoint` this simulates
    the process dying at that instant — tests then build a *fresh* service
    over the same directory and assert recovery.
``partial``
    Returned to the site, which carries it out itself (a write site's torn
    half-write followed by :class:`KillPoint`).
``sleep``
    Block for ``seconds`` at the site — used to hold a mine run open long
    enough for a concurrent cancel/deadline to land deterministically.

Faults fire ``times`` times after skipping the first ``after`` hits, so a
test can say "the 3rd dispatch fails, twice" and exercise retry paths.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

from ..core import placement as _placement

__all__ = [
    "FaultInjector",
    "KillPoint",
    "DeviceFault",
    "placement_faults",
    "NULL_INJECTOR",
]


class KillPoint(RuntimeError):
    """Simulated process death. Never caught by the service — it unwinds the
    whole request like a crash would, and tests recover from disk."""


class DeviceFault(RuntimeError):
    """Simulated accelerator failure; classified by
    :func:`repro_torch.core.placement.is_device_failure` and therefore eligible
    for retry on the device, unlike :class:`KillPoint`."""

    is_device_failure = True


@dataclasses.dataclass
class _Fault:
    action: str
    exc: BaseException | None
    times: int
    after: int
    seconds: float
    hits: int = 0
    fired: int = 0


class FaultInjector:
    """Thread-safe registry of armed faults keyed by site name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: dict[str, _Fault] = {}
        self._hits: dict[str, int] = {}

    def arm(
        self,
        site: str,
        *,
        action: str = "raise",
        exc: BaseException | None = None,
        times: int = 1,
        after: int = 0,
        seconds: float = 0.0,
    ) -> None:
        """Arm ``site``. The fault fires on hits ``after+1 .. after+times``;
        later hits pass through untouched."""
        if action not in ("raise", "partial", "sleep"):
            raise ValueError(f"unknown fault action {action!r}")
        if action in ("raise", "partial") and exc is None:
            exc = KillPoint(site)
        with self._lock:
            self._faults[site] = _Fault(action, exc, times, after, seconds)

    def disarm(self, site: str) -> None:
        with self._lock:
            self._faults.pop(site, None)

    def reset(self) -> None:
        with self._lock:
            self._faults.clear()
            self._hits.clear()

    def hits(self, site: str) -> int:
        """How many times ``site`` was reached (armed or not)."""
        with self._lock:
            return self._hits.get(site, 0)

    def check(self, site: str) -> str | None:
        """Called by production code at a fault site. Returns the action the
        site must carry out itself (``"partial"``), performs ``sleep``
        in-line, raises for ``raise`` — or returns None when nothing fires."""
        with self._lock:
            self._hits[site] = self._hits.get(site, 0) + 1
            fault = self._faults.get(site)
            if fault is None:
                return None
            fault.hits += 1
            if fault.hits <= fault.after or fault.fired >= fault.times:
                return None
            fault.fired += 1
            action, exc, seconds = fault.action, fault.exc, fault.seconds
        if action == "sleep":
            time.sleep(seconds)
            return None
        if action == "raise":
            raise exc
        return action  # "partial": the site does the torn write itself

    def fired(self, site: str) -> int:
        with self._lock:
            fault = self._faults.get(site)
            return fault.fired if fault is not None else 0


class _NullInjector(FaultInjector):
    """Default injector: arming is a programming error, checking is free."""

    def arm(self, *a, **kw):  # pragma: no cover - guard rail
        raise RuntimeError("arm faults on a dedicated FaultInjector, not the default")

    def check(self, site: str) -> None:
        return None


NULL_INJECTOR = _NullInjector()


@contextlib.contextmanager
def placement_faults(injector: FaultInjector):
    """Route the process-global placement fault hook into ``injector``.

    Every device dispatch site in :mod:`repro_torch.core.placement`
    (``dispatch``/``frontier``/``coverage``) funnels into the single
    ``placement.dispatch`` injector site — chaos tests care that *an*
    accelerator call failed, not which one. Restores the previous hook on
    exit so parallel test modules cannot leak faults into each other.
    """
    prev = _placement.set_fault_hook(lambda site: injector.check("placement.dispatch"))
    try:
        yield injector
    finally:
        _placement.set_fault_hook(prev)
