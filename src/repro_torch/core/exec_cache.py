"""One process-wide cache of bound dispatch callables, namespaced per
kernel family.

* :class:`SharedExecutableCache` holds one ``(family, key) -> callable`` map
  with per-family hit/miss/entry counters behind one lock;
* :meth:`SharedExecutableCache.family` hands out a :class:`FamilyCache`
  view (``get``/``keys``/``stats``/``clear``) that each kernel family binds
  as its module's ``EXEC_CACHE`` (``intersect``, ``coverage``, ``frontier``);
* :func:`stats` is the one observability surface — per-family counters plus
  process totals — reported as the ``executables`` section of the
  service's ``/stats``.

What a hit and a miss mean here. PyTorch compiles nothing per shape: the
CUDA kernels are built once per process from their sources
(``kernels/_build.py``) and take any batch size, and the plain versions are
eager torch. An entry is therefore the *bound wrapper callable* of one
``(family, bucket, variant)`` key — the engine, kernel variant, word width
and power-of-two batch bucket a placement dispatches with. A **miss** is the
first binding of such a bucket in this process, not a compile; a **hit** is
every later dispatch of the same bucket. The counters keep the buckets'
reuse observable, and ``/stats`` keeps the same shape as a compiling
backend's.

Import discipline: this module is a **leaf** (stdlib only). The kernels
packages import it, and ``repro_torch.core`` re-exports it — kernels must
never import anything else from ``repro_torch.core`` at module scope.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

__all__ = [
    "FamilyCache",
    "SharedExecutableCache",
    "SHARED_EXEC_CACHE",
    "exec_family",
    "stats",
    "reset",
    "publish_metrics",
]


class SharedExecutableCache:
    """Process-wide cache of bound batch-dispatch callables, keyed by
    ``(family, key)``.

    One entry per dispatch bucket: the engine/variant selection is bound
    once and shared across pipelines, levels, mining requests and kernel
    families (the resident service's warm start), and warm-vs-cold stays
    observable via per-family hit/miss counters.
    """

    def __init__(self):
        self._fns: dict[tuple, Any] = {}
        self._lock = threading.Lock()
        self._hits: dict[str, int] = {}
        self._misses: dict[str, int] = {}

    def get(self, family: str, key: tuple, builder: Callable[[], Any]):
        full = (family, key)
        with self._lock:
            fn = self._fns.get(full)
            if fn is not None:
                self._hits[family] = self._hits.get(family, 0) + 1
                return fn
            self._misses[family] = self._misses.get(family, 0) + 1
        fn = builder()
        with self._lock:
            # a racing builder may have beaten us; keep the first binding so
            # every caller shares one executable bucket
            fn = self._fns.setdefault(full, fn)
        return fn

    def family(self, name: str) -> "FamilyCache":
        return FamilyCache(self, name)

    def keys(self, family: str) -> list[tuple]:
        """The bound executable keys of one family — lets callers pad new
        dispatches to bucket sizes that already have executables (the
        sampling tier's boundary recount reuses warm buckets this way)."""
        with self._lock:
            return [k for fam, k in self._fns if fam == family]

    def family_stats(self, name: str) -> dict:
        with self._lock:
            entries = sum(1 for fam, _ in self._fns if fam == name)
            return {
                "entries": entries,
                "hits": self._hits.get(name, 0),
                "misses": self._misses.get(name, 0),
            }

    def stats(self) -> dict:
        """Per-family counters plus totals — the ``/stats`` payload."""
        with self._lock:
            families: dict[str, dict] = {}
            for fam, _ in self._fns:
                families.setdefault(fam, {"entries": 0})["entries"] += 1
            for fam in set(self._hits) | set(self._misses) | set(families):
                entry = families.setdefault(fam, {"entries": 0})
                entry["hits"] = self._hits.get(fam, 0)
                entry["misses"] = self._misses.get(fam, 0)
            return {
                "families": families,
                "entries": len(self._fns),
                "hits": sum(self._hits.values()),
                "misses": sum(self._misses.values()),
            }

    def clear(self, family: str | None = None) -> None:
        with self._lock:
            if family is None:
                self._fns.clear()
                self._hits.clear()
                self._misses.clear()
                return
            for full in [k for k in self._fns if k[0] == family]:
                del self._fns[full]
            self._hits.pop(family, None)
            self._misses.pop(family, None)


class FamilyCache:
    """One family's view of the shared cache (``get(key, builder)`` /
    ``keys()`` / ``stats()`` / ``clear()``)."""

    def __init__(self, shared: SharedExecutableCache, name: str):
        self._shared = shared
        self.name = name

    def get(self, key: tuple, builder: Callable[[], Any]):
        return self._shared.get(self.name, key, builder)

    def keys(self) -> list[tuple]:
        return self._shared.keys(self.name)

    def stats(self) -> dict:
        return self._shared.family_stats(self.name)

    def clear(self) -> None:
        self._shared.clear(self.name)

    def __repr__(self) -> str:
        return f"FamilyCache({self.name!r})"


SHARED_EXEC_CACHE = SharedExecutableCache()


def exec_family(name: str) -> FamilyCache:
    """The named family view of the process-wide executable cache."""
    return SHARED_EXEC_CACHE.family(name)


def stats() -> dict:
    """Single observability surface over every kernel family's executables."""
    return SHARED_EXEC_CACHE.stats()


def reset(family: str | None = None) -> None:
    SHARED_EXEC_CACHE.clear(family)


def publish_metrics(registry=None) -> None:
    """Mirror the shared executable cache into a metrics registry as the
    ``exec_cache`` named collector (idempotent: re-registering replaces).

    The cache keeps its own counters — the ``/stats`` ``executables``
    section is built from them — so the bridge
    reads them at scrape time instead of double-counting at every ``get``.
    Imported lazily so this module stays a stdlib-only leaf for callers
    that never scrape metrics.
    """
    from ..obs import metrics as _om

    reg = registry or _om.REGISTRY
    g_entries = reg.gauge(
        "repro_exec_cache_entries",
        "Bound executables resident per kernel family.",
        ("family",),
    )
    c_hits = reg.counter(
        "repro_exec_cache_hits_total", "Executable-cache hits.", ("family",)
    )
    c_misses = reg.counter(
        "repro_exec_cache_misses_total", "Executable-cache misses.", ("family",)
    )

    def _collect():
        s = SHARED_EXEC_CACHE.stats()
        for fam, fs in s["families"].items():
            g_entries.set(fs["entries"], family=fam)
            c_hits.set_total(fs.get("hits", 0), family=fam)
            c_misses.set_total(fs.get("misses", 0), family=fam)

    reg.register_collector("exec_cache", _collect)
