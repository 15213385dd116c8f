"""LRU result cache for the resident mining service.

Keys are ``(dataset_version, tau, kmax, ordering)`` — everything that
determines a mining answer on the store (the engine only changes *how* the
answer is computed; engines are validated bit-identical, so results are
shared across them). Entries keep the full :class:`MiningResult`, which
serves three roles:

* repeat queries at the current version return instantly;
* the newest entry for the same ``(tau, kmax, ordering)`` at an *older*
  version is the base the incremental miner recounts against after appends;
* quasi-identifier reports are derived from cached results without
  re-mining.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

from ..core.kyiv import MiningResult
from ..obs import metrics as _om

__all__ = [
    "CacheKey",
    "CacheEntry",
    "ResultCache",
    "make_key",
    "make_approx_key",
]

# process-wide event counter beside the per-instance hit/miss attributes
# (tests assert on fresh-instance counts; /stats keeps the instance view)
_CACHE_REQUESTS = _om.counter(
    "repro_result_cache_requests_total",
    "Result-cache lookups by outcome.",
    ("outcome",),
)

CacheKey = tuple  # (version, tau, kmax, ordering) — exact entries only


def make_key(version: int, tau: int, kmax: int, ordering: str) -> CacheKey:
    return (int(version), int(tau), int(kmax), str(ordering))


def make_approx_key(
    version: int, tau: int, kmax: int, ordering: str, epsilon: float
) -> CacheKey:
    """Cache key of a sampled (ε-approximate) answer.

    Deliberately a different key *shape* (6-tuple, with ε folded in): an
    approx entry must never be confused with — or returned in place of —
    the exact entry at the same parameters, and :meth:`ResultCache.
    latest_base` skips non-4-tuple keys, so approx entries can never
    serve as incremental recount bases."""
    return (
        int(version),
        int(tau),
        int(kmax),
        str(ordering),
        "approx",
        round(float(epsilon), 9),
    )


@dataclasses.dataclass
class CacheEntry:
    key: CacheKey
    result: MiningResult
    source: str  # "cold" | "incremental" | "partial" | "approx" | "refined"
    info: dict
    created_at: float = dataclasses.field(default_factory=time.time)
    hits: int = 0
    # near-boundary recount companion (service.incremental.ResultBands):
    # count-sorted per-arity matrices persisted beside the result so an
    # append-burst recount touches only the (tau, tau+d] band instead of
    # rebuilding the sort for all cached itemsets on every delta
    bands: object | None = None

    @property
    def version(self) -> int:
        return self.key[0]

    def nbytes(self) -> int:
        """Approximate payload footprint for byte-bounded eviction.

        Counts the itemset lists plus any prep arrays the entry's info
        references (``l_bits`` / table bits). Shared preps across entries
        are counted once per entry — deliberately conservative: the bound
        overestimates, never undercounts."""
        if self.result is None:
            return 0
        total = 0
        for ids, _cnt in self.result.itemsets:
            total += 16 + 8 * len(ids)
        prep = getattr(self.result, "prep", None)
        arr = getattr(prep, "l_bits", None)
        if arr is not None and hasattr(arr, "nbytes"):
            total += int(arr.nbytes)
        bits = getattr(getattr(prep, "table", None), "bits", None)
        if bits is not None and hasattr(bits, "nbytes"):
            total += int(bits.nbytes)
        if self.bands is not None:
            total += int(self.bands.nbytes())
        return total


class ResultCache:
    """Thread-safe LRU over mining results."""

    def __init__(self, capacity: int = 64, max_bytes: int | None = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[CacheKey, CacheEntry]" = OrderedDict()
        self._bytes: dict[CacheKey, int] = {}
        self._total_bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: CacheKey) -> CacheEntry | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
                entry.hits += 1
        _CACHE_REQUESTS.inc(outcome="miss" if entry is None else "hit")
        return entry

    def put(self, entry: CacheEntry) -> None:
        nbytes = entry.nbytes()
        with self._lock:
            if entry.key in self._bytes:
                self._total_bytes -= self._bytes[entry.key]
            self._entries[entry.key] = entry
            self._bytes[entry.key] = nbytes
            self._total_bytes += nbytes
            self._entries.move_to_end(entry.key)
            self._evict_locked()

    def _evict_locked(self) -> None:
        # evict LRU-first while over either bound, but never the entry just
        # touched — a single oversized result still gets cached (the bound
        # is a budget for the tail, not a hard admission gate)
        def over() -> bool:
            if len(self._entries) > self.capacity:
                return True
            return self.max_bytes is not None and self._total_bytes > self.max_bytes

        while len(self._entries) > 1 and over():
            key, _ = self._entries.popitem(last=False)
            self._total_bytes -= self._bytes.pop(key, 0)

    def latest_base(
        self, tau: int, kmax: int, ordering: str, before_version: int
    ) -> CacheEntry | None:
        """Newest entry with the same mining parameters at an older dataset
        version — the incremental miner's recount base."""
        best: CacheEntry | None = None
        with self._lock:
            for entry in self._entries.values():
                if len(entry.key) != 4:
                    # approx/refined entries (make_approx_key) are scaled
                    # estimates — never a base to recount exactly against
                    continue
                v, t, k, o = entry.key
                if (t, k, o) == (tau, kmax, ordering) and v < before_version:
                    if best is None or v > best.version:
                        best = entry
        return best

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "bytes": self._total_bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes.clear()
            self._total_bytes = 0
            self.hits = 0
            self.misses = 0
