"""Engine selection, bucket padding and the level pipeline around the
intersection kernels.

The level loop (``core.frontier``) hands this module ragged pair lists; it pads them to shape
buckets, dispatches to one of the engines through a placement
(``repro_torch.core.placement``) and strips padding:

* ``numpy`` — host vectorised ``np.bitwise_and`` + ``np.bitwise_count``;
* ``torch`` — the plain PyTorch versions of ``ref.py``, on any device;
* ``cuda``  — the hand-written CUDA kernels (``intersect.py``),

each device engine in the indexed kernel family or the gathered one
(:func:`build_engine_dispatch`'s ``indexed``).

:class:`LevelPipeline` is the batch pipeline used by
``repro_torch.core.kyiv``. The placement supplies residency (parent bitsets
and popcounts placed once per level), padding and dispatch; this class owns
the locality sort, the async handles (``submit`` returns at once; only
``result()`` waits for the device), padding strips and the inverse
permutation. Host candidate generation for batch *n+1* thus overlaps the
device intersection of batch *n* when the level loop double-buffers.

Locality-aware pair scheduling: :func:`locality_order` sorts a batch's pairs
by ``(i, j)`` so neighbouring pairs share their first parent row; outputs are
un-permuted before the caller sees them. The candidate generator already
emits ``i``-sorted batches, so the common case is one O(M) check.

Tracing: under an active trace (``repro_torch.obs.trace``) each dispatch
sets ``launched``, the padded pair count, on the span around it, and times
the CUDA kernels it launches with events on their stream
(``intersect.timed_launches``). :meth:`LevelPipeline.retire` (the level's
last batch consumed) resolves each dispatch's events into ``device_s`` on
its span and their sum into :attr:`LevelPipeline.device_s`; nothing waits
for the device. The events sit just around each kernel, recorded by the
launcher in C, not around the whole dispatch: the stream is often idle when
a batch is dispatched, and events recorded before the dispatch would also
time the host's work up to the launch (the pairs' upload, the Python in
between).

Padding contract: pair rows added for padding point at row 0 twice; a
self-pair is *uniform* (count == min parent count), so fused classify marks
padding ``CLASS_SKIP``. Buckets are powers of two (at least 256), as in the
reference: later layers read the bucket sizes. All returned arrays are sliced
back to the true count, so callers never observe padding.
"""

from __future__ import annotations

import numpy as np

from ...core.bitops import host_bits
from ...core.exec_cache import exec_family
from ...obs import metrics as _om
from ...obs.trace import Span, current_span
from . import intersect as _k
from . import ref as _ref
from .ref import CLASS_EMIT, CLASS_SKIP, CLASS_STORE

__all__ = [
    "classify_counts_host",
    "build_engine_dispatch",
    "intersect_and_count",
    "intersect_classify",
    "locality_order",
    "next_bucket",
    "LevelPipeline",
    "LegacyIntersectPipeline",
    "BatchHandle",
    "ENGINES",
    "EXEC_CACHE",
    "executable_cache_stats",
    "reset_executable_cache",
    "CLASS_SKIP",
    "CLASS_EMIT",
    "CLASS_STORE",
]

ENGINES = ("numpy", "torch", "cuda")

# The bound dispatch callables of the device placements, one per (engine,
# kernel variant, word width, batch bucket): the ``intersect`` family of the
# process-wide ``repro_torch.core.exec_cache`` registry.
EXEC_CACHE = exec_family("intersect")


def executable_cache_stats() -> dict:
    """Snapshot of this family's bucket cache (entries/hits/misses): the
    ``intersect`` family of the process-wide ``core.exec_cache`` registry,
    one hit/miss surface per kernel family."""
    return EXEC_CACHE.stats()


def reset_executable_cache() -> None:
    EXEC_CACHE.clear()

_MIN_BUCKET = 256

_PIPE_BATCHES = _om.counter(
    "repro_intersect_batches_total",
    "Pair batches dispatched through the level pipeline.",
    ("mode",),
)
_PIPE_PAIRS = _om.counter(
    "repro_intersect_pairs_total",
    "Pairs dispatched through the level pipeline (padding included for "
    "mode=padded).",
    ("mode",),
)
_LEVELS_RETIRED = _om.counter(
    "repro_intersect_levels_retired_total",
    "Level residencies eagerly retired by the level loop.",
)


def next_bucket(m: int, minimum: int = _MIN_BUCKET) -> int:
    """Smallest power-of-two bucket >= m (>= minimum)."""
    b = minimum
    while b < m:
        b <<= 1
    return b


def _pad_pairs(pairs: np.ndarray, bucket: int) -> np.ndarray:
    m = pairs.shape[0]
    if m == bucket:
        return pairs
    out = np.zeros((bucket, 2), dtype=pairs.dtype)
    out[:m] = pairs
    return out


def locality_order(pairs: np.ndarray) -> tuple[np.ndarray | None, np.ndarray | None]:
    """Locality-aware pair schedule: stable sort by ``(i, j)``.

    Returns ``(order, inverse)`` such that ``pairs[order]`` is sorted and
    ``out[inverse]`` restores the caller's order, or ``(None, None)`` when the
    pairs are already ``i``-monotone.
    """
    i = pairs[:, 0]
    if len(i) < 2 or bool(np.all(i[1:] >= i[:-1])):
        return None, None
    order = np.lexsort((pairs[:, 1], i))
    inverse = np.empty_like(order)
    inverse[order] = np.arange(len(order), dtype=order.dtype)
    return order, inverse


def classify_counts_host(counts: np.ndarray, minp: np.ndarray, tau: int) -> np.ndarray:
    """Host classification (Alg. 1 lines 32-41)."""
    counts = np.asarray(counts)
    skip = (counts == 0) | (counts == minp)
    emit = ~skip & (counts <= tau)
    return np.where(skip, CLASS_SKIP, np.where(emit, CLASS_EMIT, CLASS_STORE)).astype(np.int32)


def _host(x) -> np.ndarray:
    """Host numpy copy of a placement-native (numpy or torch) array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


class BatchHandle:
    """Future-like handle for one dispatched batch.

    ``result()`` waits (device->host copy) and returns ``(child | None,
    counts int64, classes int32 | None)`` in the caller's original pair order.
    ``raw()`` returns the placement-native (still padded, possibly on the
    device) ``(child, counts, classes)`` without any host copy — the device
    frontier consumes batches this way, so stored children never leave the
    device.
    """

    def __init__(self, materialize, raw=None):
        self._materialize = materialize
        self._raw = raw
        self._out = None
        self._done = False

    def result(self):
        if not self._done:
            self._out = self._materialize()
            self._materialize = None
            self._done = True
        return self._out

    def raw(self):
        if self._raw is None:
            raise ValueError("batch was not dispatched with raw outputs")
        return self._raw


def build_engine_dispatch(
    engine: str,
    *,
    fused_classify: bool,
    write_children: bool,
    indexed: bool = True,
    donate: bool = False,
):
    """The single-device dispatch callable of one engine and kernel variant:
    ``fn(bits, pairs, pc, tau) -> (child | None, cnt, cls | None)`` on
    ``(t, W)`` int32 words, ``(M, 2)`` int32 pairs and ``(t,)`` int32
    popcounts.

    ``indexed`` picks the kernel family: the indexed kernels read the pairs'
    parent rows themselves; the gathered ones take ``a = bits[i]``,
    ``b = bits[j]`` and ``minp = min(pc[i], pc[j])`` gathered here by torch
    indexing, as the reference gathers them outside Pallas. ``donate`` (the
    gathered fused write path only) writes each child over its gathered
    ``a``, so the batch allocates no child buffer."""
    if engine not in ("torch", "cuda"):
        raise ValueError(f"engine must be torch|cuda, got {engine!r}")
    if indexed:
        if engine == "torch":
            write_cls, count_cls = _ref.intersect_classify_ref, _ref.intersect_classify_count_ref
            write, count = _ref.intersect_pairs_ref, _ref.intersect_count_ref
        else:
            write_cls, count_cls = _k.intersect_classify_write_indexed, _k.intersect_classify_count_indexed
            write, count = _k.intersect_write_indexed, _k.intersect_count_indexed
        if fused_classify:
            if write_children:
                return write_cls
            return lambda bits, pairs, pc, tau: (None, *count_cls(bits, pairs, pc, tau))
        if write_children:
            return lambda bits, pairs, pc, tau: (*write(bits, pairs), None)
        return lambda bits, pairs, pc, tau: (None, count(bits, pairs), None)

    if engine == "torch":
        write_cls = (
            (lambda a, b, minp, tau: _ref.intersect_classify_gathered_ref(a, b, minp, tau, out=a))
            if donate else _ref.intersect_classify_gathered_ref
        )
        count_cls = _ref.intersect_classify_count_gathered_ref
        write, count = _ref.intersect_gathered_ref, _ref.intersect_count_gathered_ref
    else:
        write_cls = (
            _k.intersect_classify_write_gathered_donating
            if donate else _k.intersect_classify_write_gathered
        )
        count_cls = _k.intersect_classify_count_gathered
        write, count = _k.intersect_write_gathered, _k.intersect_count_gathered

    def gather(bits, pairs):
        return bits[pairs[:, 0]], bits[pairs[:, 1]]

    if fused_classify:
        if write_children:
            return lambda bits, pairs, pc, tau: write_cls(
                *gather(bits, pairs), _ref.min_parent_ref(pc, pairs), tau
            )
        return lambda bits, pairs, pc, tau: (
            None, *count_cls(*gather(bits, pairs), _ref.min_parent_ref(pc, pairs), tau)
        )
    if write_children:
        return lambda bits, pairs, pc, tau: (*write(*gather(bits, pairs)), None)
    return lambda bits, pairs, pc, tau: (None, count(*gather(bits, pairs)), None)


def intersect_and_count(
    bits,
    pairs: np.ndarray,
    *,
    write_children: bool,
    engine: str = "cuda",
    device="cuda",
    indexed: bool = True,
):
    """One-shot ``child = bits[i] & bits[j]`` and/or ``counts = |child|``.

    ``bits`` are (t, W) uint32 host bitsets, ``pairs`` (M, 2) row indices;
    ``engine`` is ``numpy`` / ``torch`` / ``cuda`` on ``device``, and
    ``indexed`` picks the kernel family. Returns ``(child (M, W) uint32 |
    None, counts (M,) int64)`` on the host."""
    bits = np.asarray(bits)
    pipe = LevelPipeline(
        bits, np.zeros(bits.shape[0], dtype=np.int64), tau=0,
        placement=_placement(engine, device, indexed),
        fused_classify=False, locality_sort=False,
    )
    try:
        child, counts, _ = pipe.submit(np.asarray(pairs), write_children).result()
    finally:
        pipe.retire()
    return child, counts


def intersect_classify(
    bits,
    pairs: np.ndarray,
    parent_counts: np.ndarray,
    *,
    tau: int,
    write_children: bool,
    engine: str = "cuda",
    device="cuda",
    indexed: bool = True,
    locality_sort: bool = True,
):
    """Fused intersect + classify, one shot through :class:`LevelPipeline`.

    Returns ``(child | None, counts (M,) int64, classes (M,) int32)`` on the
    host, classes in {CLASS_SKIP, CLASS_EMIT, CLASS_STORE}."""
    pipe = LevelPipeline(
        bits, parent_counts, tau=tau, placement=_placement(engine, device, indexed),
        fused_classify=True, locality_sort=locality_sort,
    )
    try:
        return pipe.submit(np.asarray(pairs), write_children).result()
    finally:
        pipe.retire()


def _placement(engine: str, device, indexed: bool):
    from ...core.placement import make_placement  # deferred: placement imports this module

    return make_placement(engine, device=device, indexed=indexed)


class LevelPipeline:
    """Placement-generic, bucket-padded batch dispatcher for one BFS level.

    Construction hands the parent bitsets and popcounts to the placement once
    (``placement.prepare``); every ``submit`` then ships only the pair list.
    Device placements dispatch asynchronously; ``BatchHandle.result()`` is
    the only synchronisation point. The host placement computes eagerly
    inside ``submit``.

    With ``fused_classify=True`` the per-pair class codes come from the
    placement itself; with ``False`` the handle returns ``classes=None`` and
    the caller classifies on the host (the unfused baseline).

    ``device_s`` is the summed device time of the CUDA kernels the level's
    traced dispatches launched, once :meth:`retire` has resolved it; None
    where none was timed (no trace, or no CUDA kernel: the CPU, the torch
    engine).
    """

    def __init__(
        self,
        bits,
        parent_counts,
        *,
        tau: int,
        placement,
        fused_classify: bool = True,
        locality_sort: bool = True,
        n_words: int | None = None,
    ):
        self.placement = placement
        self.tau = int(tau)
        self.fused_classify = fused_classify
        self.locality_sort = locality_sort
        # logical word count: device bitsets may carry word padding
        self.n_words = int(bits.shape[1]) if n_words is None else int(n_words)
        self._state = placement.prepare(bits, parent_counts, self.tau, fused_classify=fused_classify)
        self._timed: list = []  # (span, its timed_launches() events) per traced dispatch
        self.device_s: float | None = None

    def retire(self) -> None:
        """Drop this level's prepared residency (the buffers the placement
        uploaded itself), once the level's last batch has been consumed, and
        resolve the traced dispatches' device times."""
        state, self._state = self._state, None
        if state is not None:
            _LEVELS_RETIRED.inc()
            self.placement.release(state)
        timed, self._timed = self._timed, []
        for sp, events in timed:
            seconds = _k.launch_seconds(events)
            if seconds is not None:
                sp.set(device_s=seconds)
                self.device_s = (self.device_s or 0.0) + seconds

    def _dispatch(self, pairs, write_children: bool):
        """``placement.dispatch`` of one padded batch, recorded on the span
        around it (see the module's "Tracing")."""
        sp = current_span()
        if not isinstance(sp, Span):
            return self.placement.dispatch(self._state, pairs, write_children)
        sp.set(launched=int(pairs.shape[0]))
        with _k.timed_launches() as events:
            out = self.placement.dispatch(self._state, pairs, write_children)
        if events:
            self._timed.append((sp, events))
        return out

    def _materializer(self, out, m: int, inverse=None):
        child_d, cnt_d, cls_d = out
        n_words = self.n_words

        def materialize():
            counts = _host(cnt_d[:m]).astype(np.int64)
            child = host_bits(child_d[:m], n_words) if child_d is not None else None
            classes = _host(cls_d[:m]).astype(np.int32) if cls_d is not None else None
            if inverse is not None:
                counts = counts[inverse]
                if child is not None:
                    child = child[inverse]
                if classes is not None:
                    classes = classes[inverse]
            return child, counts, classes

        return materialize

    def submit_padded(self, pairs, m: int, write_children: bool) -> BatchHandle:
        """Dispatch one *pre-padded* batch of device-generated pair indices.

        The device frontier hands bucket-padded, candidate-ordered pairs
        straight from candidate generation. ``m`` is the true pair count for
        ``result()``'s strip; ``raw()`` exposes the padded outputs for
        device-side partitioning.
        """
        _PIPE_BATCHES.inc(mode="padded")
        _PIPE_PAIRS.inc(int(pairs.shape[0]), mode="padded")
        out = self._dispatch(pairs, write_children)
        return BatchHandle(self._materializer(out, m), raw=out)

    def submit(self, pairs: np.ndarray, write_children: bool) -> BatchHandle:
        """Dispatch one batch of pair intersections; non-blocking on device placements."""
        m = int(pairs.shape[0])
        if m == 0:
            child = np.zeros((0, self.n_words), dtype=np.uint32) if write_children else None
            classes = np.zeros(0, dtype=np.int32) if self.fused_classify else None
            out = (child, np.zeros(0, dtype=np.int64), classes)
            return BatchHandle(lambda: out)

        _PIPE_BATCHES.inc(mode="host")
        _PIPE_PAIRS.inc(m, mode="host")
        pairs = np.ascontiguousarray(pairs, dtype=np.int32)
        inverse = None
        if self.locality_sort:
            order, inverse = locality_order(pairs)
            if order is not None:
                pairs = pairs[order]
        padded = _pad_pairs(pairs, self.placement.padded_size(m))
        out = self._dispatch(padded, write_children)
        return BatchHandle(self._materializer(out, m, inverse))


class LegacyIntersectPipeline:
    """Adapter: wrap an ``intersect_fn(bits, pairs, write_children)`` callable
    (the older injection contract, e.g. ``core.sharded.make_sharded_intersect``)
    in the pipeline interface. The level loop runs its host path on it:
    host bitsets, classification on the host (``classes=None``)."""

    fused_classify = False

    def __init__(self, intersect_fn, bits):
        from ...core.placement import HostPlacement

        self._fn = intersect_fn
        self._bits = bits
        self.placement = HostPlacement()

    def submit(self, pairs: np.ndarray, write_children: bool) -> BatchHandle:
        child, counts = self._fn(self._bits, pairs, write_children)
        out = (child, np.asarray(counts, dtype=np.int64), None)
        return BatchHandle(lambda: out)

    def retire(self) -> None:
        self._bits = None
