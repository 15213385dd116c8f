"""Versioned, device-resident dataset store for the resident mining service.

The one-shot pipeline re-itemizes the whole table on every ``mine()`` call.
A data custodian's table instead *grows*: the AOL-style workload is a stream
of row-block appends interleaved with quasi-identifier queries. This store
keeps the itemized representation — the ``(n_items, W)`` uint32 bitset matrix
the intersection kernels consume — **live across requests**:

* Item bitsets are stored in word tiles: the word dimension is padded to a
  multiple of ``word_tile`` so that the padded width (and hence the dispatch
  buckets bound in the executable cache, ``core.exec_cache``) stays stable
  while rows accumulate inside a tile, and only steps tile-by-tile
  afterwards. The tile is aligned to the placement's ``store_word_tile``.
* ``append(rows)`` itemizes *only the appended block*: existing items get new
  bits OR-ed into their rows, new ``(column, value)`` pairs get fresh item
  ids. History is never re-itemized; both the item and word axes grow by
  amortised doubling.
* Every append bumps an integer ``version`` and records the row/item
  watermarks, so result caches can key on ``version`` and the incremental
  miner can ask for ``delta_bits(base_version)`` — each item's row set
  restricted to the appended rows, at a cost proportional to the delta, not
  the history.
* ``device_bits()`` keeps the current full bitset matrix resident on the
  placement's device (one upload per version, through the placement's
  ``put_bits``: int32 words on the card, the word axis padded to a multiple
  of 4), so back-to-back mining requests at the same version skip the
  host->device transfer.
* Long-lived streams accumulate append-block bookkeeping (one version
  watermark per append, capacity slack from amortised doubling);
  ``compact()`` coalesces them into a consolidated base — old watermarks
  beyond ``keep_versions`` are dropped and the backing arrays are trimmed to
  snug tile-aligned capacity. ``delta_bits``/``rows_at`` semantics are
  preserved for every retained version; the incremental miner falls back to
  a cold mine when its base version was compacted away (``has_version``).

Item ids are append-ordered and **stable across versions** — a mined
itemset's ids stay meaningful after later appends, which is what lets cached
results be recounted instead of re-derived.

``export_state`` / ``from_state`` carry the store as a flat dict of numpy
arrays and ints, in the reference package's layout (a state exported there
loads here unchanged; ``repro_torch.convert.store_from_numpy``).

Process sharding (the multi-process fleet)
------------------------------------------

With ``shard=(pid, nproc)`` each process stores only the word **stripes** it
owns: the global word axis is cut into ``word_tile``-wide stripes assigned
round-robin (stripe ``s`` belongs to process ``s % nproc``), and the global
padded width is kept a multiple of ``word_tile * nproc`` so every process
holds exactly ``1/nproc`` of the words — identical local shapes keep the
lockstep mining loop's batch sizing process-invariant. ``append`` receives
the full row block on every process (metadata — item ids, freq, min_row,
watermarks — is computed globally and identically everywhere) but
**itemizes only its own row range** into local tiles; ``export_state``
persists local stripes only. Popcounts over local bits are partial
supports; the fleet placement's all-reduce is the only cross-process mining
collective. ``word_map()`` exposes the local->global word mapping consumers
need to translate bit positions back to row ids.
"""

from __future__ import annotations

import math
import threading

import numpy as np

from ..core.items import WORD_BITS, ItemTable
from ..core.placement import HostPlacement

__all__ = ["DatasetStore", "mask_delta_words", "mask_delta_words_local"]

_MIN_ITEM_CAP = 64
_MIN_WORD_CAP = 8


def mask_delta_words(bits: np.ndarray, base_rows: int) -> tuple[np.ndarray, int]:
    """Slice a (t, W) bitset matrix down to the words covering rows >=
    ``base_rows``, masking off the straddling word's pre-existing bits.

    Returns ``(delta bits (t, W_delta) uint32, word_lo)``; popcounts over the
    result are exact delta supports. Shared by :meth:`DatasetStore.delta_bits`
    (live store) and the incremental miner (immutable snapshots)."""
    word_lo = base_rows // WORD_BITS
    sub = bits[:, word_lo:].copy()
    keep = base_rows % WORD_BITS
    if keep:
        sub[:, 0] &= np.uint32(0xFFFFFFFF) << np.uint32(keep)
    return sub, word_lo


def mask_delta_words_local(
    bits: np.ndarray, base_rows: int, word_map: np.ndarray
) -> np.ndarray:
    """Sharded-store analogue of :func:`mask_delta_words`: zero the bits of
    rows below ``base_rows`` **in place of slicing** — a process-sharded
    matrix keeps its full local width because delta words are scattered
    round-robin across processes, not contiguous. ``word_map`` is the
    store's local->global word mapping; popcounts over the result are exact
    *partial* delta supports (sum across the fleet for the global count)."""
    word_map = np.asarray(word_map)
    boundary = base_rows // WORD_BITS
    sub = np.ascontiguousarray(bits).copy()
    sub[:, word_map < boundary] = 0
    keep = base_rows % WORD_BITS
    if keep:
        sub[:, word_map == boundary] &= np.uint32(0xFFFFFFFF) << np.uint32(keep)
    return sub


class DatasetStore:
    """Append-only itemized dataset with versioned snapshots.

    Thread-safe for interleaved appends and reads (one lock; appends are
    rare and cheap relative to mining).
    """

    def __init__(
        self,
        n_cols: int,
        *,
        word_tile: int = _MIN_WORD_CAP,
        placement=None,
        compact_threshold: int | None = None,
        keep_versions: int = 8,
        shard: tuple[int, int] | None = None,
    ):
        if n_cols <= 0:
            raise ValueError(f"n_cols must be positive, got {n_cols}")
        if word_tile <= 0:
            raise ValueError(f"word_tile must be positive, got {word_tile}")
        if keep_versions <= 0:
            raise ValueError(f"keep_versions must be positive, got {keep_versions}")
        if compact_threshold is not None and compact_threshold <= keep_versions + 1:
            # a compaction retains keep_versions+1 watermarks; a smaller
            # threshold would re-trigger on every append (compaction thrash)
            raise ValueError(
                f"compact_threshold must exceed keep_versions + 1 "
                f"({keep_versions + 1}), got {compact_threshold}"
            )
        if shard is not None:
            pid, nproc = int(shard[0]), int(shard[1])
            if nproc <= 0 or not (0 <= pid < nproc):
                raise ValueError(f"shard must be (pid, nproc) with 0 <= pid < nproc, got {shard}")
            shard = (pid, nproc)
        self.n_cols = int(n_cols)
        self.placement = placement
        if placement is not None:
            # the padded width stays a multiple of the placement's tile
            ptile = int(getattr(placement, "store_word_tile", 1) or 1)
            word_tile = word_tile * ptile // math.gcd(word_tile, ptile)
        self.word_tile = int(word_tile)
        # (pid, nproc) stripe ownership; (0, 1) is the identity sharding —
        # deliberately the same code path, so loopback fleets exercise the
        # stripe math in ordinary single-process tests
        self.shard = shard or (0, 1)
        self.compact_threshold = compact_threshold
        self.keep_versions = int(keep_versions)
        self.compactions = 0
        self.n_rows = 0
        self.version = 0
        self._n_items = 0
        self._n_words = 0  # current LOCAL padded width (multiple of word_tile)
        self._n_words_global = 0  # nproc * local width (== local unsharded)
        self._id_of: dict[tuple[int, int], int] = {}  # (col, value) -> item id
        cap = _MIN_ITEM_CAP
        self._value = np.zeros(cap, dtype=np.int64)
        self._col = np.zeros(cap, dtype=np.int64)
        self._freq = np.zeros(cap, dtype=np.int64)
        self._min_row = np.zeros(cap, dtype=np.int64)
        self._bits = np.zeros((cap, word_tile), dtype=np.uint32)
        # version -> (n_rows, n_items) watermarks; version 0 = empty store
        self._watermarks: dict[int, tuple[int, int]] = {0: (0, 0)}
        self._device: dict[int, object] = {}  # version -> device bits
        self._lock = threading.RLock()

    @classmethod
    def from_dataset(cls, dataset: np.ndarray, **kw) -> "DatasetStore":
        dataset = np.asarray(dataset)
        if dataset.ndim != 2:
            raise ValueError(f"dataset must be 2-D, got shape {dataset.shape}")
        store = cls(dataset.shape[1], **kw)
        store.append(dataset)
        return store

    @property
    def n_items(self) -> int:
        return self._n_items

    @property
    def n_words(self) -> int:
        return self._n_words

    def nbytes(self) -> int:
        return self._bits.nbytes

    def stats(self) -> dict:
        """One locked read of every ``/stats`` store field — an in-flight
        append can't tear the view (version bumped but n_rows not yet, a
        row count from one version and a byte count from another)."""
        with self._lock:
            return {
                "version": self.version,
                "n_rows": self.n_rows,
                "n_items": self._n_items,
                "n_words": self._n_words,
                "word_tile": self.word_tile,
                "shard": list(self.shard),
                "n_words_global": self._n_words_global,
                "bitset_bytes": self._bits.nbytes,
                "compactions": self.compactions,
            }

    def word_map(self, n_words: int | None = None) -> np.ndarray:
        """Local->global word index mapping (int64, length ``n_words``).

        Entry ``lw`` is the global word index this process's local word ``lw``
        holds; under the identity shard (0, 1) this is ``arange(n_words)``.
        The mapping is a pure function of the index (prefix-stable as the
        store grows), so callers holding an older snapshot pass that
        snapshot's ``n_words``. Consumers use it to translate local bit
        positions back to row ids and to mask delta words
        (:func:`mask_delta_words_local`)."""
        with self._lock:
            pid, nproc = self.shard
            lw = np.arange(
                self._n_words if n_words is None else int(n_words), dtype=np.int64
            )
            stripe = lw // self.word_tile
            return (stripe * nproc + pid) * self.word_tile + lw % self.word_tile

    def watermark_digest(self) -> bytes:
        """Cheap process-invariant digest of the version watermarks.

        Every fleet process computes this from purely global metadata
        (versions, row/item watermarks — never the local bits), so after a
        fanned-out append the coordinator can all-gather digests and assert
        the processes agree before mining against the new version."""
        with self._lock:
            versions = sorted(self._watermarks)
            payload = np.asarray(
                [self.version, self.n_rows, self._n_items, self._n_words_global]
                + [x for v in versions for x in (v, *self._watermarks[v])],
                dtype=np.int64,
            )
            return payload.tobytes()

    # -- growth -------------------------------------------------------------

    def _grow(self, items_needed: int, words_needed: int) -> None:
        item_cap, word_cap = self._bits.shape
        new_items = item_cap
        while new_items < items_needed:
            new_items *= 2
        new_words = max(word_cap, _MIN_WORD_CAP)
        while new_words < words_needed:
            new_words *= 2
        if new_items == item_cap and new_words == word_cap:
            return
        bits = np.zeros((new_items, new_words), dtype=np.uint32)
        bits[:item_cap, :word_cap] = self._bits
        self._bits = bits
        if new_items != item_cap:
            for name in ("_value", "_col", "_freq", "_min_row"):
                arr = getattr(self, name)
                grown = np.zeros(new_items, dtype=arr.dtype)
                grown[:item_cap] = arr
                setattr(self, name, grown)

    # -- append -------------------------------------------------------------

    def append(self, rows: np.ndarray) -> int:
        """Append a row block; itemizes only the block. Returns the new version."""
        rows = np.asarray(rows)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.n_cols:
            raise ValueError(
                f"rows must be (d, {self.n_cols}), got shape {rows.shape}"
            )
        d = rows.shape[0]
        if d == 0:
            return self.version
        with self._lock:
            base = self.n_rows
            total = base + d
            pid, nproc = self.shard
            # the global width stays a multiple of word_tile * nproc so the
            # round-robin stripes divide exactly: every process's local
            # width is identical, keeping lockstep batch sizing in sync
            unit = self.word_tile * nproc
            words_exact = (total + WORD_BITS - 1) // WORD_BITS
            n_words_global = ((words_exact + unit - 1) // unit) * unit
            n_words = n_words_global // nproc

            global_rows = base + np.arange(d, dtype=np.int64)
            gw = global_rows // WORD_BITS
            gb = (global_rows % WORD_BITS).astype(np.uint32)
            stripe = gw // self.word_tile
            # row-range ownership: this process itemizes only rows landing
            # in its own stripes ((0, 1) shards own everything)
            own = (stripe % nproc) == pid
            lw = (stripe // nproc) * self.word_tile + gw % self.word_tile

            for j in range(self.n_cols):
                colv = rows[:, j]
                uniq, inverse, counts = np.unique(
                    colv, return_inverse=True, return_counts=True
                )
                ids = np.empty(len(uniq), dtype=np.int64)
                for u, v in enumerate(uniq):
                    key = (j, int(v))
                    item = self._id_of.get(key)
                    if item is None:
                        item = self._n_items
                        self._grow(item + 1, n_words)
                        self._id_of[key] = item
                        self._n_items = item + 1
                        self._value[item] = int(v)
                        self._col[item] = j
                        self._freq[item] = 0
                        self._min_row[item] = np.iinfo(np.int64).max
                    ids[u] = item
                self._grow(self._n_items, n_words)
                item_ids = ids[inverse]  # (d,)
                np.bitwise_or.at(
                    self._bits, (item_ids[own], lw[own]), np.uint32(1) << gb[own]
                )
                self._freq[ids] += counts
                # first occurrence per unique value within this block
                order = np.argsort(inverse, kind="stable")
                starts = np.zeros(len(uniq), dtype=np.int64)
                starts[1:] = np.cumsum(counts)[:-1]
                first_rows = global_rows[order][starts]
                self._min_row[ids] = np.minimum(self._min_row[ids], first_rows)

            self._n_words = max(self._n_words, n_words)
            self._n_words_global = max(self._n_words_global, n_words_global)
            self.n_rows = total
            self.version += 1
            self._watermarks[self.version] = (self.n_rows, self._n_items)
            self._device.clear()
            if (
                self.compact_threshold is not None
                and len(self._watermarks) > self.compact_threshold
            ):
                self._compact_locked(self.keep_versions)
            return self.version

    # -- compaction ---------------------------------------------------------

    def compact(self, keep_versions: int | None = None) -> dict:
        """Coalesce accumulated append blocks into a consolidated base.

        Retains the newest ``keep_versions`` append versions plus one
        consolidated base watermark; everything older is folded into the base
        (those per-version deltas are no longer addressable — ``has_version``
        turns False and the incremental miner re-mines cold). Doubling-growth
        capacity slack of the backing arrays is trimmed back to snug
        tile-aligned sizes when at least a quarter of the allocation is
        slack (so steady append streams never realloc-thrash). Everything
        observable about the *retained* versions — ``rows_at``/``items_at``
        watermarks, ``delta_bits`` masks, item ids, supports — is unchanged.
        """
        if keep_versions is not None and keep_versions <= 0:
            raise ValueError(f"keep_versions must be positive, got {keep_versions}")
        with self._lock:
            return self._compact_locked(
                self.keep_versions if keep_versions is None else keep_versions
            )

    def _compact_locked(self, keep: int) -> dict:
        floor = self.version - keep
        dropped = [v for v in self._watermarks if v < floor]
        for v in dropped:
            del self._watermarks[v]
        freed = 0
        item_cap, word_cap = self._bits.shape
        snug_items = max(_MIN_ITEM_CAP, self._n_items)
        snug_words = max(self.word_tile, self._n_words)
        if snug_items * snug_words <= (item_cap * word_cap * 3) // 4:
            bits = np.zeros((snug_items, snug_words), dtype=np.uint32)
            bits[: self._n_items, : self._n_words] = self._bits[
                : self._n_items, : self._n_words
            ]
            freed = self._bits.nbytes - bits.nbytes
            self._bits = bits
            if snug_items < item_cap:
                for name in ("_value", "_col", "_freq", "_min_row"):
                    setattr(self, name, getattr(self, name)[:snug_items].copy())
        # only the current version's placement cache stays warm
        self._device = {
            v: d for v, d in self._device.items() if v == self.version
        }
        self.compactions += 1
        return {
            "dropped_versions": len(dropped),
            "retained_versions": len(self._watermarks),
            "freed_bytes": int(freed),
        }

    def has_version(self, version: int) -> bool:
        """Is this version's watermark still addressable (not compacted away)?"""
        with self._lock:
            return version in self._watermarks

    # -- state (the reference's snapshot layout) -----------------------------

    def export_state(self) -> dict:
        """Everything observable about the store as a flat pytree of arrays
        and scalars — the payload a durable snapshot persists. Capacity
        slack from amortised doubling is deliberately not captured (it is
        not observable); ``from_state`` rebuilds snug arrays."""
        with self._lock:
            t, w = self._n_items, self._n_words
            versions = sorted(self._watermarks)
            return {
                "n_cols": int(self.n_cols),
                "word_tile": int(self.word_tile),
                "n_rows": int(self.n_rows),
                "version": int(self.version),
                "n_items": int(t),
                "n_words": int(w),
                "n_words_global": int(self._n_words_global),
                "shard_pid": int(self.shard[0]),
                "shard_nproc": int(self.shard[1]),
                "compactions": int(self.compactions),
                "value": self._value[:t].copy(),
                "col": self._col[:t].copy(),
                "freq": self._freq[:t].copy(),
                "min_row": self._min_row[:t].copy(),
                "bits": self._bits[:t, :w].copy(),
                "wm_version": np.asarray(versions, dtype=np.int64),
                "wm_rows": np.asarray(
                    [self._watermarks[v][0] for v in versions], dtype=np.int64
                ),
                "wm_items": np.asarray(
                    [self._watermarks[v][1] for v in versions], dtype=np.int64
                ),
            }

    @classmethod
    def from_state(
        cls,
        state: dict,
        *,
        placement=None,
        compact_threshold: int | None = None,
        keep_versions: int = 8,
        shard: tuple[int, int] | None = None,
    ) -> "DatasetStore":
        """Rebuild a store from :meth:`export_state` output (this package's
        or the reference's). The rebuilt store is observably identical: item
        ids, bitsets, supports, version/watermarks.

        ``placement`` must be layout-compatible with the state (its word
        tile has to divide the state's padded width); rebuilding onto a
        placement with a coarser word tile raises rather than silently
        re-pack bits. A process-sharded state holds local stripes only and
        must be rebuilt by the same ``shard`` — each fleet process replays
        its own WAL/snapshot."""
        snap_shard = (int(state.get("shard_pid", 0)), int(state.get("shard_nproc", 1)))
        if shard is None:
            shard = snap_shard
        elif tuple(shard) != snap_shard:
            raise ValueError(
                f"snapshot was taken by shard {snap_shard} but recovery "
                f"requested shard {tuple(shard)} — local stripes are not "
                "transferable between processes"
            )
        store = cls(
            int(state["n_cols"]),
            word_tile=int(state["word_tile"]),
            placement=placement,
            compact_threshold=compact_threshold,
            keep_versions=keep_versions,
            shard=shard,
        )
        t, w = int(state["n_items"]), int(state["n_words"])
        if w % store.word_tile != 0:
            raise ValueError(
                f"snapshot word width {w} is not a multiple of the "
                f"placement-aligned word tile {store.word_tile} — the store "
                "was snapshotted under an incompatible placement"
            )
        store._grow(max(t, 1), max(w, store.word_tile))
        store._n_items = t
        store._n_words = w
        store._n_words_global = int(state.get("n_words_global", w))
        store.n_rows = int(state["n_rows"])
        store.version = int(state["version"])
        store.compactions = int(state["compactions"])
        for name in ("value", "col", "freq", "min_row"):
            getattr(store, f"_{name}")[:t] = np.asarray(state[name], dtype=np.int64)
        store._bits[:t, :w] = np.asarray(state["bits"], dtype=np.uint32)
        store._id_of = {
            (int(store._col[i]), int(store._value[i])): i for i in range(t)
        }
        store._watermarks = {
            int(v): (int(r), int(it))
            for v, r, it in zip(
                np.asarray(state["wm_version"]),
                np.asarray(state["wm_rows"]),
                np.asarray(state["wm_items"]),
            )
        }
        return store

    # -- snapshots ----------------------------------------------------------

    def item_table(self, *, snapshot: bool = True) -> ItemTable:
        """Current table as the miner's :class:`ItemTable`.

        ``snapshot=True`` (default) copies under the store lock, so the
        returned table is immutable even while later appends mutate the
        store in place — that is what lets a long mining run proceed
        concurrently with ``/append`` traffic. ``snapshot=False`` returns
        zero-copy views for read-only single-threaded use (tests, benches).

        ``n_words`` is the padded tile width; the pad words are zero, which
        every consumer (popcount, AND, preprocess hashing) treats as "row
        absent", so padding is semantically invisible.
        """
        with self._lock:
            t, w = self._n_items, self._n_words
            take = (lambda a: a.copy()) if snapshot else (lambda a: a)
            return ItemTable(
                n_rows=self.n_rows,
                n_cols=self.n_cols,
                n_words=w,
                value=take(self._value[:t]),
                col=take(self._col[:t]),
                freq=take(self._freq[:t]),
                min_row=take(self._min_row[:t]),
                bits=take(self._bits[:t, :w]),
            )

    def snapshot(self) -> tuple[int, ItemTable]:
        """Atomic ``(version, immutable item table)`` pair — the unit a
        mining request operates on, immune to appends landing mid-run."""
        with self._lock:
            return self.version, self.item_table(snapshot=True)

    def rows_at(self, version: int) -> int:
        return self._watermarks[version][0]

    def items_at(self, version: int) -> int:
        return self._watermarks[version][1]

    def delta_bits(self, base_version: int) -> tuple[np.ndarray, int]:
        """Per-item bitsets restricted to rows appended after ``base_version``.

        Returns ``(bits (n_items, W_delta) uint32, word_lo)`` where
        ``word_lo`` is the first word index covered. Bits belonging to rows
        that already existed at ``base_version`` are masked off, so popcounts
        over the returned slice are exact delta supports. Cost is
        O(n_items * W_delta) — proportional to the appended rows, not to the
        history.
        """
        with self._lock:
            base_rows = self.rows_at(base_version)
            view = self._bits[: self._n_items, : self._n_words]
            if self.shard[1] > 1:
                # sharded words are round-robin striped, not contiguous:
                # keep the full local width (word_lo = 0) and zero the
                # pre-existing rows' words instead of slicing them off
                return mask_delta_words_local(view, base_rows, self.word_map()), 0
            return mask_delta_words(view, base_rows)

    def device_bits(self, version: int | None = None):
        """Full bitset matrix placed for the store's placement, once per
        version and shared by every mining request at that version (the
        device placement's level-1 bits are a device-side gather of this
        tensor): ``placement.put_bits``, which on a device uploads int32
        words with the word axis padded to a multiple of 4 (host views strip
        the padding, ``core.bitops.host_bits``); a ``MeshPlacement`` word-
        shards it. Without a placement the host placement's contiguous numpy
        copy.

        ``version`` pins the expected store version: if appends have already
        moved the store past it, returns None and the caller falls back to
        uploading its own snapshot.
        """
        with self._lock:
            if version is not None and version != self.version:
                return None
            cached = self._device.get(self.version)
            if cached is None:
                view = self._bits[: self._n_items, : self._n_words]
                cached = (self.placement or HostPlacement()).put_bits(view)
                self._device[self.version] = cached
            return cached
