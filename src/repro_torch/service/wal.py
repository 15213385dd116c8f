"""Durability layer under :class:`repro_torch.service.store.DatasetStore`:
the port's copy of the reference package's ``repro.service.wal``, with its
on-disk format, so a ``wal_dir`` written by either package recovers in the
other.

Two pieces:

:class:`WriteAheadLog`
    An append-only log of CRC-framed, fsync'd records. Each ``/append``
    block is logged *before* it is itemized into the in-memory store, so an
    acknowledged append survives a crash. Replay walks the longest valid
    prefix — a torn final frame (power cut mid-write) is detected by its
    CRC/length and truncated away, never propagated.

:class:`DurableStore`
    Owns the :class:`DatasetStore` plus its WAL and periodic snapshots.
    Every ``snapshot_every`` appends the full store state
    (:meth:`DatasetStore.export_state`) is folded into an atomic
    :class:`~repro_torch.distributed.checkpoint.CheckpointManager` checkpoint and
    the WAL is reset, bounding both replay time and log size.
    :meth:`DurableStore.recover` rebuilds the store bit-identically —
    same item ids, bitsets, version watermarks — from the newest intact
    snapshot plus an idempotent WAL replay.

The frame format is ``KWAL | crc32(payload) | len(payload) | payload``
with the payload a pickled ``{"version": v, "rows": ndarray}`` dict.
Version numbers make replay idempotent: records at or below the snapshot's
version are skipped, so a crash *between* snapshot and WAL reset cannot
double-apply a block.

Pickles read back from disk (WAL frames here, level-checkpoint blobs in
:mod:`repro_torch.service.api`) go through :func:`restricted_loads`, which
resolves only this package's classes, numpy's and plain builtin types: a
blob that names another package's class (the reference's
``repro.core.kyiv.MiningState``) fails to load instead of importing it.

What fsync buys (and doesn't): an acknowledged append survives process
death and OS crash on a journaling filesystem; it does not survive the
disk itself lying about flushes, and the final un-acked frame may be torn
— recovery drops it, which is exactly the client-visible contract (no ack,
no append).
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import threading
import time
import zlib

import numpy as np

from ..distributed.checkpoint import CheckpointManager
from ..obs import metrics as _om
from ..obs.trace import span as _obs_span
from .faults import NULL_INJECTOR, FaultInjector
from .store import DatasetStore

__all__ = ["WriteAheadLog", "DurableStore", "restricted_loads"]

_WAL_APPENDS = _om.counter(
    "repro_wal_appends_total", "Durably fsync'd WAL frames."
)
_WAL_BYTES = _om.counter(
    "repro_wal_bytes_written_total", "WAL frame bytes written (incl. header)."
)
_WAL_FSYNC = _om.histogram(
    "repro_wal_append_seconds", "Frame+fsync latency of one WAL append."
)
_WAL_TRUNCATED = _om.counter(
    "repro_wal_truncated_bytes_total",
    "Torn-tail bytes dropped during WAL replay.",
)
_SNAPSHOTS = _om.counter(
    "repro_store_snapshots_total", "Durable store snapshots taken."
)
_SNAPSHOT_SECONDS = _om.histogram(
    "repro_store_snapshot_seconds", "Snapshot (export+checkpoint+reset) time."
)
_RECOVERIES = _om.counter(
    "repro_store_recoveries_total", "Durable store recoveries completed."
)
_REPLAYED = _om.counter(
    "repro_wal_records_replayed_total",
    "WAL records re-applied during recovery.",
)

MAGIC = b"KWAL"
_HEADER = struct.Struct("<4sII")  # magic, crc32(payload), len(payload)

# the builtins a pickled record or mining state may name: plain data types
_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "range", "set", "slice", "str", "tuple",
})


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        top = module.split(".")[0]
        if top in ("repro_torch", "numpy") or (
            module == "builtins" and name in _SAFE_BUILTINS
        ):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name}")


def restricted_loads(data: bytes):
    """``pickle.loads`` that resolves only ``repro_torch.*``, ``numpy.*`` and
    plain builtin types; any other global raises ``UnpicklingError``."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()


class WriteAheadLog:
    """CRC-framed fsync'd append log with torn-tail recovery."""

    def __init__(self, path: str, injector: FaultInjector = NULL_INJECTOR):
        self.path = path
        self.injector = injector
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(path, "ab")
        self.appended = 0
        self.truncated_bytes = 0

    def append(self, record: dict) -> None:
        """Frame, write, fsync. Returns only once the record is durable."""
        payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        frame = _HEADER.pack(MAGIC, zlib.crc32(payload), len(payload)) + payload
        t0 = time.perf_counter()
        with self._lock, _obs_span("wal.append", bytes=len(frame)):
            action = self.injector.check("wal.append")
            if action == "partial":
                # simulate a power cut mid-write: half the frame reaches the
                # platter, then the process dies
                self._fh.write(frame[: len(frame) // 2])
                self._fh.flush()
                os.fsync(self._fh.fileno())
                from .faults import KillPoint

                raise KillPoint("wal.append:partial")
            self._fh.write(frame)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.appended += 1
        # durable appends only — a simulated torn write never acks, so it
        # never counts (the client-visible contract the metrics mirror)
        _WAL_APPENDS.inc()
        _WAL_BYTES.inc(len(frame))
        _WAL_FSYNC.observe(time.perf_counter() - t0)

    def replay(self) -> list[dict]:
        """Decode the longest valid prefix; a corrupt/truncated tail is
        truncated off the file (it was never acknowledged)."""
        records: list[dict] = []
        good_end = 0
        with self._lock:
            self._fh.flush()
            with open(self.path, "rb") as f:
                data = f.read()
            off = 0
            while off + _HEADER.size <= len(data):
                magic, crc, length = _HEADER.unpack_from(data, off)
                body = data[off + _HEADER.size : off + _HEADER.size + length]
                if magic != MAGIC or len(body) < length or zlib.crc32(body) != crc:
                    break
                try:
                    records.append(restricted_loads(body))
                except Exception:
                    break
                off += _HEADER.size + length
                good_end = off
            self.truncated_bytes = len(data) - good_end
            if self.truncated_bytes:
                _WAL_TRUNCATED.inc(self.truncated_bytes)
                self._truncate_locked(good_end)
        return records

    def _truncate_locked(self, size: int) -> None:
        self._fh.close()
        with open(self.path, "r+b") as f:
            f.truncate(size)
        self._fh = open(self.path, "ab")

    def reset(self) -> None:
        """Drop all records (they were folded into a snapshot)."""
        with self._lock:
            self._truncate_locked(0)

    def size(self) -> int:
        with self._lock:
            self._fh.flush()
            return os.path.getsize(self.path)

    def close(self) -> None:
        with self._lock:
            self._fh.close()


class DurableStore:
    """A :class:`DatasetStore` that survives process death.

    Appends are WAL-logged before itemization; every ``snapshot_every``
    appends the store state is checkpointed and the WAL reset. A fresh
    ``DurableStore`` over the same directory + :meth:`recover` yields a
    store observably identical to the pre-crash one at its last
    acknowledged version.
    """

    def __init__(
        self,
        directory: str,
        *,
        placement=None,
        snapshot_every: int = 8,
        injector: FaultInjector = NULL_INJECTOR,
        recorder=None,
        **store_kw,
    ):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.placement = placement
        self.snapshot_every = max(1, int(snapshot_every))
        self.injector = injector
        # optional FlightRecorder: snapshot/recover milestones go into the
        # crash-persistent ring (durable kinds — fsync'd inline)
        self.recorder = recorder
        self._store_kw = dict(store_kw)
        self._store_kw["placement"] = placement
        self.wal = WriteAheadLog(os.path.join(directory, "wal.log"), injector)
        self.snapshots = CheckpointManager(
            os.path.join(directory, "snapshots"), keep=2
        )
        self.store: DatasetStore | None = None
        self._since_snapshot = 0
        self.snapshots_taken = 0
        self._lock = threading.RLock()

    def _ensure_store(self, n_cols: int) -> DatasetStore:
        if self.store is None:
            self.store = DatasetStore(n_cols, **self._store_kw)
        return self.store

    def append(self, rows: np.ndarray) -> int:
        """Durably append a block: WAL first, then itemize. The version
        returned is only handed back (acknowledged) once the record is on
        disk; a crash between the two leaves the WAL ahead of the store and
        replay closes the gap."""
        rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int64))
        with self._lock:
            store = self._ensure_store(rows.shape[1])
            self.wal.append({"version": store.version + 1, "rows": rows})
            version = store.append(rows)
            self._since_snapshot += 1
            if self._since_snapshot >= self.snapshot_every:
                self.snapshot()
        return version

    def snapshot(self) -> int | None:
        """Fold store state into an atomic checkpoint and reset the WAL.
        Order matters: the snapshot commits (atomic rename) *before* the
        WAL resets, so a crash in between merely replays records the
        snapshot already holds — replay skips them by version."""
        t0 = time.perf_counter()
        with self._lock, _obs_span("store.snapshot"):
            if self.store is None:
                return None
            state = self.store.export_state()
            self.snapshots.save(
                self.store.version,
                state,
                meta={"kind": "dataset_store"},
                blocking=True,
            )
            self.wal.reset()
            self._since_snapshot = 0
            self.snapshots_taken += 1
            version = self.store.version
        # metrics outside the store lock: scrape collectors read stats()
        # under the registry lock (reverse acquisition order)
        _SNAPSHOTS.inc()
        _SNAPSHOT_SECONDS.observe(time.perf_counter() - t0)
        if self.recorder is not None:
            self.recorder.record("store.snapshot", version=version)
        return version

    def recover(self) -> dict:
        """Rebuild the store from newest intact snapshot + WAL replay.

        Returns an info dict (snapshot version, records replayed/skipped,
        torn-tail bytes truncated) for ``/stats`` and logs.
        """
        with self._lock, _obs_span("store.recover"):
            state, _meta = self.snapshots.restore()
            snapshot_version = 0
            if state is not None:
                # device bits are uploaded lazily (``device_bits``), so the
                # replay below costs one upload of the recovered version
                self.store = DatasetStore.from_state(
                    state,
                    placement=self.placement,
                    compact_threshold=self._store_kw.get("compact_threshold"),
                    keep_versions=self._store_kw.get("keep_versions", 8),
                )
                snapshot_version = self.store.version
            replayed = skipped = 0
            for record in self.wal.replay():
                rows = np.asarray(record["rows"], dtype=np.int64)
                store = self._ensure_store(rows.shape[1])
                if record["version"] <= store.version:
                    skipped += 1
                    continue
                got = store.append(rows)
                if got != record["version"]:
                    raise IOError(
                        f"WAL replay divergence: expected version "
                        f"{record['version']}, store produced {got}"
                    )
                replayed += 1
            self._since_snapshot = replayed
            _RECOVERIES.inc()
            _REPLAYED.inc(replayed)
            info = {
                "snapshot_version": snapshot_version,
                "replayed": replayed,
                "skipped": skipped,
                "truncated_bytes": self.wal.truncated_bytes,
                "version": self.store.version if self.store is not None else 0,
            }
            if self.recorder is not None:
                self.recorder.record("store.recover", **info)
            return info

    def stats(self) -> dict:
        with self._lock:
            return {
                "directory": self.directory,
                "wal_bytes": self.wal.size(),
                "wal_appends": self.wal.appended,
                "snapshot_every": self.snapshot_every,
                "snapshots_taken": self.snapshots_taken,
                "since_snapshot": self._since_snapshot,
                "latest_snapshot": self.snapshots.latest_step(),
            }

    def close(self) -> None:
        self.wal.close()
