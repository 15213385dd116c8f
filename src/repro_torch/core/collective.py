"""Host-level fleet collectives over a ``torch.distributed.TCPStore``.

The multi-process miner needs one cross-process primitive inside the level
loop — summing per-process partial popcounts — plus a handful of
control-plane exchanges (watermark agreement, candidate-pool unions, result
digests, the command bus). All of it is host data, so the fleet speaks one
transport: a key-value ``TCPStore`` (process 0 hosts it). The collective is
handed the store, this process's index and the process count; the
launcher takes them from ``launch.mesh.distributed_init``.

Protocol
--------

Every collective is one *round*. At round ``n`` each process

1. deletes its own round ``n-2`` keys (safe: completing round ``n-1`` is a
   rendezvous, so every peer has already read the ``n-2`` keys — see
   :meth:`FleetCollective._gc`),
2. publishes its payload under ``<ns>/<n>/<pid>``,
3. blocking-reads the other ``P-1`` keys, within the round's deadline.

A payload larger than ``chunk_bytes`` is split inside the collective: its
chunks go under ``<ns>/<n>/<pid>/<c>`` first, and the ``<ns>/<n>/<pid>`` key,
written last, holds the chunk count, so a reader that sees it finds every
chunk. The store's libuv server refuses a value over 8 MiB (and drops the
client that sent it), so the default chunk is 4 MiB: a batch's int64 counts
at the largest bucket are 8 MiB alone.

Rounds are strictly ordered per process and every process must run the
*same sequence* of collectives. A peer that dies mid-round surfaces as
:class:`FleetTimeout` on the survivors, which the coordinator maps to its
single-process degradation path.

Object payloads cross a socket, so :meth:`Collective.allgather_obj` loads
them through ``core.pickling.restricted_loads`` (``repro_torch.*``, numpy
and plain builtin types only), not through ``pickle.loads``.

:class:`LoopbackCollective` is the ``P == 1`` implementation: it lets every
fleet code path run, and be tested, in one ordinary process.
"""

from __future__ import annotations

import pickle
import struct
import threading
import time
from datetime import timedelta

import numpy as np

from .pickling import restricted_loads

__all__ = [
    "Collective",
    "FleetCollective",
    "FleetDesyncError",
    "FleetTimeout",
    "LoopbackCollective",
]


class FleetTimeout(RuntimeError):
    """A peer failed to publish its round payload within the deadline — the
    fleet-level analogue of a device loss; the coordinator degrades."""


class FleetDesyncError(RuntimeError):
    """Processes disagreed on a value that must be replicated (version
    watermarks, result digests). Always a bug or corruption, never retried."""


class Collective:
    """Interface shared by the loopback and multi-process implementations.

    ``pid`` / ``nproc`` identify this process; :meth:`allgather` is the one
    primitive, everything else derives from it.
    """

    pid: int = 0
    nproc: int = 1

    # cumulative accounting (/stats and the smoke read these)
    rounds: int = 0
    seconds: float = 0.0
    payload_bytes: int = 0

    def allgather(self, payload: bytes, *, wait_s: float | None = None) -> list[bytes]:
        """One round: every process's payload, in pid order. ``wait_s``
        overrides the round's deadline (the peer loop's wait for its next
        command has none worth keeping: an idle fleet is healthy)."""
        raise NotImplementedError

    def allreduce_sum(self, arr: np.ndarray) -> np.ndarray:
        """Element-wise sum of one equal-shape int64 array per process."""
        arr = np.ascontiguousarray(arr, dtype=np.int64)
        if self.nproc == 1:
            self.rounds += 1
            return arr.copy()
        parts = self.allgather(arr.tobytes())
        out = np.zeros_like(arr)
        for raw in parts:
            out += np.frombuffer(raw, dtype=np.int64).reshape(arr.shape)
        return out

    def allgather_obj(self, obj, *, wait_s: float | None = None) -> list:
        """All-gather python payloads (loaded restricted)."""
        if self.nproc == 1:
            self.rounds += 1
            return [obj]
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        parts = self.allgather(blob) if wait_s is None else self.allgather(blob, wait_s=wait_s)
        return [obj if p == self.pid else restricted_loads(raw) for p, raw in enumerate(parts)]

    def agree(self, value: bytes, what: str = "value") -> bytes:
        """Assert every process holds the same ``value`` (watermarks,
        digests); returns it. Divergence raises :class:`FleetDesyncError`."""
        if self.nproc == 1:
            self.rounds += 1
            return value
        parts = self.allgather(value)
        for pid, other in enumerate(parts):
            if other != value:
                raise FleetDesyncError(
                    f"{what} diverged: p{self.pid}={value!r} p{pid}={other!r}"
                )
        return value

    def barrier(self, name: str = "sync") -> None:
        self.allgather(name.encode())

    def stats(self) -> dict:
        return {
            "nproc": self.nproc,
            "pid": self.pid,
            "rounds": self.rounds,
            "seconds": round(self.seconds, 6),
            "payload_bytes": self.payload_bytes,
        }


class LoopbackCollective(Collective):
    """Single-process fleet: every collective is the identity."""

    def __init__(self):
        self.pid = 0
        self.nproc = 1
        self.rounds = 0
        self.seconds = 0.0
        self.payload_bytes = 0

    def allgather(self, payload: bytes, *, wait_s: float | None = None) -> list[bytes]:
        self.rounds += 1
        self.payload_bytes += len(payload)
        return [payload]

    def __repr__(self) -> str:
        return "LoopbackCollective()"


_HEADER = struct.Struct("<QQ")  # (chunk count, payload length)


class FleetCollective(Collective):
    """Key-value collectives over a ``TCPStore`` (``store``), as process
    ``pid`` of ``nproc``. One instance per process, shared by the store,
    placement and coordinator (rounds are one global sequence, guarded by a
    lock so that service worker threads cannot interleave two
    collectives)."""

    def __init__(
        self,
        store,
        pid: int,
        nproc: int,
        *,
        timeout_s: float = 60.0,
        namespace: str = "fleet",
        chunk_bytes: int = 4 << 20,
    ):
        self._store = store
        self.pid = int(pid)
        self.nproc = int(nproc)
        self.timeout_s = float(timeout_s)
        self.chunk_bytes = max(1, int(chunk_bytes))
        self._ns = namespace
        self._round = 0
        self._lock = threading.Lock()
        self._chunks: dict[int, int] = {}  # round -> chunks this process wrote
        self.rounds = 0
        self.seconds = 0.0
        self.payload_bytes = 0
        self.chunked_rounds = 0

    def _key(self, n: int, pid: int, chunk: int | None = None) -> str:
        base = f"{self._ns}/{n}/{pid}"
        return base if chunk is None else f"{base}/{chunk}"

    def _gc(self, n: int) -> None:
        # Deleting our round n-2 keys at the start of round n is race-free:
        # a blocking read is a rendezvous, so finishing round n-1 implies
        # every peer *started* n-1, which implies every peer *finished* n-2
        # — and finishing n-2 means it read all n-2 keys, ours included.
        if n < 2:
            return
        old = n - 2
        try:
            for c in range(self._chunks.pop(old, 0)):
                self._store.delete_key(self._key(old, self.pid, c))
            self._store.delete_key(self._key(old, self.pid))
        except Exception:
            pass  # best effort: a stale key only costs the store's memory

    def _publish(self, n: int, payload: bytes) -> None:
        size = len(payload)
        n_chunks = 0 if size + _HEADER.size <= self.chunk_bytes else -(-size // self.chunk_bytes)
        if n_chunks:
            for c in range(n_chunks):
                lo = c * self.chunk_bytes
                self._store.set(self._key(n, self.pid, c), payload[lo : lo + self.chunk_bytes])
            self._chunks[n] = n_chunks
            self.chunked_rounds += 1
            self._store.set(self._key(n, self.pid), _HEADER.pack(n_chunks, size))
        else:
            self._store.set(self._key(n, self.pid), _HEADER.pack(0, size) + payload)

    def _read(self, n: int, pid: int, deadline: float, wait_s: float) -> bytes:
        key = self._key(n, pid)
        try:
            self._store.wait([key], timedelta(seconds=max(deadline - time.monotonic(), 0.001)))
        except Exception as exc:  # a deadline, or the store's host gone
            raise FleetTimeout(
                f"peer p{pid} missed round {n} within {wait_s:.1f}s: {exc}"
            ) from exc
        raw = self._store.get(key)
        n_chunks, size = _HEADER.unpack_from(raw)
        if n_chunks == 0:
            return bytes(raw[_HEADER.size :])
        # the header is written after every chunk: they are all there
        out = b"".join(self._store.get(self._key(n, pid, c)) for c in range(n_chunks))
        if len(out) != size:
            raise FleetDesyncError(f"round {n} payload of p{pid}: {len(out)} of {size} bytes")
        return out

    def allgather(self, payload: bytes, *, wait_s: float | None = None) -> list[bytes]:
        if self.nproc == 1:
            self.rounds += 1
            self.payload_bytes += len(payload)
            return [payload]
        payload = bytes(payload)
        wait_s = self.timeout_s if wait_s is None else float(wait_s)
        t0 = time.perf_counter()
        with self._lock:
            n = self._round
            self._round += 1
            self._gc(n)
            self._publish(n, payload)
            deadline = time.monotonic() + wait_s
            out = [payload if pid == self.pid else self._read(n, pid, deadline, wait_s)
                   for pid in range(self.nproc)]
            self.rounds += 1
            self.payload_bytes += sum(len(b) for b in out)
            self.seconds += time.perf_counter() - t0
        return out

    def stats(self) -> dict:
        return {**super().stats(), "chunked_rounds": self.chunked_rounds,
                "chunk_bytes": self.chunk_bytes}

    def __repr__(self) -> str:
        return f"FleetCollective(pid={self.pid}, nproc={self.nproc})"
