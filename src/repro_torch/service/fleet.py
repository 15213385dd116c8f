"""Multi-process fan-out/merge coordinator for the mining fleet.

The fleet runs one :class:`~repro_torch.service.api.MiningService` per
process over a process-sharded store (``shard=(pid, nproc)`` word stripes)
and a :class:`~repro_torch.core.fleet.FleetPlacement`. Mining is *lockstep*: every
process executes the identical request and the partial popcounts meet in
one all-reduce per batch — so "fan-out" here is command replication, and
"merge" is digest agreement, not result stitching. Three pieces:

* :func:`replicate` — the command bus. One collective round broadcasts the
  frontend's ``(op, args)`` to every process (peers contribute a ready
  marker and take process 0's entry); each process then executes the op on
  its local service, and a final round all-gathers the outcome digest —
  raising :class:`~repro_torch.core.collective.FleetDesyncError` if the fleet
  disagrees, and re-raising remote errors locally so every process stays
  round-aligned even when one fails deterministically. The bus is the
  ``TCPStore`` collective: a command's payload (an append's whole row block)
  crosses it pickled, is loaded restricted, and is chunked when large.
* :class:`FleetFrontend` — what process 0 binds HTTP to (``serve_miner``
  gates it with ``launch.mesh.is_main()``). Replicated ops (append /
  mine / report / risk) go through the bus under a global op lock (the
  collective is one strictly-ordered round sequence; two interleaved ops
  would shear it). Everything else (stats, readiness, slowlog, drain)
  reads local state and delegates via ``__getattr__``.
* :func:`serve_fleet_peer` — the peer loop (processes 1..P-1): block on
  the next command round, execute, repeat until the frontend broadcasts
  shutdown or a peer failure poisons the fleet.

Degradation: a :class:`~repro_torch.core.collective.FleetTimeout` anywhere in a
replicated op (a peer died or stalled past its deadline) trips the fleet
breaker **permanently** — stripes held by a dead peer are unrecoverable
without re-itemizing, so the frontend fails over to its *shadow*: a plain
single-process service over an unsharded copy of the data, kept in sync on
every append. It mines with the frontend's engine, so on the card: a dead
peer never turns into a host answer. Subsequent requests are served by that
one process (slower, still exact); ``/stats.resilience.fleet`` makes the
switch operator-visible.
Restarting the fleet is the only way back — rejoin-in-place would need
stripe re-replication, which the store deliberately refuses (local stripes
are not transferable between processes).
"""

from __future__ import annotations

import hashlib
import json
import pickle
import threading
import time

import numpy as np

from ..core.collective import Collective, FleetDesyncError, FleetTimeout
from ..obs import metrics as _om

__all__ = [
    "FleetFrontend",
    "FleetOpError",
    "replicate",
    "serve_fleet_peer",
]

_FLEET_OPS = _om.counter(
    "repro_fleet_ops_total",
    "Replicated fleet operations by op and outcome.",
    ("op", "outcome"),
)

# ops every process executes in lockstep; anything else is local-only.
# Every op that can reach a mining collective MUST be here — a collective
# issued outside the command bus pairs against the peers' command round
# and shears the fleet's round sequence. Digests pin bit-identity of the
# *deterministic* part of each answer — wall-clock fields vary per process
# and are excluded.
REPLICATED_OPS = ("append", "mine", "report", "risk", "anonymize_plan")

_VOLATILE_KEYS = ("latency_s", "source", "wall_time", "info")


class FleetOpError(RuntimeError):
    """A replicated op failed on at least one process (deterministically —
    validation errors and the like). Raised on *every* process so the round
    sequence stays aligned; carries the per-process error strings."""

    def __init__(self, op: str, errors: dict[int, str]):
        self.op = op
        self.errors = errors
        super().__init__(f"fleet op {op!r} failed: {errors}")


def _scrub(obj):
    """Canonical form for digesting: drop per-process wall-clock fields,
    coerce numpy scalars/arrays, sort mapping keys."""
    if isinstance(obj, dict):
        return {
            k: _scrub(v)
            for k, v in sorted(obj.items())
            if k not in _VOLATILE_KEYS
        }
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _digest_of(op: str, service, out) -> bytes:
    if op == "append":
        # the store's watermark digest covers version/rows/items/width —
        # stronger than the append response alone
        return service.store.watermark_digest()
    if op == "mine":
        payload = (out.version, tuple(out.result.itemsets))
        return hashlib.sha256(pickle.dumps(payload)).digest()
    # report / risk: JSON-shaped dicts with volatile fields scrubbed
    blob = json.dumps(_scrub(out), sort_keys=True, default=repr).encode()
    return hashlib.sha256(blob).digest()


def device_peak_bytes(service) -> int | None:
    """Peak device memory of this process on its service's card (``None``
    off a card): every fleet process holds its own allocator."""
    placement = service.placement
    dev = getattr(getattr(placement, "inner", placement), "device", None)
    if dev is None or dev.type != "cuda":
        return None
    import torch

    return int(torch.cuda.max_memory_allocated(dev))


def _jsonable(out):
    return out.to_json() if hasattr(out, "to_json") else out


def replicate(service, collective: Collective, op: str, kw: dict):
    """Execute one replicated op on the local service and agree on its
    digest. Must be called by **every** process with the same ``(op, kw)``
    in the same round (the command bus guarantees this). Returns the local
    result; raises :class:`FleetOpError` fleet-wide if any process failed,
    :class:`FleetDesyncError` if digests diverge, :class:`FleetTimeout`
    if a peer vanished."""
    out = err = None
    try:
        out = getattr(service, op)(**kw)
    except FleetTimeout:
        raise  # a dead peer is a fleet event, not an op error
    except Exception as exc:  # deterministic op failure: exchange, re-raise
        err = f"{type(exc).__name__}: {exc}"
    outcome = ("err", err) if err is not None else ("ok", _digest_of(op, service, out))
    outcomes = collective.allgather_obj(outcome)
    errors = {p: o[1] for p, o in enumerate(outcomes) if o[0] == "err"}
    if errors:
        _FLEET_OPS.inc(op=op, outcome="error")
        raise FleetOpError(op, errors)
    digests = {o[1] for o in outcomes}
    if len(digests) != 1:
        _FLEET_OPS.inc(op=op, outcome="desync")
        raise FleetDesyncError(
            f"fleet op {op!r} produced {len(digests)} distinct digests"
        )
    _FLEET_OPS.inc(op=op, outcome="ok")
    return out


_SHUTDOWN = {"op": "__shutdown__", "kw": {}}

# How long a peer waits for its next command: no deadline worth keeping (an
# idle fleet is healthy; the frontend may be reading its preload). A peer
# whose frontend dies learns it from the store's closed connection.
PEER_IDLE_WAIT_S = 30 * 24 * 3600.0


class FleetFrontend:
    """Process 0's request facade: replicates mining ops across the fleet,
    serves everything else from the local (sharded) service, and fails over
    to ``shadow`` — a single-process full-copy service — when a peer dies.

    Duck-types the slice of :class:`MiningService` the HTTP layer calls;
    unknown attributes delegate to whichever service is currently active.
    """

    def __init__(self, service, collective: Collective, *, shadow=None):
        self.service = service
        self.collective = collective
        self.shadow = shadow
        self.degraded = False
        self.degraded_reason: str | None = None
        self.degraded_at: float | None = None
        # the collective is one global round sequence: replicated ops are
        # serialised fleet-wide by this lock (HTTP threads would interleave)
        self._op_lock = threading.RLock()
        self._ops = 0

    # -- degradation ---------------------------------------------------------

    def _degrade(self, exc: Exception):
        self.degraded = True
        self.degraded_reason = f"{type(exc).__name__}: {exc}"
        self.degraded_at = time.time()
        _FLEET_OPS.inc(op="*", outcome="degraded")
        # the preprocess row-group rendezvous is a module-level hook: left
        # installed it would drag the *shadow's* cold mines into collective
        # rounds against a dead fleet
        from ..core.preprocess import set_row_group_collective

        set_row_group_collective(None)
        if self.shadow is None:
            raise RuntimeError(
                "fleet degraded with no shadow service configured"
            ) from exc

    @property
    def active(self):
        return self.shadow if self.degraded else self.service

    # -- replicated ops ------------------------------------------------------

    def _replicated(self, op: str, **kw):
        with self._op_lock:
            if self.degraded:
                return getattr(self.shadow, op)(**kw)
            self._ops += 1
            try:
                # command round: peers block on this and mirror the call
                self.collective.allgather_obj({"op": op, "kw": kw})
                return replicate(self.service, self.collective, op, kw)
            except FleetTimeout as exc:
                self._degrade(exc)
                return getattr(self.shadow, op)(**kw)

    def append(self, rows):
        rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int64))
        with self._op_lock:
            out = self._replicated("append", rows=rows)
            # the shadow ingests every append while the fleet is healthy —
            # at degradation time it must already hold the full table (a
            # dead peer's stripes cannot be reconstructed from survivors).
            # Sync strictly *after* the replicated op: if it degraded
            # mid-call the fallback already applied this block to the
            # shadow, and a second application would fork the row count.
            if not self.degraded and self.shadow is not None:
                self.shadow.append(rows)
            return out

    def mine(self, **kw):
        if not self.degraded:
            # both features are wall-clock-driven and therefore process-
            # divergent: a deadline can expire on one process and not another
            # (partial results would desync the digest), and sampled mining
            # draws row subsets a sharded store cannot materialise
            if kw.get("mode") == "approx":
                raise ValueError(
                    "mode='approx' is not supported on a multi-process fleet"
                )
            if kw.get("deadline_s") is not None:
                raise ValueError(
                    "per-request deadlines are not supported on a fleet; "
                    "use --fleet-timeout-s"
                )
        return self._replicated("mine", **kw)

    def report(self, **kw):
        return self._replicated("report", **kw)

    def risk(self, **kw):
        return self._replicated("risk", **kw)

    def anonymize_plan(self, **kw):
        return self._replicated("anonymize_plan", **kw)

    # -- local views ---------------------------------------------------------

    def fleet_stats(self) -> dict:
        return {
            "nproc": self.collective.nproc,
            "pid": self.collective.pid,
            "degraded": self.degraded,
            "degraded_reason": self.degraded_reason,
            "degraded_at": self.degraded_at,
            "replicated_ops": self._ops,
            "collective": self.collective.stats(),
            "shadow": self.shadow is not None,
            "device_peak_bytes": device_peak_bytes(self.service),
        }

    def stats(self) -> dict:
        s = self.active.stats()
        res = dict(s.get("resilience") or {})
        res["fleet"] = self.fleet_stats()
        s["resilience"] = res
        return s

    def shutdown_fleet(self) -> None:
        """Broadcast shutdown to the peer loops (healthy fleets only)."""
        with self._op_lock:
            if not self.degraded and self.collective.nproc > 1:
                try:
                    self.collective.allgather_obj(_SHUTDOWN)
                except FleetTimeout:
                    pass  # peers already gone

    def close(self) -> None:
        self.shutdown_fleet()
        self.service.close()
        if self.shadow is not None:
            self.shadow.close()

    def __getattr__(self, name):
        return getattr(self.active, name)


def serve_fleet_peer(service, collective: Collective, on_op=None) -> dict:
    """Peer-process main loop: execute replicated commands until shutdown.
    ``on_op(op, executed)`` runs after each executed command (the launcher
    logs it).

    The wait for each command has no deadline worth keeping
    (``PEER_IDLE_WAIT_S``): the reference's peer gives up after the fleet
    timeout, so an idle fleet (or a long preload on process 0) broke it.

    Returns a summary dict. A :class:`FleetTimeout` (frontend died) or
    :class:`FleetDesyncError` terminates the loop — the fleet is broken
    and this process cannot rejoin without a restart.
    """
    executed = 0
    reason = "shutdown"
    while True:
        try:
            msgs = collective.allgather_obj({"op": None}, wait_s=PEER_IDLE_WAIT_S)
            cmd = msgs[0]  # the frontend is always process 0
            if cmd.get("op") in (None, "__shutdown__"):
                if cmd.get("op") == "__shutdown__":
                    break
                # frontend round without a command — protocol violation
                reason = "bad-command"
                break
            replicate(service, collective, cmd["op"], cmd["kw"])
            executed += 1
            if on_op is not None:
                on_op(cmd["op"], executed)
        except FleetOpError:
            continue  # deterministic failure, fleet still aligned
        except (FleetTimeout, FleetDesyncError) as exc:
            reason = f"{type(exc).__name__}: {exc}"
            break
    return {"executed": executed, "reason": reason}
