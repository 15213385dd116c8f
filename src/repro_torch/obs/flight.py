"""Black-box flight recorder: crash-persistent telemetry (stdlib leaf).

The port's own copy of the reference package's ``repro.obs.flight``, with
its on-disk format: a ring written by either package parses in the other.

The durability layer (``service/wal.py``) recovers the *data* after a crash;
this module recovers the *explanation*. A :class:`FlightRecorder` keeps a
bounded, CRC-framed, append-only event ring on disk under
``wal_dir/flight/`` recording span open/close (via a tracer listener), level
checkpoints, placement dispatch failures, breaker transitions, WAL/snapshot
events and the resolved config at startup. On restart, :func:`recover`
parses the previous incarnation's ring into a :class:`LastCrashReport` —
which spans were in flight at death, the last completed/checkpointed level,
which request keys were active — served at ``GET /debug/lastcrash``.

Frame format mirrors ``service/wal.py``'s discipline exactly:
``KFLT | crc32(payload) | len(payload) | payload`` with a JSON payload
(one event dict). Replay walks the longest valid prefix per segment; a
torn tail (power cut mid-flush) is detected by CRC/length and dropped,
never propagated.

Boundedness + crash-isolation come from **incarnation-numbered segment
pairs**: incarnation ``N`` writes ``inc<N>.a`` / ``inc<N>.b``, rotating to
the other segment (truncating it) whenever the active one exceeds
``max_bytes // 2`` — total disk use stays ~``max_bytes``. A new
incarnation unlinks its predecessors' files *after* recovery has parsed
them, so an abandoned (killed-but-not-reaped) recorder keeps writing to an
unlinked inode instead of corrupting the live ring.

Hot-path cost: :meth:`FlightRecorder.record` appends a dict to an
in-memory buffer under a lock — no I/O. A daemon thread flushes
(frame + write + fdatasync) every ``fsync_interval_s``; **durable** kinds
(checkpoints, config, shutdown) flush the whole buffer inline so the
events that matter for forensics are on disk the moment they happen,
carrying any buffered span-opens with them.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field

from . import metrics as _om

__all__ = [
    "FlightRecorder",
    "LastCrashReport",
    "recover",
    "read_segment",
    "FLIGHT_SPANS",
    "DURABLE_KINDS",
]

MAGIC = b"KFLT"
_HEADER = struct.Struct("<4sII")  # magic, crc32(payload), len(payload)

# Span names worth persisting. Everything else (per-batch micro-spans,
# wal.append on the hot path) stays in-memory-only — the ring is a crash
# narrative, not a full trace store.
FLIGHT_SPANS = frozenset({
    "service.mine",
    "service.append",
    "mine.cold",
    "mine.incremental",
    "mine.preprocess",
    "mine.sample",
    "mine.refine",
    "mine.level",
    "mine.checkpoint",
    "store.recover",
    "store.snapshot",
})

# Kinds that flush the buffer inline (fsync before returning): the events a
# postmortem cannot afford to lose to a crash landing inside the cadence
# window.
DURABLE_KINDS = frozenset({
    "config",
    "job.checkpoint",
    "store.snapshot",
    "store.recover",
    "breaker.transition",
    "shutdown",
})

_EVENTS = _om.counter(
    "repro_flight_events_total", "Flight-recorder events recorded.",
    ("kind",),
)
_FLUSHES = _om.counter(
    "repro_flight_flushes_total", "Flight-recorder buffer flushes (fsync'd)."
)
_FLT_BYTES = _om.counter(
    "repro_flight_bytes_written_total",
    "Flight-ring bytes written (incl. frame headers).",
)
_ROTATIONS = _om.counter(
    "repro_flight_rotations_total", "Flight-ring segment rotations."
)
_RECOVERIES = _om.counter(
    "repro_flight_recoveries_total",
    "Flight rings parsed into a LastCrashReport on startup.",
)


def _json_safe(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    try:  # numpy scalars and friends
        return v.item()
    except Exception:
        return str(v)


def _fdatasync(fh) -> None:
    fh.flush()
    try:
        os.fdatasync(fh.fileno())
    except (AttributeError, OSError):
        os.fsync(fh.fileno())


def _segment_name(incarnation: int, side: str) -> str:
    return f"inc{incarnation}.{side}"


def scan_incarnations(directory: str) -> list[int]:
    """Incarnation numbers present in ``directory``, ascending."""
    incs: set[int] = set()
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        if name.startswith("inc") and name[-2:] in (".a", ".b"):
            try:
                incs.add(int(name[3:-2]))
            except ValueError:
                pass
    return sorted(incs)


def read_segment(path: str) -> tuple[list[dict], int]:
    """Decode the longest valid frame prefix of one segment file.

    Returns ``(events, torn_bytes)`` — a torn/corrupt tail is tolerated
    (it was mid-flush at death), counted, and everything before it kept.
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], 0
    events: list[dict] = []
    off = 0
    good_end = 0
    while off + _HEADER.size <= len(data):
        magic, crc, length = _HEADER.unpack_from(data, off)
        body = data[off + _HEADER.size: off + _HEADER.size + length]
        if magic != MAGIC or len(body) < length or zlib.crc32(body) != crc:
            break
        try:
            ev = json.loads(body.decode("utf-8"))
        except Exception:
            break
        if isinstance(ev, dict):
            events.append(ev)
        off += _HEADER.size + length
        good_end = off
    return events, len(data) - good_end


@dataclass
class LastCrashReport:
    """What the previous incarnation was doing when it stopped."""

    incarnation: int
    clean_shutdown: bool
    started_at: float | None
    last_event_at: float | None
    n_events: int
    torn_bytes: int
    config: dict | None
    # spans opened but never closed — the work in flight at death
    open_spans: list[dict] = field(default_factory=list)
    # the last durably checkpointed mine level (kind=job.checkpoint)
    last_checkpoint: dict | None = None
    # the last mine.level span that *completed* before death
    last_completed_level: int | None = None
    # cache keys of service.mine spans still open at death
    active_request_keys: list = field(default_factory=list)
    # trailing non-span events (breaker trips, dispatch failures, ...)
    recent_events: list[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "incarnation": self.incarnation,
            "clean_shutdown": self.clean_shutdown,
            "started_at": self.started_at,
            "last_event_at": self.last_event_at,
            "n_events": self.n_events,
            "torn_bytes": self.torn_bytes,
            "config": self.config,
            "open_spans": self.open_spans,
            "last_checkpoint": self.last_checkpoint,
            "last_completed_level": self.last_completed_level,
            "active_request_keys": self.active_request_keys,
            "recent_events": self.recent_events,
        }


def _build_report(incarnation: int, events: list[dict], torn: int) -> LastCrashReport:
    events = sorted(events, key=lambda e: e.get("seq", 0))
    opens: dict[str, dict] = {}
    config = None
    last_checkpoint = None
    last_completed_level = None
    clean = False
    recent: list[dict] = []
    for ev in events:
        kind = ev.get("kind")
        if kind == "span.open":
            opens[ev.get("span_id", "")] = ev
        elif kind == "span.close":
            closed = opens.pop(ev.get("span_id", ""), None)
            if closed is not None and closed.get("name") == "mine.level":
                k = closed.get("attrs", {}).get("k")
                if isinstance(k, int):
                    last_completed_level = k
        elif kind == "config":
            config = ev.get("config")
        elif kind == "job.checkpoint":
            last_checkpoint = {
                k: v for k, v in ev.items() if k not in ("kind", "seq")
            }
        elif kind == "shutdown":
            clean = True
        else:
            recent.append(ev)
    open_spans = [
        {
            "name": e.get("name"),
            "trace_id": e.get("trace_id"),
            "span_id": e.get("span_id"),
            "attrs": e.get("attrs", {}),
            "t": e.get("t"),
        }
        for e in sorted(opens.values(), key=lambda e: e.get("seq", 0))
    ]
    active_keys = []
    for e in open_spans:
        key = e["attrs"].get("key")
        if key is not None and key not in active_keys:
            active_keys.append(key)
    return LastCrashReport(
        incarnation=incarnation,
        clean_shutdown=clean and not open_spans,
        started_at=events[0].get("t") if events else None,
        last_event_at=events[-1].get("t") if events else None,
        n_events=len(events),
        torn_bytes=torn,
        config=config,
        open_spans=open_spans,
        last_checkpoint=last_checkpoint,
        last_completed_level=last_completed_level,
        active_request_keys=active_keys,
        recent_events=recent[-16:],
    )


def recover(directory: str) -> LastCrashReport | None:
    """Parse the newest previous incarnation's ring into a report.

    Returns ``None`` when no previous incarnation exists (first boot).
    Also persists the report as ``lastcrash.json`` beside the ring so a
    postmortem can read it even after the next incarnation rotates.
    """
    incs = scan_incarnations(directory)
    if not incs:
        return None
    inc = incs[-1]
    events: list[dict] = []
    torn = 0
    for side in ("a", "b"):
        evs, t = read_segment(os.path.join(directory, _segment_name(inc, side)))
        events.extend(evs)
        torn += t
    report = _build_report(inc, events, torn)
    _RECOVERIES.inc()
    try:
        with open(os.path.join(directory, "lastcrash.json"), "w") as f:
            json.dump(report.to_dict(), f, indent=1, default=str)
    except OSError:
        pass
    return report


class FlightRecorder:
    """Bounded on-disk event ring with batched fsync'd writes."""

    def __init__(
        self,
        directory: str,
        *,
        fsync_interval_s: float = 0.25,
        max_bytes: int = 1 << 20,
    ):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.fsync_interval_s = max(0.01, float(fsync_interval_s))
        self.max_bytes = max(4096, int(max_bytes))
        incs = scan_incarnations(directory)
        self.incarnation = (incs[-1] + 1) if incs else 1
        self._lock = threading.Lock()
        self._buffer: list[dict] = []
        self._seq = 0
        self._side = "a"
        self._fh = open(self._segment_path("a"), "ab")
        # reap predecessors: recovery (if any) already parsed them, and an
        # abandoned recorder holding an fd keeps its unlinked inode alive
        # without touching our files
        for inc in incs:
            for side in ("a", "b"):
                try:
                    os.unlink(os.path.join(directory, _segment_name(inc, side)))
                except OSError:
                    pass
        self.events_recorded = 0
        self.flushes = 0
        self.bytes_written = 0
        self.rotations = 0
        self.flush_errors = 0
        self._halted = False
        self._closed = False
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._flush_loop, name="flight-flusher", daemon=True
        )
        self._thread.start()

    def _segment_path(self, side: str) -> str:
        return os.path.join(self.directory, _segment_name(self.incarnation, side))

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, *, durable: bool | None = None, **fields) -> None:
        """Buffer one event. ``durable`` kinds (or ``durable=True``) flush
        the whole buffer inline — fsync'd before returning."""
        if self._closed or self._halted:
            return
        ev = {"kind": kind, "t": time.time()}
        for k, v in fields.items():
            ev[k] = _json_safe(v)
        flush_now = durable if durable is not None else kind in DURABLE_KINDS
        with self._lock:
            if self._closed or self._halted:
                return
            ev["seq"] = self._seq
            self._seq += 1
            self._buffer.append(ev)
            self.events_recorded += 1
            if flush_now:
                self._flush_locked()
        _EVENTS.inc(kind=kind)

    def span_listener(self, event: str, sp, trace) -> None:
        """Tracer listener (``Tracer.add_listener``): persist open/close of
        the spans that narrate a mine. Never raises."""
        name = sp.name
        if name not in FLIGHT_SPANS and not name.startswith("http "):
            return
        if event == "open":
            self.record(
                "span.open",
                name=name,
                trace_id=sp.trace_id,
                span_id=sp.span_id,
                parent_id=sp.parent_id,
                attrs=sp.attrs,
            )
        else:
            self.record(
                "span.close",
                name=name,
                trace_id=sp.trace_id,
                span_id=sp.span_id,
                duration_s=round(sp.duration, 6),
            )

    # -- flushing ------------------------------------------------------------

    def _flush_loop(self) -> None:
        while not self._wake.wait(self.fsync_interval_s):
            with self._lock:
                if self._closed or self._halted:
                    return
                if self._buffer:
                    self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buffer:
            return
        frames = []
        for ev in self._buffer:
            payload = json.dumps(
                ev, separators=(",", ":"), default=str
            ).encode("utf-8")
            frames.append(
                _HEADER.pack(MAGIC, zlib.crc32(payload), len(payload)) + payload
            )
        blob = b"".join(frames)
        self._buffer.clear()
        try:
            self._fh.write(blob)
            _fdatasync(self._fh)
            self.flushes += 1
            self.bytes_written += len(blob)
            if self._fh.tell() > self.max_bytes // 2:
                self._rotate_locked()
        except OSError:
            self.flush_errors += 1
            return
        _FLUSHES.inc()
        _FLT_BYTES.inc(len(blob))

    def _rotate_locked(self) -> None:
        self._fh.close()
        self._side = "b" if self._side == "a" else "a"
        path = self._segment_path(self._side)
        # truncate the segment we are rotating into — its events are the
        # oldest in the ring and give way to new ones (bounded total size)
        self._fh = open(path, "wb")
        self.rotations += 1
        _ROTATIONS.inc()

    def flush(self) -> None:
        with self._lock:
            if not (self._closed or self._halted):
                self._flush_locked()

    # -- lifecycle -----------------------------------------------------------

    def halt(self) -> None:
        """Simulate instant process death: discard the in-memory buffer and
        stop flushing, leaving only what already reached disk. Test seam —
        a Python 'kill' unwinds context managers (recording span closes a
        real crash never would), so chaos tests call this the moment the
        KillPoint propagates."""
        with self._lock:
            self._halted = True
            self._buffer.clear()
        self._wake.set()

    def close(self) -> None:
        """Orderly shutdown: record the terminal event, flush, stop."""
        if self._closed:
            return
        self.record("shutdown", durable=True)
        with self._lock:
            self._closed = True
        self._wake.set()
        self._thread.join(timeout=2.0)
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass

    def stats(self) -> dict:
        with self._lock:
            return {
                "directory": self.directory,
                "incarnation": self.incarnation,
                "events_recorded": self.events_recorded,
                "buffered": len(self._buffer),
                "flushes": self.flushes,
                "bytes_written": self.bytes_written,
                "rotations": self.rotations,
                "flush_errors": self.flush_errors,
                "fsync_interval_s": self.fsync_interval_s,
                "max_bytes": self.max_bytes,
                "halted": self._halted,
                "closed": self._closed,
            }
