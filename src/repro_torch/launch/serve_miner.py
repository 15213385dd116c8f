"""Resident mining service over HTTP (stdlib only, apart from the service).

  PYTHONPATH=src python -m repro_torch.launch.serve_miner --port 8750 \
      --preload randomized --n 2000 --m 10            # on the CUDA card
  PYTHONPATH=src python -m repro_torch.launch.serve_miner --engine torch \
      --device cpu --preload table.csv                # on the CPU

The service runs on the card by default (``--engine cuda --device cuda``:
the hand-written CUDA kernels); without a card it exits with an error unless
given ``--device cpu`` or ``--engine numpy``.

Endpoints (JSON in / JSON out):

  POST /append   {"rows": [[...], ...]}                 -> version watermarks
  POST /mine     {"tau": 1, "kmax": 3, "ordering": "ascending",
                  "max_itemsets": 100}                  -> itemsets + source
  GET  /mine?tau=1&kmax=3                               -> same, query form
  GET  /mine?tau=1&kmax=3&mode=approx&epsilon=0.1       -> ε-confident sampled
                                                           answer: scaled counts +
                                                           confidence/epsilon/seed/
                                                           boundary_count in "info";
                                                           exact refinement runs in
                                                           the background
  GET  /report?tau=1&kmax=3                             -> sdc quasi-id report
  GET  /risk?tau=1&kmax=3&top=10                        -> per-record risk profile
  GET  /anonymize?tau=1&kmax=3                          -> verified masking plan
  GET  /stats                                           -> store/placement/cache/http stats,
                                                           durability/resilience sections,
                                                           unified executables, last_mine
                                                           timing
  GET  /healthz                                         -> liveness (never gated)
  GET  /readyz                                          -> readiness: 503 while recovering
                                                           (WAL replay / job resume) or while
                                                           the device circuit breaker is open
  POST /cancel   {"tau": 1, "kmax": 3}                  -> cancel in-flight matching runs
  GET  /metrics                                         -> Prometheus text exposition
                                                           (auth-gated, backpressure-exempt)
  GET  /trace?n=10 | /trace?id=TRACE_ID                 -> recent mining-trace span trees;
                                                           &before=SEQ pages backwards
                                                           without duplicates (the response
                                                           carries "next_before")
  GET  /debug/lastcrash                                 -> the previous incarnation's
                                                           parsed flight ring (in-flight
                                                           spans at death, last checkpointed
                                                           level, active request keys)
  GET  /debug/slowlog?n=20                              -> newest-first slow-mine cost
                                                           envelopes (--slow-mine-threshold-s)
  GET  /debug/bundle                                    -> one gzipped JSON postmortem
                                                           bundle: metrics, traces, slowlog,
                                                           lastcrash, stats, exec-cache keys,
                                                           resolved config

Request correlation: every data route runs under a trace. Clients may send
``X-Trace-Id``; the id (incoming or freshly minted) is echoed in the
``X-Trace-Id`` response header and as ``"trace_id"`` in JSON bodies, and the
span tree is retrievable at ``GET /trace?id=...``. ``--log-json`` switches
logs to one-JSON-object-per-line carrying the same ``trace_id``.

``source`` in the /mine response is "cold", "incremental" or "cache". A
``deadline_s`` on /mine bounds the request: an exceeded deadline returns
``499`` with the partial result mined so far (``"source": "partial"``). With
``mode=approx`` the source is "approx" (sample-mined), "refined" (already
promoted to exact) or "cache"; ``/stats`` carries a ``sampling`` section
with the derived sampler seed and refinement counters.

``--profile-dir DIR`` wraps every cold mine in ``torch.profiler`` and writes
its activity (CUDA activity on a card) to ``DIR`` as a Chrome trace (the
mine response's ``info.profile_trace`` names the file).

Durability (``--wal-dir DIR``): appends are WAL-logged and fsync'd before
itemization, snapshots fold the log every ``--snapshot-every`` appends, and
a restarted server recovers the store to the exact pre-crash version (and
resumes interrupted mine jobs from their last checkpointed level). A flight
recorder (off with ``--no-flight``) keeps a crash-persistent event ring
under ``DIR/flight``; the next start serves it parsed at
``/debug/lastcrash``. SIGTERM drains in-flight requests (bounded by
``--drain-timeout``), snapshots the store, and exits 0. A restart with the
same ``--preload`` appends the preload again on top of the recovered store,
as the reference server does: restart without it.

Hardening:

* ``--auth-token TOKEN`` (or env ``MINER_AUTH_TOKEN``) requires
  ``Authorization: Bearer TOKEN`` on every route except ``/healthz``;
  constant-time comparison, 401 on mismatch.
* ``--max-inflight N`` bounds concurrently served requests; when the bound
  is hit new requests get an immediate ``429 {"error": ...}`` instead of
  piling onto the mining worker (liveness stays exempt so probes never 429).
"""

from __future__ import annotations

import argparse
import gzip
import hmac
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..obs import logs as obs_logs
from ..obs import metrics as _om
from ..obs.trace import TRACER as _obs_tracer
from ..obs.trace import current_trace_id as _current_trace_id
from ..obs.trace import span as _obs_span
from ..service import (
    DeadlineExceeded,
    IncrementalConfig,
    MiningService,
    NotReadyError,
)

__all__ = ["make_server", "main"]

_log = obs_logs.get_logger()

# routes are a small fixed set, so route is a safe label; anything else is
# bucketed as "other" to bound cardinality against path scanning
_KNOWN_ROUTES = frozenset(
    {"/append", "/mine", "/report", "/risk", "/anonymize", "/stats",
     "/cancel", "/healthz", "/readyz", "/metrics", "/trace",
     "/debug/lastcrash", "/debug/slowlog", "/debug/bundle"}
)
# data routes run under a trace; probes and the obs endpoints themselves
# don't (a scrape must never displace a mining trace in the ring buffer)
_TRACED_ROUTES = frozenset(
    {"/append", "/mine", "/report", "/risk", "/anonymize", "/cancel"}
)

_HTTP_REQUESTS = _om.counter(
    "repro_http_requests_total",
    "HTTP requests served by route and status code.",
    ("route", "code"),
)
_HTTP_LATENCY = _om.histogram(
    "repro_http_request_seconds",
    "Wall time spent handling one HTTP request.",
    labelnames=("route",),
)


def _mine_params(payload: dict) -> dict:
    return {
        "tau": int(payload.get("tau", 1)),
        "kmax": int(payload.get("kmax", 3)),
        "ordering": str(payload.get("ordering", "ascending")),
    }


class MinerHandler(BaseHTTPRequestHandler):
    service: MiningService  # bound by make_server
    quiet: bool = True
    auth_token: str | None = None
    inflight: threading.BoundedSemaphore | None = None
    http_stats: dict  # shared counters, bound by make_server
    _stats_lock = threading.Lock()
    _trace_id: str | None = None  # per-request, set by _run
    _last_code: int = 0

    def log_message(self, fmt, *args):  # noqa: D102
        if not self.quiet:
            super().log_message(fmt, *args)

    def _count(self, key: str) -> None:
        with self._stats_lock:
            self.http_stats[key] = self.http_stats.get(key, 0) + 1

    def _send(self, code: int, payload: dict) -> None:
        if self._trace_id and isinstance(payload, dict):
            payload.setdefault("trace_id", self._trace_id)
        body = json.dumps(payload).encode()
        self._last_code = code
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self._trace_id:
            self.send_header("X-Trace-Id", self._trace_id)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str,
                   content_type: str = "text/plain; version=0.0.4; charset=utf-8") -> None:
        body = text.encode("utf-8")
        self._last_code = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_gzip_json(self, code: int, payload: dict) -> None:
        body = gzip.compress(json.dumps(payload, default=str).encode("utf-8"))
        self._last_code = code
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(body)))
        if self._trace_id:
            self.send_header("X-Trace-Id", self._trace_id)
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return {}
        return json.loads(self.rfile.read(length) or b"{}")

    def _query(self) -> dict:
        qs = parse_qs(urlparse(self.path).query)
        return {k: v[0] for k, v in qs.items()}

    def _authorized(self) -> bool:
        if not self.auth_token:
            return True
        # compare bytes: compare_digest on str raises TypeError for
        # non-ASCII, and header bytes are attacker-controlled
        header = self.headers.get("Authorization", "").encode("utf-8")
        return hmac.compare_digest(header, f"Bearer {self.auth_token}".encode("utf-8"))

    def _handle(self, payload: dict) -> None:
        route = urlparse(self.path).path
        if route == "/healthz":  # liveness: never auth-gated, never queued
            self._send(200, {"ok": True})
            return
        if route == "/readyz":  # readiness: also probe-exempt, but honest
            ready, reason = self.service.readiness()
            self._send(200 if ready else 503, {"ready": ready, "reason": reason})
            return
        if not self._authorized():
            self._count("unauthorized")
            self._send(401, {"error": "missing or invalid bearer token"})
            return
        if route == "/metrics":
            # backpressure-exempt: a saturated server is exactly when the
            # scrape matters most (still auth-gated — internals leak here)
            self._count("scrapes")
            self._send_text(200, _om.REGISTRY.render())
            return
        if route == "/trace":
            self._handle_trace(payload)
            return
        if route.startswith("/debug/"):
            # forensic snapshots are backpressure-exempt for the same reason
            # /metrics is: a saturated or just-crashed server is exactly when
            # operators need them (still auth-gated — internals leak here)
            self._handle_debug(route, payload)
            return
        if self.inflight is not None and not self.inflight.acquire(blocking=False):
            self._count("rejected")
            self._send(429, {"error": "request queue full, retry later"})
            return
        try:
            self._count("served")
            self._dispatch(route, payload)
        finally:
            if self.inflight is not None:
                self.inflight.release()

    def _dispatch(self, route: str, payload: dict) -> None:
        if route == "/stats":
            stats = self.service.stats()
            with self._stats_lock:
                stats["http"] = dict(self.http_stats)
            stats["http"]["auth"] = bool(self.auth_token)
            stats["http"]["max_inflight"] = (
                self.inflight._initial_value if self.inflight is not None else None
            )
            self._send(200, stats)
        elif route == "/append":
            rows = np.asarray(payload.get("rows", []), dtype=np.int64)
            if rows.size == 0:
                self._send(400, {"error": "append requires non-empty 'rows'"})
                return
            self._send(200, self.service.append(rows))
        elif route == "/mine":
            max_itemsets = payload.get("max_itemsets")
            deadline_s = payload.get("deadline_s")
            mode = str(payload.get("mode", "exact"))
            if mode not in ("exact", "approx"):
                self._send(
                    400, {"error": f"mode must be 'exact' or 'approx', got {mode!r}"}
                )
                return
            epsilon = payload.get("epsilon")
            resp = self.service.mine(
                **_mine_params(payload),
                deadline_s=float(deadline_s) if deadline_s is not None else None,
                mode=mode,
                epsilon=float(epsilon) if epsilon is not None else None,
            )
            # 499 (client-timeout convention): the run stopped at a batch
            # boundary; the body still carries the valid partial answer
            code = 499 if resp.source == "partial" else 200
            if code == 499:
                self._count("deadline_exceeded")
            # itemset decode + JSON encode is real wall time on a cold mine;
            # span it so the trace tree accounts for the full request
            with _obs_span("http.respond"):
                self._send(
                    code,
                    resp.to_json(
                        max_itemsets=int(max_itemsets)
                        if max_itemsets is not None
                        else None
                    ),
                )
        elif route == "/cancel":
            self._send(
                200,
                self.service.cancel(
                    int(payload.get("tau", 1)),
                    int(payload.get("kmax", 3)),
                    str(payload.get("ordering", "ascending")),
                ),
            )
        elif route == "/report":
            self._send(200, self.service.report(**_mine_params(payload)))
        elif route == "/risk":
            top = int(payload.get("top", 10))
            self._send(200, self.service.risk(**_mine_params(payload), top=top))
        elif route == "/anonymize":
            max_sup = payload.get("max_suppressions")
            self._send(
                200,
                self.service.anonymize_plan(
                    **_mine_params(payload),
                    max_suppressions=int(max_sup) if max_sup is not None else 200,
                ),
            )
        else:
            self._send(404, {"error": f"unknown route {route}"})

    def _handle_trace(self, payload: dict) -> None:
        trace_id = payload.get("id")
        if trace_id:
            trace = _obs_tracer.get(str(trace_id))
            if trace is None:
                self._send(404, {"error": f"no stored trace {trace_id!r}"})
                return
            self._send(200, {"trace": trace.to_dict()})
            return
        n = int(payload.get("n", 10))
        before = payload.get("before")
        traces, next_before = _obs_tracer.page(
            n, before=int(before) if before is not None else None
        )
        self._send(
            200,
            {
                "traces": [t.to_dict() for t in traces],
                "next_before": next_before,
                "tracer": _obs_tracer.stats(),
            },
        )

    def _handle_debug(self, route: str, payload: dict) -> None:
        if route == "/debug/lastcrash":
            self._count("debug")
            self._send(
                200, {"report": self.service.last_crash_report()}
            )
        elif route == "/debug/slowlog":
            self._count("debug")
            n = payload.get("n")
            self._send(
                200,
                {
                    "entries": self.service.slowlog_entries(
                        int(n) if n is not None else None
                    ),
                    "slowlog": self.service.slowlog.stats(),
                },
            )
        elif route == "/debug/bundle":
            self._count("debug")
            self._send_gzip_json(200, self.service.debug_bundle())
        else:
            self._send(404, {"error": f"unknown route {route}"})

    def _run(self, payload: dict) -> None:
        try:
            self._handle(payload)
        except NotReadyError as e:
            self._send(503, {"error": str(e), "retry": True})
        except DeadlineExceeded as e:
            # a coalesced waiter timed out; the shared run keeps going for
            # the waiters that imposed no deadline
            self._count("deadline_exceeded")
            self._send(499, {"error": str(e)})
        except Exception as e:  # service must survive bad requests
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _serve(self, payload: dict) -> None:
        route = urlparse(self.path).path
        t0 = time.perf_counter()
        self._trace_id = None
        if route in _TRACED_ROUTES:
            incoming = self.headers.get("X-Trace-Id") or None
            with _obs_tracer.start(
                "http " + route, trace_id=incoming, meta={"route": route}
            ) as sp:
                # sampled-out requests still echo a client-supplied id so
                # upstream correlation survives sampling
                self._trace_id = _current_trace_id() or incoming
                self._run(payload)
                sp.set(code=self._last_code)
        else:
            self._run(payload)
        dt = time.perf_counter() - t0
        label = route if route in _KNOWN_ROUTES else "other"
        _HTTP_REQUESTS.inc(route=label, code=str(self._last_code))
        _HTTP_LATENCY.observe(dt, route=label)
        # probes poll constantly; keep them out of info-level access logs
        log = _log.debug if route in ("/healthz", "/readyz") else _log.info
        log(
            "%s %s %d %.1fms", self.command, route, self._last_code, dt * 1e3,
            extra={"route": label, "code": self._last_code,
                   "duration_ms": round(dt * 1e3, 2)},
        )

    def do_GET(self):  # noqa: N802
        self._serve(self._query())

    def do_POST(self):  # noqa: N802
        try:
            payload = self._body()
        except Exception as e:
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
            return
        self._serve(payload)


def make_server(
    service: MiningService,
    host: str = "127.0.0.1",
    port: int = 8750,
    *,
    quiet: bool = True,
    auth_token: str | None = None,
    max_inflight: int | None = None,
) -> ThreadingHTTPServer:
    sem = None
    if max_inflight is not None:
        if max_inflight <= 0:
            raise ValueError(f"max_inflight must be positive, got {max_inflight}")
        sem = threading.BoundedSemaphore(max_inflight)
    handler = type(
        "BoundMinerHandler",
        (MinerHandler,),
        {
            "service": service,
            "quiet": quiet,
            "auth_token": auth_token,
            "inflight": sem,
            "http_stats": {},
        },
    )
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8750,
                    help="TCP port; 0 binds a free one (logged at startup)")
    ap.add_argument("--engine", default="cuda", choices=["numpy", "torch", "cuda"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the torch/cuda engines")
    ap.add_argument("--cache-capacity", type=int, default=64)
    ap.add_argument("--cache-max-bytes", type=int, default=None,
                    help="bound the result cache by payload bytes, not just "
                         "entry count")
    ap.add_argument("--wal-dir", default=None,
                    help="durability directory (write-ahead log + snapshots); "
                         "a restarted server recovers the store from it")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="fold the WAL into a snapshot every N appends")
    ap.add_argument("--drain-timeout", type=float, default=10.0,
                    help="seconds SIGTERM waits for in-flight requests before "
                         "cancelling them")
    ap.add_argument("--max-delta-fraction", type=float, default=0.25)
    ap.add_argument("--compact-threshold", type=int, default=None,
                    help="auto-compact the store when this many append "
                         "versions accumulate")
    ap.add_argument("--auth-token", default=os.environ.get("MINER_AUTH_TOKEN"),
                    help="require 'Authorization: Bearer <token>' "
                         "(default: $MINER_AUTH_TOKEN)")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="429 when this many requests are already in flight "
                         "(0 disables the bound)")
    ap.add_argument("--preload", default=None,
                    help="'randomized' for a synthetic table, or a path: "
                         "*.csv via data.loaders.read_csv, else FIMI format")
    ap.add_argument("--n", type=int, default=2000, help="--preload randomized rows")
    ap.add_argument("--m", type=int, default=10, help="--preload randomized columns")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--log-level", default="info",
                    choices=["debug", "info", "warning", "error"],
                    help="minimum level for structured logs")
    ap.add_argument("--log-json", action="store_true",
                    help="emit logs as one JSON object per line (with "
                         "trace_id correlation)")
    ap.add_argument("--profile-dir", default=None,
                    help="wrap cold mines in torch.profiler and write Chrome "
                         "traces into this directory")
    ap.add_argument("--trace-max", type=int, default=64,
                    help="ring-buffer size for finished traces (GET /trace)")
    ap.add_argument("--trace-sample", type=int, default=1,
                    help="trace 1 in N requests (1 = every request)")
    ap.add_argument("--slow-mine-threshold-s", type=float, default=1.0,
                    help="mines slower than this land in GET /debug/slowlog "
                         "with their full cost envelope")
    ap.add_argument("--no-flight", action="store_true",
                    help="disable the crash-persistent flight recorder "
                         "(only meaningful with --wal-dir)")
    ap.add_argument("--flight-fsync-s", type=float, default=0.25,
                    help="flight-recorder flush/fsync cadence; checkpoints "
                         "and config events always fsync inline")
    ap.add_argument("--flight-max-bytes", type=int, default=1 << 20,
                    help="on-disk bound for the flight event ring")
    args = ap.parse_args(argv)
    if args.engine != "numpy" and args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.exit(2, f"serve_miner: --engine {args.engine} on {args.device} needs a CUDA card and "
                   "torch sees none; pass --device cpu or --engine numpy to serve from the CPU\n")

    obs_logs.setup(level=args.log_level, json_mode=args.log_json)
    _obs_tracer.configure(
        max_traces=args.trace_max, sample_every=args.trace_sample
    )

    service = MiningService(
        engine=args.engine,
        device=args.device,
        cache_capacity=args.cache_capacity,
        cache_max_bytes=args.cache_max_bytes,
        compact_threshold=args.compact_threshold,
        wal_dir=args.wal_dir,
        snapshot_every=args.snapshot_every,
        incremental=IncrementalConfig(max_delta_fraction=args.max_delta_fraction),
        profile_dir=args.profile_dir,
        slow_mine_threshold_s=args.slow_mine_threshold_s,
        flight_enabled=not args.no_flight,
        flight_fsync_s=args.flight_fsync_s,
        flight_max_bytes=args.flight_max_bytes,
    )

    if args.preload == "randomized":
        from ..data.synth import randomized_dataset

        service.append(randomized_dataset(args.n, args.m, seed=args.seed))
    elif args.preload and args.preload.endswith(".csv"):
        from ..data.loaders import read_csv

        service.append(read_csv(args.preload)[0])
    elif args.preload:
        from ..data.loaders import read_fimi

        service.append(read_fimi(args.preload))

    server = make_server(
        service,
        args.host,
        args.port,
        quiet=not args.verbose,
        auth_token=args.auth_token,
        max_inflight=args.max_inflight or None,
    )
    store = service._store
    port = server.server_address[1]
    _log.info(
        "serve_miner on http://%s:%d (placement=%s, rows=%d, items=%d, "
        "auth=%s, max_inflight=%s, wal=%s, profile=%s)",
        args.host, port, service.placement.describe(),
        store.n_rows if store else 0, store.n_items if store else 0,
        "on" if args.auth_token else "off",
        args.max_inflight or "unbounded", args.wal_dir or "off",
        args.profile_dir or "off",
        extra={"event": "startup", "port": port},
    )

    # graceful shutdown: the server loop runs in a thread; the main thread
    # waits on the signal, stops accepting, drains in-flight work (bounded),
    # snapshots the durable store, and exits 0 so supervisors see a clean stop
    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        while not stop.wait(0.2):
            pass
    except KeyboardInterrupt:
        pass
    _log.info("serve_miner draining...", extra={"event": "drain"})
    server.shutdown()
    thread.join()
    drain = service.drain(args.drain_timeout)
    snapshot = service.snapshot_store()
    server.server_close()
    service.close()
    _log.info(
        "serve_miner stopped (drained=%d, abandoned=%d, snapshot=%s)",
        drain["drained"], drain["abandoned"],
        "v%d" % snapshot if snapshot is not None else "none",
        extra={"event": "shutdown", "drained": drain["drained"],
               "abandoned": drain["abandoned"]},
    )
    sys.exit(0)


if __name__ == "__main__":
    main()
