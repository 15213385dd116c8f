"""The port's black-box flight recorder (``repro_torch.obs.flight``) and
per-mine cost forensics, ported from ``tests/test_flight.py`` to the port's
service on the CPU (``engine="torch"`` and numpy), and held against the
reference's recorder: a ring written by either package parses in the other
into the same report.

Covers frame/segment mechanics (CRC framing, durable-kind inline flush,
torn-tail truncation, rotation, incarnation reaping), ``halt()`` as the
simulated-instant-death seam, the ``LastCrashReport``, the chaos scenario
(kill mid-mine, restart, and the report's in-flight level and checkpoint
agree with the level the resumed mine continues from), cost envelopes on
every answer path, and the HTTP debug routes.
"""

import gzip
import json
import os
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.core import KyivConfig as RefConfig
from repro.core import mine as ref_mine
from repro.obs import flight as ref_flight
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import metrics as om
from repro_torch.obs.metrics import lint_exposition
from repro_torch.service import FaultInjector, KillPoint, MiningService

ENGINES = ["torch", "numpy"]


def _rand(seed, n, m, dom=4):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


def _sets(result):
    return result.canonical_set()


def _service(engine="numpy", **kw):
    return MiningService(engine=engine, device="cpu", **kw)


# a recorder whose cadence never fires during a test: only explicit
# flush() calls and durable kinds reach disk
SLOW = dict(fsync_interval_s=60.0)


def _segments(d, inc):
    return [os.path.join(d, f"inc{inc}.{s}") for s in ("a", "b")]


def _disk_events(d, inc):
    events, torn = [], 0
    for path in _segments(d, inc):
        evs, t = obs_flight.read_segment(path)
        events.extend(evs)
        torn += t
    return sorted(events, key=lambda e: e["seq"]), torn


# ---------------------------------------------------------------------------
# frame / segment mechanics
# ---------------------------------------------------------------------------


def test_record_flush_roundtrip(tmp_path):
    d = str(tmp_path)
    rec = obs_flight.FlightRecorder(d, **SLOW)
    rec.record("dispatch.failure", error="DeviceFault", attempt=1)
    rec.record("probe", value=np.int64(7), arr=(1, 2))
    assert _disk_events(d, rec.incarnation)[0] == []  # buffered, no I/O yet
    rec.flush()
    events, torn = _disk_events(d, rec.incarnation)
    assert torn == 0
    assert [e["kind"] for e in events] == ["dispatch.failure", "probe"]
    assert events[0]["error"] == "DeviceFault"
    assert events[1]["value"] == 7 and events[1]["arr"] == [1, 2]
    assert [e["seq"] for e in events] == [0, 1]
    rec.close()


def test_durable_kind_flushes_inline_carrying_buffer(tmp_path):
    d = str(tmp_path)
    rec = obs_flight.FlightRecorder(d, **SLOW)
    rec.record("span.open", name="mine.level", span_id="s1", attrs={"k": 2})
    assert _disk_events(d, rec.incarnation)[0] == []
    # the durable checkpoint fsyncs the buffered span-open along with itself
    rec.record("job.checkpoint", level=2, key=[2, 4, "exact"])
    events, _ = _disk_events(d, rec.incarnation)
    assert [e["kind"] for e in events] == ["span.open", "job.checkpoint"]
    assert rec.stats()["buffered"] == 0
    rec.close()


def test_torn_tail_truncated_like_wal(tmp_path):
    """Mirror of the WAL's torn-tail cases on the flight ring: garbage, a
    half-written frame, and a corrupted byte are each dropped without
    losing the valid prefix."""
    import zlib

    d = str(tmp_path)
    rec = obs_flight.FlightRecorder(d, **SLOW)
    for i in range(4):
        rec.record("ev", i=i)
    rec.flush()
    path = rec._segment_path(rec._side)
    rec.halt()

    good = open(path, "rb").read()
    # power cut mid-flush: half of a fifth frame reaches the platter
    payload = json.dumps({"kind": "ev", "i": 4, "seq": 4}).encode()
    frame = obs_flight._HEADER.pack(
        obs_flight.MAGIC, zlib.crc32(payload), len(payload)
    ) + payload
    with open(path, "ab") as f:
        f.write(frame[: len(frame) // 2])
    events, torn = obs_flight.read_segment(path)
    assert [e["i"] for e in events] == [0, 1, 2, 3]
    assert torn == len(frame) // 2

    # plain garbage tail
    with open(path, "wb") as f:
        f.write(good + b"\x00garbage-tail")
    events, torn = obs_flight.read_segment(path)
    assert len(events) == 4 and torn == len(b"\x00garbage-tail")

    # one flipped byte inside the last frame: CRC rejects it
    corrupt = bytearray(good)
    corrupt[-3] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(corrupt))
    events, torn = obs_flight.read_segment(path)
    assert [e["i"] for e in events] == [0, 1, 2] and torn > 0

    # recover() tolerates the torn ring and still builds a report
    report = obs_flight.recover(d)
    assert report is not None and report.n_events == 3
    assert report.torn_bytes == torn and not report.clean_shutdown


def test_rotation_keeps_total_disk_bounded(tmp_path):
    d = str(tmp_path)
    rec = obs_flight.FlightRecorder(d, fsync_interval_s=60.0, max_bytes=4096)
    pad = "x" * 64
    for i in range(200):
        rec.record("ev", i=i, pad=pad, durable=True)  # one frame per flush
    st = rec.stats()
    assert st["rotations"] >= 2
    total = sum(
        os.path.getsize(p) for p in _segments(d, rec.incarnation)
        if os.path.exists(p)
    )
    # each segment stays under max_bytes//2 plus one in-flight frame
    assert total <= 4096 + 2 * 256
    # the newest events survived rotation; recovery sees the recent tail
    events, _ = _disk_events(d, rec.incarnation)
    assert events and events[-1]["i"] == 199
    rec.halt()
    report = obs_flight.recover(d)
    assert report.n_events == len(events) < 200


def test_incarnations_reaped_and_lastcrash_persisted(tmp_path):
    d = str(tmp_path)
    assert obs_flight.recover(d) is None  # first boot: nothing to report
    rec1 = obs_flight.FlightRecorder(d, **SLOW)
    rec1.record("config", config={"tau": 2})
    rec1.close()

    report = obs_flight.recover(d)
    assert report.incarnation == rec1.incarnation
    assert report.clean_shutdown and report.config == {"tau": 2}
    assert json.load(open(os.path.join(d, "lastcrash.json")))["clean_shutdown"]

    rec2 = obs_flight.FlightRecorder(d, **SLOW)
    assert rec2.incarnation == rec1.incarnation + 1
    # predecessors reaped: only the live incarnation's segments remain
    assert obs_flight.scan_incarnations(d) == [rec2.incarnation]
    rec2.close()


def test_halt_discards_buffered_events(tmp_path):
    d = str(tmp_path)
    rec = obs_flight.FlightRecorder(d, **SLOW)
    rec.record("job.checkpoint", level=3)  # durable -> on disk
    rec.record("span.close", name="mine.level", span_id="s9")  # buffered
    rec.halt()
    events, _ = _disk_events(d, rec.incarnation)
    assert [e["kind"] for e in events] == ["job.checkpoint"]
    rec.record("late", x=1)  # ignored after halt
    rec.flush()
    assert len(_disk_events(d, rec.incarnation)[0]) == 1


# ---------------------------------------------------------------------------
# span listener + report construction
# ---------------------------------------------------------------------------


def _span(name, span_id, **attrs):
    return types.SimpleNamespace(
        name=name, trace_id="t1", span_id=span_id, parent_id=None,
        attrs=attrs, duration=0.01,
    )


def _crash_narrative(rec):
    mine_sp = _span("service.mine", "s1", key=[2, 3, "exact"])
    lvl2, lvl3 = _span("mine.level", "s2", k=2), _span("mine.level", "s3", k=3)
    for sp in (mine_sp, lvl2):
        rec.span_listener("open", sp, None)
    rec.span_listener("close", lvl2, None)
    rec.span_listener("open", lvl3, None)
    # hot-path micro-spans are filtered out of the ring
    rec.span_listener("open", _span("wal.append", "s4"), None)
    rec.record("breaker.transition", state="open")
    rec.record("job.checkpoint", level=2)
    rec.halt()


def test_span_listener_filters_and_report_names_in_flight_work(tmp_path):
    d = str(tmp_path)
    rec = obs_flight.FlightRecorder(d, **SLOW)
    _crash_narrative(rec)

    report = obs_flight.recover(d)
    assert not report.clean_shutdown
    open_names = {(s["name"], s["attrs"].get("k")) for s in report.open_spans}
    assert open_names == {("service.mine", None), ("mine.level", 3)}
    assert report.last_completed_level == 2
    assert report.last_checkpoint["level"] == 2
    assert report.active_request_keys == [[2, 3, "exact"]]
    rec.close()


def test_clean_close_yields_clean_report(tmp_path):
    d = str(tmp_path)
    rec = obs_flight.FlightRecorder(d, **SLOW)
    sp = _span("service.mine", "s1")
    rec.span_listener("open", sp, None)
    rec.span_listener("close", sp, None)
    rec.close()
    report = obs_flight.recover(d)
    assert report.clean_shutdown and report.open_spans == []


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_ring_crosses_packages(tmp_path, writer):
    """A ring written by one package's recorder parses into the same report
    in the other's (the report's own timestamps and counts included)."""
    module = ref_flight if writer == "reference" else obs_flight
    d = str(tmp_path)
    rec = module.FlightRecorder(d, **SLOW)
    _crash_narrative(rec)
    want = ref_flight._build_report(*_read_ring(ref_flight, d)).to_dict()
    got = obs_flight._build_report(*_read_ring(obs_flight, d)).to_dict()
    assert got == want and got["last_checkpoint"]["level"] == 2
    assert obs_flight.FLIGHT_SPANS == ref_flight.FLIGHT_SPANS
    assert obs_flight.DURABLE_KINDS == ref_flight.DURABLE_KINDS


def _read_ring(module, d):
    inc = module.scan_incarnations(d)[-1]
    events, torn = [], 0
    for side in ("a", "b"):
        evs, t = module.read_segment(os.path.join(d, f"inc{inc}.{side}"))
        events += evs
        torn += t
    return inc, events, torn


# ---------------------------------------------------------------------------
# chaos: kill mid-mine -> crash report agrees with the resumed job
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_kill_mid_mine_crash_report_matches_resume_checkpoint(tmp_path, engine):
    data = _rand(0, 150, 6, 4)
    cfg = dict(tau=2, kmax=4)
    undisturbed = ref_mine(data, RefConfig(**cfg))

    d = str(tmp_path / "wal")
    inj = FaultInjector()
    # cadence far beyond the test: only durable checkpoint flushes persist,
    # exactly what a real power cut inside the fsync window leaves behind
    svc = _service(engine, wal_dir=d, fault_injector=inj, flight_fsync_s=60.0)
    svc.append(data)
    inj.arm("mine.level_end", action="raise", exc=KillPoint("mid-mine"), after=1)
    with pytest.raises(KillPoint):
        svc.mine(**cfg)
    # the KillPoint unwound the span stack (a real crash would not have) —
    # halt() discards those buffered closes, freezing the on-disk ring at
    # the instant of death
    svc.flight.halt()
    svc.close()

    svc2 = _service(engine, wal_dir=d)
    try:
        report = svc2.last_crash
        assert report is not None and not report.clean_shutdown
        assert svc2.last_crash_report() == report.to_dict()

        # the ring names the level that was in flight when the process died
        open_levels = [
            s["attrs"].get("k") for s in report.open_spans
            if s["name"] == "mine.level"
        ]
        assert len(open_levels) == 1
        in_flight = open_levels[0]
        assert report.last_completed_level == in_flight - 1
        assert report.last_checkpoint["level"] == in_flight
        assert report.active_request_keys  # the mine's cache key, captured

        # ...and the restarted service resumes from that same checkpoint
        assert svc2.stats()["durability"]["resumed_jobs"] == 1
        r = svc2.mine(**cfg)
        assert r.info["resumed_from_level"] == report.last_checkpoint["level"] + 1
        assert _sets(r.result) == undisturbed.canonical_set()

        fr = svc2.stats()["forensics"]
        assert fr["last_crash"]["clean_shutdown"] is False
        assert fr["last_crash"]["open_spans"] >= 1
        assert fr["flight"]["incarnation"] == report.incarnation + 1
    finally:
        svc2.close()

    # an orderly close is distinguishable from the crash
    svc3 = _service(engine, wal_dir=d)
    assert svc3.last_crash is not None and svc3.last_crash.clean_shutdown
    svc3.close()


# ---------------------------------------------------------------------------
# cost accounting on every answer path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_cost_envelope_per_answer_path(tmp_path, engine):
    from repro_torch.obs.cost import SLOW_MINES

    d = str(tmp_path / "wal")
    svc = _service(engine, wal_dir=d, slow_mine_threshold_s=0.0)
    slow_cold_before = SLOW_MINES.value(path="cold")
    try:
        svc.append(_rand(0, 150, 6, 4))
        r = svc.mine(tau=2, kmax=4)
        cost = r.info["cost"]
        assert cost["path"] == "cold"
        assert cost["rows_scanned"] > 0 and cost["candidate_pairs"] > 0
        assert cost["levels"] >= 2 and cost["itemsets_emitted"] > 0
        assert cost["executables_compiled"] >= 0
        assert cost["wall_s"] >= 0 and cost["trace_id"]

        r2 = svc.mine(tau=2, kmax=4)
        c2 = r2.info["cost"]
        assert c2["path"] == "cache" and c2["levels"] == 0
        assert c2["rows_scanned"] == 0  # a cache hit scans nothing

        svc.append(_rand(1, 30, 6, 4))
        r3 = svc.mine(tau=2, kmax=4)
        c3 = r3.info["cost"]
        assert c3["path"] == "incremental" and c3["levels"] >= 1
        assert c3["trace_id"] != cost["trace_id"]

        # every mine crossed the 0s slow threshold into the forensics ring
        entries = svc.slowlog_entries()
        assert len(entries) == 3
        assert entries[0]["path"] == "incremental"  # newest first
        assert all(e["trace_id"] for e in entries)
        assert svc.stats()["forensics"]["slowlog"]["total"] == 3

        # the counter is process-global — assert the delta, not the total
        assert SLOW_MINES.value(path="cold") == slow_cold_before + 1
        text = om.REGISTRY.render()
        assert lint_exposition(text) == []
        assert 'repro_slow_mines_total{path="cold"}' in text
        assert 'repro_mine_cost_candidate_pairs_bucket{path="cold"' in text
        assert "repro_flight_events_total" in text
        assert "repro_service_resumed_jobs_total 0" in text
        # exemplar: the latency histogram links back to the mine's trace
        assert f'# {{trace_id="{cost["trace_id"]}"}}' in text
    finally:
        svc.close()


def test_cost_envelope_on_sampled_path():
    from repro_torch.service import SamplingConfig

    svc = MiningService.from_dataset(
        _rand(2, 400, 5, 4),
        engine="torch",
        device="cpu",
        sampling=SamplingConfig(oversample=1.0, min_rows=64),
    )
    try:
        r = svc.mine(tau=3, kmax=3, mode="approx")
        cost = r.info["cost"]
        assert cost["path"] in ("approx", "refined")
        assert cost["rows_scanned"] > 0 and cost["trace_id"]
    finally:
        svc.close()


def test_slowlog_threshold_filters(tmp_path):
    svc = MiningService.from_dataset(
        _rand(0, 80, 5, 4), engine="numpy", slow_mine_threshold_s=1e9
    )
    try:
        svc.mine(tau=2, kmax=3)
        assert svc.slowlog_entries() == []  # nothing is that slow
        assert svc.stats()["forensics"]["slowlog"]["total"] == 0
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# HTTP: /debug/lastcrash, /debug/slowlog, /debug/bundle
# ---------------------------------------------------------------------------


def _req(port, path, payload=None, headers=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(payload).encode() if payload is not None else None
    resp = urllib.request.urlopen(
        urllib.request.Request(url, data=data, headers=headers or {}), timeout=60
    )
    return resp, resp.read()


@pytest.fixture()
def debug_http_service(tmp_path):
    from repro_torch.launch.serve_miner import make_server

    svc = _service(
        "torch", wal_dir=str(tmp_path / "wal"), slow_mine_threshold_s=0.0
    )
    svc.append(_rand(0, 120, 5, 4))
    server = make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield svc, server.server_address[1]
    server.shutdown()
    server.server_close()
    svc.close()


def test_http_debug_endpoints_and_bundle(debug_http_service):
    _, port = debug_http_service
    resp, body = _req(port, "/debug/lastcrash")
    assert json.loads(body)["report"] is None  # first boot over this dir

    _req(port, "/mine", {"tau": 2, "kmax": 3})
    _req(port, "/mine", {"tau": 2, "kmax": 4})

    _, body = _req(port, "/debug/slowlog?n=1")
    j = json.loads(body)
    assert len(j["entries"]) == 1 and j["slowlog"]["total"] == 2
    assert j["entries"][0]["trace_id"] and "wall_s" in j["entries"][0]

    resp, body = _req(port, "/debug/bundle")
    assert resp.headers["Content-Encoding"] == "gzip"
    assert resp.headers["Content-Type"].startswith("application/json")
    bundle = json.loads(gzip.decompress(body))
    for key in ("generated_at", "config", "stats", "metrics", "traces",
                "slowlog", "lastcrash", "exec_cache_keys", "flight"):
        assert key in bundle, key
    assert bundle["config"]["slow_mine_threshold_s"] == 0.0
    assert bundle["config"]["mining"]["engine"] == "torch"
    assert bundle["stats"]["store"]["n_rows"] == 120
    assert bundle["stats"]["durability"]["wal_appends"] == 1
    assert "repro_service_mine_latency_seconds" in bundle["metrics"]
    assert len(bundle["slowlog"]) == 2
    assert any(t["spans"] for t in bundle["traces"])

    with pytest.raises(urllib.error.HTTPError) as e:
        _req(port, "/debug/nosuch")
    assert e.value.code == 404


def test_debug_routes_auth_gated_but_backpressure_exempt():
    from repro_torch.launch.serve_miner import make_server

    svc = MiningService.from_dataset(_rand(0, 60, 3, 4), engine="numpy")
    server = make_server(svc, port=0, auth_token="tok", max_inflight=1)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        for route in ("/debug/slowlog", "/debug/lastcrash", "/debug/bundle"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _req(port, route)
            assert e.value.code == 401
        resp, body = _req(
            port, "/debug/slowlog", headers={"Authorization": "Bearer tok"}
        )
        assert resp.status == 200 and "entries" in json.loads(body)
        # a held in-flight slot (the bound is 1) turns data routes away,
        # never the debug routes
        assert server.RequestHandlerClass.inflight.acquire(blocking=False)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _req(port, "/stats", headers={"Authorization": "Bearer tok"})
            assert e.value.code == 429
            resp, body = _req(
                port, "/debug/lastcrash", headers={"Authorization": "Bearer tok"}
            )
            assert resp.status == 200 and json.loads(body) == {"report": None}
        finally:
            server.RequestHandlerClass.inflight.release()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_no_flight_flag_disables_recorder(tmp_path):
    svc = _service(
        "numpy", wal_dir=str(tmp_path / "wal"), flight_enabled=False
    )
    try:
        assert svc.flight is None and svc.last_crash is None
        svc.append(_rand(0, 40, 4, 4))
        r = svc.mine(tau=2, kmax=3)
        assert r.info["cost"]["path"] == "cold"  # cost accounting still on
        assert svc.stats()["forensics"]["flight"] is None
        assert not os.path.isdir(os.path.join(str(tmp_path / "wal"), "flight"))
    finally:
        svc.close()


def test_serve_miner_durable_flags(tmp_path, monkeypatch):
    """``--wal-dir``, ``--snapshot-every``, ``--no-flight`` and the flight
    cadence and bound reach the service; SIGTERM snapshots the store."""
    from repro_torch.launch import serve_miner

    made = {}
    real = serve_miner.MiningService

    def spy(**kw):
        made.update(kw)
        made["service"] = real(**kw)
        return made["service"]

    monkeypatch.setattr(serve_miner, "MiningService", spy)
    # the handler runs as it is installed: the server stops at once
    monkeypatch.setattr(serve_miner.signal, "signal", lambda sig, handler: handler(sig, None))
    d = str(tmp_path / "wal")
    with pytest.raises(SystemExit) as e:
        serve_miner.main(["--engine", "numpy", "--port", "0", "--preload", "randomized",
                          "--n", "200", "--m", "4", "--wal-dir", d, "--snapshot-every", "3",
                          "--flight-fsync-s", "0.5", "--flight-max-bytes", "65536"])
    assert e.value.code == 0
    assert made["wal_dir"] == d and made["snapshot_every"] == 3
    assert made["flight_enabled"] and made["flight_fsync_s"] == 0.5
    assert made["flight_max_bytes"] == 65536
    # the stop folded the store into a snapshot and closed the ring cleanly
    svc = _service("numpy", wal_dir=d)
    assert svc.stats()["durability"]["last_recovery"] == {
        "snapshot_version": 1, "replayed": 0, "skipped": 0, "truncated_bytes": 0,
        "version": 1, "resumed_jobs": 0}
    assert svc.last_crash.clean_shutdown
    svc.close()
