"""Chaos tests of the port's durable service on the CPU, ported from
``tests/test_faults.py``: the fault-injection harness driving the service's
robustness machinery (``engine="torch"`` and numpy).

Every scenario asserts convergence, not just survival: a killed/restarted
service must end up serving the same answer an undisturbed cold ``mine()``
of the reference produces. Where the reference degrades a dead device to
the host, the port refuses (``DeviceUnavailable``, HTTP 503) and records the
failures and the breaker's transition in the flight ring.
"""

import os
import threading
import time

import numpy as np
import pytest

from repro.core import KyivConfig as RefConfig
from repro.core import mine as ref_mine
from repro_torch.obs import flight as obs_flight
from repro_torch.service import (
    DeadlineExceeded,
    DeviceFault,
    DeviceUnavailable,
    FaultInjector,
    KillPoint,
    MiningService,
    ResilienceConfig,
    placement_faults,
)

ENGINES = ["torch", "numpy"]


def _rand(seed, n, m, dom=4):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


def _sets(result):
    return result.canonical_set()


def _ref_sets(data, **cfg):
    return ref_mine(data, RefConfig(**cfg)).canonical_set()


def _service(engine, **kw):
    return MiningService(engine=engine, device="cpu", **kw)


FAST = ResilienceConfig(
    max_retries=2, backoff_s=0.001, failure_threshold=3, cooldown_s=60.0
)


def _ring_events(wal_dir, svc):
    svc.flight.flush()
    d = os.path.join(wal_dir, "flight")
    events = []
    for side in ("a", "b"):
        evs, _ = obs_flight.read_segment(os.path.join(d, f"inc{svc.flight.incarnation}.{side}"))
        events += evs
    return sorted(events, key=lambda e: e["seq"])


# ---------------------------------------------------------------------------
# FaultInjector mechanics
# ---------------------------------------------------------------------------


def test_injector_times_and_after():
    inj = FaultInjector()
    inj.arm("site", action="raise", exc=DeviceFault("x"), times=2, after=1)
    inj.check("site")  # hit 1: skipped by after
    with pytest.raises(DeviceFault):
        inj.check("site")
    with pytest.raises(DeviceFault):
        inj.check("site")
    inj.check("site")  # fired out
    assert inj.hits("site") == 4 and inj.fired("site") == 2


def test_null_injector_refuses_arming():
    from repro_torch.service.faults import NULL_INJECTOR

    with pytest.raises(RuntimeError):
        NULL_INJECTOR.arm("site")
    assert NULL_INJECTOR.check("anything") is None


# ---------------------------------------------------------------------------
# Kill mid-mine -> resume from level checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_kill_mid_mine_resumes_from_checkpoint(tmp_path, engine):
    data = _rand(0, 150, 6, 4)
    cfg = dict(tau=2, kmax=4)

    d = str(tmp_path / "wal")
    inj = FaultInjector()
    svc = _service(engine, wal_dir=d, fault_injector=inj)
    svc.append(data)
    # die at the second level boundary — after its checkpoint was saved
    inj.arm("mine.level_end", action="raise", exc=KillPoint("mid-mine"), after=1)
    with pytest.raises(KillPoint):
        svc.mine(**cfg)
    svc.close()

    # "restart": a fresh process over the same directory resumes the job
    svc2 = _service(engine, wal_dir=d)
    assert svc2.stats()["durability"]["resumed_jobs"] == 1
    r = svc2.mine(**cfg)  # coalesces onto the resumed run
    assert r.info.get("resumed_from_level", 0) >= 3
    assert _sets(r.result) == _ref_sets(data, **cfg)
    svc2.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_completed_job_leaves_no_checkpoints(tmp_path, engine):
    d = str(tmp_path / "wal")
    svc = _service(engine, wal_dir=d)
    svc.append(_rand(0, 80, 5, 4))
    svc.mine(tau=2, kmax=3)
    jobs = os.path.join(d, "jobs")
    assert not os.path.isdir(jobs) or os.listdir(jobs) == []
    svc.close()


# ---------------------------------------------------------------------------
# Flaky / dead device -> retry, refuse, recover
# ---------------------------------------------------------------------------


def test_flaky_device_retries_then_succeeds(tmp_path):
    data = _rand(1, 100, 5, 4)
    d = str(tmp_path / "wal")
    inj = FaultInjector()
    svc = _service("torch", wal_dir=d, fault_injector=inj, resilience=FAST)
    svc.append(data)
    with placement_faults(inj):
        inj.arm("placement.dispatch", exc=DeviceFault("transient"), times=1)
        r = svc.mine(tau=2, kmax=3)
    assert svc.device_retries == 1 and svc.unavailable_mines == 0
    assert svc.breaker.state == "closed"
    assert _sets(r.result) == _ref_sets(data, tau=2, kmax=3, engine="numpy")
    failures = [e for e in _ring_events(d, svc) if e["kind"] == "dispatch.failure"]
    assert len(failures) == 1 and "transient" in failures[0]["error"]
    svc.close()


def test_dead_device_refuses_with_503_and_breaker_opens(tmp_path):
    """The port's counterpart of the reference's
    ``test_dead_device_degrades_to_host_and_breaker_opens``: where the
    reference answers from the host, the port refuses; the failures and the
    breaker's opening land in the flight ring as in the reference."""
    from repro_torch.launch.serve_miner import make_server
    import json
    import urllib.error
    import urllib.request

    data = _rand(2, 100, 5, 4)
    d = str(tmp_path / "wal")
    inj = FaultInjector()
    svc = _service("torch", wal_dir=d, fault_injector=inj, resilience=FAST)
    svc.append(data)
    with placement_faults(inj):
        inj.arm("placement.dispatch", exc=DeviceFault("dead"), times=10_000)
        with pytest.raises(DeviceUnavailable, match="dead"):
            svc.mine(tau=2, kmax=3)
        assert svc.breaker.state == "open"
        assert svc.readiness() == (False, "circuit_breaker_open")
        # with the breaker open, further requests are refused without
        # touching the device
        hits_before = inj.hits("placement.dispatch")
        server = make_server(svc, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{server.server_address[1]}/mine?tau=2&kmax=4", timeout=60)
            assert e.value.code == 503
            assert "circuit breaker is open" in json.loads(e.value.read())["error"]
        finally:
            server.shutdown()
            server.server_close()
        assert inj.hits("placement.dispatch") == hits_before
    stats = svc.stats()["resilience"]
    assert stats["state"] == "open" and stats["unavailable_mines"] == 2
    events = _ring_events(d, svc)
    assert [e["state"] for e in events if e["kind"] == "breaker.transition"] == ["open"]
    assert sum(e["kind"] == "dispatch.failure" for e in events) == 3
    svc.close()
    report = obs_flight.recover(os.path.join(d, "flight"))
    assert any(e["kind"] == "breaker.transition" for e in report.recent_events)


def test_breaker_cooldown_allows_device_recovery(tmp_path):
    data = _rand(3, 90, 5, 4)
    d = str(tmp_path / "wal")
    inj = FaultInjector()
    res = ResilienceConfig(
        max_retries=1, backoff_s=0.001, failure_threshold=2, cooldown_s=0.05
    )
    svc = _service("torch", wal_dir=d, fault_injector=inj, resilience=res)
    svc.append(data)
    with placement_faults(inj):
        inj.arm("placement.dispatch", exc=DeviceFault("dead"), times=10_000)
        with pytest.raises(DeviceUnavailable):
            svc.mine(tau=2, kmax=3)
        assert svc.breaker.state == "open"
        inj.disarm("placement.dispatch")  # the device "comes back"
        time.sleep(0.06)
        assert svc.breaker.state == "half_open"
        svc.cache.clear()
        r = svc.mine(tau=2, kmax=3)  # the probe: runs on-device, closes
    assert svc.breaker.state == "closed"
    assert r.source == "cold"
    assert _sets(r.result) == _ref_sets(data, tau=2, kmax=3)
    assert svc.readiness() == (True, "ok")
    states = [e["state"] for e in _ring_events(d, svc) if e["kind"] == "breaker.transition"]
    assert states == ["open", "closed"]
    svc.close()


# ---------------------------------------------------------------------------
# Deadlines and cancellation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_deadline_returns_partial_and_does_not_wedge(tmp_path, engine):
    data = _rand(4, 120, 6, 4)
    inj = FaultInjector()
    svc = _service(engine, wal_dir=str(tmp_path / "wal"), fault_injector=inj)
    svc.append(data)
    # each level boundary stalls 0.25s; a 0.1s deadline trips at the first
    # batch/level check after it expires
    inj.arm("mine.level_end", action="sleep", seconds=0.25, times=100)
    t0 = time.monotonic()
    r = svc.mine(tau=1, kmax=5, deadline_s=0.1)
    elapsed = time.monotonic() - t0
    assert r.source == "partial"
    assert r.info["interrupted"] == "deadline"
    assert not r.result.completed
    assert elapsed < 2.0  # deadline + one stalled boundary, not the full run
    # partial answers are never cached and the scheduler is not wedged
    inj.reset()
    r2 = svc.mine(tau=1, kmax=5)
    assert r2.source == "cold" and r2.result.completed
    assert _sets(r2.result) == _ref_sets(data, tau=1, kmax=5)
    svc.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_cancel_stops_inflight_run(tmp_path, engine):
    data = _rand(5, 120, 6, 4)
    inj = FaultInjector()
    svc = _service(engine, wal_dir=str(tmp_path / "wal"), fault_injector=inj)
    svc.append(data)
    inj.arm("mine.level_end", action="sleep", seconds=0.25, times=100)
    out = {}

    def run():
        out["resp"] = svc.mine(tau=1, kmax=5)

    t = threading.Thread(target=run)
    t.start()
    while not svc._controls:  # the run is registered and cancellable
        time.sleep(0.01)
    assert svc.cancel(1, 5)["cancelled"] == 1
    t.join(timeout=30)
    assert out["resp"].source == "partial"
    assert out["resp"].info["interrupted"] == "cancelled"
    svc.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_coalesced_waiter_deadline(tmp_path, engine):
    """A deadline-free initiator keeps its run; a coalesced waiter with a
    deadline gets DeadlineExceeded instead of blocking on the shared run."""
    data = _rand(6, 120, 6, 4)
    inj = FaultInjector()
    svc = _service(
        engine,
        wal_dir=str(tmp_path / "wal"),
        fault_injector=inj,
        deadline_grace_s=0.05,
    )
    svc.append(data)
    inj.arm("mine.level_end", action="sleep", seconds=0.4, times=3)
    out = {}

    def initiator():
        out["resp"] = svc.mine(tau=1, kmax=5)

    t = threading.Thread(target=initiator)
    t.start()
    while not svc._controls:
        time.sleep(0.01)
    with pytest.raises(DeadlineExceeded):
        svc.mine(tau=1, kmax=5, deadline_s=0.05)
    t.join(timeout=30)
    assert out["resp"].result.completed  # the initiator was unaffected
    svc.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_kill_mid_mine_then_recovery_converges_with_appends(tmp_path, engine):
    """Full chaos loop: append, die mid-mine, restart, append more, mine —
    the final answer matches an undisturbed cold run over all the rows."""
    a, b = _rand(7, 100, 5, 4), _rand(8, 40, 5, 4)
    d = str(tmp_path / "wal")
    inj = FaultInjector()
    svc = _service(engine, wal_dir=d, fault_injector=inj)
    svc.append(a)
    inj.arm("mine.level_end", action="raise", exc=KillPoint("die"), after=1)
    with pytest.raises(KillPoint):
        svc.mine(tau=2, kmax=4)
    svc.close()

    svc2 = _service(engine, wal_dir=d)
    svc2.append(b)  # moves past the dead job's version
    r = svc2.mine(tau=2, kmax=4)
    assert _sets(r.result) == _ref_sets(np.concatenate([a, b]), tau=2, kmax=4)
    svc2.close()


# ---------------------------------------------------------------------------
# against the reference: a kill at every level boundary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("append", [False, True], ids=["no-append", "append"])
@pytest.mark.parametrize("kill_after", [0, 1, 2], ids=["after-level-2", "after-level-3", "after-level-4"])
@pytest.mark.parametrize("engine", ENGINES)
def test_level_end_kill_answers_equal_reference(tmp_path, engine, kill_after, append):
    """Killed at the ``kill_after``-th level boundary (after that level's
    checkpoint) and rebuilt over the same directory, the service resumes
    from that checkpoint and answers as the reference's ``mine``; with rows
    appended after the restart, the stale job is dropped and the answer
    equals the reference's mine of all rows."""
    a, b = _rand(10, 160, 6, 4), _rand(11, 30, 6, 4)
    cfg = dict(tau=2, kmax=5)
    d = str(tmp_path / "wal")
    inj = FaultInjector()
    svc = _service(engine, wal_dir=d, fault_injector=inj)
    svc.append(a)
    inj.arm("mine.level_end", action="raise", exc=KillPoint("die"), after=kill_after)
    with pytest.raises(KillPoint):
        svc.mine(**cfg)
    svc.flight.halt()
    svc.close()

    svc2 = _service(engine, wal_dir=d)
    try:
        assert svc2.stats()["durability"]["resumed_jobs"] == 1
        level = svc2.last_crash.last_checkpoint["level"]
        assert level == kill_after + 2
        if append:
            svc2.append(b)
            r = svc2.mine(**cfg)
            assert "resumed_from_level" not in r.info
            assert _sets(r.result) == _ref_sets(np.concatenate([a, b]), **cfg)
        else:
            r = svc2.mine(**cfg)
            assert r.info["resumed_from_level"] == level + 1
            assert _sets(r.result) == _ref_sets(a, **cfg)
        assert os.listdir(os.path.join(d, "jobs")) == []
    finally:
        svc2.close()
