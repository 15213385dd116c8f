"""The port's observability modules — metrics, traces, structured logs,
per-request cost and the slow-mine log — held against the reference's on the
cases of the reference's telemetry tests (each case runs on both packages'
modules), and the port's ``torch.profiler`` wrapper without a card (gauges,
and a Chrome trace of CPU activity only)."""

import importlib
import io
import json
import logging
import re

import numpy as np
import pytest

from repro_torch.core import KyivConfig, mine
from repro_torch.obs import cost as port_cost
from repro_torch.obs import logs as port_logs
from repro_torch.obs import metrics as port_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs.trace import TRACER, current_trace_id
from repro_torch.service import MiningService, RequestScheduler

PACKAGES = ["repro", "repro_torch"]


def _rand(seed, n, m, dom=5):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


@pytest.fixture(params=PACKAGES)
def obs(request):
    """One package's observability modules, by attribute."""
    pkg = request.param

    class _Obs:
        name = pkg
        metrics = importlib.import_module(f"{pkg}.obs.metrics")
        trace = importlib.import_module(f"{pkg}.obs.trace")
        cost = importlib.import_module(f"{pkg}.obs.cost")
        logs = importlib.import_module(f"{pkg}.obs.logs")

    return _Obs


@pytest.fixture()
def tracer_reset():
    yield TRACER
    TRACER.configure(max_traces=64, sample_every=1, sync_devices=False)
    TRACER.reset()


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_basics(obs):
    reg = obs.metrics.MetricsRegistry()
    c = reg.counter("t_requests_total", "req", ("route",))
    c.inc(route="/mine")
    c.inc(2, route="/mine")
    assert c.value(route="/mine") == 3 and c.value(route="/never") == 0
    with pytest.raises(ValueError):
        c.inc(-1, route="/mine")
    with pytest.raises(ValueError):
        c.inc(path="/mine")
    g = reg.gauge("t_depth", "depth")
    g.set(4)
    g.add(-1.5)
    assert g.value() == 2.5
    h = reg.histogram("t_latency_seconds", "lat", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    s = h.series()
    assert s["count"] == 5 and s["sum"] == pytest.approx(56.05)
    assert [n for _, n in s["buckets"]] == [1, 3, 4, 5]
    c.set_total(10, route="/stats")
    assert c.value(route="/stats") == 10


def test_registry_rejects_conflicting_reregistration(obs):
    reg = obs.metrics.MetricsRegistry()
    reg.counter("t_x_total", "x")
    with pytest.raises(ValueError):
        reg.gauge("t_x_total", "x")
    with pytest.raises(ValueError):
        reg.counter("t_x_total", "x", ("route",))
    assert reg.counter("t_x_total", "x") is reg.counter("t_x_total", "x")
    with pytest.raises(ValueError):
        reg.counter("0bad name", "x")


def test_render_lint_snapshot_and_exemplars(obs):
    reg = obs.metrics.MetricsRegistry()
    reg.counter("t_served_total", "served", ("route",)).inc(route="/mine")
    reg.gauge("t_ready", "ready").set(1)
    h = reg.histogram("t_wall_seconds", "wall", buckets=(0.01, 1.0))
    h.observe(0.5, exemplar={"trace_id": "abc123"})
    text = reg.render()
    assert obs.metrics.lint_exposition(text) == []
    assert "# TYPE t_served_total counter" in text
    assert 't_wall_seconds_bucket{le="+Inf"} 1' in text
    assert '# {trace_id="abc123"} 0.5' in text
    snap = reg.snapshot()
    assert snap["t_served_total"]["values"]["/mine"] == 1
    assert snap["t_wall_seconds"]["values"][""]["count"] == 1


def test_render_matches_reference_byte_for_byte():
    """The same recordings render the same exposition in both packages."""
    texts = []
    for pkg in PACKAGES:
        m = importlib.import_module(f"{pkg}.obs.metrics")
        reg = m.MetricsRegistry()
        reg.counter("t_a_total", "a", ("k",)).inc(3, k="x")
        reg.gauge("t_b", "b").set(2.5)
        reg.histogram("t_c_seconds", "c", ("s",)).observe(0.003, s="cold")
        texts.append(reg.render())
    assert texts[0] == texts[1]


def test_lint_catches_bad_expositions(obs):
    lint = obs.metrics.lint_exposition
    assert lint("# TYPE bad_counter counter\nbad_counter 3\n")
    assert lint("orphan_sample 1\n")
    assert lint('# TYPE h histogram\nh_bucket{le="0.1"} 5\nh_bucket{le="+Inf"} 3\n')


def test_named_collectors_replace_and_owner_checked_unregister(obs):
    reg = obs.metrics.MetricsRegistry()
    g = reg.gauge("t_mirror", "mirrored")
    calls = []

    def c1():
        calls.append("c1")
        g.set(1)

    def c2():
        calls.append("c2")
        g.set(2)

    reg.register_collector("svc", c1)
    reg.render()
    reg.register_collector("svc", c2)
    reg.render()
    reg.unregister_collector("svc", c1)  # stale owner must not evict c2
    reg.render()
    assert calls == ["c1", "c2", "c2"]
    reg.unregister_collector("svc", c2)
    calls.clear()
    reg.render()
    assert calls == []


def test_broken_collector_never_fails_the_scrape(obs):
    reg = obs.metrics.MetricsRegistry()

    def boom():
        raise RuntimeError("collector bug")

    reg.register_collector("bad", boom)
    assert obs.metrics.lint_exposition(reg.render()) == []
    assert reg.collector_errors == 1


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_span_nesting_parent_ids_and_tree(obs):
    tr = obs.trace.Tracer(max_traces=4)
    with tr.start("req") as root:
        with tr.span("outer", k=2) as outer:
            with tr.span("inner"):
                pass
        assert obs.trace.current_trace_id() == root.trace_id
        assert obs.trace.current_span() is root
    trace = tr.last(1)[0]
    outer_sp, inner_sp = trace.find("outer")[0], trace.find("inner")[0]
    assert outer_sp.parent_id == trace.root.span_id and inner_sp.parent_id == outer_sp.span_id
    assert outer_sp.attrs == {"k": 2}
    d = trace.to_dict()
    assert d["spans"][0]["children"][0]["children"][0]["name"] == "inner"
    assert tr.get(root.trace_id) is trace and tr.get("nope") is None


def test_nested_start_trace_joins_the_outer_trace(obs):
    tr = obs.trace.Tracer()
    with tr.start("outer"):
        with tr.start("inner") as sp:
            sp.set(tag=1)
    assert len(tr.last(10)) == 1
    trace = tr.last(1)[0]
    assert trace.find("inner")[0].parent_id == trace.root.span_id


def test_sampling_ring_overflow_and_paging(obs):
    tr = obs.trace.Tracer(max_traces=3, sample_every=2)
    for _ in range(8):
        with tr.start("req"):
            pass
    st = tr.stats()
    assert st["started"] == 8 and st["sampled_out"] == 4 and st["stored"] == 3
    tr = obs.trace.Tracer(max_traces=4, sample_every=1)
    for i in range(10):
        with tr.start("req", meta={"i": i}):
            pass
    assert tr.stats()["dropped"] == 6
    page1, cursor = tr.page(2)
    assert [t.seq for t in page1] == [9, 8] and cursor == 8
    with tr.start("req"):
        pass
    page2, cursor2 = tr.page(2, before=cursor)
    assert [t.seq for t in page2] == [7] and cursor2 is None


def test_span_is_noop_without_active_trace(obs):
    tr = obs.trace.Tracer()
    assert obs.trace.current_trace_id() is None
    with tr.span("orphan") as sp:
        sp.set(ignored=True)
    assert tr.last(10) == []


def test_device_sync_is_a_noop_off_the_card(tracer_reset):
    import torch

    from repro_torch.obs.trace import device_sync

    assert device_sync(torch.zeros(3)) is False  # not tracing
    TRACER.configure(sync_devices=True)
    with TRACER.start("req"):
        assert device_sync(torch.zeros(3), None) is False  # no CUDA tensor


def test_scheduler_propagates_trace_and_cost_context(tracer_reset):
    """The worker-thread hop carries the active span and cost envelope."""
    sched = RequestScheduler()
    try:
        with TRACER.start("req") as root, port_cost.attach() as env:
            seen = sched.submit("k", lambda: (current_trace_id(), port_cost.current())).result()
        assert seen == (root.trace_id, env)
        assert sched.submit("k2", lambda: current_trace_id()).result() is None
    finally:
        sched.shutdown()


def test_service_mine_trace_and_dropped_counter(tracer_reset):
    svc = MiningService.from_dataset(_rand(0, 300, 6), engine="torch", device="cpu")
    try:
        r = svc.mine(tau=1, kmax=3)
        trace = TRACER.last(1)[0]
        assert trace.name == "service.mine" and trace.root.attrs["source"] == "cold"
        assert len(trace.find("mine.level")) == len(r.result.stats) - 1
        assert trace.find("intersect.dispatch") and trace.find("mine.cold")
        TRACER.configure(max_traces=2)
        for tau in (2, 3, 1, 2):
            svc.mine(tau=tau, kmax=2)
        assert svc.stats()["obs"]["traces"]["dropped"] >= 2
        text = port_metrics.REGISTRY.render()
        assert port_metrics.lint_exposition(text) == []
        m = re.search(r"^repro_trace_dropped_total (\d+)", text, re.M)
        assert m and int(m.group(1)) >= 2
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# structured logs
# ---------------------------------------------------------------------------


@pytest.fixture()
def clean_loggers():
    saved = {}
    for name in PACKAGES:
        logger = logging.getLogger(name)
        saved[name] = (list(logger.handlers), logger.level, logger.propagate)
    yield
    for name, (handlers, level, propagate) in saved.items():
        logger = logging.getLogger(name)
        for h in list(logger.handlers):
            logger.removeHandler(h)
        for h in handlers:
            logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = propagate


def test_json_logs_carry_trace_id(obs, clean_loggers):
    buf = io.StringIO()
    log = obs.logs.setup(level="info", json_mode=True, stream=buf)
    assert log.name == obs.name
    with obs.trace.TRACER.start("req") as root:
        log.info("access", extra={"route": "/mine", "code": 200})
    log.warning("later")
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert lines[0]["msg"] == "access" and lines[0]["trace_id"] == root.trace_id
    assert lines[0]["route"] == "/mine" and lines[0]["code"] == 200 and lines[0]["level"] == "info"
    assert "trace_id" not in lines[1]


def test_text_logs_carry_trace_id(obs, clean_loggers):
    buf = io.StringIO()
    log = obs.logs.setup(level="debug", json_mode=False, stream=buf)
    with obs.trace.TRACER.start("req") as root:
        log.debug("hello", extra={"k": 3})
    line = buf.getvalue().strip()
    assert f"trace_id={root.trace_id}" in line and "k=3" in line


def test_port_logger_is_its_own_hierarchy(clean_loggers):
    log = port_logs.setup(level="info", stream=io.StringIO())
    assert log.name == "repro_torch" and port_logs.get_logger().name == "repro_torch"


# ---------------------------------------------------------------------------
# per-request cost and the slow-mine log
# ---------------------------------------------------------------------------


def test_cost_envelope_add_note_and_attach(obs):
    cost = obs.cost
    assert cost.current() is None
    cost.add(levels=1)  # no envelope attached: a no-op
    with cost.attach() as env:
        cost.add(levels=2, candidate_pairs=10)
        cost.note(path="cold", version=3, trace_id="t1")
        env.add_device_time(0.25)
        with pytest.raises(KeyError):
            env.add(bogus=1)
    d = env.finish().to_dict()
    assert d["levels"] == 2 and d["candidate_pairs"] == 10 and d["path"] == "cold"
    assert d["version"] == 3 and d["trace_id"] == "t1" and d["device_s"] == 0.25
    assert cost.current() is None


def test_cost_envelope_fields_match_reference():
    from repro.obs import cost as ref_cost

    assert port_cost.CostEnvelope._FIELDS == ref_cost.CostEnvelope._FIELDS


@pytest.mark.parametrize("threshold,recorded", [(0.0, True), (3600.0, False)])
def test_slowlog_threshold(obs, threshold, recorded):
    log = obs.cost.SlowMineLog(threshold_s=threshold, maxlen=2)
    env = obs.cost.CostEnvelope()
    env.note(path="cold")
    env.finish()
    assert log.offer(env, tau=1, kmax=3) is recorded
    assert log.stats()["stored"] == int(recorded)
    if recorded:
        for _ in range(3):
            log.offer(env)
        assert len(log.entries()) == 2 and log.entries(1)[0]["path"] == "cold"


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_service_mine_carries_cost_and_slowlog(engine):
    svc = MiningService.from_dataset(_rand(1, 300, 6), engine=engine, device="cpu",
                                     slow_mine_threshold_s=0.0)
    try:
        r = svc.mine(tau=1, kmax=3)
        c = r.info["cost"]
        assert c["path"] == "cold" and c["levels"] == len(r.result.stats) - 1
        assert c["itemsets_emitted"] > 0 and c["trace_id"]
        assert (c["device_dispatches"] > 0) is (engine == "torch")
        assert c["executables_compiled"] + c["executables_reused"] >= (engine == "torch")
        cached = svc.mine(tau=1, kmax=3)
        assert cached.info["cost"]["path"] == "cache"
        entries = svc.slowlog_entries()
        assert [e["path"] for e in entries[:2]] == ["cache", "cold"]
        assert svc.stats()["forensics"]["slowlog"]["total"] == 2
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# profiling hook (no card)
# ---------------------------------------------------------------------------


def test_profile_without_dump_dir_is_gauges_only():
    reg = port_metrics.MetricsRegistry()
    with obs_profile.profile(registry=reg) as prof:
        pass
    assert prof.profiler_active is False and prof.trace_path is None
    assert prof.device_memory == {"allocated": 0, "max_allocated": 0, "reserved": 0}
    assert reg.counter("repro_profile_runs_total", "", ("profiler",)).value(profiler="off") == 1


def test_profile_records_gauges_and_cpu_trace(tmp_path):
    reg = port_metrics.MetricsRegistry()
    dump = tmp_path / "prof"
    with obs_profile.profile(str(dump), device="cpu", registry=reg) as prof:
        result = mine(_rand(1, 200, 5), KyivConfig(tau=1, kmax=3, engine="torch", device="cpu"))
        prof.set_result(result)
    assert prof.wall_s > prof.start_s > 0 and set(prof.exec_cache_delta) == {"hits", "misses", "entries"}
    assert reg.gauge("repro_profile_last_wall_seconds", "").value() == pytest.approx(prof.wall_s)
    assert reg.gauge("repro_profile_levels_retired", "").value() == len(result.stats)
    mem = reg.gauge("repro_profile_device_memory_bytes", "", ("stat",))
    assert mem.value(stat="allocated") == 0
    runs = reg.counter("repro_profile_runs_total", "", ("profiler",))
    assert runs.value(profiler="torch") == 1
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert prof.trace_path.startswith(str(dump)) and events
    assert not [e for e in events if e.get("cat") == "kernel"]  # no CUDA activity here


def test_service_profile_dir_writes_one_trace_per_cold_mine(tmp_path):
    svc = MiningService.from_dataset(_rand(2, 200, 5), engine="torch", device="cpu",
                                     profile_dir=str(tmp_path))
    try:
        r = svc.mine(tau=1, kmax=3)
        assert r.info["profile_trace"] and r.info["profile_trace"].startswith(str(tmp_path))
        assert "profile_trace" in svc.mine(tau=1, kmax=3).info  # the cached entry's info
        assert len(list(tmp_path.glob("trace_*.json"))) == 1
    finally:
        svc.close()


class _BrokenProfiler:
    """A ``torch.profiler.profile`` stand-in that fails at ``stage``."""

    def __init__(self, stage):
        self.stage = stage

    def __call__(self, activities):
        if self.stage == "start":
            raise RuntimeError("CUPTI unavailable")
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        raise OSError("disk full")


@pytest.mark.parametrize("stage,message", [("start", "CUPTI unavailable"), ("export", "disk full")])
def test_profiler_failure_is_recorded_not_swallowed(monkeypatch, tmp_path, stage, message):
    """A profiler that cannot start or export leaves the mine's answer
    alone, but its error reaches the record, the counter and the request's
    info."""
    import torch

    monkeypatch.setattr(torch.profiler, "profile", _BrokenProfiler(stage))
    reg = port_metrics.MetricsRegistry()
    with obs_profile.profile(str(tmp_path), device="cpu", registry=reg) as prof:
        pass
    assert prof.trace_path is None and prof.error.startswith(f"{stage}: ") and message in prof.error
    assert reg.counter("repro_profile_runs_total", "", ("profiler",)).value(profiler="failed") == 1
    data = _rand(3, 120, 4)
    svc = MiningService.from_dataset(data, engine="torch", device="cpu", profile_dir=str(tmp_path))
    try:
        r = svc.mine(tau=1, kmax=3)
        assert message in r.info["profile_error"] and r.info["profile_trace"] is None
        want = mine(data, KyivConfig(tau=1, kmax=3, engine="numpy"))
        assert sorted(r.result.as_value_sets()) == sorted(want.as_value_sets())
    finally:
        svc.close()
