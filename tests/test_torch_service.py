"""The port's resident service (``repro_torch.service``) held against the
reference's (``repro.service``) on the CPU: the dataset store (itemization,
deltas, compaction, state carried across packages), the result cache, the
scheduler, one request log replayed against both services, the HTTP layer,
and the device-failure classification behind the device retries (a mine the
card keeps failing is refused with 503, never answered from the host).

Item ids agree between the two stores (same append order, same itemizer),
but mined answers are compared in value-set form, which is id-independent.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import service as ref_service
from repro.core import KyivConfig as RefConfig
from repro.core import mine as ref_mine
from repro.sampling import SamplingConfig as RefSampling
from repro_torch.convert import store_from_numpy, store_to_numpy
from repro_torch.core import HostPlacement, KyivConfig, is_device_failure, make_placement, mine
from repro_torch.data.loaders import read_csv
from repro_torch.kernels import _build
from repro_torch.sampling import SamplingConfig
from repro_torch.service import (
    CacheEntry,
    DatasetStore,
    DeviceFault,
    DeviceUnavailable,
    FaultInjector,
    KillPoint,
    MiningService,
    RequestScheduler,
    ResilienceConfig,
    ResultCache,
    make_key,
    placement_faults,
)

def _rand(seed, n, m, dom):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


def _value_sets(result):
    return {(frozenset(ids), int(c)) for ids, c in result.as_value_sets()}


def _assert_same_state(port_store, ref_store):
    a, b = port_store.export_state(), ref_store.export_state()
    assert set(a) == set(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# DatasetStore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("word_tile", [1, 3, 8])
@pytest.mark.parametrize("blocks", [(37, 37, 37), (1, 300, 2), (64, 32, 31)])
def test_store_itemization_matches_reference(word_tile, blocks):
    """Appending the same blocks gives the reference's state, bit for bit:
    item ids, metadata, word-tiled bitsets, version watermarks and stats."""
    port = DatasetStore(4, word_tile=word_tile)
    ref = ref_service.DatasetStore(4, word_tile=word_tile)
    for s, n in enumerate(blocks):
        rows = _rand(s, n, 4, 5)
        assert port.append(rows) == ref.append(rows)
    _assert_same_state(port, ref)
    assert port.stats() == ref.stats()
    assert port.n_words % word_tile == 0


@pytest.mark.parametrize(
    "base_rows,delta_rows",
    [(31, 2), (32, 1), (33, 40), (255, 2), (256, 300), (250, 20)],
    ids=["in-word", "at-word", "cross-word", "in-tile", "at-tile", "cross-tile"],
)
def test_store_delta_bits_match_reference(base_rows, delta_rows):
    """Delta masks count unpadded words: appends whose rows start inside a
    word, on a word boundary, and across a word-tile (8 words) boundary."""
    a, b = _rand(0, base_rows, 3, 4), _rand(1, delta_rows, 3, 5)
    port = DatasetStore.from_dataset(a, word_tile=8)
    ref = ref_service.DatasetStore.from_dataset(a, word_tile=8)
    base = port.version
    port.append(b)
    ref.append(b)
    got, lo = port.delta_bits(base)
    want, want_lo = ref.delta_bits(base)
    assert lo == want_lo == base_rows // 32
    np.testing.assert_array_equal(got, want)
    # popcounts over the delta words are each item's support in the block
    table = port.item_table()
    for i in range(table.n_items):
        col, val = int(table.col[i]), int(table.value[i])
        assert int(np.bitwise_count(got[i]).sum()) == int((b[:, col] == val).sum())


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_store_device_bits_pad_and_strip(engine):
    """The resident copy goes through ``placement.put_bits``: int32 words
    with the word axis padded to a multiple of 4 on a device (word_tile 3
    leaves 3 words); the host view strips the padding."""
    placement = make_placement(engine, device="cpu")
    store = DatasetStore.from_dataset(_rand(0, 70, 3, 4), word_tile=3, placement=placement)
    dev = store.device_bits()
    assert store.device_bits(store.version) is dev  # one upload per version
    assert store.device_bits(store.version - 1) is None
    host = store.item_table().bits
    if engine == "torch":
        assert dev.dtype == torch.int32 and dev.shape == (host.shape[0], 4)
        np.testing.assert_array_equal(dev[:, :3].numpy().view(np.uint32), host)
        assert not dev[:, 3:].any()
    else:
        np.testing.assert_array_equal(dev, host)


def test_store_compaction_matches_reference():
    port = DatasetStore(4, compact_threshold=5, keep_versions=2)
    ref = ref_service.DatasetStore(4, compact_threshold=5, keep_versions=2)
    for s in range(7):
        rows = _rand(s, 30, 4, 5)
        port.append(rows)
        ref.append(rows)
    assert port.compactions == ref.compactions >= 1
    _assert_same_state(port, ref)
    assert port.compact(1) == ref.compact(1)
    _assert_same_state(port, ref)
    assert not port.has_version(1) and port.has_version(port.version)


def test_store_state_carried_from_reference_answers_identically():
    """A table appended in the reference service, exported and carried over
    through ``convert.store_from_numpy``, mines here as it does there."""
    ref_svc = ref_service.MiningService.from_dataset(_rand(0, 150, 4, 4), engine="numpy")
    ref_svc.append(_rand(1, 40, 4, 5))
    state = ref_svc.store.export_state()
    svc = MiningService(engine="torch", device="cpu")
    svc._store = store_from_numpy(state, placement=svc.placement)
    _assert_same_state(svc.store, ref_svc.store)
    assert store_to_numpy(svc.store).keys() == state.keys()
    got, want = svc.mine(tau=1, kmax=3), ref_svc.mine(tau=1, kmax=3)
    assert got.version == want.version == 2
    assert _value_sets(got.result) == _value_sets(want.result)
    # the carried store keeps appending like the reference's
    rows = _rand(2, 12, 4, 5)
    svc.append(rows)
    ref_svc.append(rows)
    _assert_same_state(svc.store, ref_svc.store)
    assert _value_sets(svc.mine(tau=1, kmax=3).result) == _value_sets(ref_svc.mine(tau=1, kmax=3).result)
    svc.close()
    ref_svc.close()


def test_store_from_fleet_shard_state_refused():
    """A fleet shard's state loads only as that shard: its bitsets are one
    process's word stripes."""
    ref = ref_service.DatasetStore(3, word_tile=8, shard=(1, 2))
    ref.append(_rand(0, 400, 3, 4))
    state = ref.export_state()
    assert store_from_numpy(state).shard == (1, 2)
    with pytest.raises(ValueError, match="not transferable"):
        store_from_numpy(state, shard=(0, 2))


@pytest.mark.parametrize("header", [True, False])
def test_read_csv_matches_reference(tmp_path, header):
    from repro.data.loaders import read_csv as ref_read_csv

    path = tmp_path / "t.csv"
    lines = (["age,zip,sex"] if header else []) + [
        f"{20 + i % 7},{1000 + i % 5},{'MF'[i % 2]}" for i in range(40)
    ]
    path.write_text("\n".join(lines) + "\n")
    got, want = read_csv(str(path)), ref_read_csv(str(path))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# ResultCache and RequestScheduler
# ---------------------------------------------------------------------------


def _entry(version, result=None):
    return CacheEntry(key=make_key(version, 1, 3, "ascending"), result=result, source="cold", info={})


def test_cache_lru_eviction_and_latest_base():
    cache = ResultCache(capacity=2)
    cache.put(_entry(1))
    cache.put(_entry(2))
    assert cache.get(make_key(1, 1, 3, "ascending")) is not None  # 1 now MRU
    cache.put(_entry(3))  # evicts version 2
    assert cache.get(make_key(2, 1, 3, "ascending")) is None
    base = cache.latest_base(1, 3, "ascending", before_version=3)
    assert base is not None and base.version == 1
    assert cache.latest_base(2, 3, "ascending", before_version=99) is None


def test_cache_bytes_match_reference_and_bound_entries():
    """An entry's footprint is the reference's for the same answer, and the
    byte bound evicts least-recently-used entries."""
    data = _rand(0, 60, 4, 5)
    result = mine(data, KyivConfig(tau=1, kmax=2, engine="numpy"))
    ref_result = ref_mine(data, RefConfig(tau=1, kmax=2, engine="numpy"))
    per_entry = _entry(1, result).nbytes()
    assert per_entry == ref_service.CacheEntry(
        key=make_key(1, 1, 3, "ascending"), result=ref_result, source="cold", info={}
    ).nbytes() > 0
    cache = ResultCache(capacity=64, max_bytes=3 * per_entry)
    for v in range(1, 7):
        cache.put(_entry(v, result))
    stats = cache.stats()
    assert stats["entries"] == 3 and stats["bytes"] <= stats["max_bytes"]
    assert cache.get(make_key(6, 1, 3, "ascending")) is not None
    assert cache.get(make_key(1, 1, 3, "ascending")) is None
    tiny = ResultCache(capacity=4, max_bytes=1)  # smaller than any entry
    tiny.put(_entry(1, result))
    assert tiny.get(make_key(1, 1, 3, "ascending")) is not None  # newest never evicted


def test_scheduler_coalesces_identical_requests():
    sched = RequestScheduler(max_workers=2)
    calls = []
    release = threading.Event()

    def work():
        calls.append(1)
        release.wait(timeout=5)
        return "done"

    f1 = sched.submit(("k",), work)
    f2 = sched.submit(("k",), work)  # coalesced onto f1
    assert f2 is f1
    release.set()
    assert f1.result(timeout=5) == "done"
    assert len(calls) == 1 and sched.stats()["coalesced"] == 1
    assert sched.submit(("k",), lambda: "again").result(timeout=5) == "again"
    sched.shutdown()


def test_scheduler_failure_fails_only_that_key():
    sched = RequestScheduler(max_workers=1)

    def boom():
        raise RuntimeError("worker died")

    with pytest.raises(RuntimeError):
        sched.submit(("k",), boom).result(timeout=10)
    assert sched.submit(("k",), lambda: 42).result(timeout=10) == 42
    stats = sched.stats()
    assert stats["failed"] == 1 and stats["inflight"] == 0
    sched.shutdown()


# ---------------------------------------------------------------------------
# One request log replayed against both services
# ---------------------------------------------------------------------------

_SMALL_REF = dict(oversample=0.5, min_rows=32)
_BASE, _DELTA = _rand(3, 400, 5, 5), _rand(4, 30, 5, 6)
_VOLATILE = ("latency_s", "source", "trace_id", "version")
STEPS = ["cold", "cache", "append", "incremental", "risk", "report", "anonymize",
         "approx", "refined", "exact-after-refine"]


def _strip(d):
    return {k: v for k, v in d.items() if k not in _VOLATILE}


def _replay(svc):
    """The request log; each step's answer in an id-independent form, with
    the serving source beside it."""
    out = {}
    r = svc.mine(tau=1, kmax=3)
    out["cold"] = (r.source, _value_sets(r.result))
    r = svc.mine(tau=1, kmax=3)
    out["cache"] = (r.source, _value_sets(r.result))
    out["append"] = ("append", svc.append(_DELTA))
    r = svc.mine(tau=1, kmax=3)
    out["incremental"] = (r.source, _value_sets(r.result))
    out["risk"] = ("risk", _strip(svc.risk(tau=1, kmax=3)))
    out["report"] = ("report", _strip(svc.report(tau=1, kmax=3)))
    out["anonymize"] = ("anonymize", _strip(svc.anonymize_plan(tau=1, kmax=3)))
    r = svc.mine(tau=2, kmax=3, mode="approx", epsilon=0.3)
    info = {k: r.info[k] for k in ("epsilon", "seed", "sample_rows", "tau_sample",
                                   "boundary_count", "confidence", "refined")}
    out["approx"] = (r.source, info, _value_sets(r.result))
    assert svc.scheduler.drain(timeout=300)["abandoned"] == 0
    r = svc.mine(tau=2, kmax=3, mode="approx", epsilon=0.3)
    out["refined"] = (r.source, r.info["refined"], r.info["confidence"], _value_sets(r.result))
    r = svc.mine(tau=2, kmax=3)
    out["exact-after-refine"] = (r.source, _value_sets(r.result))
    res = svc.stats()["resilience"]
    # the reference degrades to the host; the port refuses instead
    assert res.get("degraded_mines", 0) == 0 and res.get("unavailable_mines", 0) == 0
    svc.close()
    return out


@pytest.fixture(scope="module")
def replayed():
    services = {
        "ref-numpy": lambda: ref_service.MiningService.from_dataset(
            _BASE, engine="numpy", sampling=RefSampling(**_SMALL_REF)),
        "ref-jnp": lambda: ref_service.MiningService.from_dataset(
            _BASE, engine="jnp", sampling=RefSampling(**_SMALL_REF)),
        "port-torch-cpu": lambda: MiningService.from_dataset(
            _BASE, engine="torch", device="cpu", sampling=SamplingConfig(**_SMALL_REF)),
        "port-numpy": lambda: MiningService.from_dataset(
            _BASE, engine="numpy", sampling=SamplingConfig(**_SMALL_REF)),
    }
    return {name: _replay(make()) for name, make in services.items()}


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("port", ["port-torch-cpu", "port-numpy"])
def test_request_log_replay_matches_reference(replayed, port, step):
    want = replayed["ref-numpy"][step]
    assert replayed["ref-jnp"][step] == want  # the reference agrees with itself
    assert replayed[port][step] == want


def test_request_log_sources(replayed):
    got = replayed["port-torch-cpu"]
    assert [got[s][0] for s in ("cold", "cache", "incremental", "approx", "exact-after-refine")] == [
        "cold", "cache", "incremental", "approx", "cache"]
    assert got["refined"][1:3] == (True, 1.0)


# ---------------------------------------------------------------------------
# Placement: warm level-1 gather, device failures, retries and refusal
# ---------------------------------------------------------------------------


def test_warm_pipeline_factory_gathers_level1_from_the_store():
    data = _rand(5, 70, 5, 4)  # 3 words, one word tile of 3: padded to 4 on the device
    svc = MiningService.from_dataset(data, engine="torch", device="cpu", word_tile=3)
    prep = svc._prep_for(svc.store.version, svc.store.item_table(), svc._request_config(1, 3, "ascending"))
    factory = svc._warm_pipeline_factory(svc.store.version, prep, svc._request_config(1, 3, "ascending"))
    pipe = factory(prep.l_bits, prep.l_freq, 1)
    assert pipe.n_words == prep.l_bits.shape[1] == 3
    assert isinstance(pipe._state["bits"], torch.Tensor) and pipe._state["bits"].shape[1] == 4
    np.testing.assert_array_equal(pipe._state["bits"][:, :3].numpy().view(np.uint32), prep.l_bits)
    got = svc.mine(tau=1, kmax=3)
    assert _value_sets(got.result) == _value_sets(mine(data, KyivConfig(tau=1, kmax=3, engine="numpy")))
    assert svc.stats()["executables"]["families"]["intersect"]["misses"] >= 1
    svc.close()


@pytest.mark.parametrize(
    "exc,expected",
    [
        (DeviceFault("injected"), True),
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
        (RuntimeError("intersect_classify_write_indexed: launch failed: out of memory"), True),
        (RuntimeError("coverage_accumulate_anchored: launch failed: unspecified launch failure"), True),
        (RuntimeError("CUDA kernel build failed: nvcc exited 1 on intersect.cu"), False),
        (RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build"), False),
        (ImportError("cannot import name 'triton'"), False),
        (ValueError("kernel inputs must share one device"), False),
        (RuntimeError("shape mismatch"), False),
        (KillPoint("mid-mine"), False),
    ],
    ids=["injected", "oom", "cuda-error", "launch-oom", "launch-failure", "build-failed",
         "no-nvcc", "import", "value", "plain-runtime", "killpoint"],
)
def test_is_device_failure(exc, expected):
    assert is_device_failure(exc) is expected


def test_kernel_build_failure_is_not_a_device_failure(monkeypatch, tmp_path):
    """The build's own error (a compiler that exits non-zero) is never
    classified as a device failure, so it is never retried."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA kernel build failed") as e:
        _build.build(["intersect"])
    assert not is_device_failure(e.value)


def test_flaky_device_retries_then_succeeds():
    data = _rand(0, 120, 4, 4)
    inj = FaultInjector()
    svc = MiningService.from_dataset(
        data, engine="torch", device="cpu", fault_injector=inj,
        resilience=ResilienceConfig(max_retries=2, backoff_s=0.0),
    )
    inj.arm("placement.dispatch", action="raise", exc=DeviceFault("flaky"), times=1)
    with placement_faults(inj):
        r = svc.mine(tau=1, kmax=3)
    assert svc.device_retries == 1 and svc.unavailable_mines == 0
    assert _value_sets(r.result) == _value_sets(mine(data, KyivConfig(tau=1, kmax=3, engine="numpy")))
    svc.close()


def test_dead_device_refuses_with_503_and_breaker_opens():
    """A device service whose card keeps failing retries on the card, then
    refuses (DeviceUnavailable, HTTP 503) with no host answer; with the
    breaker open the next mine is refused before it reaches the card. A
    service built on the host answers under the same faults."""
    from repro_torch.launch.serve_miner import make_server

    data = _rand(1, 120, 4, 4)
    inj = FaultInjector()
    svc = MiningService.from_dataset(
        data, engine="torch", device="cpu",
        resilience=ResilienceConfig(max_retries=1, backoff_s=0.0, failure_threshold=2),
    )
    inj.arm("placement.dispatch", action="raise", exc=DeviceFault("dead"), times=1000)
    with placement_faults(inj):
        with pytest.raises(DeviceUnavailable, match="dead") as e:
            svc.mine(tau=1, kmax=3)
        assert isinstance(e.value.__cause__, DeviceFault)
        res = svc.stats()["resilience"]
        assert res["unavailable_mines"] == 1 and res["state"] == "open" and res["device_retries"] == 1
        assert svc.readiness() == (False, "circuit_breaker_open")
        fired = inj.fired("placement.dispatch")
        server = make_server(svc, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as h:
                _req(server.server_address[1], "/mine?tau=1&kmax=3")
            body = json.loads(h.value.read())
            assert h.value.code == 503 and "circuit breaker is open" in body["error"]
        finally:
            server.shutdown()
            server.server_close()
        assert inj.fired("placement.dispatch") == fired and svc.unavailable_mines == 2
        assert svc.cache.get(make_key(svc.store.version, 1, 3, "ascending")) is None
        host = MiningService.from_dataset(data, engine="numpy")
        r = host.mine(tau=1, kmax=3)
    assert _value_sets(r.result) == _value_sets(mine(data, KyivConfig(tau=1, kmax=3, engine="numpy")))
    svc.close()
    host.close()


def test_non_device_error_propagates_without_degrading():
    inj = FaultInjector()
    svc = MiningService.from_dataset(_rand(2, 80, 4, 4), engine="torch", device="cpu")
    inj.arm("placement.dispatch", action="raise", exc=KillPoint("bug"), times=1000)
    with placement_faults(inj), pytest.raises(KillPoint):
        svc.mine(tau=1, kmax=3)
    assert svc.unavailable_mines == 0 and svc.breaker.state == "closed"
    svc.close()


def test_service_defaults_to_the_card(monkeypatch):
    """Built with no engine, the service places on the CUDA card; without a
    card construction raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        MiningService(3)
    assert KyivConfig().engine == "cuda" and KyivConfig().device == "cuda"


def test_host_placement_surface():
    h = HostPlacement()
    assert h.padded_size(5) == 5
    assert h.describe() == {"kind": "host", "engine": "numpy", "devices": 0}
    d = make_placement("torch", device="cpu")
    assert d.padded_size(5) == 256 and d.padded_size(5, pad_buckets=False) == 5
    assert d.describe()["device"] == "cpu" and d.store_word_tile == 1


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


@pytest.fixture()
def http_service():
    from repro_torch.launch.serve_miner import make_server

    svc = MiningService.from_dataset(_rand(0, 200, 4, 5), engine="torch", device="cpu")
    server = make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield svc, server.server_address[1]
    server.shutdown()
    server.server_close()
    svc.close()


def _req(port, path, payload=None, raw=False):
    url = f"http://127.0.0.1:{port}{path}"
    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=60)
    body = resp.read()
    return resp.status, (body.decode() if raw else json.loads(body))


def test_http_mine_append_report_cycle(http_service):
    svc, port = http_service
    assert _req(port, "/healthz")[1] == {"ok": True}
    assert _req(port, "/readyz")[1] == {"ready": True, "reason": "ok"}
    code, m1 = _req(port, "/mine", {"tau": 1, "kmax": 3, "max_itemsets": 5})
    assert code == 200 and m1["source"] == "cold" and len(m1["itemsets"]) <= 5
    code, m2 = _req(port, "/mine?tau=1&kmax=3")
    assert m2["source"] == "cache" and m2["n_itemsets"] == m1["n_itemsets"]
    code, a = _req(port, "/append", {"rows": _rand(7, 15, 4, 5).tolist()})
    assert code == 200 and a["appended"] == 15 and a["version"] == 2
    code, m3 = _req(port, "/mine", {"tau": 1, "kmax": 3})
    assert m3["source"] == "incremental" and m3["version"] == 2
    code, rep = _req(port, "/report?tau=1&kmax=3")
    assert rep["n_quasi_identifiers"] == m3["n_itemsets"] and rep["n_rows"] == 215
    code, risk = _req(port, "/risk?tau=1&kmax=3&top=3")
    assert code == 200 and len(risk["top_records"]) <= 3
    code, stats = _req(port, "/stats")
    assert stats["store"]["n_rows"] == 215 and stats["cache"]["hits"] >= 1
    assert stats["placement"]["engine"] == "torch" and stats["http"]["served"] >= 6
    assert set(stats["executables"]["families"]) >= {"intersect", "frontier", "coverage"}


def test_http_metrics_lint_clean_and_trace_retrievable(http_service):
    from repro_torch.obs.metrics import lint_exposition

    _, port = http_service
    _req(port, "/mine?tau=1&kmax=2")
    code, text = _req(port, "/metrics", raw=True)
    assert code == 200 and lint_exposition(text) == []
    assert "repro_service_mine_requests_total" in text and "repro_http_requests_total" in text
    code, tr = _req(port, "/trace?n=5")
    names = {t["name"] for t in tr["traces"]}
    assert "http /mine" in names
    one = tr["traces"][-1]
    code, got = _req(port, f"/trace?id={one['trace_id']}")
    assert got["trace"]["trace_id"] == one["trace_id"]
    code, slow = _req(port, "/debug/slowlog?n=2")
    assert code == 200 and "entries" in slow and slow["slowlog"]["threshold_s"] == 1.0


@pytest.mark.parametrize(
    "path,payload,code",
    [("/nope", None, 404), ("/append", {"rows": []}, 400), ("/mine?mode=fast", None, 400),
     ("/debug/nosuch", None, 404), ("/debug/lastcrash/x", None, 404),
     ("/trace?id=missing", None, 404)],
)
def test_http_error_codes(http_service, path, payload, code):
    _, port = http_service
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(port, path, payload)
    assert e.value.code == code


def test_serve_miner_without_a_card_exits_with_an_error(monkeypatch, capsys):
    from repro_torch.launch.serve_miner import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["--port", "0", "--preload", "randomized", "--n", "50", "--m", "3"])
    assert e.value.code == 2
    assert "--device cpu or --engine numpy" in capsys.readouterr().err


@pytest.fixture()
def hardened_http_service():
    from repro_torch.launch.serve_miner import make_server

    svc = MiningService.from_dataset(_rand(0, 120, 4, 5), engine="numpy")
    server = make_server(svc, port=0, auth_token="tok3n", max_inflight=2)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield svc, server
    server.shutdown()
    server.server_close()
    svc.close()


def _req_auth(port, path, token=None):
    headers = {} if token is None else {"Authorization": f"Bearer {token}"}
    resp = urllib.request.urlopen(
        urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers), timeout=30)
    return resp.status, json.loads(resp.read())


def test_http_bearer_auth_and_bounded_queue(hardened_http_service):
    _, server = hardened_http_service
    port = server.server_address[1]
    assert _req_auth(port, "/healthz")[1] == {"ok": True}  # liveness is never gated
    for token in (None, "wrong", "café"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _req_auth(port, "/mine?tau=1&kmax=2", token=token)
        assert e.value.code == 401
    code, body = _req_auth(port, "/mine?tau=1&kmax=2", token="tok3n")
    assert code == 200 and body["source"] == "cold"
    sem = server.RequestHandlerClass.inflight
    # the handler releases its slot just after it writes the response, so
    # the client may get here first: wait (bounded) for both slots
    assert sem.acquire(timeout=10) and sem.acquire(timeout=10)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _req_auth(port, "/stats", token="tok3n")
        assert e.value.code == 429
        assert _req_auth(port, "/healthz")[1] == {"ok": True}
    finally:
        sem.release()
        sem.release()
    code, stats = _req_auth(port, "/stats", token="tok3n")
    assert stats["http"]["auth"] is True and stats["http"]["unauthorized"] == 3
    assert stats["http"]["rejected"] == 1 and stats["http"]["max_inflight"] == 2
    assert stats["placement"]["kind"] == "host"


def test_http_deadline_partial_and_cancel(http_service):
    _, port = http_service
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(port, "/mine", {"tau": 1, "kmax": 4, "deadline_s": 0.0})
    assert e.value.code == 499
    body = json.loads(e.value.read())
    assert body["source"] == "partial" and body["info"]["interrupted"] == "deadline"
    code, m = _req(port, "/mine", {"tau": 1, "kmax": 4})
    assert code == 200 and m["source"] == "cold"  # a partial answer is never cached
    code, c = _req(port, "/cancel", {"tau": 1, "kmax": 4})
    assert code == 200 and c["cancelled"] == 0 and "trace_id" in c


def test_http_not_ready_returns_503():
    from repro_torch.launch.serve_miner import make_server

    svc = MiningService(engine="numpy", defer_recovery=True)
    server = make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(port, "/readyz")
        assert e.value.code == 503 and json.loads(e.value.read())["reason"] == "recovering"
        assert _req(port, "/healthz")[1] == {"ok": True}
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(port, "/mine?tau=1&kmax=2")
        assert e.value.code == 503
        svc.recover()
        assert _req(port, "/readyz")[0] == 200
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_concurrent_http_requests_coalesce(http_service):
    svc, port = http_service
    svc.cache.clear()
    results = []
    threads = [threading.Thread(target=lambda: results.append(_req(port, "/mine", {"tau": 1, "kmax": 3})[1]))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 6 and len({r["n_itemsets"] for r in results}) == 1
    sched, cache = svc.scheduler.stats(), svc.cache.stats()
    assert sched["scheduled"] + sched["coalesced"] + cache["hits"] >= 6
    assert sum(1 for r in results if r["source"] == "cold") >= 1


def _stalled_service(**kw):
    """A torch-on-CPU service whose device dispatches each stall 0.2 s."""
    inj = FaultInjector()
    svc = MiningService.from_dataset(_rand(5, 120, 6, 4), engine="torch", device="cpu", **kw)
    inj.arm("placement.dispatch", action="sleep", seconds=0.2, times=1000)
    return svc, inj


def test_cancel_stops_inflight_run():
    svc, inj = _stalled_service()
    out = {}
    with placement_faults(inj):
        t = threading.Thread(target=lambda: out.setdefault("resp", svc.mine(tau=1, kmax=5)))
        t.start()
        deadline = threading.Event()
        while not svc._controls and not deadline.wait(0.01):
            pass
        assert svc.cancel(1, 5)["cancelled"] == 1
        t.join(timeout=30)
    assert out["resp"].source == "partial" and out["resp"].info["interrupted"] == "cancelled"
    svc.close()


def test_coalesced_waiter_deadline():
    """A deadline-free initiator keeps its run; a coalesced waiter with a
    deadline gets DeadlineExceeded instead of blocking on the shared run."""
    from repro_torch.service import DeadlineExceeded

    svc, inj = _stalled_service(deadline_grace_s=0.05)
    out = {}
    with placement_faults(inj):
        t = threading.Thread(target=lambda: out.setdefault("resp", svc.mine(tau=1, kmax=5)))
        t.start()
        while not svc._controls:
            threading.Event().wait(0.01)
        with pytest.raises(DeadlineExceeded):
            svc.mine(tau=1, kmax=5, deadline_s=0.05)
        inj.reset()
        t.join(timeout=60)
    assert out["resp"].result.completed
    svc.close()


def test_incremental_falls_back_cold_after_compaction():
    base, d1, d2 = _rand(0, 200, 4, 5), _rand(1, 10, 4, 5), _rand(2, 10, 4, 5)
    svc = MiningService.from_dataset(base, engine="torch", device="cpu")
    svc.mine(tau=1, kmax=3)
    svc.append(d1)
    svc.append(d2)
    svc.store.compact(keep_versions=1)
    assert not svc.store.has_version(1)
    r = svc.mine(tau=1, kmax=3)
    assert r.source == "cold"
    want = mine(np.concatenate([base, d1, d2]), KyivConfig(tau=1, kmax=3, engine="numpy"))
    assert _value_sets(r.result) == _value_sets(want)
    assert svc.stats()["store"]["compactions"] == 1
    assert svc.drain(timeout=1.0) == {"inflight": 0, "drained": 0, "abandoned": 0}
    svc.close()
