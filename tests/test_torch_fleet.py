"""The port's multi-process fleet: the sharded store, lockstep collectives
and the coordinator (a port of ``tests/test_fleet.py``).

* unit tests — stripe math and ``word_map`` of the process-sharded
  ``DatasetStore`` against the reference's, delta masks, sharded states
  crossing between the packages both ways, foreign shards refused;
* an in-process fleet — threads posing as processes, each with its own
  sharded store and ``FleetPlacement`` (host numpy, or the torch engine on
  the CPU inside): mine, incremental mine and risk equal the
  single-process answers on every simulated process;
* the loopback frontend against a plain service, approximate mode refused;
* two real processes over a ``TCPStore`` (``slow``): the frontend and the
  peer loop, then ``serve_miner --num-processes 2`` over HTTP with a peer
  SIGKILLed, degrading to the shadow with exact answers — each held against
  the reference's single-process service.
"""

import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from repro.service import DatasetStore as RefStore
from repro.service import MiningService as RefService
from repro_torch.core.collective import Collective, FleetDesyncError, LoopbackCollective
from repro_torch.core.fleet import FleetPlacement
from repro_torch.core.kyiv import KyivConfig, mine, mine_preprocessed
from repro_torch.core.placement import DevicePlacement, HostPlacement, MeshPlacement
from repro_torch.service import (
    DatasetStore,
    FleetFrontend,
    IncrementalConfig,
    MiningService,
    ResultBands,
    mine_incremental,
)
from repro_torch.launch.mesh import mesh_from_spec
from repro_torch.service.store import mask_delta_words_local

_pre = importlib.import_module("repro_torch.core.preprocess")
_inc = importlib.import_module("repro_torch.service.incremental")

NPROC = 2
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
INNERS = {
    "host": HostPlacement,
    "torch": lambda: DevicePlacement("torch", device="cpu"),
    # each process's local mesh (a three-part DCNxDATAxMODEL spec)
    "mesh": lambda: MeshPlacement(mesh_from_spec("2x2x2", devices=["cpu"] * 4, num_processes=2),
                                  word_axis="model", engine="torch"),
}


# -- in-process fleet simulation ------------------------------------------


class ThreadCollective(Collective):
    """Barrier-backed collective for N threads posing as N processes."""

    def __init__(self, pid: int, shared: dict, nproc: int = NPROC):
        self.pid, self.nproc = pid, nproc
        self.sh = shared
        self._round = 0
        self.rounds = 0
        self.seconds = 0.0
        self.payload_bytes = 0

    def allgather(self, payload: bytes) -> list[bytes]:
        n = self._round
        self._round += 1
        self.sh["slots"][(n, self.pid)] = payload
        self.sh["barrier"].wait()
        out = [self.sh["slots"][(n, p)] for p in range(self.nproc)]
        self.sh["barrier"].wait()
        self.rounds += 1
        self.payload_bytes += sum(len(b) for b in out)
        return out


class _HookProxy:
    """Routes the module-global preprocess hook to each thread's collective."""

    def __init__(self, nproc: int = NPROC):
        self.by_thread: dict[int, ThreadCollective] = {}
        self.nproc = nproc

    def _mine(self) -> ThreadCollective:
        return self.by_thread[threading.get_ident()]

    def allgather(self, payload):
        return self._mine().allgather(payload)

    def allreduce_sum(self, arr):
        return self._mine().allreduce_sum(arr)


def _run_fleet(worker, nproc: int = NPROC):
    """Run ``worker(pid, collective)`` on nproc threads; returns results."""
    shared = {"slots": {}, "barrier": threading.Barrier(nproc, timeout=120)}
    proxy = _HookProxy(nproc)
    prev = _pre.set_row_group_collective(proxy)
    outs = [None] * nproc
    errs = [None] * nproc

    def run(p):
        try:
            tc = ThreadCollective(p, shared, nproc)
            proxy.by_thread[threading.get_ident()] = tc
            outs[p] = worker(p, tc)
        except Exception as exc:  # noqa: BLE001 - surfaced via errs
            errs[p] = exc
            try:
                shared["barrier"].abort()
            except Exception:
                pass

    threads = [threading.Thread(target=run, args=(p,)) for p in range(nproc)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _pre.set_row_group_collective(prev)
    assert not any(errs), [e for e in errs if e]
    return outs


def _dataset(seed=3, n=400, d=130, cols=4, vals=5):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, vals, size=(n, cols)),
        rng.integers(0, vals, size=(d, cols)),
    )


def _stats(res):
    return [(s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections, s.emitted,
             s.skipped_absent_uniform, s.stored) for s in res.stats]


def _prep(store, config):
    return _pre.preprocess(store.item_table(), config.tau, ordering=config.ordering,
                           seed=config.seed)


# -- sharded store stripe math --------------------------------------------


@pytest.mark.parametrize("nproc", [2, 3])
def test_sharded_store_reconstructs_global_bits(nproc):
    rows, delta = _dataset(seed=9, n=900)
    full = DatasetStore(4, word_tile=8)
    full.append(rows)
    full.append(delta)
    t_full = full.item_table()
    rebuilt = None
    for p in range(nproc):
        s = DatasetStore(4, word_tile=8, shard=(p, nproc))
        ref = RefStore(4, word_tile=8, shard=(p, nproc))
        for blk in (rows, delta):
            s.append(blk)
            ref.append(blk)
        t, rt = s.item_table(), ref.item_table()
        np.testing.assert_array_equal(t.bits, rt.bits)
        wm = s.word_map(t.n_words)
        np.testing.assert_array_equal(wm, ref.word_map(t.n_words))
        assert s.stats() == ref.stats()
        assert s.watermark_digest() == ref.watermark_digest()
        n_words_global = s.stats()["n_words_global"]
        if rebuilt is None:
            rebuilt = np.zeros((t_full.n_items, n_words_global), dtype=np.uint32)
        rebuilt[:, wm] = t.bits
        np.testing.assert_array_equal(t.freq, t_full.freq)
        np.testing.assert_array_equal(t.value, t_full.value)
        assert s.version == full.version and s.n_rows == full.n_rows
    np.testing.assert_array_equal(rebuilt[:, : t_full.n_words], t_full.bits)
    assert not rebuilt[:, t_full.n_words :].any()


def test_sharded_delta_popcounts_sum_to_global():
    rows, delta = _dataset(seed=21)
    base_rows = len(rows)
    full = DatasetStore(4, word_tile=8)
    v1 = full.append(rows)
    full.append(delta)
    fbits, _ = full.delta_bits(v1)
    want = np.bitwise_count(fbits).sum(axis=1).astype(np.int64)
    got = np.zeros_like(want)
    for p in range(NPROC):
        s = DatasetStore(4, word_tile=8, shard=(p, NPROC))
        v = s.append(rows)
        s.append(delta)
        t = s.item_table()
        dbits = mask_delta_words_local(t.bits, base_rows, s.word_map(t.n_words))
        np.testing.assert_array_equal(dbits, s.delta_bits(v)[0])
        # the incremental miner keeps only the local words from the first
        # delta word on: the same popcounts
        sliced = _inc._delta_bits_of(t, base_rows, s.word_map(t.n_words))
        assert sliced.shape[1] < dbits.shape[1]
        np.testing.assert_array_equal(np.bitwise_count(sliced).sum(axis=1),
                                      np.bitwise_count(dbits).sum(axis=1))
        got += np.bitwise_count(dbits).sum(axis=1).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_sharded_states_cross_both_ways_and_refuse_foreign_shards():
    rows, delta = _dataset(seed=4, n=700)
    for p in range(NPROC):
        port = DatasetStore(4, word_tile=8, shard=(p, NPROC))
        ref = RefStore(4, word_tile=8, shard=(p, NPROC))
        for blk in (rows, delta):
            port.append(blk)
            ref.append(blk)
        # reference state -> port, port state -> reference
        a = DatasetStore.from_state(ref.export_state())
        b = RefStore.from_state(port.export_state())
        assert a.shard == b.shard == (p, NPROC)
        for x, y in ((a.export_state(), ref.export_state()),
                     (b.export_state(), port.export_state())):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
        foreign = ((p + 1) % NPROC, NPROC)
        with pytest.raises(ValueError, match="not transferable"):
            DatasetStore.from_state(ref.export_state(), shard=foreign)
        with pytest.raises(ValueError, match="not transferable"):
            RefStore.from_state(port.export_state(), shard=foreign)


def test_identity_shard_is_unsharded():
    rows, _ = _dataset()
    a = DatasetStore(4, word_tile=8)
    b = DatasetStore(4, word_tile=8, shard=(0, 1))
    a.append(rows)
    b.append(rows)
    np.testing.assert_array_equal(a.item_table().bits, b.item_table().bits)
    assert a.watermark_digest() == b.watermark_digest()


# -- lockstep fleet mining (thread-simulated processes) -------------------


@pytest.mark.parametrize("inner", sorted(INNERS))
@pytest.mark.parametrize("cfg", [dict(tau=8, kmax=4), dict(tau=40, kmax=3)])
def test_fleet_mining_bit_identical(cfg, inner):
    rows, delta = _dataset()
    baseline = mine(np.concatenate([rows, delta]), KyivConfig(engine="numpy", **cfg))

    def worker(p, tc):
        store = DatasetStore(4, word_tile=8, shard=(p, NPROC))
        store.append(rows)
        store.append(delta)
        placement = FleetPlacement(INNERS[inner](), collective=tc)
        config = KyivConfig(placement=placement, **cfg)
        return mine_preprocessed(_prep(store, config), config)

    for out in _run_fleet(worker):
        assert out.itemsets == baseline.itemsets
        # every stat but level_bytes, which counts this process's local words
        assert _stats(out) == _stats(baseline)


@pytest.mark.parametrize("inner", sorted(INNERS))
def test_fleet_incremental_bit_identical(inner):
    rows, delta = _dataset(seed=11, n=420, d=60)
    cfg = dict(tau=12, kmax=4)
    cold = mine(np.concatenate([rows, delta]), KyivConfig(engine="numpy", **cfg))

    def worker(p, tc):
        placement = FleetPlacement(INNERS[inner](), collective=tc)
        store = DatasetStore(4, word_tile=8, shard=(p, NPROC), placement=placement)
        v1 = store.append(rows)
        config = KyivConfig(placement=placement, **cfg)
        base = mine_preprocessed(_prep(store, config), config)
        store.append(delta)
        resident = store.device_bits() if inner != "host" else None
        out = mine_incremental(
            store, base, v1, config, IncrementalConfig(),
            bands=ResultBands.from_result(base.itemsets), resident_bits=resident,
        )
        assert out is not None
        return out

    outs = _run_fleet(worker)
    for res, info in outs:
        assert sorted(res.itemsets) == sorted(cold.itemsets)
        assert info["fleet"]["nproc"] == NPROC
    assert outs[0][1]["n_recounted"] == outs[1][1]["n_recounted"]


@pytest.mark.parametrize("inner", sorted(INNERS))
def test_fleet_risk_profile_bit_identical(inner):
    from repro.core import KyivConfig as RefConfig
    from repro.core import mine as ref_mine
    from repro.privacy.risk import risk_profile as ref_risk
    from repro_torch.privacy.risk import risk_profile

    rows, delta = _dataset(seed=29)
    cfg = dict(tau=20, kmax=3)
    ref = ref_risk(ref_mine(np.concatenate([rows, delta]), RefConfig(**cfg)))

    def worker(p, tc):
        store = DatasetStore(4, word_tile=8, shard=(p, NPROC))
        store.append(rows)
        store.append(delta)
        placement = FleetPlacement(INNERS[inner](), collective=tc)
        config = KyivConfig(placement=placement, **cfg)
        result = mine_preprocessed(_prep(store, config), config)
        table = store.item_table()
        return risk_profile(result, placement=placement, word_map=store.word_map(table.n_words))

    for prof in _run_fleet(worker):
        np.testing.assert_array_equal(prof.counts_by_size, ref.counts_by_size)
        np.testing.assert_array_equal(prof.risk, ref.risk)
        assert prof.records_at_risk == ref.records_at_risk


def test_collective_agree_raises_on_divergence():
    def worker(p, tc):
        with pytest.raises(FleetDesyncError):
            tc.agree(f"value-{p}".encode(), what="digest")
        return True

    assert all(_run_fleet(worker))


def test_fleet_placement_surface():
    inner = DevicePlacement("torch", device="cpu")
    fp = FleetPlacement(inner, collective=LoopbackCollective())
    assert fp.kind == "fleet" and fp.use_device_frontier is False
    assert fp.shard == (0, 1) and fp.padded_size(5) == inner.padded_size(5)
    with pytest.raises(ValueError, match="do not nest"):
        FleetPlacement(fp)
    with pytest.raises(ValueError, match="disagrees"):
        FleetPlacement(inner, collective=LoopbackCollective(), shard=(1, 2))
    desc = fp.describe()
    assert desc["inner"]["engine"] == "torch" and desc["collective"]["nproc"] == 1


# -- loopback frontend: coordinator semantics without processes -----------


@pytest.mark.parametrize("inner", sorted(INNERS))
def test_loopback_frontend_matches_plain_service(inner):
    rows, delta = _dataset(seed=5, n=300, d=40, cols=5, vals=4)
    tc = LoopbackCollective()
    svc = MiningService(placement=FleetPlacement(INNERS[inner](), collective=tc))
    shadow = MiningService(engine="torch", device="cpu")
    front = FleetFrontend(svc, tc, shadow=shadow)
    plain = MiningService(engine="numpy")

    front.append(rows)
    plain.append(rows)
    assert (front.mine(tau=10, kmax=3).result.itemsets
            == plain.mine(tau=10, kmax=3).result.itemsets)
    front.append(delta)
    plain.append(delta)
    r = front.mine(tau=10, kmax=3)
    p = plain.mine(tau=10, kmax=3)
    assert r.result.itemsets == p.result.itemsets
    assert r.source == "incremental"
    rf, rp = front.risk(tau=10, kmax=3), plain.risk(tau=10, kmax=3)
    for k in ("records_at_risk", "max_risk", "qi_total", "top_records"):
        assert rf[k] == rp[k]
    assert shadow.store.n_rows == len(rows) + len(delta)
    fl = front.stats()["resilience"]["fleet"]
    assert fl["degraded"] is False and fl["replicated_ops"] == 5
    front.close()
    plain.close()


def test_frontend_rejects_fleet_incompatible_modes():
    tc = LoopbackCollective()
    svc = MiningService(placement=FleetPlacement(HostPlacement(), collective=tc))
    front = FleetFrontend(svc, tc, shadow=MiningService(engine="numpy"))
    front.append(np.zeros((64, 3), dtype=np.int64))
    with pytest.raises(ValueError, match="approx"):
        front.mine(tau=1, kmax=2, mode="approx")
    with pytest.raises(ValueError, match="deadline"):
        front.mine(tau=1, kmax=2, deadline_s=1.0)
    front.close()


# -- real processes over a TCPStore (slow ring) ---------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, sys.argv[4])
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from repro_torch.launch.mesh import distributed_init, fleet_store
distributed_init(f"127.0.0.1:{port}", nproc, pid)
from repro_torch.core.collective import FleetCollective
from repro_torch.core.fleet import FleetPlacement
from repro_torch.core.placement import DevicePlacement
from repro_torch.core.preprocess import set_row_group_collective
from repro_torch.service import FleetFrontend, MiningService, serve_fleet_peer

fc = FleetCollective(*fleet_store(), timeout_s=60.0)
set_row_group_collective(fc)
svc = MiningService(placement=FleetPlacement(DevicePlacement("torch", device="cpu"),
                                             collective=fc))
rng = np.random.default_rng(17)
rows = rng.integers(0, 5, size=(360, 5))
delta = rng.integers(0, 5, size=(50, 5))

if pid != 0:
    out = serve_fleet_peer(svc, fc)
    print(json.dumps({"pid": pid, **out}), flush=True)
    sys.exit(0)

shadow = MiningService(engine="torch", device="cpu")
front = FleetFrontend(svc, fc, shadow=shadow)
front.append(rows)
r1 = front.mine(tau=18, kmax=3)
front.append(delta)
r2 = front.mine(tau=18, kmax=3)
risk = front.risk(tau=18, kmax=3)
fl = front.stats()["resilience"]["fleet"]
front.close()
print(json.dumps({
    "pid": 0,
    "r1": sorted([[list(map(int, i)), int(c)] for i, c in r1.result.itemsets]),
    "r2": sorted([[list(map(int, i)), int(c)] for i, c in r2.result.itemsets]),
    "r2_source": r2.source,
    "risk": {k: risk[k] for k in ("records_at_risk", "max_risk", "qi_total")},
    "degraded": fl["degraded"],
    "rounds": fl["collective"]["rounds"],
}), flush=True)
"""


def _fmt(r):
    return sorted([[list(map(int, i)), int(c)] for i, c in r.result.itemsets])


def _reference_baseline(rows, delta, tau, kmax, deltas=()):
    """The reference's single-process service over the same appends."""
    svc = RefService(engine="numpy")
    svc.append(rows)
    out = [_fmt(svc.mine(tau=tau, kmax=kmax))]
    svc.append(delta)
    out.append(_fmt(svc.mine(tau=tau, kmax=kmax)))
    risk = svc.risk(tau=tau, kmax=kmax)
    for d in deltas:
        svc.append(d)
        out.append(_fmt(svc.mine(tau=tau, kmax=kmax)))
    svc.close()
    return out, {k: risk[k] for k in ("records_at_risk", "max_risk", "qi_total")}


@pytest.mark.slow
def test_two_process_fleet_bit_identical_to_reference():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(p), "2", str(port), SRC],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
             for p in range(2)]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=120)
        assert p.returncode == 0, se[-3000:]
        outs.append(json.loads(so.strip().splitlines()[-1]))
    o0 = next(o for o in outs if o["pid"] == 0)
    o1 = next(o for o in outs if o["pid"] == 1)
    rng = np.random.default_rng(17)
    rows, delta = rng.integers(0, 5, size=(360, 5)), rng.integers(0, 5, size=(50, 5))
    (b1, b2), bk = _reference_baseline(rows, delta, 18, 3)
    assert o0["r1"] == b1 and o0["r2"] == b2
    assert o0["r2_source"] == "incremental"
    assert o0["risk"] == bk
    assert o0["degraded"] is False and o0["rounds"] > 10
    assert o1["reason"] == "shutdown" and o1["executed"] == 5


def _http(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=120).read())


@pytest.mark.slow
def test_serve_miner_fleet_peer_kill_degrades_to_shadow(tmp_path):
    rng = np.random.default_rng(23)
    rows = rng.integers(0, 5, size=(2000, 5))
    delta, delta2 = rng.integers(0, 5, size=(40, 5)), rng.integers(0, 5, size=(30, 5))
    csv = tmp_path / "t.csv"
    csv.write_text("a,b,c,d,e\n" + "\n".join(",".join(map(str, r)) for r in rows) + "\n")
    http_port, coord = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_miner", "--engine", "torch",
           "--device", "cpu", "--num-processes", "2", "--coordinator-address",
           f"127.0.0.1:{coord}", "--fleet-timeout-s", "2", "--wal-dir", str(tmp_path / "wal")]
    p0 = subprocess.Popen(cmd + ["--process-id", "0", "--port", str(http_port), "--preload",
                                 str(csv)], env=env, stderr=subprocess.PIPE, text=True)
    p1 = subprocess.Popen(cmd + ["--process-id", "1"], env=env, stderr=subprocess.PIPE,
                          text=True)
    try:
        deadline = time.time() + 90
        while True:
            try:
                _http(http_port, "/healthz")
                break
            except Exception:
                assert time.time() < deadline and p0.poll() is None, "frontend never came up"
                time.sleep(0.2)
        # an idle fleet stays up: the peer's wait for its next command has no
        # round deadline
        time.sleep(3)
        assert p1.poll() is None, "the peer gave up while the fleet was idle"
        m1 = _http(http_port, "/mine?tau=2&kmax=3")
        _http(http_port, "/append", {"rows": delta.tolist()})
        m2 = _http(http_port, "/mine?tau=2&kmax=3")
        risk = _http(http_port, "/risk?tau=2&kmax=3")
        st = _http(http_port, "/stats")
        fl = st["resilience"]["fleet"]
        assert fl["degraded"] is False and fl["collective"]["rounds"] > 0
        assert st["placement"]["kind"] == "fleet" and st["placement"]["level_reduces"]
        p1.send_signal(signal.SIGKILL)
        p1.wait(30)
        _http(http_port, "/append", {"rows": delta2.tolist()})
        m3 = _http(http_port, "/mine?tau=2&kmax=3")
        fl = _http(http_port, "/stats")["resilience"]["fleet"]
        assert fl["degraded"] is True and "FleetTimeout" in fl["degraded_reason"]
        # each process journals its own stripes
        assert (tmp_path / "wal" / "p0").is_dir() and (tmp_path / "wal" / "p1").is_dir()
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in (p0, p1):
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
    (b1, b2, b3), bk = _reference_baseline(rows, delta, 2, 3, deltas=(delta2,))
    got = [sorted([[sorted([list(x) for x in s["items"]]), s["count"]] for s in m["itemsets"]])
           for m in (m1, m2, m3)]
    ref_svc = RefService(engine="numpy")
    want = []
    for blk in (rows, delta, delta2):
        ref_svc.append(blk)
        resp = ref_svc.mine(tau=2, kmax=3).to_json()
        want.append(sorted([[sorted([list(x) for x in s["items"]]), s["count"]]
                            for s in resp["itemsets"]]))
    ref_svc.close()
    assert got == want
    assert [m["n_itemsets"] for m in (m1, m2, m3)] == [len(b) for b in (b1, b2, b3)]
    assert m1["source"] == "cold" and m2["source"] == "incremental"
    assert {k: risk[k] for k in bk} == bk
