"""The port's durability layer (``repro_torch.service.wal``): WAL framing,
snapshot folding and crash recovery, ported from ``tests/test_durability.py``
to the port's store and service on the CPU (``engine="torch"`` and numpy),
and held against the reference's ``DurableStore``: a ``wal_dir`` written by
either package recovers in the other to the same version, bitsets and item
ids, torn frames included.

The contract: an acknowledged append survives process death (fsync'd WAL
record), an unacknowledged torn tail is dropped, and a recovered store is
observably identical to the pre-crash one — same item ids, bitsets,
supports and version watermarks.
"""

import os
import shutil

import numpy as np
import pytest

from repro.service import DurableStore as RefDurableStore
from repro.service import FaultInjector as RefFaultInjector
from repro.service import KillPoint as RefKillPoint
from repro.service import MiningService as RefMiningService
from repro_torch.core import bits_to_rows
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.service import (
    DatasetStore,
    DurableStore,
    FaultInjector,
    KillPoint,
    MiningService,
    NotReadyError,
    WriteAheadLog,
)

ENGINES = ["torch", "numpy"]


def _rand(seed, n, m, dom=4):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


def _service(engine, **kw):
    return MiningService(engine=engine, device="cpu", **kw)


def _store_fingerprint(store):
    """Everything a client can observe about a store (either package's)."""
    table = store.item_table()
    items = {
        (int(table.col[i]), int(table.value[i])): (
            int(table.freq[i]),
            int(table.min_row[i]),
            tuple(bits_to_rows(table.bits[i]).tolist()),
        )
        for i in range(table.n_items)
    }
    watermarks = {
        v: (store.rows_at(v), store.items_at(v))
        for v in range(1, store.version + 1)
        if store.has_version(v)
    }
    return (store.version, store.n_rows, store.n_items, items, watermarks)


def _store_layout(store):
    """Item ids and the raw bitset words, in id order."""
    table = store.item_table()
    return (
        table.col.tolist(),
        table.value.tolist(),
        table.bits.tobytes(),
        table.n_words,
    )


# ---------------------------------------------------------------------------
# WriteAheadLog
# ---------------------------------------------------------------------------


def test_wal_roundtrip(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.log"))
    records = [{"version": i, "rows": _rand(i, 5, 3)} for i in range(1, 4)]
    for r in records:
        wal.append(r)
    got = wal.replay()
    assert len(got) == 3
    for want, have in zip(records, got):
        assert have["version"] == want["version"]
        np.testing.assert_array_equal(have["rows"], want["rows"])
    assert wal.truncated_bytes == 0


def test_wal_truncated_tail_dropped(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path)
    wal.append({"version": 1, "rows": _rand(0, 5, 3)})
    wal.append({"version": 2, "rows": _rand(1, 5, 3)})
    wal.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:  # tear the last frame mid-payload
        f.truncate(size - 7)
    wal2 = WriteAheadLog(path)
    got = wal2.replay()
    assert [r["version"] for r in got] == [1]
    assert wal2.truncated_bytes > 0
    # the torn tail is physically gone: a fresh append after recovery
    # produces a clean log
    wal2.append({"version": 2, "rows": _rand(1, 5, 3)})
    assert [r["version"] for r in wal2.replay()] == [1, 2]


def test_wal_corrupt_tail_bytes_dropped(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path)
    wal.append({"version": 1, "rows": _rand(0, 5, 3)})
    wal.close()
    with open(path, "ab") as f:  # garbage after the good prefix
        f.write(b"\x00garbage-not-a-frame" * 3)
    wal2 = WriteAheadLog(path)
    assert [r["version"] for r in wal2.replay()] == [1]
    assert wal2.truncated_bytes > 0


def test_wal_flipped_bit_fails_crc(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path)
    wal.append({"version": 1, "rows": _rand(0, 5, 3)})
    wal.close()
    data = bytearray(open(path, "rb").read())
    data[-3] ^= 0x40
    open(path, "wb").write(bytes(data))
    assert WriteAheadLog(path).replay() == []


def test_wal_reset(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.log"))
    wal.append({"version": 1, "rows": _rand(0, 5, 3)})
    wal.reset()
    assert wal.size() == 0 and wal.replay() == []
    wal.append({"version": 2, "rows": _rand(1, 5, 3)})
    assert [r["version"] for r in wal.replay()] == [2]


def test_wal_frame_naming_a_foreign_class_ends_the_replay(tmp_path):
    """A frame whose pickle names anything but numpy, this package or plain
    builtins is not loaded: replay keeps the prefix before it."""
    import pickle
    import struct
    import zlib

    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path)
    wal.append({"version": 1, "rows": _rand(0, 5, 3)})
    wal.close()
    payload = pickle.dumps({"version": 2, "rows": os.getcwd})
    with open(path, "ab") as f:
        f.write(struct.pack("<4sII", b"KWAL", zlib.crc32(payload), len(payload)) + payload)
    wal2 = WriteAheadLog(path)
    assert [r["version"] for r in wal2.replay()] == [1]
    assert wal2.truncated_bytes == 12 + len(payload)


# ---------------------------------------------------------------------------
# DatasetStore state export
# ---------------------------------------------------------------------------


def test_export_from_state_identical():
    store = DatasetStore(4)
    for s in range(4):
        store.append(_rand(s, 30, 4, 5))
    rebuilt = DatasetStore.from_state(store.export_state())
    assert _store_fingerprint(rebuilt) == _store_fingerprint(store)
    # the rebuilt store keeps working: appends continue the version chain
    # and itemize against the recovered item-id table
    a, b = _rand(9, 20, 4, 5), _rand(9, 20, 4, 5)
    assert store.append(a) == rebuilt.append(b) == 5
    np.testing.assert_array_equal(a, b)
    assert _store_fingerprint(rebuilt) == _store_fingerprint(store)


def test_export_state_is_a_snapshot():
    store = DatasetStore(3)
    store.append(_rand(0, 25, 3, 4))
    state = store.export_state()
    store.append(_rand(1, 25, 3, 4))
    rebuilt = DatasetStore.from_state(state)
    assert rebuilt.version == 1 and rebuilt.n_rows == 25


# ---------------------------------------------------------------------------
# DurableStore: WAL + snapshots + recovery
# ---------------------------------------------------------------------------


def test_durable_store_recovers_from_wal_only(tmp_path):
    d = str(tmp_path / "wal")
    ds = DurableStore(d, snapshot_every=100)
    for s in range(3):
        ds.append(_rand(s, 20, 4, 5))
    want = _store_fingerprint(ds.store)
    ds.close()

    ds2 = DurableStore(d, snapshot_every=100)
    info = ds2.recover()
    assert info["replayed"] == 3 and info["snapshot_version"] == 0
    assert _store_fingerprint(ds2.store) == want


def test_durable_store_snapshot_folding(tmp_path):
    d = str(tmp_path / "wal")
    ds = DurableStore(d, snapshot_every=2)
    for s in range(5):
        ds.append(_rand(s, 20, 4, 5))
    assert ds.snapshots_taken == 2  # after appends 2 and 4
    assert ds.stats()["since_snapshot"] == 1
    want = _store_fingerprint(ds.store)
    ds.close()

    ds2 = DurableStore(d, snapshot_every=2)
    info = ds2.recover()
    assert info["snapshot_version"] == 4 and info["replayed"] == 1
    assert _store_fingerprint(ds2.store) == want


def test_kill_mid_append_recovers_to_last_ack(tmp_path):
    """The torn half-frame of a power cut mid-append is dropped: recovery
    lands on the last *acknowledged* version, exactly."""
    d = str(tmp_path / "wal")
    inj = FaultInjector()
    ds = DurableStore(d, snapshot_every=100, injector=inj)
    ds.append(_rand(0, 30, 4, 5))
    ds.append(_rand(1, 30, 4, 5))
    want = _store_fingerprint(ds.store)

    inj.arm("wal.append", action="partial")
    with pytest.raises(KillPoint):
        ds.append(_rand(2, 30, 4, 5))
    ds.close()

    ds2 = DurableStore(d, snapshot_every=100)
    info = ds2.recover()
    assert info["truncated_bytes"] > 0
    assert ds2.store.version == 2
    assert _store_fingerprint(ds2.store) == want
    # and the recovered store accepts the retried block normally
    assert ds2.append(_rand(2, 30, 4, 5)) == 3


def test_crash_between_snapshot_and_wal_reset_is_idempotent(tmp_path):
    """Records the snapshot already holds are skipped by version on replay —
    simulate the crash window by re-appending the WAL records the snapshot
    folded in."""
    d = str(tmp_path / "wal")
    ds = DurableStore(d, snapshot_every=2)
    blocks = [_rand(s, 20, 4, 5) for s in range(2)]
    for b in blocks:
        ds.append(b)
    # snapshot at v2 just ran and reset the WAL; undo the reset
    for i, b in enumerate(blocks):
        ds.wal.append({"version": i + 1, "rows": b})
    want = _store_fingerprint(ds.store)
    ds.close()

    ds2 = DurableStore(d, snapshot_every=2)
    info = ds2.recover()
    assert info["skipped"] == 2 and info["replayed"] == 0
    assert _store_fingerprint(ds2.store) == want


def test_replay_uploads_the_recovered_version_once(tmp_path, monkeypatch):
    """Recovery replays every WAL record into the store, but the placement
    receives one upload: of the recovered version, at its first use."""
    from repro_torch.core.placement import DevicePlacement

    d = str(tmp_path / "wal")
    svc = _service("torch", wal_dir=d, snapshot_every=100)
    for s in range(5):
        svc.append(_rand(s, 40, 4, 4))
    svc.close()

    calls = []
    real = DevicePlacement.put_bits
    monkeypatch.setattr(DevicePlacement, "put_bits",
                        lambda self, bits: calls.append(bits.shape) or real(self, bits))
    svc2 = _service("torch", wal_dir=d, snapshot_every=100)
    assert svc2.stats()["durability"]["last_recovery"]["replayed"] == 5
    assert calls == []
    svc2.mine(tau=1, kmax=3)
    svc2.mine(tau=2, kmax=3)
    assert len(calls) == 1 and list(svc2.store._device) == [5]
    svc2.close()


# ---------------------------------------------------------------------------
# CheckpointManager hardening (restore fallback)
# ---------------------------------------------------------------------------


def test_manager_restore_falls_back_past_corrupt_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    mgr.save(1, {"x": np.arange(3)})
    mgr.save(2, {"x": np.arange(4)})
    # corrupt the newest checkpoint's arrays
    with open(os.path.join(mgr._step_dir(2), "arrays.npz"), "wb") as f:
        f.write(b"not an npz")
    tree, meta = mgr.restore()
    assert meta["step"] == 1
    np.testing.assert_array_equal(tree["x"], np.arange(3))
    # the corrupt dir is quarantined, not rediscovered
    assert mgr.steps() == [1]
    assert os.path.exists(mgr._step_dir(2) + ".corrupt")


def test_manager_restore_none_when_all_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    mgr.save(1, {"x": np.arange(3)})
    with open(os.path.join(mgr._step_dir(1), "arrays.npz"), "wb") as f:
        f.write(b"junk")
    assert mgr.restore() == (None, None)


# ---------------------------------------------------------------------------
# MiningService over a durable store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_service_restart_recovers_store_and_serves(tmp_path, engine):
    d = str(tmp_path / "wal")
    svc = _service(engine, wal_dir=d, snapshot_every=3)
    for s in range(5):
        svc.append(_rand(s, 25, 4, 5))
    want = _store_fingerprint(svc.store)
    ref = svc.mine(tau=2, kmax=3)
    svc.close()

    svc2 = _service(engine, wal_dir=d, snapshot_every=3)
    assert svc2.ready
    assert _store_fingerprint(svc2.store) == want
    got = svc2.mine(tau=2, kmax=3)
    assert got.result.canonical_set() == ref.result.canonical_set()
    stats = svc2.stats()
    assert stats["durability"]["last_recovery"]["version"] == 5
    svc2.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_service_not_ready_rejects_until_recovered(tmp_path, engine):
    d = str(tmp_path / "wal")
    svc = _service(engine, wal_dir=d)
    svc.append(_rand(0, 25, 4, 5))
    svc.close()

    svc2 = _service(engine, wal_dir=d, defer_recovery=True)
    assert not svc2.ready
    assert svc2.readiness() == (False, "recovering")
    with pytest.raises(NotReadyError):
        svc2.mine(tau=1, kmax=2)
    with pytest.raises(NotReadyError):
        svc2.append(_rand(1, 5, 4, 5))
    svc2.recover()
    assert svc2.ready
    assert svc2.mine(tau=1, kmax=2).result is not None
    svc2.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_compact_snapshots_durable_state(tmp_path, engine):
    d = str(tmp_path / "wal")
    svc = _service(engine, wal_dir=d, snapshot_every=100)
    for s in range(4):
        svc.append(_rand(s, 20, 4, 5))
    svc.compact(keep_versions=1)
    want = _store_fingerprint(svc.store)
    svc.close()

    svc2 = _service(engine, wal_dir=d, snapshot_every=100)
    assert _store_fingerprint(svc2.store) == want
    assert svc2.store.compactions == 1
    svc2.close()


# ---------------------------------------------------------------------------
# a wal_dir crosses between the packages
# ---------------------------------------------------------------------------


def _write(package, d, blocks, snapshot_every, torn=None):
    """Append ``blocks`` through ``package``'s DurableStore; ``torn`` rows
    end the log with a power cut mid-append (a ``partial`` frame)."""
    if package == "reference":
        inj = RefFaultInjector()
        ds = RefDurableStore(d, snapshot_every=snapshot_every, injector=inj)
        kill = RefKillPoint
    else:
        inj = FaultInjector()
        ds = DurableStore(d, snapshot_every=snapshot_every, injector=inj)
        kill = KillPoint
    for b in blocks:
        ds.append(b)
    if torn is not None:
        inj.arm("wal.append", action="partial")
        with pytest.raises(kill):
            ds.append(torn)
    ds.close()


def _recover(package, d, snapshot_every):
    cls = RefDurableStore if package == "reference" else DurableStore
    ds = cls(d, snapshot_every=snapshot_every)
    info = ds.recover()
    ds.close()
    return ds.store, info


@pytest.mark.parametrize("snapshot_every", [1, 2, 100])
@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_wal_dir_crosses_packages(tmp_path, writer, reader, snapshot_every):
    """Snapshots, WAL records, or both, written by one package recover in
    the other to the same version, item ids and bitset words."""
    d = str(tmp_path / "wal")
    blocks = [_rand(s, 37 + 11 * s, 4, 5) for s in range(3)]
    _write(writer, d, blocks, snapshot_every)
    got, got_info = _recover(reader, d, snapshot_every)
    want, want_info = _recover(writer, d, snapshot_every)
    assert got.version == want.version == 3
    assert _store_fingerprint(got) == _store_fingerprint(want)
    assert _store_layout(got) == _store_layout(want)
    assert got_info == want_info


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_torn_partial_frame_recovers_identically(tmp_path, writer):
    """A WAL ending in the ``partial`` torn frame gives both packages the
    same store: the last acknowledged version, the torn bytes dropped."""
    d = str(tmp_path / "wal")
    blocks = [_rand(s, 30, 4, 5) for s in range(3)]
    _write(writer, d, blocks, snapshot_every=2, torn=_rand(7, 30, 4, 5))
    copies = {}
    for package in ("reference", "port"):
        copies[package] = str(tmp_path / package)
        shutil.copytree(d, copies[package])
    ref_store, ref_info = _recover("reference", copies["reference"], 2)
    port_store, port_info = _recover("port", copies["port"], 2)
    assert ref_info == port_info and port_info["truncated_bytes"] > 0
    assert port_store.version == 3 and port_info["snapshot_version"] == 2
    assert _store_fingerprint(port_store) == _store_fingerprint(ref_store)
    assert _store_layout(port_store) == _store_layout(ref_store)


@pytest.mark.parametrize("engine", ENGINES)
def test_service_wal_dir_crosses_packages(tmp_path, engine):
    """A reference service's directory serves in the port, and the port's
    later appends recover in the reference: same store, same answers."""
    from repro.core import KyivConfig as RefConfig
    from repro.core import mine as ref_mine

    d = str(tmp_path / "wal")
    a, b = _rand(0, 90, 5, 4), _rand(1, 30, 5, 4)
    ref = RefMiningService(engine="numpy", wal_dir=d, snapshot_every=2)
    ref.append(a[:60])
    ref.append(a[60:])
    ref.append(b[:10])
    want_store = _store_fingerprint(ref.store)
    ref.close()

    port = _service(engine, wal_dir=d, snapshot_every=2)
    assert _store_fingerprint(port.store) == want_store
    assert port.last_crash is not None and port.last_crash.clean_shutdown
    port.append(b[10:])
    got = port.mine(tau=2, kmax=3)
    want = ref_mine(np.concatenate([a, b]), RefConfig(tau=2, kmax=3))
    assert got.result.canonical_set() == want.canonical_set()
    port_store = _store_fingerprint(port.store)
    port.close()

    ref2 = RefMiningService(engine="numpy", wal_dir=d, snapshot_every=2)
    assert _store_fingerprint(ref2.store) == port_store
    assert ref2.last_crash is not None and ref2.last_crash.clean_shutdown
    ref2.close()


_PORT_OVER_REFERENCE_JOB = r"""
import json, os, sys
from repro_torch.service import MiningService
svc = MiningService(engine="torch", device="cpu", wal_dir=sys.argv[1])
resumed = svc.stats()["durability"]["resumed_jobs"]
r = svc.mine(tau=2, kmax=4)
jobs = os.listdir(os.path.join(sys.argv[1], "jobs"))
svc.close()
print(json.dumps({
    "resumed_jobs": resumed, "source": r.source,
    "resumed_from_level": r.info.get("resumed_from_level"),
    "value_sets": sorted([sorted(map(list, ids)), c] for ids, c in r.result.as_value_sets()),
    "jobs": jobs,
    "repro_modules": sorted(m for m in sys.modules if m == "repro" or m.startswith("repro.")),
}))
"""


def test_reference_job_blob_is_dropped_never_unpickled(tmp_path):
    """A job directory holding the reference's pickled ``MiningState`` (it
    names ``repro.core.kyiv``) is dropped by the port, which mines cold; the
    port's process never imports ``repro``."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from repro.core import KyivConfig as RefConfig
    from repro.core import mine as ref_mine

    d = str(tmp_path / "wal")
    data = _rand(0, 150, 6, 4)
    inj = RefFaultInjector()
    ref = RefMiningService(engine="numpy", wal_dir=d, fault_injector=inj)
    ref.append(data)
    inj.arm("mine.level_end", action="raise", exc=RefKillPoint("mid-mine"), after=1)
    with pytest.raises(RefKillPoint):
        ref.mine(tau=2, kmax=4)
    ref.close()
    (job,) = os.listdir(os.path.join(d, "jobs"))
    steps = sorted(os.listdir(os.path.join(d, "jobs", job)))
    assert steps == ["ckpt_0000000002", "ckpt_0000000003"]

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", _PORT_OVER_REFERENCE_JOB, d],
                          capture_output=True, text=True, env=env, timeout=300, cwd=str(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["repro_modules"] == []
    # the job was found and re-issued, its blob refused, the mine ran cold
    assert out["resumed_jobs"] == 1 and out["resumed_from_level"] is None
    assert out["source"] == "cold" and out["jobs"] == []
    want = ref_mine(data, RefConfig(tau=2, kmax=4))
    assert out["value_sets"] == sorted(
        [sorted(map(list, ids)), c] for ids, c in want.as_value_sets())
