"""The durable service on a card: a mine killed at a level checkpoint
(``KillPoint`` at ``mine.level_end``, the flight ring frozen by ``halt()``)
resumes in a fresh service over the same ``wal_dir`` on the scheduler's
worker thread, through the CUDA kernels, and equals a cold ``cuda`` mine;
after the recovery an append is answered incrementally over the recovered
store's resident rows (rows 3-4). The checkpoint's CRC-32 kernels against
``zlib``, and a CUDA tensor leaf streamed to disk through the pinned
staging, its files equal to those of the same tree saved from the host.
Marked ``gpu``; every test skips where torch sees no CUDA card (run them
there with ``python -m pytest -m gpu tests/test_torch_gpu_durability.py``)."""

import json
import os
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import KyivConfig, mine
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.kernels import crc32 as crc
from repro_torch.kernels import intersect
from repro_torch.obs.trace import TRACER
from repro_torch.service import FaultInjector, KillPoint, MiningService

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench.reference import checkpoint as plain  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rand(seed, n, m, dom):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


def _value_sets(result):
    return {(frozenset(ids), int(c)) for ids, c in result.as_value_sets()}


def _stat_tuples(result):
    return [(s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections,
             s.emitted, s.skipped_absent_uniform, s.stored) for s in result.stats]


@pytest.mark.parametrize("kill_after", [0, 1], ids=["after-level-2", "after-level-3"])
def test_killed_mine_resumes_on_the_card(cuda, tmp_path, kill_after):
    base, delta = _rand(0, 5000, 6, 7), _rand(1, 300, 6, 8)
    cfg = dict(tau=1, kmax=4)
    d = str(tmp_path / "wal")
    inj = FaultInjector()
    svc = MiningService(wal_dir=d, fault_injector=inj)  # the default: engine cuda
    assert svc.placement.device.type == "cuda"
    svc.append(base)
    inj.arm("mine.level_end", action="raise", exc=KillPoint("die"), after=kill_after)
    with pytest.raises(KillPoint):
        svc.mine(**cfg)
    svc.flight.halt()
    svc.close()
    # the level's bits stand apart from the pickled state, CRC'd on the card
    (job,) = os.listdir(os.path.join(d, "jobs"))
    tree, _ = CheckpointManager(os.path.join(d, "jobs", job), keep=2).restore()
    assert sorted(tree) == ["bits", "state"] and tree["bits"].dtype == np.uint32
    assert tree["bits"].shape[0] > 0 and crc.LAUNCHES["crc32_blocks"] > 0

    intersect.reset_launches()
    svc2 = MiningService(wal_dir=d)
    try:
        level = svc2.last_crash.last_checkpoint["level"]
        assert level == kill_after + 2 and not svc2.last_crash.clean_shutdown
        assert svc2.stats()["durability"]["resumed_jobs"] == 1
        r = svc2.mine(**cfg)  # coalesces onto the resumed run
        assert r.source == "cold" and r.info["resumed_from_level"] == level + 1
        cold = mine(base, KyivConfig(engine="cuda", device=str(cuda), **cfg))
        assert _value_sets(r.result) == _value_sets(cold)
        assert _stat_tuples(r.result) == _stat_tuples(cold)
        assert intersect.LAUNCHES["intersect_classify_count_indexed"] > 0
        if level + 1 < cfg["kmax"]:
            assert intersect.LAUNCHES["intersect_classify_write_indexed"] > 0
        assert os.listdir(os.path.join(d, "jobs")) == []
        # one upload of the recovered version, resident on the card
        assert list(svc2.store._device) == [1]
        assert svc2.store.device_bits().device.type == "cuda"

        # incremental after the recovery, over the resident rows
        before = dict(intersect.LAUNCHES)
        svc2.append(delta)
        inc = svc2.mine(**cfg)
        assert inc.source == "incremental"
        want = mine(np.concatenate([base, delta]), KyivConfig(engine="cuda", device=str(cuda), **cfg))
        assert _value_sets(inc.result) == _value_sets(want)
        assert (intersect.LAUNCHES["intersect_write_indexed"] > before["intersect_write_indexed"]
                or intersect.LAUNCHES["intersect_count_indexed"] > before["intersect_count_indexed"])
        stats = svc2.stats()
        assert stats["resilience"]["unavailable_mines"] == 0
        assert stats["resilience"]["device_retries"] == 0
    finally:
        svc2.close()


@pytest.mark.parametrize("length", [0, 1, 3, 4, 4095, (1 << 20) + 7, (1 << 28) + 12345,
                                    (1 << 28) + (1 << 18) + 3])
def test_crc32_kernel_equals_zlib(cuda, length):
    """Lengths across the kernel's cases: no whole 256 KiB tile, whole tiles
    and a partial one, a tile a block (1,024 blocks) and two a block."""
    data = np.random.default_rng(length % 1000).integers(0, 256, length, dtype=np.uint8)
    t = torch.from_numpy(data).to(cuda)
    assert crc.crc32(t) == zlib.crc32(data)
    # one byte in: the kernel reads bytes, not words
    if length > 1:
        assert crc.crc32(t[1:]) == zlib.crc32(data[1:])


@pytest.mark.parametrize("shape,cols,dtype", [((4099, 32040), 32032, torch.int32),
                                              ((300, 33), 29, torch.int32),
                                              ((1000, 131), 7, torch.uint8)])
def test_crc32_kernel_of_a_padded_matrix_skips_the_padding(cuda, shape, cols, dtype):
    full = torch.randint(-(2**31), 2**31 - 1, shape, dtype=torch.int64, device=cuda).to(dtype)
    view = full[:, :cols]
    before = crc.LAUNCHES["crc32_blocks"]
    assert crc.crc32(view) == zlib.crc32(np.ascontiguousarray(view.cpu().numpy()))
    assert crc.LAUNCHES["crc32_blocks"] == before + 1


def test_a_cuda_leaf_streams_and_saves_what_the_host_saves(cuda, tmp_path):
    TRACER.configure(max_traces=64, sample_every=1)
    TRACER.reset()
    full = torch.randint(0, 2**31 - 1, (4701, 8000), dtype=torch.int32, device=cuda)
    bits = full[:, :7993].view(torch.uint32)  # 150 MB, padded: pieces of whole rows
    flat = torch.randint(0, 255, ((1 << 27) + 5,), dtype=torch.uint8, device=cuda)
    blob = np.frombuffer(b"the state", dtype=np.uint8)
    tree = {"bits": bits, "flat": flat, "state": blob, "next_k": 4}
    cm = CheckpointManager(str(tmp_path / "card"))
    with TRACER.start("request"):
        cm.save(3, tree)
    trace = TRACER.last(1)[0]
    (write,) = trace.find("checkpoint.write")
    copies = trace.find("checkpoint.copy")
    streamed = bits.numel() * 4 + flat.numel()
    assert write.attrs["streamed"] == streamed and write.attrs["crc"] == "cuda"
    assert write.attrs["bytes"] == streamed + blob.nbytes
    assert sum(s.attrs["bytes"] for s in copies) == streamed and len(copies) >= 6
    assert all(s.parent_id == write.span_id for s in copies)

    host = {"bits": np.ascontiguousarray(bits.cpu().numpy()), "flat": flat.cpu().numpy(),
            "state": blob, "next_k": 4}
    save_pytree(str(tmp_path / "host"), host, {"step": 3})
    a, _ = load_pytree(cm._step_dir(3))
    b, _ = load_pytree(str(tmp_path / "host"))
    assert a["next_k"] == b["next_k"] == 4
    for k in ("bits", "flat", "state"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    m1 = json.loads((Path(cm._step_dir(3)) / "manifest.json").read_text())
    m2 = json.loads((tmp_path / "host" / "manifest.json").read_text())
    m1.pop("time"), m2.pop("time")
    assert m1 == m2
    assert plain.faults(cm._step_dir(3)) == []


def test_a_cuda_leaf_streams_in_pieces_of_the_staging(cuda, tmp_path, monkeypatch):
    """Staging of 1,000 bytes (made anew for this test): a padded matrix
    streams in pieces of whole rows, a flat tensor in pieces of one row;
    one ``checkpoint.copy`` a piece, inside the write."""
    monkeypatch.setattr(ckpt, "STAGE_BYTES", 1000)
    monkeypatch.setattr(ckpt, "_STAGING", {})
    TRACER.configure(max_traces=64, sample_every=1)
    TRACER.reset()
    full = torch.randint(0, 2**31 - 1, (90, 40), dtype=torch.int32, device=cuda)
    bits = full[:, :33].view(torch.uint32)  # 132 B a row, 7 rows a piece
    flat = torch.arange(2500, device=cuda).to(torch.uint8)  # one row: 1000-byte pieces
    cm = CheckpointManager(str(tmp_path / "t"))
    with TRACER.start("request"):
        cm.save(3, {"bits": bits, "flat": flat, "k": 3})
    trace = TRACER.last(1)[0]
    (write,) = trace.find("checkpoint.write")
    copies = trace.find("checkpoint.copy")
    assert all(s.parent_id == write.span_id for s in copies)
    assert [s.attrs["bytes"] for s in copies] == [924] * 12 + [132 * 6] + [1000, 1000, 500]
    assert write.attrs["streamed"] == write.attrs["bytes"] == bits.numel() * 4 + 2500
    assert write.attrs["crc"] == "cuda"
    got, _ = load_pytree(cm._step_dir(3))
    assert np.array_equal(got["bits"], bits.cpu().numpy()) and got["bits"].dtype == np.uint32
    assert np.array_equal(got["flat"], flat.cpu().numpy())
    assert plain.faults(cm._step_dir(3)) == []
