"""The durable path's checkpoint spans: inside each ``mine.checkpoint`` span
a durable cold mine opens ``checkpoint.encode`` (the service's pickle of the
state without its bits) and ``checkpoint.write`` (``CheckpointManager.save``
through the rename and the prune), once per level boundary. Their ``bytes``
are what was written, and the write's ``streamed`` and ``crc`` say which
path the bits took: on the CPU they are saved as a host array, so nothing
streams, and inside the write one ``checkpoint.copy`` makes the level's
words contiguous (on a card, one a piece of the bits as they stream:
``tests/test_torch_gpu_durability.py``). A level hook
that saves with ``CheckpointManager`` and does not declare ``device_bits``
gets ``copy`` (its host bits) and ``write`` with no code of its own."""

import os

import numpy as np
import pytest

from repro_torch.core import KyivConfig
from repro_torch.core.kyiv import mine_preprocessed, prepare
from repro_torch.distributed.checkpoint import CheckpointManager, load_pytree
from repro_torch.obs.trace import TRACER
from repro_torch.service import MiningService
from repro_torch.service.faults import FaultInjector, KillPoint
from repro_torch.service.wal import restricted_loads

CKPT_SPANS = ("checkpoint.copy", "checkpoint.encode", "checkpoint.write")


@pytest.fixture()
def tracer_reset():
    yield TRACER
    TRACER.configure(max_traces=64, sample_every=1)
    TRACER.reset()


def _table(seed=3, n=300, m=6, dom=4):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


def _inner(trace, ckpt):
    """The checkpoint spans directly inside one ``mine.checkpoint`` span,
    by name."""
    out: dict = {}
    for s in trace.children_of(ckpt):
        out.setdefault(s.name, []).append(s)
    return out


def test_durable_cold_mine_opens_copy_encode_write_per_level_boundary(tmp_path, tracer_reset):
    inj = FaultInjector()
    svc = MiningService.from_dataset(_table(), wal_dir=str(tmp_path / "wal"), engine="torch",
                                     device="cpu", fault_injector=inj)
    try:
        r = svc.mine(tau=1, kmax=4)
        trace = TRACER.last(1)[0]
        ckpts = trace.find("mine.checkpoint")
        # one boundary per level the loop ran (k = 2 .. kmax), each saved
        assert [s.attrs["k"] for s in ckpts] == [s.k for s in r.result.stats[1:]] == [2, 3, 4]
        bits = []
        for c in ckpts:
            inner = _inner(trace, c)
            assert {n: len(v) for n, v in inner.items()} == {"checkpoint.encode": 1,
                                                             "checkpoint.write": 1}
            write = inner["checkpoint.write"][0]
            copies = _inner(trace, write).get("checkpoint.copy", [])
            assert set(_inner(trace, write)) <= {"checkpoint.copy"} and len(copies) <= 1
            assert write.attrs["streamed"] == 0 and write.attrs["crc"] == "host"  # host words
            bits.append(write.attrs["bytes"] - inner["checkpoint.encode"][0].attrs["bytes"])
            assert sum(s.attrs["bytes"] for s in copies) == bits[-1]
        # the blob and the level's words; level 4 (kmax) stores no rows
        assert [b > 0 and b % 4 == 0 for b in bits] == [True, True, False]
        assert not any(s.parent_id is None or s.name not in CKPT_SPANS for s in trace.spans
                       if s.name.startswith("checkpoint."))

        # killed after level 3's checkpoint, what the spans saw is on disk
        svc.cache.clear()
        inj.arm("mine.level_end", action="raise", exc=KillPoint("die"), after=1)
        with pytest.raises(KillPoint):
            svc.mine(tau=1, kmax=4)
        trace = TRACER.last(1)[0]
        (job,) = os.listdir(os.path.join(svc.wal_dir, "jobs"))
        mgr = CheckpointManager(os.path.join(svc.wal_dir, "jobs", job), keep=2)
        assert mgr.steps() == [2, 3]
        for c in trace.find("mine.checkpoint"):
            inner = _inner(trace, c)
            write = inner["checkpoint.write"][0]
            tree, meta = load_pytree(os.path.join(mgr.directory, f"ckpt_{c.attrs['k']:010d}"))
            blob, bits = tree["state"], tree["bits"]
            assert meta["step"] == c.attrs["k"] == write.attrs["step"]
            assert write.attrs["bytes"] == blob.nbytes + bits.nbytes
            assert inner["checkpoint.encode"][0].attrs["bytes"] == blob.nbytes
            state = restricted_loads(blob.tobytes())
            assert state.next_k == c.attrs["k"] + 1 and state.level.bits is None
            assert bits.dtype == np.uint32 and bits.shape[0] == state.level.t > 0
            (copy,) = _inner(trace, write)["checkpoint.copy"]
            assert copy.attrs["bytes"] == bits.nbytes and write.attrs["streamed"] == 0
    finally:
        svc.close()


def test_a_level_hook_that_saves_gets_copy_and_write(tmp_path, tracer_reset):
    """A hook like the CLI's ``--ckpt-dir`` one but with no ``device_bits``:
    the level's host arrays saved as they are, no pickle, so no
    ``checkpoint.encode``."""
    cfg = KyivConfig(tau=1, kmax=3, engine="torch", device="cpu")
    cm = CheckpointManager(str(tmp_path / "ck"))

    def hook(k, state):
        lvl = state["level"]
        cm.save(k, {"itemsets": lvl.itemsets, "counts": lvl.counts, "bits": lvl.bits,
                    "next_k": state["next_k"]})

    with TRACER.start("request"):
        mine_preprocessed(prepare(_table(4), cfg), cfg, on_level_end=hook)
    trace = TRACER.last(1)[0]
    ckpts = trace.find("mine.checkpoint")
    assert [c.attrs["k"] for c in ckpts] == cm.steps() == [2, 3]
    for c in ckpts:
        inner = _inner(trace, c)
        assert {n: len(v) for n, v in inner.items()} == {"checkpoint.copy": 1, "checkpoint.write": 1}
        tree, _ = load_pytree(os.path.join(cm.directory, f"ckpt_{c.attrs['k']:010d}"))
        arrays = (tree["itemsets"], tree["counts"], tree["bits"])
        assert inner["checkpoint.write"][0].attrs["bytes"] == sum(a.nbytes for a in arrays)
        # the level at kmax stores no rows: nothing to copy
        assert inner["checkpoint.copy"][0].attrs["bytes"] == tree["bits"].nbytes
        assert (tree["bits"].nbytes > 0) == (c.attrs["k"] < 3)


def test_no_trace_no_spans_and_the_same_files(tmp_path, tracer_reset):
    """Without an active trace no span is kept and the save writes what it
    always wrote; ``save_pytree`` returns the arrays' bytes (and that none
    streamed)."""
    from repro_torch.distributed.checkpoint import save_pytree

    cm = CheckpointManager(str(tmp_path / "ck"), keep=1)
    cm.save(1, {"w": np.arange(6, dtype=np.int32)})
    saved = save_pytree(str(tmp_path / "one"), {"a": np.ones(3), "b": [np.zeros(2, np.uint8), 7]})
    assert (saved.nbytes, saved.streamed, saved.crc) == (26, 0, "host")
    tree, meta = load_pytree(cm._step_dir(1))
    assert meta["step"] == 1 and tree["w"].tolist() == list(range(6))
    assert TRACER.last(1) == []
