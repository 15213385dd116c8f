"""The checkpoint's save on the CPU: the hand-written ``.npz``
(``repro_torch.distributed.npz``), read by ``np.load``, ``zipfile``, both
packages' ``load_pytree`` and the benchmark's plain reader; the CRC-32
helpers against ``zlib``; the byte view the CRC kernels read; a CPU tensor
leaf saved as its array; which level hook gets the level's words where
they lie; and job checkpoints in the layout with the bits apart, and in the
one before it, resumed by a rebuilt service. The streamed save of a CUDA
tensor leaf is tested on the card (``tests/test_torch_gpu_durability.py``)."""

import io
import json
import os
import pickle
import struct
import sys
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import KyivConfig as RefConfig
from repro.core import mine as ref_mine
from repro.distributed import checkpoint as rckpt
from repro_torch.core import KyivConfig
from repro_torch.core.kyiv import mine_preprocessed, prepare
from repro_torch.distributed.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.distributed.npz import crc32_combine, npy_header
from repro_torch.kernels.crc32 import rows_view
from repro_torch.obs.trace import TRACER
from repro_torch.service import FaultInjector, KillPoint, MiningService

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from bench.reference import checkpoint as plain  # noqa: E402

TREE = {
    "w": np.arange(12, dtype=np.float32).reshape(3, 4),
    "zero_d": np.array(7, dtype=np.int64),
    "empty": np.zeros((0, 5), dtype=np.uint32),
    "bytes": np.frombuffer(b"durable", dtype=np.uint8),
    "fortran": np.asfortranarray(np.arange(6, dtype=np.int16).reshape(2, 3)),
    "step": 4,
    "name": "x",
    "nested": {"lst": [np.int64(2), (1.5, "a")], "none": None},
}
ZERO_D = {"zero_d", "nested.lst.0"}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k])
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k] or (k == "lst" and a[k][1] == b[k][1]), k


def _ref_tree():
    return {"w": TREE["w"], "zero_d": TREE["zero_d"], "empty": TREE["empty"],
            "bytes": TREE["bytes"], "fortran": np.ascontiguousarray(TREE["fortran"]),
            "step": 4, "name": "x", "nested": {"lst": [np.array(2), (1.5, "a")], "none": None}}


# -- the container ------------------------------------------------------------


def test_host_tree_round_trips_through_every_reader(tmp_path):
    p = str(tmp_path / "ck")
    assert save_pytree(p, TREE, {"tau": 1}) == (48 + 8 + 0 + 7 + 12 + 8, 0, "host")
    npz = os.path.join(p, "arrays.npz")
    with np.load(npz) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == ["bytes", "empty", "fortran", "nested.lst.0", "w", "zero_d"]
    assert got["zero_d"].shape == () and got["empty"].shape == (0, 5)
    assert np.array_equal(got["fortran"], TREE["fortran"])
    with zipfile.ZipFile(npz) as z:
        assert z.testzip() is None
    for load in (load_pytree, rckpt.load_pytree):
        tree, meta = load(p)
        assert meta == {"tau": 1}
        _equal(tree, _ref_tree())
    # the plain reader widens a 0-d array to shape [1] (np.ascontiguousarray),
    # whichever package wrote it; every other array matches its manifest
    faults = plain.faults(p)
    assert {f.split(":")[0] for f in faults} == ZERO_D
    assert all("[1], manifest int64[]" in f for f in faults)
    no_0d = str(tmp_path / "no0d")
    save_pytree(no_0d, {k: v for k, v in TREE.items() if k not in ("zero_d", "nested")})
    assert plain.faults(no_0d) == []


def test_manifest_equals_the_reference_writers(tmp_path):
    save_pytree(str(tmp_path / "a"), TREE, {"m": 2})
    rckpt.save_pytree(str(tmp_path / "b"), _ref_tree(), {"m": 2})
    m1, m2 = (json.loads((tmp_path / d / "manifest.json").read_text()) for d in "ab")
    m1.pop("time"), m2.pop("time")
    assert m1 == m2


def _local_headers(data: bytes):
    """Each member's ``ZipInfo`` with its local header's two 32-bit size
    fields and its extra field, found at the central directory's offsets."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        infos = z.infolist()
    out = []
    for info in infos:
        o = info.header_offset
        sig, _, _, _, _, _, _, csize, usize, nlen, elen = struct.unpack("<IHHHHHIIIHH", data[o : o + 30])
        assert sig == 0x04034B50
        out.append((info, csize, usize, data[o + 30 + nlen : o + 30 + nlen + elen]))
    return out


def test_every_member_carries_zip64_fields(tmp_path):
    p = str(tmp_path / "ck")
    save_pytree(p, {"a": np.arange(3, dtype=np.uint8), "b": np.ones((2, 2))})
    data = (Path(p) / "arrays.npz").read_bytes()
    for info, csize, usize, extra in _local_headers(data):
        assert csize == usize == 0xFFFFFFFF
        tag, size, u64, c64 = struct.unpack("<HHQQ", extra)
        assert (tag, size) == (0x0001, 16) and u64 == c64 == info.file_size == info.compress_size
        assert info.compress_type == zipfile.ZIP_STORED and info.extract_version == 45
        central = struct.unpack("<HH", info.extra[:4])
        assert central == (0x0001, 24)
        assert struct.unpack("<QQQ", info.extra[4:28])[2] == info.header_offset
    # the ZIP64 end record and its locator before the end record
    assert data[-22:-18] == struct.pack("<I", 0x06054B50)
    assert data[-42:-38] == struct.pack("<I", 0x07064B50)
    assert data[-98:-94] == struct.pack("<I", 0x06064B50)


def test_a_flipped_data_byte_fails_both_crcs(tmp_path):
    p = str(tmp_path / "ck")
    w = np.arange(1000, dtype=np.uint32)
    save_pytree(p, {"w": w})
    npz = Path(p) / "arrays.npz"
    data = bytearray(npz.read_bytes())
    (info, *_), = _local_headers(bytes(data))
    start = info.header_offset + 30 + len(info.filename) + 20 + 128  # the .npy header is 128 B
    assert bytes(data[start : start + 8]) == w[:2].tobytes()
    data[start + 2000] ^= 0x01
    npz.write_bytes(bytes(data))
    # the member's zip CRC
    with np.load(npz) as z, pytest.raises(zipfile.BadZipFile, match="CRC"):
        z["w"]
    with pytest.raises(Exception):
        load_pytree(p)
    # the manifest's CRC, on the data read past the zip's check
    got = np.frombuffer(bytes(data[start : start + w.nbytes]), dtype=np.uint32)
    manifest = json.loads((Path(p) / "manifest.json").read_text())
    assert zlib.crc32(got) != manifest["arrays"]["w"]["crc32"] == zlib.crc32(w)
    assert plain.faults(p)[0].startswith("unreadable") or plain.faults(p)[0].startswith("w:")


@pytest.mark.parametrize("seed", range(4))
def test_crc32_combine_equals_zlib_of_the_concatenation(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(0, 5000)), dtype=np.uint8).tobytes()
    for _ in range(20):
        cut = int(rng.integers(0, len(data) + 1))
        a, b = data[:cut], data[cut:]
        assert crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == zlib.crc32(data)


@pytest.mark.parametrize("length", [0, 1, 3, 4, 4095, (1 << 20) + 7])
def test_member_crc_joins_the_header_and_the_data(tmp_path, length):
    """A member's zip CRC, joined from its ``.npy`` header's and its data's
    by ``crc32_combine``, is zlib's of the two back to back."""
    data = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8)
    p = str(tmp_path / "ck")
    save_pytree(p, {"a": data})
    with zipfile.ZipFile(os.path.join(p, "arrays.npz")) as z:
        (info,) = z.infolist()
        assert z.testzip() is None
    assert info.CRC == zlib.crc32(npy_header(data.dtype, data.shape) + data.tobytes())
    manifest = json.loads((Path(p) / "manifest.json").read_text())
    assert manifest["arrays"]["a"]["crc32"] == zlib.crc32(data)


# -- the bytes the CRC kernels read ---------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8])
def test_rows_view_reads_a_padded_matrix_at_its_pitch(dtype):
    full = torch.from_numpy(np.random.default_rng(1).integers(0, 100, (37, 33))).to(dtype)
    view = full[:, :29]
    u8 = rows_view(view)
    size = full.element_size()
    assert u8.shape == (37, 29 * size) and u8.stride() == (33 * size, 1)
    assert u8.data_ptr() == full.data_ptr()  # in place: nothing copied
    want = np.ascontiguousarray(view.numpy()).tobytes()
    assert b"".join(bytes(r.numpy()) for r in u8) == want
    # a contiguous tensor of any shape is one row of its bytes
    assert rows_view(full).shape == (1, full.numel() * size)
    assert bytes(rows_view(full.reshape(-1, 3, 11)).numpy()) == full.numpy().tobytes()


# -- tensor leaves ------------------------------------------------------------------


@pytest.fixture()
def traced():
    yield TRACER
    TRACER.configure(max_traces=64, sample_every=1)
    TRACER.reset()


def test_a_cpu_tensor_leaf_saves_as_its_array(tmp_path, traced):
    full = torch.from_numpy(np.random.default_rng(2).integers(0, 2**31, (90, 40))).to(torch.int32)
    bits = full[:, :33].view(torch.uint32)
    flat = torch.arange(2500, dtype=torch.uint8)
    tree = {"bits": bits, "flat": flat, "blob": np.frombuffer(b"abc", dtype=np.uint8), "k": 3}
    cm = CheckpointManager(str(tmp_path / "t"))
    with TRACER.start("request"):
        cm.save(3, tree)
    trace = TRACER.last(1)[0]
    (write,) = trace.find("checkpoint.write")
    copies = trace.find("checkpoint.copy")  # one a tensor: its bytes made contiguous
    assert [s.attrs["bytes"] for s in copies] == [bits.numel() * 4, 2500]
    assert all(s.parent_id == write.span_id for s in copies)
    assert write.attrs["streamed"] == 0 and write.attrs["crc"] == "host"
    assert write.attrs["bytes"] == bits.numel() * 4 + 2500 + 3
    host = {"bits": np.ascontiguousarray(bits.numpy()), "flat": flat.numpy(), "blob": tree["blob"],
            "k": 3}
    save_pytree(str(tmp_path / "h"), host)
    a, _ = load_pytree(cm._step_dir(3))
    b, _ = load_pytree(str(tmp_path / "h"))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in ("bits", "flat", "blob"))
    assert a["bits"].dtype == np.uint32
    m1 = json.loads((Path(cm._step_dir(3)) / "manifest.json").read_text())
    m2 = json.loads((tmp_path / "h" / "manifest.json").read_text())
    m1.pop("time"), m2.pop("time"), m1["meta"].pop("step")
    assert m1 == m2
    assert plain.faults(cm._step_dir(3)) == []


def test_host_leaves_stream_nothing(tmp_path, traced):
    cm = CheckpointManager(str(tmp_path / "t"))
    with TRACER.start("request"):
        cm.save(1, {"x": np.ones(5)})
    (write,) = TRACER.last(1)[0].find("checkpoint.write")
    assert write.attrs["streamed"] == 0 and write.attrs["crc"] == "host"
    assert TRACER.last(1)[0].find("checkpoint.copy") == []


# -- who gets the level's words ---------------------------------------------------


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_only_a_declaring_hook_gets_the_words_where_they_lie(engine):
    data = np.random.default_rng(3).integers(0, 4, size=(300, 6))
    cfg = KyivConfig(tau=1, kmax=3, engine=engine, device="cpu")
    prep = prepare(data, cfg)
    seen = {"plain": [], "device": []}

    def plain_hook(k, state):
        seen["plain"].append(state.level.bits)

    def device_hook(k, state):
        seen["device"].append(np.array(state.level.bits))  # a copy: the words are the level's

    device_hook.device_bits = True
    mine_preprocessed(prep, cfg, on_level_end=plain_hook)
    mine_preprocessed(prep, cfg, on_level_end=device_hook)
    for host, dev in zip(seen["plain"], seen["device"]):
        assert isinstance(host, np.ndarray) and host.dtype == np.uint32
        assert host.flags.c_contiguous and host.shape[1] == prep.l_bits.shape[1]
        assert np.array_equal(host, dev)
    assert len(seen["plain"]) == 2


def test_a_declaring_hook_on_a_device_gets_a_view_of_its_words():
    data = np.random.default_rng(4).integers(0, 4, size=(200, 5))
    cfg = KyivConfig(tau=1, kmax=3, engine="torch", device="cpu")
    got = []

    def hook(k, state):
        got.append(state.level.bits)

    hook.device_bits = True
    mine_preprocessed(prepare(data, cfg), cfg, on_level_end=hook)
    assert isinstance(got[0], torch.Tensor) and got[0].dtype == torch.uint32


# -- job checkpoints resumed ------------------------------------------------------


def _tup(s):
    return (s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections, s.emitted,
            s.skipped_absent_uniform, s.stored)


def _kill(d, data, kill_after, cfg):
    inj = FaultInjector()
    svc = MiningService(engine="torch", device="cpu", wal_dir=d, fault_injector=inj)
    svc.append(data)
    inj.arm("mine.level_end", action="raise", exc=KillPoint("die"), after=kill_after)
    with pytest.raises(KillPoint):
        svc.mine(**cfg)
    svc.flight.halt()
    svc.close()
    (job,) = os.listdir(os.path.join(d, "jobs"))
    return CheckpointManager(os.path.join(d, "jobs", job), keep=2)


def _resume_and_check(d, data, cfg, level):
    ref = ref_mine(data, RefConfig(**cfg))
    svc = MiningService(engine="torch", device="cpu", wal_dir=d)
    try:
        assert svc.stats()["durability"]["resumed_jobs"] == 1
        r = svc.mine(**cfg)
        assert r.info["resumed_from_level"] == level + 1
        assert r.result.canonical_set() == ref.canonical_set()
        assert list(map(_tup, r.result.stats)) == list(map(_tup, ref.stats))
    finally:
        svc.close()


@pytest.mark.parametrize("kill_after", [0, 1], ids=["from-level-3", "from-level-4"])
def test_the_bits_apart_resume(tmp_path, kill_after):
    data = np.random.default_rng(10).integers(0, 4, size=(160, 6))
    cfg = dict(tau=2, kmax=5)
    d = str(tmp_path / "wal")
    mgr = _kill(d, data, kill_after, cfg)
    tree, _ = mgr.restore()
    assert sorted(tree) == ["bits", "state"] and tree["bits"].dtype == np.uint32
    assert pickle.loads(tree["state"].tobytes()).level.bits is None
    _resume_and_check(d, data, cfg, kill_after + 2)


def test_a_single_blob_job_checkpoint_still_resumes(tmp_path):
    """A ``wal_dir`` written before the bits were saved apart: the job's
    newest checkpoint is one pickled state, bits inside."""
    from repro_torch.service.api import job_state

    data = np.random.default_rng(11).integers(0, 4, size=(160, 6))
    cfg = dict(tau=2, kmax=5)
    d = str(tmp_path / "wal")
    mgr = _kill(d, data, 1, cfg)
    step = mgr.latest_step()
    state = job_state(mgr.restore()[0])
    assert isinstance(state.level.bits, np.ndarray) and state.level.bits.size
    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    save_pytree(mgr._step_dir(step), {"state": np.frombuffer(blob, dtype=np.uint8)}, {"step": step})
    assert sorted(mgr.restore()[0]) == ["state"]
    _resume_and_check(d, data, cfg, 3)
