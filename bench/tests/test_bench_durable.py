"""The durable cell's traffic driver on the CPU: a run of the harness on a small
Poker-like table reads ``correct``, and each fault the durable service can
have under it turns ``correct`` false: checkpoints never written, a
checkpoint's bytes altered once written, a resume that runs cold, an
emitted support changed. Then the durability layer's readers, on span
trees built by hand."""

import importlib.util
import json
import os
from pathlib import Path
from types import SimpleNamespace as S

import numpy as np
import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"
CELL = "poker-hand-durable.cold-mine"
CHECKS = ("answers_wrong", "levels_wrong", "checkpoints_missing", "resume_wrong")
NEW = ("checkpoint_s", "ckpt_copy_s", "ckpt_encode_s", "ckpt_write_s", "ckpt_gb")


def _cell(harness, tmp_path, **service):
    spec = harness.load_spec(CELL)
    spec.cfg.update(rows=1500, wal_root=str(tmp_path / "durable"))
    spec.cfg["service"] = dict(spec.cfg["service"], **service)
    spec.mix["warmup_rounds"] = 0
    return spec


def _run(harness, spec, trace=False):
    line = harness.run(spec, 2**31 + 23, 0.2, trace, engine="torch", device="cpu")
    assert not os.path.exists(spec.cfg["wal_root"])  # the run leaves nothing behind
    return line


def _values(line):
    return {k: line["checks"][k]["value"] for k in CHECKS}


def test_the_cell_names_its_deployment(harness):
    spec = harness.load_spec(CELL)
    assert spec.cfg["service"] == {"job_checkpoint_levels": 1, "snapshot_every": 8, "flight_enabled": True}
    assert (spec.cfg["rows"], spec.cfg["columns"], spec.cfg["tau"], spec.cfg["kmax"]) == (1025010, 10, 1, 4)
    assert spec.cfg["wal_root"] == "build/durable" and spec.cfg["reduced"] == []
    assert [m["name"] for m in spec.per_layer] == list(NEW)
    assert {m["name"] for m in spec.end_to_end} == {"setup_s", "mine_s", "peak_gb"}
    # the full table's word axis (32,032 words) is a whole number of the store's tiles
    assert ((spec.cfg["rows"] + 31) // 32) % 8 == 0


def test_a_sound_run_is_correct(harness, tmp_path):
    spec = _cell(harness, tmp_path)
    spec.mix["warmup_rounds"] = 1
    line = _run(harness, spec, trace=True)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert _values(line) == dict.fromkeys(CHECKS, 0)
    got = {k: line["metrics"][k]["value"] for k in NEW}
    assert got["ckpt_copy_s"] + got["ckpt_encode_s"] + got["ckpt_write_s"] <= got["checkpoint_s"]
    assert got["ckpt_gb"] > 0


def test_checkpoints_never_written(harness, tmp_path):
    """``job_checkpoint_levels`` above kmax: no level boundary saves."""
    line = _run(harness, _cell(harness, tmp_path, job_checkpoint_levels=5))
    got = _values(line)
    assert not line["correct"] and got["checkpoints_missing"] >= 3 and got["resume_wrong"] >= 1
    assert got["answers_wrong"] == got["levels_wrong"] == 0


def test_a_checkpoint_altered_once_written(harness, tmp_path, monkeypatch):
    """Every checkpoint's first array gets one byte flipped after the save,
    in a well-formed ``.npz``: only the manifest's CRC32 can see it."""
    from repro_torch.distributed import checkpoint as ckpt

    save = ckpt.save_pytree

    def altered(path, tree, extra_meta=None):
        written = save(path, tree, extra_meta)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        first = sorted(arrays)[0]
        flat = arrays[first].reshape(-1).view(np.uint8)
        flat[len(flat) // 2] ^= 0x10
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
        return written

    monkeypatch.setattr(ckpt, "save_pytree", altered)
    line = _run(harness, _cell(harness, tmp_path))
    got = _values(line)
    assert not line["correct"] and got["checkpoints_missing"] >= 1 and got["resume_wrong"] >= 1
    assert got["answers_wrong"] == got["levels_wrong"] == 0


def test_a_resume_that_runs_cold(harness, tmp_path, monkeypatch):
    """The rebuilt service drops the job's checkpoint and mines cold: the
    answer is right, and the check still sees that nothing was resumed."""
    from repro_torch.service import MiningService

    monkeypatch.setattr(MiningService, "_restore_job", staticmethod(lambda mgr: None))
    line = _run(harness, _cell(harness, tmp_path))
    got = _values(line)
    assert not line["correct"] and got["resume_wrong"] >= 1
    assert got["answers_wrong"] == got["levels_wrong"] == got["checkpoints_missing"] == 0


def test_one_emitted_support_changed(harness, tmp_path, monkeypatch):
    import repro_torch.core.frontier as frontier

    emit = frontier._emit_rows

    def altered(results, ls, prep, expansion, lpos_mat, cnts):
        cnts = np.array(cnts, copy=True)
        cnts[:1] += 1
        emit(results, ls, prep, expansion, lpos_mat, cnts)

    monkeypatch.setattr(frontier, "_emit_rows", altered)
    line = _run(harness, _cell(harness, tmp_path))
    got = _values(line)
    assert not line["correct"] and got["answers_wrong"] >= 1 and got["resume_wrong"] >= 1
    assert got["levels_wrong"] == got["checkpoints_missing"] == 0


def test_the_plain_reader_against_the_programs_files(tmp_path):
    from bench.reference import checkpoint as plain
    from repro_torch.distributed.checkpoint import save_pytree

    path = str(tmp_path / "ck")
    save_pytree(path, {"state": np.frombuffer(b"durable", dtype=np.uint8), "w": np.arange(6).reshape(2, 3),
                       "next_k": 4})
    assert plain.faults(path) == []
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    manifest["arrays"]["w"]["shape"] = [3, 2]
    manifest["arrays"]["state"]["crc32"] ^= 1
    (tmp_path / "ck" / "manifest.json").write_text(json.dumps(manifest))
    assert [f.split(":")[0] for f in plain.faults(path)] == ["state", "w"]
    (tmp_path / "ck" / "arrays.npz").write_bytes(b"torn")
    assert plain.faults(path)[0].startswith("unreadable")


def _reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, duration, **attrs):
    return S(name=name, duration=duration, attrs=attrs)


def _mine(scale, gb):
    """One durable mine's spans: three level boundaries, level 3's the large
    one."""
    spans = [_span("request", 30.0 * scale), _span("mine", 25.0 * scale)]
    for k, share in ((2, 0.05), (3, 0.9), (4, 0.05)):
        spans += [_span("mine.checkpoint", 20.0 * share * scale, k=k),
                  _span("checkpoint.copy", 2.0 * share * scale, bytes=0),
                  _span("checkpoint.encode", 6.0 * share * scale, bytes=int(gb * share * 1e9)),
                  _span("checkpoint.write", 11.0 * share * scale, bytes=int(gb * share * 1e9), step=k)]
    return S(spans=spans)


def test_durability_readers_by_hand():
    run = S(requests=[{"trace": _mine(1.0, 9.0)}, {"trace": _mine(2.0, 9.0)}, {"trace": None}])
    got = {name: _reader(name).read(run) for name in NEW}
    assert got["checkpoint_s"] == pytest.approx((20.0 + 40.0) / 2)
    assert got["ckpt_copy_s"] == pytest.approx((2.0 + 4.0) / 2)
    assert got["ckpt_encode_s"] == pytest.approx((6.0 + 12.0) / 2)
    assert got["ckpt_write_s"] == pytest.approx((11.0 + 22.0) / 2)
    assert got["ckpt_gb"] == pytest.approx(9.0)


def test_durability_readers_read_nothing_where_the_program_records_nothing():
    """A program with only the ``mine.checkpoint`` span (before the
    checkpoint's inner spans) reads ``checkpoint_s`` alone; a run with no
    traced request reads nothing."""
    older = S(spans=[_span("request", 30.0), _span("mine.checkpoint", 18.0, k=3)])
    got = {name: _reader(name).read(S(requests=[{"trace": older}])) for name in NEW}
    assert got == dict(dict.fromkeys(NEW), checkpoint_s=18.0)
    assert {name: _reader(name).read(S(requests=[{"trace": None}])) for name in NEW} == dict.fromkeys(NEW)
