"""BENCHMARK.json against the benchmark's contract, and the harness's lookup
of every file by name."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_keys_names_units_and_text():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic")) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in (metrics, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_reports_what_the_contract_asks(harness):
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e_names
    for w in BENCH["workloads"]:
        spec = harness.load_spec(w["name"])
        reported = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and spec.per_layer
        for m in spec.per_layer:
            assert m["moves"] in reported


def test_each_cell_resolves_its_files_by_name(harness):
    for w in BENCH["workloads"]:
        spec = harness.load_spec(w["name"])
        assert spec.cfg["name"] == w["config"]
        assert (ROOT / "bench" / "traffic" / f"{spec.mix['driver']}.py").is_file()
        for m in spec.end_to_end + spec.per_layer:
            reader = harness.load_module(ROOT / "bench" / "metrics" / f"{m['name']}.py")
            assert callable(reader.read)


def _copy(tmp_path, with_src=True):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    if with_src:
        (tmp_path / "src").symlink_to(ROOT / "src")
    return tmp_path


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    """A configuration with a table generator of its own, a traffic mix and
    a per-layer metric added as new files and entries, no file of the
    benchmark edited."""
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*") if p.is_file()}
    (root / "bench" / "data" / "tiny_survey.py").write_text(
        "import numpy as np\n\n\n"
        "def make(n, m, seed):\n"
        "    rng = np.random.default_rng(seed)\n"
        "    return rng.integers(0, [2, 3, 5, 7, 11, 13][:m], size=(n, m))\n")
    cfg = json.loads((root / "bench" / "configs" / "poker-hand.json").read_text())
    cfg.update(name="survey-tiny", generator="tiny_survey", rows=1500, columns=6, kmax=3)
    (root / "bench" / "configs" / "survey-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "bench" / "traffic" / "cold_mine.json").read_text())
    mix.update(tables=3, warmup_rounds=0)
    (root / "bench" / "traffic" / "cold_mine_3.json").write_text(json.dumps(mix))
    (root / "bench" / "metrics" / "tables_seen.py").write_text(
        "def read(run):\n    return len({r['table'] for r in run.requests})\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "survey-tiny", "source": "https://example.org/survey",
                             "file": "bench/configs/survey-tiny.json", "reduced": ["rows"], "why": "test"})
    bench["workloads"].append({"name": "survey-tiny.three", "config": "survey-tiny", "traffic": "cold_mine_3",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "tables_seen", "unit": "tables", "better": "higher",
                               "source": "program_counter", "layer": "entry", "moves": "mine_s",
                               "workloads": ["survey-tiny.three"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_run_copy", root / "bench" / "run.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    cell = copy.load_spec("survey-tiny.three")
    assert [m["name"] for m in cell.per_layer] == ["tables_seen"]
    driver = copy.load_module(root / "bench" / "traffic" / "cold_mine.py")
    assert [t.shape for t in driver.tables(cell.cfg, cell.mix, 5)] == [(1500, 6)] * 3
    line = copy.run(cell, 5, 1.0, True, engine="torch", device="cpu")
    assert line["correct"] and line["metrics"]["tables_seen"]["value"] == min(3, line["attempted"])
    line = copy.run(cell, 5, 0.1, False, engine="torch", device="cpu")
    assert set(line["metrics"]) == {"setup_s", "mine_s"}  # peak_gb: no card, no reading
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_forbidden_modules_compare_whole_top_level_names(harness):
    names = ["repro_torch", "repro_torch.core.kyiv", "reprox", "jax_like", "jax.numpy", "jaxlib",
             "flax.linen", "repro", "repro.core"]
    assert harness.forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_the_harness_loads_no_jax(harness):
    """The harness's modules, the reference and the program's entry load none
    of the forbidden top-level names (run in a fresh process)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import importlib.util\n"
        "s = importlib.util.spec_from_file_location('h', %r); h = importlib.util.module_from_spec(s)\n"
        "s.loader.exec_module(h)\n"
        "import bench.trace, bench.reference.kyiv, bench.data.poker_like, bench.data.connect4_uci\n"
        "import repro_torch.core.kyiv\n"
        "spec = h.load_spec('poker-hand.cold-mine')\n"
        "h.load_module(h.BENCH / 'traffic' / 'cold_mine.py')\n"
        "[h.load_module(h.BENCH / 'metrics' / (m['name'] + '.py')) for m in spec.end_to_end + spec.per_layer]\n"
        "print(h.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "src"), str(ROOT / "bench" / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_means_no_measurement(harness, capsys):
    """A measurement path with no card fails: no fallback to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "connect-4.cold-mine", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


@pytest.mark.parametrize("with_src", [True, False])
def test_the_command_exits_nonzero_without_a_card_or_without_the_program(tmp_path, with_src):
    import torch

    if torch.cuda.is_available() and with_src:
        pytest.skip("a card is present")
    root = _copy(tmp_path, with_src=with_src)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "connect-4.cold-mine", "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
