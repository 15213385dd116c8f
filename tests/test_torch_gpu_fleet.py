"""The lockstep fleet on a card: two ``serve_miner`` processes share
``cuda:0`` (each its own CUDA context and word stripes) and answer cold,
incremental and ``/risk`` requests as the numpy service does; the unfused
kernels count each process's partial popcounts. Marked ``gpu``; skips
where torch sees no CUDA card (run it there with
``python -m pytest -m gpu tests/test_torch_gpu_fleet.py``)."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.service import MiningService

pytestmark = pytest.mark.gpu

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=300).read())


def _sets(resp):
    return sorted((tuple(sorted(map(tuple, s["items"]))), s["count"]) for s in resp["itemsets"])


def test_two_processes_share_the_card(cuda, tmp_path):
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 9, size=(50_000, 8))
    csv = tmp_path / "t.csv"
    np.savetxt(csv, rows, fmt="%d", delimiter=",", header=",".join(f"c{i}" for i in range(8)),
               comments="")
    http_port, coord = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_miner", "--device", "cuda:0",
           "--num-processes", "2", "--coordinator-address", f"127.0.0.1:{coord}"]
    p0 = subprocess.Popen(cmd + ["--process-id", "0", "--port", str(http_port), "--preload",
                                 str(csv)], env=env, stderr=subprocess.DEVNULL)
    p1 = subprocess.Popen(cmd + ["--process-id", "1"], env=env, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 180
        while True:
            try:
                _http(http_port, "/healthz")
                break
            except Exception:
                assert time.time() < deadline and p0.poll() is None
                time.sleep(0.25)
        plain = MiningService(engine="numpy")
        from repro_torch.data.loaders import read_csv

        table = read_csv(str(csv))[0]
        plain.append(table)
        cold = _http(http_port, "/mine?tau=1&kmax=3")
        assert cold["source"] == "cold"
        assert _sets(cold) == _sets(plain.mine(tau=1, kmax=3).to_json())
        # rows of the table's own codes (the CSV's codebook)
        part = table[rng.integers(0, len(table), size=200)]
        _http(http_port, "/append", {"rows": part.tolist()})
        plain.append(part)
        inc = _http(http_port, "/mine?tau=1&kmax=3")
        assert inc["source"] == "incremental"
        assert _sets(inc) == _sets(plain.mine(tau=1, kmax=3).to_json())
        risk = _http(http_port, "/risk?tau=1&kmax=3")
        want = plain.risk(tau=1, kmax=3)
        for k in ("records_at_risk", "max_risk", "qi_total", "top_records"):
            assert risk[k] == want[k]
        st = _http(http_port, "/stats")
        assert st["resilience"]["fleet"]["degraded"] is False
        launches = st["launches"]["intersect"]
        assert launches["intersect_write_indexed"] and launches["intersect_count_indexed"]
        assert not launches["intersect_classify_write_indexed"]
        assert st["resilience"]["fleet"]["device_peak_bytes"] > 0
        plain.close()
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in (p0, p1):
            try:
                p.wait(60)
            except subprocess.TimeoutExpired:
                p.kill()
