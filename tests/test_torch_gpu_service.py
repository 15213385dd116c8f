"""The resident service on a card: cold, cached, incremental and
approximate-then-refined mines through the CUDA kernels equal the numpy
service's answers; ``/risk`` runs the coverage kernels; the profile trace
names the intersect kernels (``intersect_indexed_kernel<...>``); no request is refused or retried. Marked ``gpu``; every test
skips where torch sees no CUDA card (run them there with
``python -m pytest -m gpu tests/test_torch_gpu_service.py``)."""

import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import coverage, intersect
from repro_torch.sampling import SamplingConfig
from repro_torch.service import MiningService

pytestmark = pytest.mark.gpu

SMALL = SamplingConfig(oversample=0.5, min_rows=32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rand(seed, n, m, dom):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


def _value_sets(result):
    return {(frozenset(ids), int(c)) for ids, c in result.as_value_sets()}


def _replay(svc, delta):
    out = [svc.mine(tau=1, kmax=3), svc.mine(tau=1, kmax=3)]
    svc.append(delta)
    out.append(svc.mine(tau=1, kmax=3))
    risk = {k: v for k, v in svc.risk(tau=1, kmax=3).items() if k not in ("latency_s", "source")}
    approx = svc.mine(tau=2, kmax=3, mode="approx", epsilon=0.3)
    svc.scheduler.drain(timeout=300)
    refined = svc.mine(tau=2, kmax=3, mode="approx", epsilon=0.3)
    return out, risk, approx, refined


def test_service_on_the_card_matches_numpy(cuda):
    base, delta = _rand(0, 5000, 6, 7), _rand(1, 300, 6, 8)
    card = MiningService.from_dataset(base, sampling=SMALL)  # the default: engine cuda
    host = MiningService.from_dataset(base, engine="numpy", sampling=SMALL)
    assert card.placement.engine == "cuda" and card.placement.device.type == "cuda"
    intersect.reset_launches()
    coverage.reset_launches()
    got, want = _replay(card, delta), _replay(host, delta)
    assert [r.source for r in got[0]] == ["cold", "cache", "incremental"]
    for a, b in zip(got[0], want[0]):
        assert _value_sets(a.result) == _value_sets(b.result)
    assert got[1] == want[1]
    assert got[2].source == "approx" and got[3].info["refined"] is True
    assert _value_sets(got[3].result) == _value_sets(want[3].result)
    assert intersect.LAUNCHES["intersect_classify_write_indexed"] > 0
    assert sum(coverage.LAUNCHES.values()) > 0
    stats = card.stats()
    assert stats["resilience"]["unavailable_mines"] == 0 and stats["resilience"]["state"] == "closed"
    assert stats["executables"]["families"]["intersect"]["hits"] > 0
    assert isinstance(card.store.device_bits(), torch.Tensor)
    card.close()
    host.close()


def test_profile_trace_names_the_intersect_kernels(cuda, tmp_path):
    svc = MiningService.from_dataset(_rand(2, 20000, 8, 9), profile_dir=str(tmp_path))
    r = svc.mine(tau=1, kmax=3)
    events = json.loads(open(r.info["profile_trace"]).read())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("intersect_indexed_kernel" in k for k in kernels), sorted(kernels)[:20]
    svc.close()


@pytest.mark.parametrize("chunk_bytes", [1 << 30, 1 << 16], ids=["one-chunk", "chunks"])
def test_delta_born_full_count_on_the_card(cuda, monkeypatch, chunk_bytes):
    """The delta-born stage's full-width count through the CUDA kernels
    (rows 3 and 4 over the store's resident rows) equals the host count,
    and the kernels launched."""
    from repro_torch.core import make_placement
    from repro_torch.service import DatasetStore
    from repro_torch.service import incremental as inc

    monkeypatch.setattr(inc, "_RESIDENT_CHUNK_BYTES", chunk_bytes)
    placement = make_placement("cuda", device=cuda)
    store = DatasetStore.from_dataset(_rand(3, 70_001, 6, 7), placement=placement)
    table = store.item_table()
    rng = np.random.default_rng(3)
    intersect.reset_launches()
    for k in (2, 3, 4):
        mat = np.stack([rng.choice(table.n_items, size=k, replace=False) for _ in range(700)])
        got = inc._full_supports_resident(placement, store.device_bits(), mat, table.n_words)
        np.testing.assert_array_equal(got, inc._full_supports(table.bits, mat))
    assert intersect.LAUNCHES["intersect_write_indexed"] > 0
    assert intersect.LAUNCHES["intersect_count_indexed"] > 0
