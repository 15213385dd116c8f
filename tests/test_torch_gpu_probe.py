"""The rate probes on a card: each runs, is sized to at least half its
target time and reports a positive rate. Marked ``gpu``; skips where torch
sees no CUDA card (run with ``python -m pytest -m gpu tests/test_torch_gpu_probe.py``)."""

import pytest
import torch

from repro_torch.kernels.probe import KINDS, measure_rate

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_probe_measures_a_rate(cuda, kind):
    r = measure_rate(kind, cuda, target_ms=20.0)
    assert r["ms"] >= 10.0 and r["ops"] > 0 and r["ops_per_s"] > 0
    assert r["ctas"] == 8 * torch.cuda.get_device_properties(cuda).multi_processor_count
