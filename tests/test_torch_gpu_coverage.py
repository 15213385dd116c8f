"""The CUDA coverage kernel on a card: bit for bit against its plain
PyTorch version and the numpy host engine, and the privacy path (risk
profiles, reports, the planner) on the ``cuda`` engine against the numpy
engine. Marked ``gpu``; every test skips where torch sees no CUDA card (run
them there with ``python -m pytest -m gpu tests/test_torch_gpu_coverage.py``)."""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import HostPlacement, KyivConfig, mine
from repro_torch.data.synth import exposed_dataset
from repro_torch.kernels.coverage import (
    LAUNCHES,
    coverage_accumulate_host,
    coverage_accumulate_indexed,
    coverage_accumulate_ref,
)
from repro_torch.privacy import apply_plan, mine_masked, plan_anonymization, risk_profile
from repro_torch.sdc.quasi import find_quasi_identifiers, report_as_dict

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(t, w, m, k, seed, overflow=False):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
    bits[0] = 0
    bits[1] = 0xFFFFFFFF
    sets = rng.integers(0, t, size=(m, k)).astype(np.int32)
    sets[: min(m, 2)] = np.array([[1] * k, [0] * k], dtype=np.int32)[: min(m, 2)]
    if overflow:
        wt = (2**30 + rng.integers(-3, 4, size=m)).astype(np.int32)
        wt[::3] = -(2**30) - 5
    else:
        wt = rng.integers(0, 3, size=m).astype(np.int32)
    return bits, sets, wt


def _dev(bits, sets, wt, device):
    return (torch.from_numpy(np.ascontiguousarray(bits).view(np.int32)).to(device),
            torch.from_numpy(sets).to(device), torch.from_numpy(wt).to(device))


@pytest.mark.parametrize("w", [1, 3, 33, 3128, 31252])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("overflow", [False, True])
def test_kernel_matches_plain_version(cuda, w, k, overflow):
    for m in (0, 1, 7, 300):
        bits, sets, wt = _case(24, w, m, k, seed=w + 10 * k + m, overflow=overflow)
        b, s, x = _dev(bits, sets, wt, cuda)
        got = coverage_accumulate_indexed(b, s, x)
        want = coverage_accumulate_ref(b, s, x)
        torch.cuda.synchronize()
        assert torch.equal(got, want), m
        if w <= 33:
            assert np.array_equal(got.cpu().numpy(), coverage_accumulate_host(bits, sets, wt))


def test_kernel_long_sets_read_indices_from_device_memory(cuda):
    """Sets longer than a shared-memory tile (2,048 items) take the
    unstaged index path."""
    bits, _, wt = _case(40, 33, 5, 1, seed=3)
    bits[2:] |= 0xF0F0F0F0
    rng = np.random.default_rng(4)
    sets = rng.integers(2, 40, size=(5, 2100)).astype(np.int32)
    got = coverage_accumulate_indexed(*_dev(bits, sets, wt, cuda))
    assert np.array_equal(got.cpu().numpy(), coverage_accumulate_host(bits, sets, wt))


def test_launch_counts(cuda):
    bits, sets, wt = _dev(*_case(16, 40, 9, 2, seed=1), cuda)
    before = LAUNCHES["coverage_accumulate_indexed"]
    coverage_accumulate_indexed(bits, sets, wt)
    empty = coverage_accumulate_indexed(bits, sets[:0], wt[:0])  # launches nothing
    assert LAUNCHES["coverage_accumulate_indexed"] == before + 1
    assert torch.equal(empty, torch.zeros_like(empty))
    with pytest.raises(ValueError):
        coverage_accumulate_indexed(bits, sets.cpu(), wt)


def test_risk_profile_and_report_on_the_card(cuda):
    D = exposed_dataset(n=20_000, seed=2)
    res = mine(D, KyivConfig(tau=1, kmax=3, device=str(cuda)))
    before = LAUNCHES["coverage_accumulate_indexed"]
    got = risk_profile(res)
    assert LAUNCHES["coverage_accumulate_indexed"] > before
    want = risk_profile(res, placement=HostPlacement())
    for name in ("counts_by_size", "qi_count", "min_qi_size", "risk"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    rep = find_quasi_identifiers(D, 1, 3, device=str(cuda))
    ref = find_quasi_identifiers(D, 1, 3, engine="numpy")
    assert json.dumps(report_as_dict(rep)) == json.dumps(report_as_dict(ref))


def test_planner_on_the_card(cuda):
    D = exposed_dataset(n=3000, seed=0)
    cfg = KyivConfig(device=str(cuda))
    plan = plan_anonymization(D, 1, 3, config=cfg)
    want = plan_anonymization(D, 1, 3, config=KyivConfig(engine="numpy"))
    assert plan.verified and plan.initial_qis == want.initial_qis
    post = mine_masked(apply_plan(D, plan), KyivConfig(tau=1, kmax=3, device=str(cuda)))
    assert post is None or not post.itemsets
