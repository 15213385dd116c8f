"""The CUDA coverage kernels on a card (scanning and anchored): bit for bit
against their plain PyTorch versions and the numpy host engine, and the
privacy path (risk profiles, reports, the planner) on the ``cuda`` engine
against the numpy engine. Marked ``gpu``; every test skips where torch sees no CUDA card (run
them there with ``python -m pytest -m gpu tests/test_torch_gpu_coverage.py``)."""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import HostPlacement, KyivConfig, mine
from repro_torch.data.synth import exposed_dataset
from repro_torch.kernels.coverage import (
    LAUNCHES,
    anchored_plan,
    build_coverage_index,
    coverage_accumulate_anchored,
    coverage_accumulate_anchored_ref,
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
    before = dict(LAUNCHES)
    coverage_accumulate_indexed(bits, sets, wt)
    empty = coverage_accumulate_indexed(bits, sets[:0], wt[:0])  # launches nothing
    assert LAUNCHES["coverage_accumulate_indexed"] == before["coverage_accumulate_indexed"] + 1
    assert torch.equal(empty, torch.zeros_like(empty))
    with pytest.raises(ValueError):
        coverage_accumulate_indexed(bits, sets.cpu(), wt)
    index = build_coverage_index(bits)
    coverage_accumulate_anchored(bits, index, sets, wt, 40)
    empty = coverage_accumulate_anchored(bits, index, sets[:0], wt[:0], 40)  # launches nothing
    dead = coverage_accumulate_anchored(bits, index, sets, torch.zeros_like(wt), 0)
    assert not empty.any() and not dead.any()
    assert LAUNCHES["coverage_accumulate_anchored"] == before["coverage_accumulate_anchored"] + 2
    assert LAUNCHES["coverage_accumulate_indexed"] == before["coverage_accumulate_indexed"] + 1
    with pytest.raises(ValueError):
        coverage_accumulate_anchored(bits, index._replace(words=index.words.cpu()), sets, wt, 40)


def _sparse(bits, seed):
    """Rows 2.. of ``bits`` with about one word in 16 kept nonzero."""
    rng = np.random.default_rng(seed)
    bits[2:] *= (rng.integers(0, 16, size=bits[2:].shape) == 0).astype(np.uint32)
    return bits


@pytest.mark.parametrize("w", [1, 3, 33, 3128, 31252])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_anchored_kernel_matches_plain_versions(cuda, w, k, overflow, sparse):
    for m in (0, 1, 7, 300):
        bits, sets, wt = _case(24, w, m, k, seed=w + 10 * k + m, overflow=overflow)
        if sparse:
            bits = _sparse(bits, m)
        b, s, x = _dev(bits, sets, wt, cuda)
        index = build_coverage_index(b)
        want = coverage_accumulate_ref(b, s, x)
        got = coverage_accumulate_anchored(b, index, s, x, anchored_plan(index.counts, sets, wt, w)[1])
        unhinted = coverage_accumulate_anchored(b, index, s, x, 1)
        plain = coverage_accumulate_anchored_ref(b, index, s, x)
        torch.cuda.synchronize()
        for out in (got, unhinted, plain):
            assert torch.equal(out, want), m
        if w <= 33:
            assert np.array_equal(got.cpu().numpy(), coverage_accumulate_host(bits, sets, wt))


def test_anchored_kernel_splits_long_anchor_lists(cuda):
    """One set anchored on an all-ones row (every word, many slices) among
    sets of short anchors, with an understated, an exact and an overstated
    longest anchor."""
    bits, sets, wt = _case(24, 31252, 64, 2, seed=5)
    bits = _sparse(bits, 6)
    sets[1] = [1, 1]  # all ones: its anchor list is all 31,252 words
    b, s, x = _dev(bits, sets, np.ones(64, dtype=np.int32), cuda)
    index = build_coverage_index(b)
    want = coverage_accumulate_ref(b, s, x)
    for hint in (1, 31252, 10**6):
        assert torch.equal(coverage_accumulate_anchored(b, index, s, x, hint), want)


def test_risk_profile_and_report_on_the_card(cuda):
    D = exposed_dataset(n=20_000, seed=2)
    res = mine(D, KyivConfig(tau=1, kmax=3, device=str(cuda)))
    before = LAUNCHES["coverage_accumulate_anchored"]
    got = risk_profile(res)
    assert LAUNCHES["coverage_accumulate_anchored"] > before
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
