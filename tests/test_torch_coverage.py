"""The port's coverage accumulation against the reference: its numpy host
engine, its plain PyTorch version and the CUDA wrapper's CPU path against
``repro``'s host engine, jnp oracle and Pallas kernel (run in interpret
mode, as the reference's own tests run it on the CPU); ``CoverageEngine``
on the port's placements against the reference's three placements on mined
quasi-identifiers; the wrapper's refusal of other devices and bad inputs.
Integer ops that wrap at int32: the tolerance is zero."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import KyivConfig as RConfig
from repro.core import mine as r_mine
from repro.core.placement import DevicePlacement as RDevicePlacement
from repro.core.placement import HostPlacement as RHostPlacement
from repro.kernels.coverage import CoverageEngine as RCoverageEngine
from repro.kernels.coverage import acc_to_record_counts as r_acc_to_record_counts
from repro.kernels.coverage import coverage_accumulate_host as r_host
from repro.kernels.coverage import coverage_accumulate_indexed as r_pallas
from repro.kernels.coverage import coverage_accumulate_ref as r_jnp
from repro_torch.core import placement as tplacement
from repro_torch.core.placement import DevicePlacement, HostPlacement
from repro_torch.kernels.coverage import (
    LAUNCHES,
    CoverageEngine,
    acc_to_record_counts,
    build_coverage_dispatch,
    build_coverage_index,
    coverage_accumulate_host,
    coverage_accumulate_indexed,
    coverage_accumulate_ref,
)
from repro_torch.kernels.coverage import ops as tops

_R_JNP = jax.jit(r_jnp)


def _case(seed, t, n_words, m, k, *, weights="small", sparse=False):
    """Random bitsets with an empty row (0) and an all-ones row (1, every
    sign bit set), sets that repeat items, and weights: ``small`` in
    {0, 1, 2}, ``overflow`` near 2**30 so that sums wrap at int32."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(t, n_words), dtype=np.uint32)
    if sparse:  # few bits per row: the host engine's anchor path
        bits &= rng.integers(0, 2**32, size=(t, n_words), dtype=np.uint32)
        bits &= rng.integers(0, 2**32, size=(t, n_words), dtype=np.uint32)
        bits &= rng.integers(0, 2**32, size=(t, n_words), dtype=np.uint32)
    if t >= 2:
        bits[0] = 0
        bits[1] = 0xFFFFFFFF
    sets = rng.integers(0, t, size=(m, k)).astype(np.int32)
    if m >= 3 and t >= 2:
        sets[0] = 1  # all ones: every record covered
        sets[1] = 0  # empty
        sets[2, :] = sets[2, 0]  # a set padded by repeating one item
    if weights == "overflow":
        wt = (2**30 + rng.integers(-3, 4, size=m)).astype(np.int32)
        wt[::5] = -(2**30) - 7
    else:
        wt = rng.integers(0, 3, size=m).astype(np.int32)
    return bits, sets, wt


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _reference(bits, sets, wt, *, pallas: bool):
    host = r_host(bits, sets, wt)
    ref = np.asarray(_R_JNP(jnp.asarray(bits), jnp.asarray(sets), jnp.asarray(wt)))
    assert np.array_equal(ref, host)
    if pallas:
        got = np.asarray(r_pallas(jnp.asarray(bits), jnp.asarray(sets), jnp.asarray(wt),
                                  block_words=bits.shape[1], interpret=True))
        assert np.array_equal(got, host)
    return host


def _port_all(bits, sets, wt):
    """The port's three CPU paths, each as (32, W) int32 numpy."""
    host = coverage_accumulate_host(bits, sets, wt)
    plain = coverage_accumulate_ref(_t(bits), _t(sets), _t(wt))
    wrapped = coverage_accumulate_indexed(_t(bits), _t(sets), _t(wt))
    for x in (plain, wrapped):
        assert x.dtype == torch.int32 and tuple(x.shape) == (32, bits.shape[1])
    return {"host": host, "plain": plain.numpy(), "wrapper": wrapped.numpy()}


# the reference's grid (tests/test_privacy.py) plus sign-bit words, widths
# that are not a multiple of 4, sparse rows and int32-overflowing weights
GRID = [
    (0, 7, 1, 9, 1, "small", False),
    (1, 24, 4, 40, 3, "small", False),
    (2, 12, 8, 17, 4, "small", False),
    (3, 2, 2, 1, 2, "small", False),
    (4, 10, 3, 20, 2, "small", False),
    (5, 16, 5, 33, 3, "overflow", False),
    (6, 9, 7, 40, 1, "overflow", False),
    (7, 30, 6, 25, 3, "small", True),
    (8, 30, 3, 40, 2, "overflow", True),
]


@pytest.mark.parametrize("seed,t,n_words,m,k,weights,sparse", GRID)
def test_coverage_matches_reference_engines_and_pallas(seed, t, n_words, m, k, weights, sparse):
    bits, sets, wt = _case(seed, t, n_words, m, k, weights=weights, sparse=sparse)
    want = _reference(bits, sets, wt, pallas=True)
    for name, got in _port_all(bits, sets, wt).items():
        assert np.array_equal(got, want), name
    n_rows = n_words * 32
    assert np.array_equal(acc_to_record_counts(want, n_rows), r_acc_to_record_counts(want, n_rows))


@pytest.mark.parametrize("n_words", [1, 3, 33, 130])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("weights", ["small", "overflow"])
def test_coverage_wide_sweep_matches_reference(n_words, k, weights):
    """Wider words than interpret mode allows: host, plain and wrapper
    against the reference's host engine and jnp oracle."""
    for m, sparse in ((0, False), (1, False), (7, True), (64, False)):
        bits, sets, wt = _case(n_words * 10 + k, 20, n_words, m, k, weights=weights, sparse=sparse)
        want = _reference(bits, sets, wt, pallas=False)
        for name, got in _port_all(bits, sets, wt).items():
            assert np.array_equal(got, want), (name, m)


def test_host_engine_takes_both_paths():
    """Dense masks take the bit-plane sweep, sparse ones the anchor
    enumeration; both equal the plain version."""
    dense = _case(11, 12, 4, 30, 2)
    sparse_bits = np.zeros((12, 64), dtype=np.uint32)
    sparse_bits[:, 5] = np.arange(12, dtype=np.uint32) | 0x80000000
    sparse = (sparse_bits, np.random.default_rng(1).integers(0, 12, (30, 3)).astype(np.int32),
              np.ones(30, dtype=np.int32))
    for bits, sets, wt in (dense, sparse):
        plain = coverage_accumulate_ref(_t(bits), _t(sets), _t(wt)).numpy()
        assert np.array_equal(coverage_accumulate_host(bits, sets, wt), plain)
        assert np.array_equal(r_host(bits, sets, wt), plain)


# -- CoverageEngine over placements -------------------------------------------

R_PLACEMENTS = [RHostPlacement(), RDevicePlacement("jnp"), RDevicePlacement("pallas", interpret=True)]


def _port_placements():
    return [HostPlacement(), DevicePlacement("torch", device="cpu"),
            DevicePlacement("cuda", device="cpu")]


@pytest.mark.parametrize("seed,n,m,dom,tau", [(5, 33, 3, 4, 1), (6, 80, 5, 6, 2)])
def test_coverage_engine_placements_match_reference(seed, n, m, dom, tau):
    D = np.random.default_rng(seed).integers(0, dom, size=(n, m))
    res = r_mine(D, RConfig(tau=tau, kmax=3))
    assert res.itemsets
    bits = res.prep.table.bits
    sets = np.asarray([list(ids) + [ids[-1]] * (3 - len(ids)) for ids, _ in res.itemsets],
                      dtype=np.int32)
    wt = np.random.default_rng(seed).integers(-2, 4, size=len(sets)).astype(np.int32)
    want = None
    for placement in R_PLACEMENTS:
        acc = RCoverageEngine(bits, placement=placement, set_width=3, max_batch_sets=16).accumulate(sets, wt)
        want = acc if want is None else want
        assert np.array_equal(acc, want), placement.kind
    for placement in _port_placements():
        eng = CoverageEngine(bits, placement=placement, set_width=3, max_batch_sets=16)
        got = eng.accumulate(sets, wt)
        assert got.dtype == np.int64 and got.shape == (32, bits.shape[1])
        assert np.array_equal(got, want), repr(placement)
        assert np.array_equal(eng.record_counts(sets, n, wt), r_acc_to_record_counts(want, n))
        assert np.array_equal(eng.accumulate(sets[:, :2]),
                              RCoverageEngine(bits, placement=RHostPlacement(), set_width=3)
                              .accumulate(sets[:, :2]))


def test_coverage_engine_batches_pad_and_count():
    """Batches split at max_batch_sets; device batches pad to the
    power-of-two bucket with weight-0 rows; empty input dispatches nothing."""
    bits, sets, wt = _case(21, 14, 3, 70, 2)
    calls = []

    class Spy(DevicePlacement):
        def coverage_dispatch(self, state, padded_sets, padded_weights):
            calls.append((padded_sets.shape, int((padded_weights == 0).sum())))
            return super().coverage_dispatch(state, padded_sets, padded_weights)

    counter = tops._COV_BATCHES
    before = counter.value()
    eng = CoverageEngine(bits, placement=Spy("torch", device="cpu"), set_width=2, max_batch_sets=32)
    got = eng.accumulate(sets, wt)
    assert [c[0] for c in calls] == [(256, 2)] * 3
    assert [c[1] for c in calls] == [256 - 32 + int((wt[:32] == 0).sum()),
                                     256 - 32 + int((wt[32:64] == 0).sum()),
                                     256 - 6 + int((wt[64:] == 0).sum())]
    assert counter.value() - before == 3
    assert np.array_equal(got, r_host(bits, sets, wt))
    assert np.array_equal(eng.accumulate(np.zeros((0, 2), dtype=np.int32)),
                          np.zeros((32, 3), dtype=np.int64))
    assert len(calls) == 3
    with pytest.raises(ValueError):
        eng.accumulate(np.zeros((4, 3), dtype=np.int32))  # wider than set_width


def test_device_coverage_dispatch_is_guarded():
    """The device dispatch passes the fault seam at site "coverage"; the
    host dispatch does not."""
    seen = []
    prev = tplacement.set_fault_hook(seen.append)
    try:
        bits, sets, wt = _case(3, 6, 2, 5, 2)
        CoverageEngine(bits, placement=HostPlacement(), set_width=2).accumulate(sets, wt)
        assert seen == []
        CoverageEngine(bits, placement=DevicePlacement("torch", device="cpu"),
                       set_width=2).accumulate(sets, wt)
        assert seen == ["coverage"]
    finally:
        tplacement.set_fault_hook(prev)


def test_build_coverage_dispatch_engines(monkeypatch):
    """``torch`` runs the plain scanning version; ``cuda`` runs the
    anchored kernel's wrapper where the batch's anchors are sparse, the
    scanning one otherwise; other engines raise."""
    bits, sets, wt = _case(12, 10, 40, 30, 3)
    bits[2:, 2:] = 0  # rows 2-9 have two nonzero words of 40
    tb = _t(bits)
    want = coverage_accumulate_ref(tb, _t(sets), _t(wt))
    called = []
    for name in ("coverage_accumulate_indexed", "coverage_accumulate_anchored"):
        real = getattr(tops._k, name)
        monkeypatch.setattr(tops._k, name,
                            lambda *a, _n=name, _f=real, **kw: called.append(_n) or _f(*a, **kw))
    assert torch.equal(build_coverage_dispatch("torch")(tb, None, sets, wt), want)
    assert called == []
    cuda = build_coverage_dispatch("cuda")
    index = build_coverage_index(tb)
    assert torch.equal(cuda(tb, index, sets, wt), want)
    dense = np.ones((30, 3), dtype=np.int32)  # the all-ones row: every word nonzero
    assert torch.equal(cuda(tb, index, dense, wt), coverage_accumulate_ref(tb, _t(dense), _t(wt)))
    assert called == ["coverage_accumulate_anchored", "coverage_accumulate_indexed"]
    with pytest.raises(ValueError):
        build_coverage_dispatch("numpy")


# -- the wrapper ----------------------------------------------------------------


def test_cpu_path_launches_nothing():
    before = dict(LAUNCHES)
    for seed, t, n_words, m, k, weights, sparse in GRID:
        bits, sets, wt = _case(seed, t, n_words, m, k, weights=weights, sparse=sparse)
        coverage_accumulate_indexed(_t(bits), _t(sets), _t(wt))
    empty = coverage_accumulate_indexed(_t(bits), _t(sets[:0]), _t(wt[:0]))
    assert torch.equal(empty, torch.zeros((32, bits.shape[1]), dtype=torch.int32))
    assert LAUNCHES == before, "the CPU path launches nothing"


def test_wrapper_refuses_other_devices_and_bad_inputs():
    bits, sets, wt = (_t(x) for x in _case(6, 8, 4, 5, 2))
    with pytest.raises(ValueError):  # not a CPU tensor: no plain fallback
        coverage_accumulate_indexed(bits.to("meta"), sets.to("meta"), wt.to("meta"))
    with pytest.raises(ValueError):  # devices differ
        coverage_accumulate_indexed(bits, sets.to("meta"), wt)
    with pytest.raises(ValueError):
        coverage_accumulate_indexed(bits.to(torch.int64), sets, wt)
    with pytest.raises(ValueError):
        coverage_accumulate_indexed(bits, sets.to(torch.int64), wt)
    with pytest.raises(ValueError):
        coverage_accumulate_indexed(bits, sets, wt[:-1])
    with pytest.raises(ValueError):
        coverage_accumulate_indexed(bits, sets[:, :0].contiguous(), wt)
    with pytest.raises(ValueError):
        coverage_accumulate_indexed(bits.t(), sets, wt)
