"""The anchored coverage path on the CPU: the index of nonzero words against
numpy, the anchored plain version (and the anchored wrapper's CPU path)
against the scanning plain version, the port's host engine and the
reference's Pallas kernel in interpret mode, the rule that picks the
anchored or the scanning kernel per batch, and a ``cuda``-engine risk
profile on the CPU against the reference's. Integer ops that wrap at
int32: the tolerance is zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import KyivConfig as RConfig
from repro.core import mine as r_mine
from repro.kernels.coverage import coverage_accumulate_host as r_host
from repro.kernels.coverage import coverage_accumulate_indexed as r_pallas
from repro.privacy import risk_profile as r_risk_profile
from repro_torch.core import DevicePlacement, KyivConfig, mine
from repro_torch.core.bitops import device_bits
from repro_torch.data import synth
from repro_torch.kernels.coverage import (
    LAUNCHES,
    CoverageEngine,
    anchored_plan,
    build_coverage_index,
    coverage_accumulate_anchored,
    coverage_accumulate_anchored_ref,
    coverage_accumulate_host,
    coverage_accumulate_ref,
)
from repro_torch.kernels.coverage import ops as tops
from repro_torch.kernels.coverage.index import ANCHOR_WORK_FACTOR, anchors, walk_anchors
from repro_torch.privacy import risk_profile


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _sparse_rows(seed, t, n_words, per_row):
    """Rows with at most ``per_row`` random nonzero words, plus an empty
    row 0, an all-ones row 1 and a row 2 of sign-bit words."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((t, n_words), dtype=np.uint32)
    for r in range(t):
        cols = rng.integers(0, n_words, size=rng.integers(0, per_row + 1))
        bits[r, cols] = rng.integers(1, 2**32, size=len(cols), dtype=np.uint32)
    bits[0] = 0
    bits[1] = 0xFFFFFFFF
    bits[2, ::3] = 0x80000000
    return bits


def _sets(seed, t, m, k, weights):
    """(m, k) sets with repeated items and sets on rows 0-2; weights small,
    overflowing int32 sums, with weight-0 padding at the end."""
    rng = np.random.default_rng(seed)
    sets = rng.integers(0, t, size=(m, k)).astype(np.int32)
    if m >= 4:
        sets[0], sets[1], sets[2] = 1, 0, 2
        sets[3, :] = sets[3, 0]
    if weights == "overflow":
        wt = (2**30 + rng.integers(-3, 4, size=m)).astype(np.int32)
        wt[::3] = -(2**30) - 7
    else:
        wt = rng.integers(0, 3, size=m).astype(np.int32)
    wt[-(m // 4 or 1):] = 0  # weight-0 batch padding
    return sets, wt


# -- the index ---------------------------------------------------------------------


@pytest.mark.parametrize("n_words", [1, 3, 5, 33, 130])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("block_elems", [1, 64, 1 << 26])
def test_index_matches_numpy_nonzero(n_words, padded, block_elems):
    bits = _sparse_rows(n_words, 12, n_words, per_row=4)
    dev = device_bits(bits, "cpu") if padded else _t(bits)
    index = build_coverage_index(dev, block_elems=block_elems)
    host = dev.numpy()
    assert index.offsets.dtype == torch.int64 and index.words.dtype == torch.int32
    assert index.counts.dtype == np.int64 and index.offsets[0] == 0
    for r in range(host.shape[0]):
        want = np.nonzero(host[r])[0]
        lo, hi = int(index.offsets[r]), int(index.offsets[r + 1])
        assert np.array_equal(index.words[lo:hi].numpy(), want), r
        assert index.counts[r] == len(want)
    assert index.counts[0] == 0 and index.counts[1] == n_words
    assert index.nbytes() == (host.shape[0] + 1) * 8 + int(index.counts.sum()) * 4


def test_index_of_an_empty_table():
    index = build_coverage_index(torch.zeros((0, 8), dtype=torch.int32))
    assert index.offsets.tolist() == [0] and index.words.numel() == 0 and len(index.counts) == 0


# -- the walk ----------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_walk_anchors_matches_a_loop_over_the_kernels_reads(k, seed):
    """Anchors (fewest nonzero words, first on ties), every (set, anchor
    word) pair in order, the AND there, and the member words read: the
    anchor's, then each other member's while the AND is nonzero."""
    bits = _sparse_rows(seed, 16, 37, per_row=6)
    sets, _ = _sets(seed, 16, 40, k, "small")
    tb = _t(bits)
    index = build_coverage_index(tb)
    idx = torch.from_numpy(sets).long()
    anchor = anchors(index, idx)
    walk = walk_anchors(tb, index, idx, anchor, reads=True)
    pairs, xs, reads = [], [], []
    for s, row in enumerate(sets):
        a = int(row[np.argmin(index.counts[row])])
        assert int(anchor[s]) == a
        for w in np.nonzero(bits[a])[0]:
            x = bits[a, w]
            reads.append(a * 37 + w)
            for item in row:
                if x != 0 and item != a:
                    reads.append(int(item) * 37 + w)
                    x &= bits[item, w]
            pairs.append((s, w))
            xs.append(x)
    assert list(zip(walk.set_of.tolist(), walk.word.tolist())) == pairs
    assert np.array_equal(walk.x.numpy().view(np.uint32), np.asarray(xs, dtype=np.uint32))
    assert sorted(walk.reads.tolist()) == sorted(reads)
    assert walk_anchors(tb, index, idx, anchor).reads is None


# -- the anchored plain version -------------------------------------------------------


def _reference(bits, sets, wt):
    want = r_host(bits, sets, wt)
    got = np.asarray(r_pallas(jnp.asarray(bits), jnp.asarray(sets), jnp.asarray(wt),
                              block_words=bits.shape[1], interpret=True))
    assert np.array_equal(got, want)
    return want


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("weights", ["small", "overflow"])
@pytest.mark.parametrize("n_words,m", [(3, 9), (33, 40), (70, 64)])
def test_anchored_ref_matches_scan_host_and_reference(k, weights, n_words, m):
    bits = _sparse_rows(100 * k + n_words, 16, n_words, per_row=6)
    sets, wt = _sets(k + m, 16, m, k, weights)
    want = _reference(bits, sets, wt)
    tb, ts, tw = _t(bits), _t(sets), _t(wt)
    index = build_coverage_index(tb)
    before = dict(LAUNCHES)
    longest = anchored_plan(index.counts, sets, wt, n_words)[1]
    for got in (coverage_accumulate_anchored_ref(tb, index, ts, tw),
                coverage_accumulate_anchored_ref(tb, index, ts, tw, chunk_pairs=7),
                coverage_accumulate_anchored(tb, index, ts, tw, longest),
                coverage_accumulate_anchored(tb, index, ts, tw, 1)):
        assert got.dtype == torch.int32 and tuple(got.shape) == (32, n_words)
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(coverage_accumulate_ref(tb, ts, tw).numpy(), want)
    assert np.array_equal(coverage_accumulate_host(bits, sets, wt), want)
    assert LAUNCHES == before, "the CPU path launches nothing"


def test_anchored_on_dense_rows_and_degenerate_batches():
    """Random (dense) rows, a batch of one set, all weights 0, no sets."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, size=(9, 20), dtype=np.uint32)
    bits[0] = 0
    tb = _t(bits)
    index = build_coverage_index(tb)
    for sets, wt in ((rng.integers(0, 9, (30, 2)).astype(np.int32), rng.integers(-4, 5, 30).astype(np.int32)),
                     (np.array([[3, 3, 5]], dtype=np.int32), np.array([7], dtype=np.int32)),
                     (np.array([[0, 4]], dtype=np.int32), np.array([1], dtype=np.int32)),
                     (np.array([[1, 2], [3, 4]], dtype=np.int32), np.zeros(2, dtype=np.int32)),
                     (np.zeros((0, 2), dtype=np.int32), np.zeros(0, dtype=np.int32))):
        want = coverage_accumulate_ref(tb, _t(sets), _t(wt))
        assert torch.equal(coverage_accumulate_anchored_ref(tb, index, _t(sets), _t(wt)), want)
        assert torch.equal(coverage_accumulate_anchored(tb, index, _t(sets), _t(wt), 20), want)


def test_anchored_wrapper_refuses_bad_inputs():
    bits = _t(_sparse_rows(1, 8, 4, 2))
    index = build_coverage_index(bits)
    sets, wt = _t(np.array([[1, 2]], dtype=np.int32)), _t(np.array([1], dtype=np.int32))
    with pytest.raises(ValueError):  # the index of another table
        coverage_accumulate_anchored(bits, build_coverage_index(bits[:5].contiguous()), sets, wt, 1)
    with pytest.raises(ValueError):
        coverage_accumulate_anchored(bits, index._replace(words=index.words.long()), sets, wt, 1)
    with pytest.raises(ValueError):  # not a CPU tensor: no plain fallback
        coverage_accumulate_anchored(bits.to("meta"), index._replace(
            offsets=index.offsets.to("meta"), words=index.words.to("meta")), sets.to("meta"), wt.to("meta"), 1)
    with pytest.raises(ValueError):
        coverage_accumulate_anchored(bits, index, sets.long(), wt, 1)


# -- the dispatch rule ------------------------------------------------------------


def _mined_qi_batch(n=3000):
    D = synth.exposed_dataset(n=n, m=6, seed=0)
    res = mine(D, KyivConfig(tau=1, kmax=3, engine="numpy"))
    sets = np.asarray([list(ids) + [ids[-1]] * (3 - len(ids)) for ids, _ in res.itemsets],
                      dtype=np.int32)
    return res.prep.table.bits, sets


def test_dispatch_rule_anchors_mined_qis_and_scans_dense_batches():
    bits, sets = _mined_qi_batch()
    tb = device_bits(bits, "cpu")
    index = build_coverage_index(tb)
    wt = np.ones(len(sets), dtype=np.int32)
    anchored, longest = anchored_plan(index.counts, sets, wt, tb.shape[1])
    assert anchored and 0 < longest < tb.shape[1]
    anchor_words = index.counts[sets].min(axis=1)
    assert longest == anchor_words.max()
    assert anchor_words.sum() * ANCHOR_WORK_FACTOR <= len(sets) * tb.shape[1]

    rng = np.random.default_rng(5)
    dense = rng.integers(0, 2**32, size=(40, tb.shape[1]), dtype=np.uint32)
    dindex = build_coverage_index(_t(dense))
    dsets = rng.integers(0, 40, size=(200, 3)).astype(np.int32)
    anchored, longest = anchored_plan(dindex.counts, dsets, np.ones(200, dtype=np.int32), tb.shape[1])
    assert not anchored and longest == tb.shape[1]
    # weight-0 sets need no work: a batch of padding walks nothing
    assert anchored_plan(dindex.counts, dsets, np.zeros(200, dtype=np.int32), tb.shape[1]) == (True, 0)


def test_cuda_engine_batches_take_the_anchored_kernel(monkeypatch):
    """A ``cuda`` placement on the CPU: a mined-QI batch runs the anchored
    wrapper (its plain version here) and equals the host engine."""
    bits, sets = _mined_qi_batch()
    called = []
    real = tops._k.coverage_accumulate_anchored
    monkeypatch.setattr(tops._k, "coverage_accumulate_anchored",
                        lambda *a: called.append(a[-1]) or real(*a))
    eng = CoverageEngine(bits, placement=DevicePlacement("cuda", device="cpu"), set_width=3)
    got = eng.accumulate(sets)
    assert called and all(c > 0 for c in called)
    assert np.array_equal(got, coverage_accumulate_host(bits, sets, np.ones(len(sets), dtype=np.int32)))
    # the torch engine builds no index and scans
    state = DevicePlacement("torch", device="cpu").prepare_coverage(bits)
    assert state[1] is None


@pytest.mark.parametrize("n,seed", [(2000, 3), (5000, 1)])
def test_cuda_engine_risk_profile_equals_reference(n, seed):
    D = synth.exposed_dataset(n=n, seed=seed)
    want = r_risk_profile(r_mine(D, RConfig(tau=1, kmax=3)))
    res = mine(D, KyivConfig(tau=1, kmax=3, engine="cuda", device="cpu"))
    got = risk_profile(res, placement=DevicePlacement("cuda", device="cpu"))
    for name in ("counts_by_size", "qi_count", "min_qi_size", "risk"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
