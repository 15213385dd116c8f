"""The port's host substrate — synthetic data, itemize, preprocess (every
ordering), prefix joins, the support test and the Lemma 4.6 / Corollary 4.7
bounds — against the reference package on ``repro.data.synth`` tables.
Integer ops: equality is exact."""

import dataclasses
import importlib

import numpy as np
import pytest

from repro.core import bounds as rbounds
from repro.core import items as ritems
from repro.core import prefix as rprefix
from repro.core import support as rsupport
from repro.core.oracle import brute_force_minimal_infrequent as r_oracle
from repro.data import synth as rsynth
from repro_torch.core import bounds as tbounds
from repro_torch.core import items as titems
from repro_torch.core import prefix as tprefix
from repro_torch.core import support as tsupport
from repro_torch.core.oracle import brute_force_minimal_infrequent as t_oracle
from repro_torch.data import synth as tsynth

# the packages re-export the function `preprocess` over its module's name
rpre = importlib.import_module("repro.core.preprocess")
tpre = importlib.import_module("repro_torch.core.preprocess")

TABLES = {
    "randomized": lambda: rsynth.randomized_dataset(400, 8, seed=3),
    "connect": lambda: rsynth.connect_like(n=500, seed=1),
    "poker": lambda: rsynth.poker_like(n=700, seed=2),
    "uscensus": lambda: rsynth.uscensus_like(n=300, m=12, seed=4),
    "mirrors": lambda: np.concatenate(
        [rsynth.randomized_dataset(150, 4, d_low=2, d_high=4, seed=5)] * 2, axis=1
    ),
}


@pytest.mark.parametrize(
    "name,kw",
    [
        ("randomized_dataset", dict(n=300, m=7, seed=3)),
        ("connect_like", dict(n=400, seed=1)),
        ("poker_like", dict(n=500, seed=2)),
        ("poker_like", dict(n=50, m=6, seed=9)),
        ("uscensus_like", dict(n=300, m=9, seed=4)),
    ],
)
def test_synth_generators_give_the_reference_arrays(name, kw):
    want = getattr(rsynth, name)(**kw)
    got = getattr(tsynth, name)(**kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_itemize_matches_reference(table):
    D = TABLES[table]()
    want, got = ritems.itemize(D), titems.itemize(D)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        assert np.array_equal(a, b), f.name
    assert np.array_equal(titems.pack_rows_to_bits([np.array([0, 33, 70])], 71),
                          ritems.pack_rows_to_bits([np.array([0, 33, 70])], 71))
    assert np.array_equal(titems.bits_to_rows(got.bits[0]), ritems.bits_to_rows(want.bits[0]))


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("ordering", ["ascending", "descending", "random"])
@pytest.mark.parametrize("tau", [1, 3])
def test_preprocess_matches_reference(table, ordering, tau):
    D = TABLES[table]()
    want = rpre.preprocess(ritems.itemize(D), tau, ordering=ordering, seed=7)
    got = tpre.preprocess(titems.itemize(D), tau, ordering=ordering, seed=7)
    for name in ("uniform_items", "infrequent_items", "l_items", "l_bits", "l_freq"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.mirror_of == want.mirror_of and got.tau == want.tau
    if table == "mirrors":
        assert got.mirror_of, "duplicate columns must give mirrors"


def _level(D, tau, k):
    """A stored level-k table of the reference miner (ascending L^<)."""
    prep = rpre.preprocess(ritems.itemize(D), tau)
    lvl = rprefix.Level(k=1, itemsets=np.arange(prep.n_l, dtype=np.int32)[:, None],
                        counts=prep.l_freq.copy(), bits=prep.l_bits)
    for _ in range(k - 1):
        cand = rprefix.generate_candidates(lvl)
        child = lvl.bits[cand.i_idx] & lvl.bits[cand.j_idx]
        cnt = np.bitwise_count(child).sum(axis=1).astype(np.int64)
        keep = cnt > tau
        lvl = rprefix.Level(k=lvl.k + 1, itemsets=cand.itemsets[keep], counts=cnt[keep],
                            bits=child[keep])
    return prep, lvl


@pytest.mark.parametrize("k", [1, 2, 3])
def test_prefix_joins_match_reference(k):
    _, lvl = _level(TABLES["randomized"](), 2, k)
    its = lvl.itemsets
    assert np.array_equal(tprefix.prefix_group_sizes(its), rprefix.prefix_group_sizes(its))
    assert np.array_equal(tprefix.group_reps(its), rprefix.group_reps(its))
    sizes = rprefix.prefix_group_sizes(its)
    for cap in (1, 50, 1 << 22):
        assert list(tprefix.iter_group_spans(sizes, cap)) == list(rprefix.iter_group_spans(sizes, cap))
    tl = tprefix.Level(k=lvl.k, itemsets=its, counts=lvl.counts, bits=None)
    got, want = tprefix.generate_candidates(tl), rprefix.generate_candidates(lvl)
    for name in ("i_idx", "j_idx", "itemsets"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("k", [2, 3])
def test_support_test_and_bounds_match_reference(k):
    D = TABLES["randomized"]()
    tau = 2
    prep, parent = _level(D, tau, k - 1)
    _, lvl = _level(D, tau, k)
    gidx_r = rsupport.ItemsetIndex(parent.itemsets, parent.counts, n_symbols=prep.n_l)
    gidx_t = tsupport.ItemsetIndex(parent.itemsets, parent.counts, n_symbols=prep.n_l)
    lidx_r = rsupport.ItemsetIndex(lvl.itemsets, lvl.counts, n_symbols=prep.n_l)
    lidx_t = tsupport.ItemsetIndex(lvl.itemsets, lvl.counts, n_symbols=prep.n_l)
    cand_r = rprefix.generate_candidates(lvl)
    cand_t = tprefix.generate_candidates(tprefix.Level(k=lvl.k, itemsets=lvl.itemsets,
                                                       counts=lvl.counts, bits=None))
    ok_r = rsupport.support_test(cand_r.itemsets, lidx_r)
    ok_t = tsupport.support_test(cand_t.itemsets, lidx_t)
    assert np.array_equal(ok_t, ok_r)
    q = cand_r.itemsets[:, :-1]
    assert np.array_equal(lidx_t.lookup_counts(q), lidx_r.lookup_counts(q))
    sub_r = rprefix.CandidateBatch(cand_r.i_idx[ok_r], cand_r.j_idx[ok_r], cand_r.itemsets[ok_r])
    sub_t = tprefix.CandidateBatch(cand_t.i_idx[ok_t], cand_t.j_idx[ok_t], cand_t.itemsets[ok_t])
    tl = tprefix.Level(k=lvl.k, itemsets=lvl.itemsets, counts=lvl.counts, bits=None)
    pr = rbounds.apply_bounds(sub_r, lvl, lidx_r, gidx_r, D.shape[0], tau)
    pt = tbounds.apply_bounds(sub_t, tl, lidx_t, gidx_t, D.shape[0], tau)
    assert np.array_equal(pt, pr)


def test_hashed_index_matches_reference():
    """k * bits > 64 switches both indexes to the hashed (verified) keys."""
    rng = np.random.default_rng(0)
    its = np.unique(np.sort(rng.integers(0, 2**20, size=(300, 4)), axis=1), axis=0).astype(np.int32)
    ti, ri = tsupport.ItemsetIndex(its), rsupport.ItemsetIndex(its)
    assert not ti.exact and not ri.exact
    q = np.concatenate([its[::3], its[::5] + 1])
    assert np.array_equal(ti.lookup(q), ri.lookup(q))


def test_oracle_matches_reference():
    D = rsynth.randomized_dataset(40, 4, d_low=2, d_high=4, seed=1)
    assert t_oracle(D, 2, 3) == r_oracle(D, 2, 3)
