"""Append-then-incremental-mine equals a cold mine of the concatenated
table, in the port (``repro_torch.service.incremental``), over the shapes and
regression cases of the reference's incremental tests; and the port's delta
mine reports what the reference's reports on the same base.

The port runs its seed expansion on the host (``numpy``) and through a
device placement over the store's resident bitsets (``torch`` on the CPU,
the plain PyTorch versions of the kernels).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro import service as ref_service
from repro.core import KyivConfig as RefConfig
from repro.core import mine as ref_mine
from repro_torch.core import KyivConfig, make_placement, mine
from repro_torch.service import DatasetStore, IncrementalConfig, ResultBands, delta_support, mine_incremental

table_st = st.tuples(
    st.integers(4, 36),  # base rows
    st.integers(1, 18),  # delta rows
    st.integers(2, 4),  # columns
    st.integers(2, 6),  # per-column domain
    st.integers(0, 10_000),  # seed
)

REGRESSIONS = [
    (30, 10, 3, 4, 7, 1, 3),
    (24, 12, 4, 3, 11, 2, 3),
    (36, 6, 3, 5, 3, 1, 2),
]


def _value_sets(result):
    return {(frozenset(ids), int(c)) for ids, c in result.as_value_sets()}


def _rebase(result, store):
    """Map a cold result's item ids onto the store's id space through
    (column, value): ids depend on assignment order."""
    table = store.item_table()
    id_of = {(int(table.col[i]), int(table.value[i])): i for i in range(table.n_items)}
    ref = result.prep.table
    remap = {i: id_of[(int(ref.col[i]), int(ref.value[i]))] for i in range(ref.n_items)}
    result.itemsets = [(tuple(sorted(remap[i] for i in ids)), c) for ids, c in result.itemsets]
    return result


def _tables(n, d, m, dom, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, dom, size=(n, m)), rng.integers(0, dom + 1, size=(d, m))


def _check(engine, n, d, m, dom, seed, tau, kmax):
    base, delta = _tables(n, d, m, dom, seed)
    cfg = KyivConfig(tau=tau, kmax=kmax, engine=engine, device="cpu")
    placement = make_placement(engine, device="cpu")
    store = DatasetStore.from_dataset(base, placement=placement)
    base_res = _rebase(mine(base, cfg), store)
    base_version = store.version
    store.append(delta)
    out = mine_incremental(
        store, base_res, base_version, cfg, IncrementalConfig(max_delta_fraction=1.0),
        placement=placement,
        resident_bits=store.device_bits() if placement.kind != "host" else None,
    )
    assert out is not None, "incremental path unexpectedly fell back"
    result, info = out
    cold = mine(np.concatenate([base, delta]), cfg)
    assert _value_sets(result) == _value_sets(cold), (
        f"incremental != cold for n={n} d={d} m={m} dom={dom} seed={seed} "
        f"tau={tau} kmax={kmax} info={info}"
    )
    return result, info


@settings(max_examples=60, deadline=None, derandomize=True)
@given(table_st, st.integers(1, 3), st.integers(2, 4))
def test_incremental_equals_cold_numpy(shape, tau, kmax):
    _check("numpy", *shape, tau, kmax)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(table_st, st.integers(1, 2), st.integers(2, 3))
def test_incremental_equals_cold_torch_resident(shape, tau, kmax):
    _check("torch", *shape, tau, kmax)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
@pytest.mark.parametrize("case", REGRESSIONS, ids=["absent-born", "promotions", "new-values"])
def test_incremental_regression_cases(engine, case):
    """Seeds that once exposed gaps in the reference (absent-born itemsets,
    promotions, new values), per engine."""
    _check(engine, *case)


@pytest.mark.parametrize("case", REGRESSIONS, ids=["absent-born", "promotions", "new-values"])
def test_incremental_info_matches_reference(case):
    """Same base, same delta: the port's delta mine takes the reference's
    steps (recounts, promotions, seeds, expansions, delta-born sets)."""
    n, d, m, dom, seed, tau, kmax = case
    base, delta = _tables(n, d, m, dom, seed)
    port_store = DatasetStore.from_dataset(base)
    ref_store = ref_service.DatasetStore.from_dataset(base)
    port_base = _rebase(mine(base, KyivConfig(tau=tau, kmax=kmax, engine="numpy")), port_store)
    ref_base = _rebase(ref_mine(base, RefConfig(tau=tau, kmax=kmax, engine="numpy")), ref_store)
    port_store.append(delta)
    ref_store.append(delta)
    inc = IncrementalConfig(max_delta_fraction=1.0)
    got = mine_incremental(port_store, port_base, 1, KyivConfig(tau=tau, kmax=kmax, engine="numpy"), inc)
    want = ref_service.mine_incremental(
        ref_store, ref_base, 1, RefConfig(tau=tau, kmax=kmax, engine="numpy"),
        ref_service.IncrementalConfig(max_delta_fraction=1.0),
    )
    assert got[1] == want[1]
    assert sorted(got[0].itemsets) == sorted(want[0].itemsets)


@pytest.mark.parametrize(
    "budget",
    [dict(max_delta_fraction=0.01), dict(expansion_budget=0), dict(enabled=False)],
    ids=["fraction", "expansion", "disabled"],
)
def test_incremental_falls_back(budget):
    """A delta past its fraction, an exhausted expansion budget or a
    disabled path signals a cold re-mine (None), as in the reference."""
    base, delta = _tables(30, 10, 3, 4, 7)
    store = DatasetStore.from_dataset(base)
    base_res = _rebase(mine(base, KyivConfig(tau=1, kmax=3, engine="numpy")), store)
    store.append(delta)
    cfg = IncrementalConfig(**{"max_delta_fraction": 1.0, **budget})
    assert mine_incremental(store, base_res, 1, KyivConfig(tau=1, kmax=3, engine="numpy"), cfg) is None


def test_result_bands_recount_matches_delta_support():
    base, delta = _tables(36, 12, 4, 3, 5)
    store = DatasetStore.from_dataset(base)
    res = _rebase(mine(base, KyivConfig(tau=2, kmax=3, engine="numpy")), store)
    store.append(delta)
    dbits, _ = store.delta_bits(1)
    dfreq = np.bitwise_count(dbits).sum(axis=1).astype(np.int64)
    new, stats = ResultBands.from_result(res.itemsets).recount(dbits, dfreq, 2, len(delta))
    sets = [ids for ids, _ in res.itemsets]
    want = np.asarray([c for _, c in res.itemsets]) + delta_support(dbits, sets)
    np.testing.assert_array_equal(new, want)
    assert stats["n_recounted"] + stats["n_recount_skipped"] == len(sets)


@pytest.mark.parametrize("chunk_bytes", [1 << 30, 64], ids=["one-chunk", "chunks-of-4-rows"])
@pytest.mark.parametrize("n_rows", [31, 33, 290], ids=["w1", "w2", "w10"])
def test_full_supports_on_resident_rows_equal_host(monkeypatch, chunk_bytes, n_rows):
    """The delta-born stage's full-width count on the device (the store's
    resident rows, padded word axis, partial ANDs kept there) equals the
    host count, for arities 2-4, in one chunk and in many."""
    from repro_torch.service import incremental as inc

    monkeypatch.setattr(inc, "_RESIDENT_CHUNK_BYTES", chunk_bytes)
    placement = make_placement("torch", device="cpu")
    store = DatasetStore.from_dataset(_tables(n_rows, 1, 4, 3, n_rows)[0], placement=placement)
    table = store.item_table()
    rng = np.random.default_rng(n_rows)
    for k in (2, 3, 4):
        mat = np.stack([rng.choice(table.n_items, size=k, replace=False) for _ in range(37)])
        got = inc._full_supports_resident(placement, store.device_bits(), mat, table.n_words)
        np.testing.assert_array_equal(got, inc._full_supports(table.bits, mat))


@pytest.mark.parametrize("case", REGRESSIONS, ids=["absent-born", "promotions", "new-values"])
def test_delta_born_on_the_device_equals_host(case):
    n, d, m, dom, seed, tau, kmax = case
    from repro_torch.service import incremental as inc

    base, delta = _tables(n, d, m, dom, seed)
    placement = make_placement("torch", device="cpu")
    store = DatasetStore.from_dataset(np.concatenate([base, delta]), placement=placement)
    table = store.item_table()
    dbits = inc._delta_bits_of(table, n)
    host = inc._delta_born(table, dbits, n, tau, kmax, 1 << 18)
    dev = inc._delta_born(table, dbits, n, tau, kmax, 1 << 18,
                          placement=placement, resident_bits=store.device_bits())
    assert dev == host
