"""The port's sampled-mining fast path (``repro_torch.sampling``) held
against the reference's (``repro.sampling``): the sampler's bound, seeds,
rows and sampled bitsets, the confidence classifier, the exact boundary
recount and the buckets it binds, and approximate mines that refine to the
exact answer — including the case where the sample is the whole table."""

import itertools

import numpy as np
import pytest
from hypothesis import example, given, settings, strategies as st

from repro import sampling as ref_sampling
from repro.core import itemize as ref_itemize
from repro_torch.core import KyivConfig, exec_cache, itemize, make_placement, mine
from repro_torch.kernels.intersect import next_bucket
from repro_torch.sampling import (
    SamplingConfig,
    build_sample,
    classify_counts,
    derive_seed,
    gather_sample_bits,
    recount_supports,
    sample_item_table,
    sample_rows,
    sample_size,
    scaled_tau,
)
from repro_torch.service import KillPoint, MiningService

SMALL = SamplingConfig(oversample=0.5, min_rows=32)
REF_SMALL = ref_sampling.SamplingConfig(oversample=0.5, min_rows=32)


def _rand(seed, n, m, dom):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


def _canonical(result):
    return sorted((tuple(sorted(ids)), int(c)) for ids, c in result.itemsets)


# ---------------------------------------------------------------------------
# the sampler against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,m,eps", [(10**6, 8, 0.1), (100, 8, 0.1), (10**6, 2, 0.9), (10**9, 16, 0.05), (1_010_000, 10, 0.1)]
)
def test_sample_size_matches_reference(n, m, eps):
    for cfg, ref_cfg in ((None, None), (SMALL, REF_SMALL)):
        assert sample_size(n, m, eps, config=cfg) == ref_sampling.sample_size(n, m, eps, config=ref_cfg)


@pytest.mark.parametrize("version,eps,seed", [(1, 0.1, 0), (3, 0.05, 0), (3, 0.1, 7), (99, 0.5, 2)])
def test_derive_seed_and_rows_match_reference(version, eps, seed):
    s = derive_seed(version, eps, seed)
    assert s == ref_sampling.derive_seed(version, eps, seed)
    np.testing.assert_array_equal(sample_rows(1000, 100, s), ref_sampling.sample_rows(1000, 100, s))
    np.testing.assert_array_equal(sample_rows(50, 80, s), np.arange(50))


@pytest.mark.parametrize("word_tile", [1, 2, 4])
def test_sample_item_table_matches_reference(word_tile):
    data = _rand(2, 333, 4, 5)
    table, ref_table = itemize(data), ref_itemize(data)
    rows = sample_rows(333, 100, seed=3)
    got = sample_item_table(table, rows, word_tile=word_tile)
    want = ref_sampling.sample_item_table(ref_table, rows, word_tile=word_tile)
    for f in ("bits", "freq", "min_row", "value", "col"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.n_rows, got.n_words) == (want.n_rows, want.n_words)
    assert got.n_words % word_tile == 0
    # the sampled bits are the full table's bits at the sampled rows
    full = np.unpackbits(table.bits.view(np.uint8), axis=1, bitorder="little")[:, :333]
    got_bits = np.unpackbits(got.bits.view(np.uint8), axis=1, bitorder="little")
    np.testing.assert_array_equal(got_bits[:, : len(rows)], full[:, rows])
    assert not got_bits[:, len(rows):].any()
    assert gather_sample_bits(table.bits, np.array([], dtype=np.int64)).shape == (table.n_items, 1)


@pytest.mark.parametrize(
    "counts,tau,eps,n,s",
    [([0, 1, 2], 10, 0.1, 1000, 100), ([3, 11], 10, 0.1, 100, 100), ([0, 1, 5, 9], 2, 0.3, 4000, 333)],
)
def test_scaled_tau_and_classifier_match_reference(counts, tau, eps, n, s):
    assert scaled_tau(tau, eps, n, s) == ref_sampling.scaled_tau(tau, eps, n, s)
    got = classify_counts(np.array(counts), tau=tau, epsilon=eps, n_rows=n, n_sample=s)
    want = ref_sampling.classify_counts(np.array(counts), tau=tau, epsilon=eps, n_rows=n, n_sample=s)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_build_sample_matches_reference():
    data = _rand(3, 400, 4, 5)
    got = build_sample(itemize(data), version=1, tau=2, epsilon=0.1, config=SMALL, word_tile=4)
    want = ref_sampling.build_sample(ref_itemize(data), version=1, tau=2, epsilon=0.1,
                                     config=REF_SMALL, word_tile=4)
    assert (got.seed, got.tau_sample, got.scale, got.n_rows_full) == (
        want.seed, want.tau_sample, want.scale, want.n_rows_full)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.table.bits, want.table.bits)
    assert 0 < got.rows.shape[0] < 400


# ---------------------------------------------------------------------------
# exact boundary recount
# ---------------------------------------------------------------------------


def _boundary_sets(table, per_pair=3):
    per_col = {}
    for i in range(table.n_items):
        per_col.setdefault(int(table.col[i]), []).append(i)
    cols = sorted(per_col)
    pairs = [(a, b) for a in per_col[cols[0]][:per_pair] for b in per_col[cols[1]][:per_pair]]
    triples = [(a, b, c) for a, b in pairs for c in per_col[cols[2]][:2]]
    return pairs + triples + [(per_col[cols[3]][0],)]


def _brute(table, itemsets):
    return np.array([int(np.bitwise_count(np.bitwise_and.reduce(table.bits[list(ids)], axis=0)).sum())
                     for ids in itemsets], dtype=np.int64)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_recount_supports_matches_reference_and_bruteforce(engine):
    data = _rand(4, 150, 4, 4)
    table = itemize(data)
    sets = _boundary_sets(table)
    counts, info = recount_supports(table, sets, placement=make_placement(engine, device="cpu"), tau=2)
    np.testing.assert_array_equal(counts, _brute(table, sets))
    ref_counts, ref_info = ref_sampling.recount_supports(
        ref_itemize(data), sets, placement=_ref_host(), tau=2)
    np.testing.assert_array_equal(counts, ref_counts)
    assert info["recounted"] == ref_info["recounted"] == len(sets)
    assert info["dispatches"] == ref_info["dispatches"]


def _ref_host():
    from repro.core.placement import HostPlacement

    return HostPlacement()


def test_recount_reuses_warm_buckets_on_device():
    """The port's meaning of warm: a bucket is warm once its dispatch was
    bound in this process (``core.exec_cache``: a miss is the first binding,
    not a compile). A recount dispatches each batch at its own power-of-two
    bucket, never a larger warm one; a second identical recount binds
    nothing new."""
    exec_cache.reset("intersect")
    placement = make_placement("torch", device="cpu")
    table = itemize(_rand(6, 120, 8, 8))
    wide = list(itertools.combinations(range(table.n_items), 2))[:300]
    sets = wide[:4]
    counts, _ = recount_supports(table, wide, placement=placement, tau=2)
    np.testing.assert_array_equal(counts, _brute(table, wide))
    assert _bound_buckets() == {next_bucket(len(wide))} == {512}
    before = exec_cache.stats()["families"]["intersect"]
    _, first = recount_supports(table, sets, placement=placement, tau=2)
    after = exec_cache.stats()["families"]["intersect"]
    assert first["dispatches"] == 1
    assert _bound_buckets() == {512, next_bucket(len(sets))}  # not padded up to 512
    assert after["misses"] == before["misses"] + 1
    _, second = recount_supports(table, sets, placement=placement, tau=2)
    again = exec_cache.stats()["families"]["intersect"]
    assert second["dispatches"] == 1
    assert again["entries"] == after["entries"] and again["misses"] == after["misses"]
    assert again["hits"] == after["hits"] + 1


def _bound_buckets() -> set:
    from repro_torch.kernels.intersect import ops

    return {key[5] for key in ops.EXEC_CACHE.keys()}


def test_recount_empty_is_noop():
    counts, info = recount_supports(itemize(_rand(5, 60, 3, 4)), [],
                                    placement=make_placement("numpy"), tau=1)
    assert counts.shape == (0,) and info["dispatches"] == 0


# ---------------------------------------------------------------------------
# approximate mines refine to the exact answer
# ---------------------------------------------------------------------------


table_st = st.tuples(
    st.integers(120, 400),  # rows
    st.integers(3, 5),  # columns
    st.integers(3, 6),  # per-column domain
    st.integers(1, 4),  # tau
    st.integers(2, 4),  # kmax
    st.integers(0, 10_000),  # seed
    st.sampled_from([0.05, 0.1, 0.3, 0.5]),  # epsilon
)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
@settings(max_examples=6, deadline=None, derandomize=True)
@given(table_st)
@example((400, 5, 6, 2, 3, 17, 0.3))  # strictly subsampled: a real boundary band
@example((120, 4, 4, 1, 3, 5, 0.05))  # the sample is the whole table
def test_refinement_converges_to_cold_mine(engine, params):
    n, m, dom, tau, kmax, seed, eps = params
    data = np.random.default_rng(seed).integers(0, dom, size=(n, m))
    cold = mine(data, KyivConfig(tau=tau, kmax=kmax, engine="numpy"))
    svc = MiningService.from_dataset(data, engine=engine, device="cpu", sampling=SMALL)
    r = svc.mine(tau=tau, kmax=kmax, mode="approx", epsilon=eps)
    assert r.source == "approx" and r.info["epsilon"] == eps
    assert 0.0 <= r.info["confidence"] <= 1.0
    assert svc.scheduler.drain(timeout=300)["abandoned"] == 0
    refined = svc.mine(tau=tau, kmax=kmax, mode="approx", epsilon=eps)
    assert refined.info["refined"] is True and refined.info["confidence"] == 1.0
    assert _canonical(refined.result) == _canonical(cold)
    exact = svc.mine(tau=tau, kmax=kmax)
    assert exact.source == "cache" and _canonical(exact.result) == _canonical(cold)
    svc.close()


@pytest.mark.parametrize(
    "n,eps,whole",
    [(120, 0.05, True), (60, 0.1, True), (400, 0.3, False), (900, 0.1, False)],
    ids=["whole-120-0.05", "whole-60-0.1", "sub-400-0.3", "sub-900-0.1"],
)
def test_killed_promotion(n, eps, whole):
    """The promotion to the exact answer dies (a ``KillPoint`` in its exact
    mine). When the sample is the whole table (a 120-row table at ε = 0.05
    under this config: the bound asks for 140 rows), the approximate answer already is the exact one —
    unscaled counts, an empty boundary band, confidence 1 — so the kill
    loses nothing. When the table is subsampled, the fast answer survives
    unpromoted, and a later exact request still gets the cold answer."""
    data = _rand(13, n, 4, 4)
    tau, kmax = 1, 3
    cold = _canonical(mine(data, KyivConfig(tau=tau, kmax=kmax, engine="numpy")))
    svc = MiningService.from_dataset(data, engine="torch", device="cpu", sampling=SMALL)
    assert (sample_size(n, 4, eps, config=SMALL) == n) is whole

    def killed(key, table, control=None):
        raise KillPoint("mid-promotion")

    svc._compute = killed
    r = svc.mine(tau=tau, kmax=kmax, mode="approx", epsilon=eps)
    assert r.source == "approx"
    svc.scheduler.drain(timeout=300)
    assert svc.stats()["sampling"]["refine_failures"] == 1
    del svc._compute
    after = svc.mine(tau=tau, kmax=kmax, mode="approx", epsilon=eps)
    assert after.source == "cache" and after.info.get("promoted") is None
    if whole:
        assert r.info["sample_rows"] == n and r.info["tau_sample"] == tau
        assert r.info["boundary_count"] == 0 and r.info["confidence"] == 1.0
        assert _canonical(r.result) == cold == _canonical(after.result)
    else:
        assert r.info["sample_rows"] < n
    exact = svc.mine(tau=tau, kmax=kmax)
    assert exact.source == "cold" and _canonical(exact.result) == cold
    svc.close()


def _level_boundaries(data, tau, kmax):
    """How many level checkpoints a cold mine of ``data`` saves: the
    ``mine.level_end`` checks a promotion's exact mine makes."""
    from repro_torch.core import prepare
    from repro_torch.core.kyiv import mine_preprocessed

    cfg = KyivConfig(tau=tau, kmax=kmax, engine="numpy")
    seen = []
    mine_preprocessed(prepare(data, cfg), cfg, on_level_end=lambda level, state: seen.append(level))
    return len(seen)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
@settings(max_examples=6, deadline=None, derandomize=True)
@given(table_st, st.integers(1, 2))
@example((400, 5, 6, 2, 3, 17, 0.3), 1)  # strictly subsampled: the kill lands mid-promotion
@example((120, 4, 4, 1, 3, 5, 0.05), 2)  # the sample is the whole table
# the whole table again, but three columns: the mine saves two checkpoints,
# so the kill armed after two never fires (the reference's flaky case)
@example((120, 3, 4, 4, 2, 2, 0.05), 2)
def test_killed_refinement_converges_after_restart(engine, params, kill_after):
    """The promotion's exact mine dies at its ``kill_after``-th level
    checkpoint; a service rebuilt over the same ``wal_dir`` resumes the job
    and converges to the cold mine. Whether the kill fires is decided by the
    table, not sampled: a mine that saves no more than ``kill_after``
    checkpoints (the whole-table example's) completes its promotion, and the
    restart then has nothing to resume."""
    import shutil
    import tempfile

    from repro_torch.service import FaultInjector

    n, m, dom, tau, kmax, seed, eps = params
    kmax = max(kmax, kill_after + 2)  # deep enough to die mid-promotion
    data = np.random.default_rng(seed).integers(0, dom, size=(n, m))
    undisturbed = _canonical(mine(data, KyivConfig(tau=tau, kmax=kmax, engine="numpy")))
    fires = _level_boundaries(data, tau, kmax) > kill_after

    d = tempfile.mkdtemp(prefix="sampling-chaos-")
    try:
        inj = FaultInjector()
        svc = MiningService(engine=engine, device="cpu", wal_dir=d,
                            fault_injector=inj, sampling=SMALL)
        svc.append(data)
        inj.arm("mine.level_end", action="raise",
                exc=KillPoint("mid-refine"), after=kill_after)
        r = svc.mine(tau=tau, kmax=kmax, mode="approx", epsilon=eps)
        assert r.source == "approx"
        svc.scheduler.drain(timeout=300)
        # the promotion died; the fast answer survived, unpromoted
        assert svc.stats()["sampling"]["refine_failures"] == int(fires)
        svc.close()

        svc2 = MiningService(engine=engine, device="cpu", wal_dir=d, sampling=SMALL)
        assert svc2.stats()["durability"]["resumed_jobs"] == int(fires)
        exact = svc2.mine(tau=tau, kmax=kmax)
        assert _canonical(exact.result) == undisturbed
        if fires:
            assert exact.info["resumed_from_level"] == kill_after + 3
        approx = svc2.mine(tau=tau, kmax=kmax, mode="approx", epsilon=eps)
        assert approx.info["confidence"] == 1.0
        assert _canonical(approx.result) == undisturbed
        svc2.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_mode_and_epsilon_validation():
    svc = MiningService.from_dataset(_rand(11, 50, 3, 4), engine="numpy")
    with pytest.raises(ValueError):
        svc.mine(tau=1, kmax=2, mode="fuzzy")
    for eps in (0.0, 1.5):
        with pytest.raises(ValueError):
            svc.mine(tau=1, kmax=2, mode="approx", epsilon=eps)
    svc.close()
