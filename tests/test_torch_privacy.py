"""The port's privacy path on the CPU against the reference ``repro``:
record-risk profiles (all four per-record arrays and the summary),
quasi-identifier reports, the §1.1 grouping transform, the anonymization
planner (equal plans on the numpy engine, verified plans with the same
initial QIs on the torch engines) and the synthetic generators the privacy
runs use. Integer results are compared exactly; the float risk scores are
computed by the same numpy expression on the same counts and compared
exactly too."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import KyivConfig as RConfig
from repro.core import itemize as r_itemize
from repro.core import mine as r_mine
from repro.data import synth as rsynth
from repro.privacy import apply_plan as r_apply_plan
from repro.privacy import plan_anonymization as r_plan
from repro.privacy import risk_profile as r_risk_profile
from repro.privacy import strip_masked_items as r_strip
from repro.privacy.risk import risk_scores as r_risk_scores
from repro.sdc import quasi as rquasi
from repro_torch.core import DevicePlacement, HostPlacement, KyivConfig, itemize, mine
from repro_torch.data import synth
from repro_torch.privacy import (
    GENERALIZED,
    MASKED,
    AnonymizationPlan,
    RiskProfile,
    apply_plan,
    mine_masked,
    plan_anonymization,
    risk_profile,
    risk_scores,
    strip_masked_items,
)
from repro_torch.sdc import quasi as tquasi

ENGINES = [("numpy", "cpu"), ("torch", "cpu"), ("cuda", "cpu")]
ARRAYS = ("counts_by_size", "qi_count", "min_qi_size", "risk")


def _rand(seed, n, m, dom):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


TABLES = {
    "rand60": (_rand(11, 60, 4, 5), 1, 3),
    "rand150": (_rand(4, 150, 5, 6), 2, 3),
    "exposed": (synth.exposed_dataset(n=2000, seed=3), 1, 3),
    "wide_k4": (_rand(8, 90, 6, 4), 1, 4),
}


def _same_profile(got: RiskProfile, want) -> None:
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (got.n_rows, got.tau, got.kmax) == (want.n_rows, want.tau, want.kmax)
    assert got.summary() == want.summary()
    assert got.top_records(25) == want.top_records(25)


def test_risk_scores_match_reference():
    rng = np.random.default_rng(0)
    for kmax in (1, 2, 3, 5):
        counts = rng.integers(0, 4, size=(kmax, 300)) * (rng.random((kmax, 300)) < 0.3)
        assert np.array_equal(risk_scores(counts), r_risk_scores(counts))
    counts = np.array([[1, 0, 0, 0], [0, 1, 0, 2], [0, 0, 1, 0]])
    assert np.array_equal(risk_scores(counts), r_risk_scores(counts))


@pytest.mark.parametrize("engine,device", ENGINES)
@pytest.mark.parametrize("table", sorted(TABLES))
def test_risk_profile_matches_reference(engine, device, table):
    D, tau, kmax = TABLES[table]
    ref = r_risk_profile(r_mine(D, RConfig(tau=tau, kmax=kmax)))
    res = mine(D, KyivConfig(tau=tau, kmax=kmax, engine=engine, device=device))
    assert res.itemsets
    # the default placement is the mine's own; the host and plain-version
    # placements, with small batches that split and pad, agree with it
    _same_profile(risk_profile(res), ref)
    for placement in (HostPlacement(), DevicePlacement("torch", device="cpu")):
        _same_profile(risk_profile(res, placement=placement, max_batch_sets=16), ref)


@pytest.mark.parametrize("engine,device", ENGINES)
def test_risk_profile_empty_result(engine, device):
    D = np.tile(np.array([[1, 2], [1, 2]]), (5, 1))  # every item frequent
    res = mine(D, KyivConfig(tau=1, kmax=2, engine=engine, device=device))
    prof = risk_profile(res)
    _same_profile(prof, r_risk_profile(r_mine(D, RConfig(tau=1, kmax=2))))
    assert prof.records_at_risk == 0 and prof.top_records() == []


@pytest.mark.parametrize("engine,device", ENGINES)
@pytest.mark.parametrize("table", sorted(TABLES))
def test_quasi_report_matches_reference(engine, device, table):
    D, tau, kmax = TABLES[table]
    want = rquasi.find_quasi_identifiers(D, tau, kmax)
    got = tquasi.find_quasi_identifiers(D, tau, kmax, engine=engine, device=device)
    assert got.result.config.engine == engine
    assert sorted(got.result.itemsets) == sorted(want.result.itemsets)
    assert got.n_quasi_identifiers == want.n_quasi_identifiers
    assert got.by_size() == want.by_size()
    assert got.risky_columns() == want.risky_columns()
    assert got.unique_records() == want.unique_records()
    assert json.dumps(tquasi.report_as_dict(got, top=7)) == json.dumps(rquasi.report_as_dict(want, top=7))
    assert json.dumps(tquasi.report_as_dict(got)) == json.dumps(rquasi.report_as_dict(want))


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 5), (4, 20)])
def test_k_anonymize_columns_matches_reference(seed, k):
    D = _rand(seed, 200, 5, 40)
    got = tquasi.k_anonymize_columns(D, k=k, seed=seed)
    assert np.array_equal(got, rquasi.k_anonymize_columns(D, k=k, seed=seed))


# -- the planner -----------------------------------------------------------------

PLAN_CASES = [
    (0, 60, 4, 5, 1, 3),
    (1, 120, 5, 6, 1, 3),
    (2, 80, 4, 4, 2, 3),
    (3, 40, 3, 8, 1, 2),  # wide domain: many singleton QIs
]


def _check_verified(D, plan, tau, kmax, engine, device):
    assert plan.verified and plan.residual_qis == 0
    post = mine_masked(apply_plan(D, plan), KyivConfig(tau=tau, kmax=kmax, engine=engine, device=device))
    assert post is None or len(post.itemsets) == 0


@pytest.mark.parametrize("seed,n,m,dom,tau,kmax", PLAN_CASES)
def test_planner_numpy_engine_equals_reference(seed, n, m, dom, tau, kmax):
    D = _rand(seed, n, m, dom)
    want = r_plan(D, tau=tau, kmax=kmax)
    got = plan_anonymization(D, tau=tau, kmax=kmax, config=KyivConfig(engine="numpy"))
    assert got.as_dict(max_suppressions=None) == want.as_dict(max_suppressions=None)
    assert got.suppressions == want.suppressions
    assert np.array_equal(apply_plan(D, got), r_apply_plan(D, want))
    _check_verified(D, got, tau, kmax, "numpy", "cpu")


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("seed,n,m,dom,tau,kmax", PLAN_CASES)
def test_planner_torch_engines_verified(engine, seed, n, m, dom, tau, kmax):
    """The greedy breaks ties by QI order, so an engine that lists the same
    QIs in another order may give another, equally verified plan. Where the
    first mine's order agrees with the numpy engine's, the plan must equal
    the reference's."""
    D = _rand(seed, n, m, dom)
    want = r_plan(D, tau=tau, kmax=kmax)
    cfg = KyivConfig(engine=engine, device="cpu")
    got = plan_anonymization(D, tau=tau, kmax=kmax, config=cfg)
    assert got.initial_qis == want.initial_qis
    _check_verified(D, got, tau, kmax, engine, "cpu")
    first = mine(D, KyivConfig(tau=tau, kmax=kmax, engine=engine, device="cpu"))
    if first.itemsets == mine(D, KyivConfig(tau=tau, kmax=kmax, engine="numpy")).itemsets:
        assert got.as_dict(max_suppressions=None) == want.as_dict(max_suppressions=None)


# PLAN_CASES and 16 random 100 x 5 tables (domain 5, tau 1, kmax 3)
PARITY_CASES = PLAN_CASES + [(100 + s, 100, 5, 5, 1, 3) for s in range(16)]
_REF_PLANS: dict = {}


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("seed,n,m,dom,tau,kmax", PARITY_CASES)
def test_planner_torch_engines_equal_reference(engine, seed, n, m, dom, tau, kmax):
    """The torch and cuda engines' plans equal the reference's, with no
    condition on the first mine's QI order."""
    D = _rand(seed, n, m, dom)
    key = (seed, n, m, dom, tau, kmax)
    if key not in _REF_PLANS:
        _REF_PLANS[key] = r_plan(D, tau=tau, kmax=kmax)
    want = _REF_PLANS[key]
    got = plan_anonymization(D, tau=tau, kmax=kmax, config=KyivConfig(engine=engine, device="cpu"))
    assert got.as_dict(max_suppressions=None) == want.as_dict(max_suppressions=None)
    assert got.suppressions == want.suppressions
    assert np.array_equal(apply_plan(D, got), r_apply_plan(D, want))


@pytest.mark.parametrize("engine,device", ENGINES)
def test_planner_on_exposed_table(engine, device):
    D = synth.exposed_dataset(n=400, seed=0)
    want = r_plan(D, tau=1, kmax=3)
    got = plan_anonymization(D, 1, 3, config=KyivConfig(engine=engine, device=device))
    assert got.initial_qis == want.initial_qis and got.initial_qis > 0
    _check_verified(D, got, 1, 3, engine, device)
    if engine == "numpy":
        assert got.as_dict(None) == want.as_dict(None)


def test_planner_base_result_and_generalize_cost_match_reference():
    D = _rand(7, 70, 4, 5)
    base = mine(D, KyivConfig(tau=1, kmax=3, engine="numpy"))
    got = plan_anonymization(D, 1, 3, config=KyivConfig(engine="numpy"), base_result=base,
                             generalize_cost=3.0, max_rounds=4)
    want = r_plan(D, 1, 3, base_result=r_mine(D, RConfig(tau=1, kmax=3)), generalize_cost=3.0,
                  max_rounds=4)
    assert got.as_dict(None) == want.as_dict(None)
    assert got.verified and got.generalized_columns


def test_planner_noop_on_safe_table():
    D = np.tile(np.array([[1, 5], [2, 6]]), (10, 1))  # all supports = 10 > tau
    plan = plan_anonymization(D, tau=1, kmax=2, config=KyivConfig(engine="torch", device="cpu"))
    assert plan.verified and plan.initial_qis == 0
    assert plan.suppressions == [] and plan.generalized_columns == []
    assert np.array_equal(apply_plan(D, plan), D)
    assert plan.as_dict() == r_plan(D, tau=1, kmax=2).as_dict()


@pytest.mark.parametrize("engine,device", ENGINES)
def test_planner_degenerate_tiny_table(engine, device):
    D = np.array([[1, 2, 3]])  # n_rows <= tau: only full suppression works
    cfg = KyivConfig(engine=engine, device=device)
    plan = plan_anonymization(D, tau=1, kmax=2, config=cfg)
    assert plan.verified
    assert sorted(plan.suppressions) == [(0, 0), (0, 1), (0, 2)]
    assert mine_masked(apply_plan(D, plan), dataclasses.replace(cfg, tau=1, kmax=2)) is None
    assert plan.as_dict() == r_plan(D, tau=1, kmax=2).as_dict()


def test_planner_rejects_sentinel_values():
    for bad in (MASKED, GENERALIZED):
        with pytest.raises(ValueError, match="sentinel"):
            plan_anonymization(np.array([[bad, 1]]), tau=1, config=KyivConfig(engine="numpy"))


def test_planner_empty_shapes():
    for shape in ((0, 3), (5, 0)):
        plan = plan_anonymization(np.empty(shape, dtype=np.int64), tau=1)
        assert isinstance(plan, AnonymizationPlan)
        assert plan.verified and plan.suppressions == [] and plan.rounds == 0
        assert plan.as_dict() == r_plan(np.empty(shape, dtype=np.int64), tau=1).as_dict()


def test_itemize_takes_sentinels_and_strip_matches_reference():
    """``itemize`` orders the int64-minimum sentinels first in a column, as
    the reference does; stripping MASKED leaves GENERALIZED as one frequent
    item."""
    D = _rand(5, 30, 3, 4)
    masked = D.copy().astype(np.int64)
    masked[0, 0] = MASKED
    masked[[3, 9], 1] = MASKED
    masked[:, 2] = GENERALIZED
    full = itemize(masked)
    assert full.value[0] == MASKED and full.col[0] == 0
    table, want = strip_masked_items(full), r_strip(r_itemize(masked))
    for name in ("value", "col", "freq", "min_row", "bits"):
        assert np.array_equal(getattr(table, name), getattr(want, name)), name
    assert (table.n_rows, table.n_cols, table.n_words) == (want.n_rows, want.n_cols, want.n_words)
    assert not (table.value == MASKED).any()
    gen_items = np.nonzero(table.value == GENERALIZED)[0]
    assert len(gen_items) == 1 and table.freq[gen_items[0]] == 30
    clean = itemize(D)
    assert strip_masked_items(clean) is clean
    every = np.full((4, 2), MASKED, dtype=np.int64)
    assert mine_masked(every, KyivConfig(engine="numpy")) is None


def test_apply_plan_matches_planner_final_state():
    D = _rand(9, 50, 4, 5)
    plan = plan_anonymization(D, tau=1, kmax=3, config=KyivConfig(engine="torch", device="cpu"))
    masked = apply_plan(D, plan)
    for r, c in plan.suppressions:
        assert masked[r, c] in (MASKED, GENERALIZED)
    for c in plan.generalized_columns:
        assert (masked[:, c] == GENERALIZED).all()
    untouched = np.ones_like(D, dtype=bool)
    if plan.suppressions:
        rows, cols = zip(*plan.suppressions)
        untouched[list(rows), list(cols)] = False
    untouched[:, plan.generalized_columns] = False
    assert np.array_equal(masked[untouched], D.astype(np.int64)[untouched])


def test_default_config_runs_on_the_card():
    """Without a card the default engine raises rather than fall back."""
    D = _rand(1, 20, 3, 4)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_anonymization(D, tau=1, kmax=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tquasi.find_quasi_identifiers(D, 1, 2)


# -- generators --------------------------------------------------------------------


@pytest.mark.parametrize(
    "name,kw",
    [
        ("exposed_dataset", dict(n=5000, seed=0)),
        ("exposed_dataset", dict(n=777, m=4, base_domain=3, exposed_frac=0.3, seed=9)),
        ("exposed_dataset", dict(n=50, m=2, seed=1)),  # m < 3: no planted rows
        ("pumsb_like", dict(n=3000, seed=0)),
        ("pumsb_like", dict(n=500, m=10, seed=4)),
    ],
)
def test_generators_match_reference(name, kw):
    got, want = getattr(synth, name)(**kw), getattr(rsynth, name)(**kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_dataset_registry_matches_reference():
    assert sorted(synth.DATASETS) == sorted(rsynth.DATASETS)
