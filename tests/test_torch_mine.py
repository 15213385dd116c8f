"""The port's ``mine`` end to end on the CPU against the reference
``repro.core.mine``: itemsets and per-level stat tuples identical across
orderings, expansions (with mirror items), bounds, thresholds, the device
and host frontier paths and the unfused classify; a reference checkpoint
resumed in the port; the launcher. Integer ops: equality is exact."""

import json

import numpy as np
import pytest

from repro.core import KyivConfig as RConfig
from repro.core import itemize as r_itemize
from repro.core import mine as r_mine
from repro.core import preprocess as r_preprocess
from repro.core.kyiv import mine_preprocessed as r_mine_preprocessed
from repro_torch import convert
from repro_torch.core import KyivConfig, RunControl, itemize, mine, preprocess
from repro_torch.core.kyiv import mine_preprocessed
from repro_torch.launch import mine as launch_mine

RNG = np.random.default_rng(2024)
BASE = RNG.integers(0, 5, size=(220, 7))
MIRRORS = np.concatenate([BASE[:120, :4], BASE[:120, :2]], axis=1)  # duplicate columns


def tup(s):
    return (s.k, s.candidates, s.support_pruned, s.bound_pruned,
            s.intersections, s.emitted, s.skipped_absent_uniform, s.stored)


def _assert_same(got, want, *, level_bytes=True):
    assert sorted(got.itemsets) == sorted(want.itemsets)
    assert list(map(tup, got.stats)) == list(map(tup, want.stats))
    if level_bytes:
        assert [s.level_bytes for s in got.stats] == [s.level_bytes for s in want.stats]


def _ref(D, **kw):
    return r_mine(D, RConfig(engine="numpy", **kw))


ENGINES = [("torch", "cpu"), ("cuda", "cpu"), ("numpy", "cpu")]


@pytest.mark.parametrize("engine,device", ENGINES)
@pytest.mark.parametrize("ordering", ["ascending", "descending", "random"])
@pytest.mark.parametrize("tau,kmax", [(1, 3), (2, 4)])
def test_orderings_thresholds(engine, device, ordering, tau, kmax):
    kw = dict(tau=tau, kmax=kmax, ordering=ordering, seed=3)
    got = mine(BASE, KyivConfig(engine=engine, device=device, **kw))
    _assert_same(got, _ref(BASE, **kw))


@pytest.mark.parametrize("engine,device", ENGINES)
@pytest.mark.parametrize("expansion", ["full", "paper"])
@pytest.mark.parametrize("use_bounds", [True, False])
def test_mirrors_expansion_bounds(engine, device, expansion, use_bounds):
    kw = dict(tau=1, kmax=3, expansion=expansion, use_bounds=use_bounds)
    got = mine(MIRRORS, KyivConfig(engine=engine, device=device, **kw))
    want = _ref(MIRRORS, **kw)
    assert want.prep.mirror_of
    _assert_same(got, want)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize(
    "flags",
    [
        dict(device_frontier=False),
        dict(fused_classify=False),
        dict(use_bounds=False),
        dict(double_buffer=False, locality_sort=False),
        dict(max_pairs_per_chunk=64),  # many batches per level
    ],
)
@pytest.mark.parametrize("tau,kmax", [(2, 4), (3, 3)])
def test_paths_and_flags(engine, flags, tau, kmax):
    got = mine(BASE, KyivConfig(tau=tau, kmax=kmax, engine=engine, device="cpu", **flags))
    _assert_same(got, _ref(BASE, tau=tau, kmax=kmax, **flags))


@pytest.mark.parametrize("tau,kmax,use_bounds", [(1, 3, True), (2, 4, False)])
def test_against_pallas_engine(tau, kmax, use_bounds):
    """The reference's Pallas kernels in interpret mode (small n: slow)."""
    D = BASE[:150, :6]
    kw = dict(tau=tau, kmax=kmax, use_bounds=use_bounds)
    want = r_mine(D, RConfig(engine="pallas", **kw))
    _assert_same(mine(D, KyivConfig(engine="cuda", device="cpu", **kw)), want)


def test_synth_table():
    from repro.data.synth import poker_like

    D = poker_like(n=2000, seed=5)[:, :6]
    _assert_same(mine(D, KyivConfig(tau=1, kmax=3, engine="torch", device="cpu")),
                 _ref(D, tau=1, kmax=3))


class _Stop(Exception):
    pass


def _ref_checkpoint(D, cfg, kill_at):
    saved = {}

    def hook(k, state):
        if k == kill_at:
            saved["state"] = state
            raise _Stop

    prep = r_preprocess(r_itemize(D), cfg.tau)
    with pytest.raises(_Stop):
        r_mine_preprocessed(prep, cfg, on_level_end=hook)
    return saved["state"]


@pytest.mark.parametrize("engine", ["torch", "cuda", "numpy"])
@pytest.mark.parametrize("kill_at", [2, 3])
def test_resume_reference_checkpoint(engine, kill_at):
    """A run checkpointed by the reference (its device frontier, jnp
    engine) resumes in the port and computes the same thing."""
    rcfg = RConfig(tau=2, kmax=4, engine="jnp")
    full = r_mine(BASE, RConfig(tau=2, kmax=4, engine="numpy"))
    d = convert.state_to_numpy(_ref_checkpoint(BASE, rcfg, kill_at))
    assert d["next_k"] == kill_at + 1 and d["level"]["bits"].dtype == np.uint32
    prep = preprocess(itemize(BASE), 2)
    got = mine_preprocessed(prep, KyivConfig(tau=2, kmax=4, engine=engine, device="cpu"),
                            resume_state=convert.state_from_numpy(d))
    _assert_same(got, full, level_bytes=False)


@pytest.mark.parametrize("kill_at", [2, 3])
def test_port_checkpoint_round_trip(kill_at):
    """The port's own level checkpoint: host uint32 bits with the word
    padding stripped, unchanged through the numpy form, and resumable."""
    cfg = KyivConfig(tau=2, kmax=4, engine="cuda", device="cpu")
    prep = preprocess(itemize(BASE), 2)
    full = mine_preprocessed(prep, cfg)
    saved = {}

    def hook(k, state):
        assert state.level.bits.dtype == np.uint32
        assert state.level.bits.shape[1] == prep.l_bits.shape[1]
        if k == kill_at:
            saved["state"] = state
            raise _Stop

    with pytest.raises(_Stop):
        mine_preprocessed(prep, cfg, on_level_end=hook)
    d = convert.state_to_numpy(saved["state"])
    again = convert.state_to_numpy(convert.state_from_numpy(d))
    assert again["results"] == d["results"] and again["stats"] == d["stats"]
    assert again["next_k"] == d["next_k"]
    for part in ("level", "grandparent"):
        for key, val in d[part].items():
            assert np.array_equal(again[part][key], val), (part, key)
    resumed = mine_preprocessed(prep, cfg, resume_state=convert.state_from_numpy(d))
    _assert_same(resumed, full, level_bytes=False)


def test_cancelled_run_returns_partial_result():
    control = RunControl()
    control.cancel()
    prep = preprocess(itemize(BASE), 1)
    res = mine_preprocessed(prep, KyivConfig(tau=1, kmax=3, engine="torch", device="cpu"),
                            control=control)
    assert res.interrupted == "cancelled" and not res.completed


def test_default_mine_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mine(BASE)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_mine.main(["--n", "50"])


def test_launcher_writes_results(tmp_path, capsys):
    out = tmp_path / "out.json"
    launch_mine.main(["--n", "300", "--m", "6", "--kmax", "3", "--engine", "torch",
                      "--device", "cpu", "--out", str(out)])
    assert "minimal tau-infrequent itemsets" in capsys.readouterr().out
    got = json.loads(out.read_text())
    from repro.data.synth import randomized_dataset

    want = _ref(randomized_dataset(300, 6, seed=0), tau=1, kmax=3)
    assert sorted((tuple(r["items"]), r["count"]) for r in got["itemsets"]) == sorted(want.itemsets)


def test_mine_records_spans_and_metrics():
    from repro_torch.obs import TRACER, metrics

    runs = metrics.counter("repro_mine_runs_total", "Mining runs by terminal status.", ("status",))
    before = runs.value(status="ok")
    res = mine(BASE, KyivConfig(tau=1, kmax=3, engine="torch", device="cpu"))
    trace = TRACER.last(1)[0]
    assert trace.name == "mine"
    assert len(trace.find("mine.level")) == len(res.stats) - 1
    assert trace.find("intersect.dispatch")
    assert runs.value(status="ok") == before + 1
    assert "repro_mine_level_seconds" in metrics.snapshot()


def test_fault_hook_sees_every_device_dispatch():
    from repro_torch.core.placement import set_fault_hook

    sites = []
    prev = set_fault_hook(sites.append)
    try:
        mine(BASE, KyivConfig(tau=1, kmax=3, engine="torch", device="cpu"))
        assert {"dispatch", "frontier"} <= set(sites)
        sites.clear()
        mine(BASE, KyivConfig(tau=1, kmax=3, engine="numpy"))
        assert sites == [], "host dispatch stays unguarded"

        def boom(site):
            raise RuntimeError(f"injected at {site}")

        set_fault_hook(boom)
        with pytest.raises(RuntimeError, match="injected"):
            mine(BASE, KyivConfig(tau=1, kmax=3, engine="cuda", device="cpu"))
    finally:
        set_fault_hook(prev)
