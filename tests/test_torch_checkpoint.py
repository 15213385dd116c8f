"""The port's checkpoints (``repro_torch.distributed.checkpoint``), as
``tests/test_checkpoint.py`` holds the reference's: pytree round trip,
corruption detected, retention and async saves, resume equivalence at level
boundaries, in memory and through disk. Besides: checkpoints cross between
the two packages in both directions (the on-disk format is one), and the
port CLI's ``--ckpt-dir`` writes what the reference CLI writes."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import KyivConfig as RConfig
from repro.core import itemize as r_itemize
from repro.core import preprocess as r_preprocess
from repro.core.kyiv import LevelStats as RLevelStats
from repro.core.kyiv import mine_preprocessed as r_mine_preprocessed
from repro.core.prefix import Level as RLevel
from repro.core.support import ItemsetIndex as RItemsetIndex
from repro.distributed import checkpoint as rckpt
from repro_torch import convert
from repro_torch.core import KyivConfig, ItemsetIndex, Level, LevelStats, MiningState
from repro_torch.core import itemize, mine, preprocess
from repro_torch.core.kyiv import mine_preprocessed
from repro_torch.distributed.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.launch import mine as launch_mine

D = np.random.default_rng(5).integers(0, 5, size=(100, 7))
CFG = KyivConfig(tau=2, kmax=4, engine="torch", device="cpu")


def tup(s):
    return (s.k, s.candidates, s.support_pruned, s.bound_pruned,
            s.intersections, s.emitted, s.skipped_absent_uniform, s.stored)


def _same(got, want):
    assert sorted(got.itemsets) == sorted(want.itemsets)
    assert list(map(tup, got.stats)) == list(map(tup, want.stats))


class _Stop(Exception):
    pass


def _stop_at(kill_at, run, on_state=None):
    """Run ``run(hook)`` until level ``kill_at`` ends; returns that state."""
    saved = {}

    def hook(k, state):
        if on_state is not None:
            on_state(k, state)
        if k == kill_at:
            saved["state"] = state
            raise _Stop

    with pytest.raises(_Stop):
        run(hook)
    return saved["state"]


# -- the pytree format ------------------------------------------------------


def test_pytree_roundtrip(tmp_path):
    tree = {
        "params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
        "step": 7,
        "lst": [np.ones(3), 2.5],
        "tup": (1, np.zeros(2, np.int64)),
        "name": "adamw",
        "bits": torch.arange(8, dtype=torch.int32).reshape(2, 4),
    }
    p = str(tmp_path / "ck")
    save_pytree(p, tree, {"note": "x"})
    restored, meta = load_pytree(p)
    assert meta["note"] == "x"
    assert np.array_equal(restored["params"]["w"], tree["params"]["w"])
    assert isinstance(restored["lst"], list) and restored["lst"][1] == 2.5
    assert isinstance(restored["tup"], tuple) and restored["tup"][0] == 1
    assert restored["tup"][1].dtype == np.int64
    assert restored["name"] == "adamw"
    assert restored["step"] == 7
    # a tensor comes back as the host numpy array it holds
    assert isinstance(restored["bits"], np.ndarray) and restored["bits"].dtype == np.int32
    assert np.array_equal(restored["bits"], tree["bits"].numpy())


def test_corruption_detected(tmp_path):
    p = str(tmp_path / "ck")
    save_pytree(p, {"w": np.ones(4)})
    npz = os.path.join(p, "arrays.npz")
    data = bytearray(open(npz, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(data))
    with pytest.raises(Exception):
        load_pytree(p)


def test_manager_retention_and_async(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    t = {"x": np.ones(3), "y": torch.full((2,), 3, dtype=torch.int64)}
    cm.save(1, t, blocking=False)
    cm.save(2, t)
    cm.save(5, t, blocking=False)
    cm.wait()
    assert cm.steps() == [2, 5]
    restored, meta = cm.restore()
    assert meta["step"] == 5 and np.array_equal(restored["y"], [3, 3])
    restored2, meta2 = cm.restore(step=2)
    assert meta2["step"] == 2


def test_restore_falls_back_past_a_corrupt_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(1, {"x": np.arange(3)})
    cm.save(2, {"x": np.arange(4)})
    npz = os.path.join(str(tmp_path), f"ckpt_{2:010d}", "arrays.npz")
    data = bytearray(open(npz, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(data))
    with pytest.raises(Exception):  # an explicit step raises on corruption
        cm.restore(step=2)
    tree, meta = cm.restore()
    assert meta["step"] == 1 and np.array_equal(tree["x"], np.arange(3))
    assert os.path.isdir(os.path.join(str(tmp_path), f"ckpt_{2:010d}.corrupt"))


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_files_identical_in_both_packages(tmp_path, writer):
    """One tree written by each package: the other loads it, arrays and
    scalars equal, and the manifests agree but for the write time."""
    tree = {"bits": np.arange(12, dtype=np.uint32).reshape(3, 4), "next_k": 3,
            "lst": [np.int64(2), (1.5, "a")], "none": None}
    other = tmp_path / "other"
    mine_path = tmp_path / "this"
    save_pytree(str(mine_path), tree, {"tau": 1})
    rckpt.save_pytree(str(other), tree, {"tau": 1})
    loaders = {"repro": rckpt.load_pytree, "repro_torch": load_pytree}
    for path in (mine_path, other):
        got, meta = loaders[writer](str(path))
        assert meta == {"tau": 1}
        assert np.array_equal(got["bits"], tree["bits"]) and got["bits"].dtype == np.uint32
        assert got["next_k"] == 3 and got["none"] is None and got["lst"][1] == (1.5, "a")
    m1 = json.loads((mine_path / "manifest.json").read_text())
    m2 = json.loads((other / "manifest.json").read_text())
    m1.pop("time"), m2.pop("time")
    assert m1 == m2


# -- resume -----------------------------------------------------------------


@pytest.mark.parametrize("kill_at", [2, 3])
@pytest.mark.parametrize("engine", ["torch", "cuda", "numpy"])
def test_mining_resume_equivalence(kill_at, engine):
    """Kill after a level boundary; resuming must reproduce the full run."""
    cfg = dataclasses.replace(CFG, engine=engine)
    prep = preprocess(itemize(D), cfg.tau)
    full = mine_preprocessed(prep, cfg)
    state = _stop_at(kill_at, lambda hook: mine_preprocessed(prep, cfg, on_level_end=hook))
    _same(mine_preprocessed(prep, cfg, resume_state=state), full)


@pytest.mark.parametrize("kill_at", [2, 3])
@pytest.mark.parametrize("indexed", [True, False])
def test_mining_resume_through_disk(tmp_path, kill_at, indexed):
    """The same, with the state round-tripping through checkpoint files
    (a node failure + restart), on both kernel families."""
    cfg = dataclasses.replace(CFG, indexed_kernel=indexed)
    prep = preprocess(itemize(D), cfg.tau)
    full = mine_preprocessed(prep, cfg)
    cm = CheckpointManager(str(tmp_path))
    _stop_at(kill_at, lambda hook: mine_preprocessed(prep, cfg, on_level_end=hook),
             on_state=lambda k, st: cm.save(k, convert.state_to_numpy(st)))
    tree, meta = CheckpointManager(str(tmp_path)).restore()
    assert meta["step"] == kill_at and tree["next_k"] == kill_at + 1
    resumed = mine_preprocessed(prep, cfg, resume_state=convert.state_from_numpy(tree))
    _same(resumed, full)


def _reference_state(d: dict):
    """The reference package's resume mapping from the numpy form."""
    fields = [f.name for f in dataclasses.fields(RLevelStats)]
    lv, gp = d["level"], d["grandparent"]
    return {
        "results": [(tuple(ids), int(c)) for ids, c in d["results"]],
        "stats": [RLevelStats(**dict(zip(fields, s))) for s in d["stats"]],
        "level": RLevel(k=int(lv["k"]), itemsets=lv["itemsets"], counts=lv["counts"],
                        bits=lv["bits"]),
        "grandparent_index": None if gp is None else RItemsetIndex(gp["itemsets"], gp["counts"]),
        "next_k": int(d["next_k"]),
    }


@pytest.mark.parametrize("kill_at", [2, 3])
def test_reference_checkpoint_resumes_in_port(tmp_path, kill_at):
    """Written by ``repro``'s CheckpointManager (its jnp device frontier),
    restored by the port's, resumed by the port: the reference's answer."""
    rcfg = RConfig(tau=2, kmax=4, engine="jnp")
    rprep = r_preprocess(r_itemize(D), 2)
    want = r_mine_preprocessed(rprep, RConfig(tau=2, kmax=4, engine="numpy"))
    rcm = rckpt.CheckpointManager(str(tmp_path))
    _stop_at(kill_at, lambda hook: r_mine_preprocessed(rprep, rcfg, on_level_end=hook),
             on_state=lambda k, st: rcm.save(k, convert.state_to_numpy(st), {"tau": 2}))
    tree, meta = CheckpointManager(str(tmp_path)).restore()
    assert meta == {"tau": 2, "step": kill_at}
    got = mine_preprocessed(preprocess(itemize(D), 2), CFG,
                            resume_state=convert.state_from_numpy(tree))
    _same(got, want)


@pytest.mark.parametrize("kill_at", [2, 3])
def test_port_checkpoint_resumes_in_reference(tmp_path, kill_at):
    """Written by the port's CheckpointManager (its gathered kernels' plain
    versions), restored by ``repro``'s, resumed by the reference: the
    port's answer."""
    cfg = dataclasses.replace(CFG, indexed_kernel=False)
    prep = preprocess(itemize(D), 2)
    want = mine_preprocessed(prep, cfg)
    cm = CheckpointManager(str(tmp_path))
    _stop_at(kill_at, lambda hook: mine_preprocessed(prep, cfg, on_level_end=hook),
             on_state=lambda k, st: cm.save(k, convert.state_to_numpy(st)))
    tree, meta = rckpt.CheckpointManager(str(tmp_path)).restore()
    assert meta == {"step": kill_at}
    got = r_mine_preprocessed(r_preprocess(r_itemize(D), 2), RConfig(tau=2, kmax=4, engine="numpy"),
                              resume_state=_reference_state(tree))
    _same(got, want)


# -- the CLI ----------------------------------------------------------------


def _cli_resume_state(out_json, stop_at, restore):
    """A CLI run stopped after level ``stop_at``, rebuilt from its
    checkpoints (``restore(step) -> (tree, meta)``) and the itemsets and
    stats it had emitted by then."""
    tree, meta = restore(stop_at)
    assert meta == {"tau": 1, "kmax": 4, "step": stop_at}
    assert int(tree["next_k"]) == stop_at + 1
    done = json.loads(out_json.read_text())
    parent = restore(stop_at - 1)[0] if stop_at > 2 else None
    return {
        "results": [(tuple(r["items"]), r["count"]) for r in done["itemsets"]
                    if len(r["items"]) <= stop_at],
        "stats": [st for st in done["stats"] if st["k"] <= stop_at],
        "level": (stop_at, tree["itemsets"], tree["counts"], tree["bits"]),
        "grandparent": None if parent is None else (parent["itemsets"], parent["counts"]),
        "next_k": int(tree["next_k"]),
    }


@pytest.mark.parametrize("stop_at", [2, 3])
def test_cli_ckpt_dir_resumes_in_both_packages(tmp_path, stop_at):
    """``--ckpt-dir`` saves every level boundary as the reference CLI does;
    a run stopped after level ``stop_at`` resumes from those files, in the
    port and in the reference, to the uninterrupted answer."""
    ckpt, out = tmp_path / "ckpt", tmp_path / "out.json"
    launch_mine.main(["--dataset", "poker", "--n", "400", "--tau", "1", "--kmax", "4",
                      "--engine", "torch", "--device", "cpu", "--ckpt-dir", str(ckpt),
                      "--out", str(out)])
    cm = CheckpointManager(str(ckpt))
    assert cm.steps() == [2, 3, 4]
    tree, _ = cm.restore(step=3)
    assert set(tree) == {"itemsets", "counts", "bits", "next_k"}
    assert tree["bits"].dtype == np.uint32 and tree["itemsets"].shape[1] == 3

    from repro_torch.data.synth import poker_like

    data = poker_like(n=400, seed=0)
    cfg = KyivConfig(tau=1, kmax=4, engine="torch", device="cpu")
    prep = preprocess(itemize(data), 1)
    full = mine_preprocessed(prep, cfg)
    rprep = r_preprocess(r_itemize(data), 1)

    s = _cli_resume_state(out, stop_at, cm.restore)
    port_state = MiningState(
        results=s["results"], stats=[LevelStats(**st) for st in s["stats"]],
        level=Level(*s["level"]),
        grandparent_index=None if s["grandparent"] is None
        else ItemsetIndex(*s["grandparent"], n_symbols=prep.n_l),
        next_k=s["next_k"],
    )
    if s["grandparent"] is None:  # level 1 is the singletons
        port_state.grandparent_index = ItemsetIndex(
            np.arange(prep.n_l, dtype=np.int32)[:, None], prep.l_freq, n_symbols=prep.n_l)
    _same(mine_preprocessed(prep, cfg, resume_state=port_state), full)

    rs = _cli_resume_state(out, stop_at, rckpt.CheckpointManager(str(ckpt)).restore)
    gp = rs["grandparent"] or (np.arange(rprep.n_l, dtype=np.int32)[:, None], rprep.l_freq)
    ref_state = {
        "results": rs["results"], "stats": [RLevelStats(**st) for st in rs["stats"]],
        "level": RLevel(*rs["level"]),
        "grandparent_index": RItemsetIndex(*gp, n_symbols=rprep.n_l),
        "next_k": rs["next_k"],
    }
    _same(r_mine_preprocessed(rprep, RConfig(tau=1, kmax=4, engine="numpy"),
                              resume_state=ref_state), full)


def test_reference_cli_checkpoints_load_in_port(tmp_path, monkeypatch):
    """The reference CLI's ``--ckpt-dir`` files load in the port, equal to
    the port CLI's own."""
    from repro.launch import mine as r_launch

    args = ["--n", "200", "--m", "5", "--tau", "1", "--kmax", "3"]
    monkeypatch.setattr(sys, "argv", ["mine", *args, "--ckpt-dir", str(tmp_path / "r")])
    r_launch.main()
    launch_mine.main([*args, "--engine", "torch", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path / "p")])
    theirs, ours = CheckpointManager(str(tmp_path / "r")), CheckpointManager(str(tmp_path / "p"))
    assert theirs.steps() == ours.steps() == [2, 3]
    for step in (2, 3):
        a, ma = theirs.restore(step=step)
        b, mb = ours.restore(step=step)
        assert ma == mb == {"tau": 1, "kmax": 3, "step": step}
        assert set(a) == set(b) and a["next_k"] == b["next_k"]
        for key in ("itemsets", "counts", "bits"):
            if a[key] is None:
                assert b[key] is None
            else:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def test_mine_unchanged_by_checkpoint_hook(tmp_path):
    """Saving at every level boundary changes nothing of the answer."""
    cm = CheckpointManager(str(tmp_path))
    got = mine_preprocessed(preprocess(itemize(D), 2), CFG,
                            on_level_end=lambda k, st: cm.save(k, convert.state_to_numpy(st),
                                                               blocking=False))
    cm.wait()
    _same(got, mine(D, CFG))
    assert cm.steps() == [2, 3, 4]
