"""A run of the harness, minus its look for a card, with the timed path
broken underneath: ``correct`` has to come out false for each fault a cold
mine can have. (A cold mine has no exchange between chips.)"""

import numpy as np
import pytest
import torch


def _cell(harness):
    spec = harness.load_spec("poker-hand.cold-mine")
    spec.cfg.update(rows=1500, kmax=3)
    return spec


def _run(harness, spec):
    line = harness.run(spec, 2**31 + 17, 0.2, False, engine="torch", device="cpu")
    return line


def test_a_sound_run_is_correct(harness):
    line = _run(harness, _cell(harness))
    assert line["correct"] and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["checks"].values())


def test_a_level_step_that_returns_its_state_unchanged(harness, monkeypatch):
    import repro_torch.core.kyiv as kyiv

    monkeypatch.setattr(kyiv, "mine_levels", lambda *a, **k: None)  # level 1 never advances
    line = _run(harness, _cell(harness))
    assert not line["correct"] and line["checks"]["levels_wrong"]["value"] > 0


def test_half_of_each_batch_left_out(harness, monkeypatch):
    from repro_torch.core.placement import DevicePlacement

    dispatch = DevicePlacement.dispatch

    def half(self, state, pairs, write_children):
        pairs = pairs.clone() if isinstance(pairs, torch.Tensor) else np.array(pairs, copy=True)
        pairs[len(pairs) // 2:] = 0  # the pad pair (0, 0): counted as nothing
        return dispatch(self, state, pairs, write_children)

    monkeypatch.setattr(DevicePlacement, "dispatch", half)
    line = _run(harness, _cell(harness))
    assert not line["correct"] and line["checks"]["levels_wrong"]["value"] > 0


def test_an_answer_altered_where_it_is_produced(harness, monkeypatch):
    import repro_torch.core.frontier as frontier

    emit = frontier._emit_rows

    def altered(results, ls, prep, expansion, lpos_mat, cnts):
        emit(results, ls, prep, expansion, lpos_mat, cnts + 1)

    monkeypatch.setattr(frontier, "_emit_rows", altered)
    line = _run(harness, _cell(harness))
    assert not line["correct"] and line["checks"]["answers_wrong"]["value"] > 0
    assert line["checks"]["levels_wrong"]["value"] == 0  # the counts alone cannot see it


def test_a_request_that_fails_is_not_correct(harness, monkeypatch):
    import repro_torch.core.kyiv as kyiv

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(kyiv, "mine_preprocessed", boom)
    spec = _cell(harness)
    spec.mix["warmup_rounds"] = 0  # fail in the window, not in set-up
    line = _run(harness, spec)
    assert not line["correct"] and line["failed"] == line["attempted"] >= 1
