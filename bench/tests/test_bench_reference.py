"""The plain reference: against a brute-force count, against the program on
the CPU, and its control (supports held in 16 bits) failing the check."""

import itertools

import numpy as np
import pytest
import torch

from bench.data import connect4_uci, poker_like
from bench.reference import kyiv as ref
from bench.traffic import cold_mine


def brute_force(table, tau, kmax):
    """Every itemset of distinct columns up to kmax with 1 <= support <= tau
    whose every proper subset has support > tau, by counting rows."""
    n, m = table.shape
    rows = {}
    for c in range(m):
        for v in np.unique(table[:, c]):
            rows[(c, int(v))] = frozenset(np.nonzero(table[:, c] == v)[0].tolist())
    items = sorted(rows)
    out = []
    for k in range(1, kmax + 1):
        for combo in itertools.combinations(items, k):
            if len({c for c, _ in combo}) < k:
                continue
            f = len(frozenset.intersection(*(rows[i] for i in combo)))
            if f == 0 or f > tau:
                continue
            if k > 1 and any(len(frozenset.intersection(*(rows[i] for i in sub))) <= tau
                             for sub in itertools.combinations(combo, k - 1)):
                continue
            out.append((combo, f))
    return sorted(out)


def _connect_rows(n, seed):
    """``n`` rows of the Connect-4 table, drawn from ``seed``."""
    table = connect4_uci.make()
    return table[np.sort(np.random.default_rng(seed).choice(len(table), n, replace=False))]


def _tables():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, size=(120, 5))
    mirrored = np.concatenate([base, base[:, :1] + 10, (base[:, 1:2] * 7) % 5], axis=1)
    uniform = np.concatenate([rng.integers(0, 3, size=(90, 4)), np.zeros((90, 1), int)], axis=1)
    return [("random", rng.integers(0, 3, size=(150, 5))), ("mirrored", mirrored), ("uniform", uniform),
            ("poker", poker_like.make(n=200, seed=4)), ("connect", _connect_rows(60, 4)[:, 20:27])]


@pytest.mark.parametrize("name,table", _tables(), ids=[t[0] for t in _tables()])
@pytest.mark.parametrize("tau,kmax", [(1, 3), (2, 4), (3, 3)])
def test_reference_equals_brute_force(name, table, tau, kmax):
    assert ref.mine(table, tau, kmax).itemsets == brute_force(table, tau, kmax)


def _program(table, tau, kmax):
    from repro_torch.core.kyiv import KyivConfig, mine

    res = mine(table, KyivConfig(tau=tau, kmax=kmax, engine="torch", device="cpu"))
    return cold_mine._value_sets(res.itemsets, res.prep.table.col, res.prep.table.value), \
        cold_mine._stat_tuples(res.stats)


@pytest.mark.parametrize("name,table,tau,kmax", [
    ("poker", poker_like.make(n=3000, seed=5), 1, 4),
    ("connect", _connect_rows(1500, 3), 1, 3),
    ("connect-tau5", _connect_rows(1500, 3), 5, 3),
    ("mirrored", _tables()[1][1], 2, 4),
])
def test_reference_equals_the_program_with_its_level_counts(name, table, tau, kmax):
    answer = ref.mine(table, tau, kmax)
    itemsets, stats = _program(table, tau, kmax)
    assert itemsets == answer.itemsets
    assert stats == answer.stats


def _control_reading(tables, tau, kmax, device):
    """The control in the program's place: two mines of each table answered
    by the reference with 16-bit supports, judged by the traffic's own check."""
    traffic = cold_mine.ColdMine(tables=tables, config=None, warmup_rounds=0, tau=tau, kmax=kmax)
    records = []
    for t, table in enumerate(tables):
        low = ref.mine(table, tau, kmax, device=device, count_dtype=torch.int16)
        ids = {iv: i for i, iv in enumerate(sorted({iv for s, _ in low.itemsets for iv in s}))}
        col = np.array([c for c, _ in ids] or [0])
        value = np.array([v for _, v in ids] or [0])
        rec = {"table": t, "itemsets": [(tuple(ids[iv] for iv in s), c) for s, c in low.itemsets],
               "stats": low.stats, "col": col, "value": value, "completed": True}
        records += [rec, dict(rec)]
    return traffic.check(records, device)


def test_control_fails_the_check_at_a_test_size():
    """Supports past 2**15 wrap in 16 bits: the control reads wrong on every
    mine (upper reading), where the exact reference reads 0 (limit 0)."""
    tables = [poker_like.make(n=140_000, seed=s) for s in (1, 2)]  # suits ~35,000 rows
    got = _control_reading(tables, 1, 2, "cpu")
    assert got["answers_wrong"][0] == 4 and got["levels_wrong"][0] == 4
    tables = [connect4_uci.make()] * 2  # blanks in up to ~67,000 rows
    got = _control_reading(tables, 1, 2, "cpu")
    assert got["answers_wrong"][0] + got["levels_wrong"][0] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["poker-hand", "connect-4"])
def test_control_fails_the_check_at_the_cell_size(cuda, config):
    """The control on the card at the cell's own size, three seeds."""
    import json
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1]
    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    mix = json.loads((bench / "traffic" / "cold_mine.json").read_text())
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        tables = cold_mine.tables(cfg, mix, seed)
        got = _control_reading(tables, cfg["tau"], cfg["kmax"], cuda)
        print(f"control {config} seed {seed}: " + ", ".join(f"{k} {v[0]}" for k, v in got.items()))
        assert got["answers_wrong"][0] + got["levels_wrong"][0] > 0
