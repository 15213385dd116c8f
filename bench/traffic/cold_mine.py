"""Traffic driver ``cold_mine``: a closed loop of cold mines.

Each request is ``repro_torch.core.kyiv.mine(table, KyivConfig(tau, kmax))``
(itemize, preprocess, the level loop and its kernels) on one of the mix's
tables, taken in turn. Table ``i`` is the table that the configuration's
generator (``bench/data/<generator>.py``, ``make(n, m, seed)``) makes for
seed ``data_seed + i``, its rows in an order drawn from the run's seed:
every seed mines the same tables, so the same work, in another row order
(which the answers do not depend on, and the bitsets do).

After the window, :meth:`ColdMine.check` holds every mine's answer and level
counts against the plain reference (``bench/reference/kyiv.py``), run once
per table from the tables the benchmark made.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from bench import load_module
from bench.reference import kyiv as reference

__all__ = ["ColdMine", "make", "tables"]


def _stat_tuples(stats) -> list[tuple]:
    return [tuple(int(getattr(s, f)) for f in reference.STAT_FIELDS) for s in stats]


def _value_sets(itemsets, col, value) -> list:
    return sorted(
        (tuple(sorted((int(col[i]), int(value[i])) for i in ids)), int(c)) for ids, c in itemsets
    )


@dataclasses.dataclass
class ColdMine:
    tables: list
    config: object  # repro_torch.core.kyiv.KyivConfig
    warmup_rounds: int
    tau: int
    kmax: int

    def warm_up(self) -> None:
        from repro_torch.core.kyiv import mine

        for _ in range(self.warmup_rounds):
            for table in self.tables:
                mine(table, self.config)

    def request(self, i: int) -> dict:
        """Mine table ``i % len(tables)``; keep what the check reads."""
        from repro_torch.core.kyiv import mine

        which = i % len(self.tables)
        res = mine(self.tables[which], self.config)
        table = res.prep.table
        return {
            "table": which,
            "itemsets": res.itemsets,
            "stats": _stat_tuples(res.stats),
            "col": table.col,
            "value": table.value,
            "words": int(table.n_words),
            "completed": res.completed,
        }

    def check(self, records: list[dict], device) -> dict[str, tuple[int, int]]:
        """Numbers compared, each ``(value, limit)``: mines whose answer
        (itemsets and supports) or whose level counts differ from the
        reference's for their table."""
        want = {}
        for t in sorted({r["table"] for r in records}):
            want[t] = reference.mine(self.tables[t], self.tau, self.kmax, device=device)
        answers_wrong = levels_wrong = 0
        seen: dict[tuple, list] = {}
        for r in records:
            key = (r["table"], tuple(r["itemsets"]))
            if key not in seen:  # mines of one table give one answer: convert it once
                seen[key] = _value_sets(r["itemsets"], r["col"], r["value"])
            ref = want[r["table"]]
            answers_wrong += int(not r["completed"] or seen[key] != ref.itemsets)
            levels_wrong += int(r["stats"] != ref.stats)
        return {
            "answers_wrong": (answers_wrong, 0),
            "levels_wrong": (levels_wrong, 0),
        }


def tables(cfg: dict, mix: dict, seed: int) -> list[np.ndarray]:
    """The mix's tables for the run's ``seed``."""
    gen = load_module(Path(__file__).resolve().parents[1] / "data" / f"{cfg['generator']}.py").make
    out = []
    for i in range(mix["tables"]):
        table = gen(n=cfg["rows"], m=cfg["columns"], seed=cfg["data_seed"] + i)
        out.append(np.ascontiguousarray(table[np.random.default_rng([seed, i]).permutation(len(table))]))
    return out


def make(cfg: dict, mix: dict, seed: int, *, engine: str | None = None,
         device: str | None = None) -> ColdMine:
    """The mix's tables and the program's configuration. ``engine`` and
    ``device`` override the configuration's (CPU tests only)."""
    from repro_torch.core.kyiv import KyivConfig

    program = dict(cfg.get("program", {}))
    if engine is not None:
        program.update(engine=engine, device=device)
    config = KyivConfig(tau=cfg["tau"], kmax=cfg["kmax"], **program)
    return ColdMine(tables=tables(cfg, mix, seed), config=config, warmup_rounds=mix["warmup_rounds"],
                    tau=cfg["tau"], kmax=cfg["kmax"])
