"""Anonymization planner: kill every quasi-identifier with minimal damage.

Motwani & Nabar's suppression objective, run on top of the miner: given the
minimal τ-infrequent itemsets of a table, choose **cell suppressions**
(single values replaced by the ``MASKED`` wildcard) and **column
generalizations** (a whole column coarsened to one bucket, the degenerate
top of a generalization hierarchy) so that the masked table has *zero*
quasi-identifiers, preferring cheap edits.

Per planning round the choice is a **weighted set cover**: the universe is
every (QI, covered row) incidence — a QI is dead only when each row it
pinpoints has lost at least one of the QI's attribute values — candidate
sets are

* ``cell (r, c)``: weight 1, covers the incidences of every current QI that
  covers row ``r`` through column ``c``;
* ``generalize c``: weight ``generalize_cost`` (default: the column's
  ``n_rows`` cells), covers every incidence of every QI touching column
  ``c`` — generalizing replaces the column by a single value occurring
  ``n_rows > τ`` times, which provably removes all QIs using the column and
  can never create new ones (a frequent item extends no *minimal*
  infrequent itemset).

Greedy picks the best coverage-per-weight set until the round's QIs are all
dead. Because suppressions lower supports, previously-frequent itemsets can
*become* infrequent — so the planner runs a **verification loop**: apply the
round's edits, re-mine the masked table (``MASKED`` items are wildcards,
excluded from itemization), and plan again over the residual QIs. The last
rounds fall back to generalizing every residual column, which guarantees
convergence to zero QIs; degenerate tables with ``n_rows <= tau`` (where
*any* non-empty combination is infrequent) are handled upfront by
suppressing everything. ``plan_anonymization`` therefore always returns a
verified plan, and the re-mine of :func:`apply_plan`'s output is asserted
zero-QI in the tests and in ``chip_smoke.py``.

Re-mines run through the same ``KyivConfig`` (engine, device and placement
included) as the original request, so a plan asked for on the card mines
every round on the card.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from ..core.items import ItemTable, itemize
from ..core.kyiv import KyivConfig, MiningResult, mine_preprocessed
from ..core.preprocess import preprocess

__all__ = [
    "MASKED",
    "GENERALIZED",
    "AnonymizationPlan",
    "plan_anonymization",
    "apply_plan",
    "mine_masked",
    "strip_masked_items",
]

# Sentinels outside any sane categorical domain. MASKED cells are wildcards
# (they match nothing: their items are dropped before mining); GENERALIZED is
# the single bucket a generalized column collapses to (a regular, frequent
# value). Input tables must not already contain them (validated).
MASKED = int(np.iinfo(np.int64).min)
GENERALIZED = int(np.iinfo(np.int64).min + 1)


def _rows_of_mask(mask: np.ndarray) -> np.ndarray:
    """Set-bit row indices of one (W,) uint32 bitset row, vectorised."""
    words = np.ascontiguousarray(np.asarray(mask, dtype=np.uint32)).astype("<u4")
    return np.nonzero(np.unpackbits(words.view(np.uint8), bitorder="little"))[0]


def strip_masked_items(table: ItemTable) -> ItemTable:
    """Drop the MASKED wildcard items from an item table (suppressed cells
    contribute to no combination)."""
    keep = table.value != MASKED
    if bool(keep.all()):
        return table
    idx = np.nonzero(keep)[0]
    return ItemTable(
        n_rows=table.n_rows,
        n_cols=table.n_cols,
        n_words=table.n_words,
        value=table.value[idx],
        col=table.col[idx],
        freq=table.freq[idx],
        min_row=table.min_row[idx],
        bits=table.bits[idx],
    )


def mine_masked(masked: np.ndarray, config: KyivConfig) -> MiningResult | None:
    """Mine a masked table: itemize, drop MASKED wildcard items, run Alg. 1.

    Returns None when nothing is left to mine (everything suppressed) —
    trivially zero quasi-identifiers.
    """
    table = strip_masked_items(itemize(masked))
    if table.n_items == 0:
        return None
    prep = preprocess(table, config.tau, ordering=config.ordering, seed=config.seed)
    return mine_preprocessed(prep, config)


@dataclasses.dataclass
class AnonymizationPlan:
    """A verified set of masking edits for one table."""

    n_rows: int
    n_cols: int
    tau: int
    kmax: int
    suppressions: list[tuple[int, int]]  # (row, col) cell suppressions
    generalized_columns: list[int]
    rounds: int
    initial_qis: int
    residual_qis: int  # after the final verification re-mine (0 = success)

    @property
    def verified(self) -> bool:
        return self.residual_qis == 0

    @property
    def cells_suppressed(self) -> int:
        return len(self.suppressions)

    @property
    def cells_masked_total(self) -> int:
        """Cells whose value is lost: suppressions + generalized columns."""
        return self.cells_suppressed + len(self.generalized_columns) * self.n_rows

    def as_dict(self, max_suppressions: int | None = 200) -> dict:
        sup = [[int(r), int(c)] for r, c in self.suppressions]
        truncated = max_suppressions is not None and len(sup) > max_suppressions
        total_cells = self.n_rows * self.n_cols
        return {
            "n_rows": self.n_rows,
            "n_cols": self.n_cols,
            "tau": self.tau,
            "kmax": self.kmax,
            "initial_qis": self.initial_qis,
            "residual_qis": self.residual_qis,
            "verified": self.verified,
            "rounds": self.rounds,
            "cells_suppressed": self.cells_suppressed,
            "generalized_columns": [int(c) for c in self.generalized_columns],
            "masked_fraction": (
                round(self.cells_masked_total / total_cells, 6) if total_cells else 0.0
            ),
            "suppressions": sup[:max_suppressions] if truncated else sup,
            "suppressions_truncated": truncated,
        }


def apply_plan(dataset: np.ndarray, plan: AnonymizationPlan) -> np.ndarray:
    """Masked copy of the dataset: suppressions -> MASKED, generalized
    columns -> GENERALIZED (column generalization wins where both apply,
    matching the planner's final state)."""
    masked = np.array(dataset, dtype=np.int64, copy=True)
    if plan.suppressions:
        rows, cols = zip(*plan.suppressions)
        masked[list(rows), list(cols)] = MASKED
    for c in plan.generalized_columns:
        masked[:, c] = GENERALIZED
    return masked


def _greedy_cover_round(
    result: MiningResult,
    *,
    allow_generalize: bool,
    generalize_cost: float,
    already_generalized: set[int],
) -> tuple[list[tuple[int, int]], list[int]]:
    """One weighted-set-cover round over the current QIs.

    Returns (cell suppressions, columns to generalize) that together cover
    every (QI, row) incidence of ``result.itemsets``.
    """
    table = result.prep.table
    qis: list[tuple[np.ndarray, list[int]]] = []
    for ids, _cnt in result.itemsets:
        mask = table.bits[ids[0]].copy()
        for i in ids[1:]:
            mask &= table.bits[i]
        rows = _rows_of_mask(mask)
        cols = sorted({int(table.col[i]) for i in ids})
        qis.append((rows, cols))

    uncovered: list[set[int]] = [set(int(r) for r in rows) for rows, _ in qis]
    cell_cover: dict[tuple[int, int], set[int]] = {}
    col_cover: dict[int, set[int]] = {}
    for q, (rows, cols) in enumerate(qis):
        for c in cols:
            if c in already_generalized:
                continue  # its items are gone next round anyway
            col_cover.setdefault(c, set()).add(q)
            for r in rows:
                cell_cover.setdefault((int(r), c), set()).add(q)

    def cell_gain(rc: tuple[int, int]) -> int:
        r = rc[0]
        return sum(1 for q in cell_cover[rc] if r in uncovered[q])

    def col_gain(c: int) -> int:
        return sum(len(uncovered[q]) for q in col_cover[c])

    # lazy-decrement greedy: scores only ever shrink as incidences get
    # covered, so a popped entry whose recomputed score still tops the heap
    # is the true argmax — the standard O(picks log C) set-cover greedy.
    heap: list[tuple[float, int, str, tuple]] = []
    tick = 0
    for rc in cell_cover:
        heap.append((-float(cell_gain(rc)), tick := tick + 1, "cell", rc))
    if allow_generalize:
        for c in col_cover:
            heap.append(
                (-col_gain(c) / generalize_cost, tick := tick + 1, "generalize", (c,))
            )
    heapq.heapify(heap)

    cells: list[tuple[int, int]] = []
    gen_cols: list[int] = []
    killed_cols: set[int] = set()
    remaining = sum(len(u) for u in uncovered)
    while remaining and heap:
        neg_score, _, kind, payload = heapq.heappop(heap)
        c = payload[-1] if kind == "cell" else payload[0]
        if c in killed_cols:
            continue
        if kind == "cell":
            score = float(cell_gain(payload))
        else:
            score = col_gain(payload[0]) / generalize_cost
        if score <= 0.0:
            continue
        if heap and -score > heap[0][0]:  # stale — reinsert with fresh score
            heapq.heappush(heap, (-score, tick := tick + 1, kind, payload))
            continue
        if kind == "cell":
            r, c = payload
            cells.append((r, c))
            for q in cell_cover[payload]:
                if r in uncovered[q]:
                    uncovered[q].discard(r)
                    remaining -= 1
        else:
            gen_cols.append(payload[0])
            killed_cols.add(payload[0])
            for q in col_cover[payload[0]]:
                remaining -= len(uncovered[q])
                uncovered[q].clear()
    return cells, gen_cols


def plan_anonymization(
    dataset: np.ndarray,
    tau: int = 1,
    kmax: int = 3,
    *,
    config: KyivConfig | None = None,
    max_rounds: int = 12,
    generalize_cost: float | None = None,
    base_result: MiningResult | None = None,
) -> AnonymizationPlan:
    """Plan (and verify) masking edits until the table has zero QIs.

    ``base_result`` short-circuits the first mine when the caller already
    holds the table's mining result; it must have been mined at exactly
    (tau, kmax) on ``dataset``. ``config`` defaults to ``KyivConfig()``,
    which mines on the CUDA card.
    """
    dataset = np.asarray(dataset)
    if dataset.ndim != 2:
        raise ValueError(f"dataset must be 2-D, got shape {dataset.shape}")
    n, m = dataset.shape
    if n == 0 or m == 0:
        return AnonymizationPlan(n, m, tau, kmax, [], [], 0, 0, 0)
    if int(dataset.min()) <= GENERALIZED:
        raise ValueError(
            "dataset contains reserved sentinel values (MASKED/GENERALIZED)"
        )
    config = config or KyivConfig()
    config = dataclasses.replace(config, tau=tau, kmax=kmax)

    if n <= tau:
        # degenerate: every non-empty combination is τ-infrequent, so the
        # only zero-QI masking suppresses every cell
        suppressions = [(r, c) for r in range(n) for c in range(m)]
        initial = base_result if base_result is not None else mine_masked(
            np.array(dataset, dtype=np.int64), config
        )
        n_initial = len(initial.itemsets) if initial is not None else 0
        return AnonymizationPlan(
            n, m, tau, kmax, suppressions, [], 1, n_initial, 0
        )

    masked = np.array(dataset, dtype=np.int64, copy=True)
    suppressions: list[tuple[int, int]] = []
    generalized: list[int] = []
    gen_cost = float(generalize_cost) if generalize_cost is not None else float(n)

    result = base_result if base_result is not None else mine_masked(masked, config)
    initial_qis = 0 if result is None else len(result.itemsets)
    # leave the last two rounds for the guaranteed-convergent fallback
    cell_rounds = max(1, max_rounds - 2)
    rounds = 0
    while result is not None and result.itemsets and rounds < max_rounds:
        rounds += 1
        if rounds > cell_rounds:
            # fallback: generalize every column a residual QI touches — kills
            # them all and creates none, so the next re-mine converges
            table = result.prep.table
            gen = sorted(
                {int(table.col[i]) for ids, _ in result.itemsets for i in ids}
                - set(generalized)
            )
            cells = []
        else:
            cells, gen = _greedy_cover_round(
                result,
                allow_generalize=True,
                generalize_cost=gen_cost,
                already_generalized=set(generalized),
            )
        for r, c in cells:
            if masked[r, c] != MASKED:
                suppressions.append((r, c))
                masked[r, c] = MASKED
        for c in gen:
            if c not in generalized:
                generalized.append(c)
                masked[:, c] = GENERALIZED
        result = mine_masked(masked, config)

    residual = 0 if result is None else len(result.itemsets)
    return AnonymizationPlan(
        n_rows=n,
        n_cols=m,
        tau=tau,
        kmax=kmax,
        suppressions=suppressions,
        generalized_columns=generalized,
        rounds=rounds,
        initial_qis=initial_qis,
        residual_qis=residual,
    )
