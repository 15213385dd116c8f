"""Per-record re-identification risk profiles (paper §1, the AOL workload).

A mining result lists the quasi-identifiers — minimal attribute
combinations occurring ≤ τ times (Def. 3.3 used as Motwani & Nabar use it).
The *actionable* question is record-level: which rows do those combinations
pinpoint, how tightly, and how exposed is each one? Bettini et al. argue
this record-level semantics is the one k-anonymity actually cares about.

On the bitset substrate the answer is a coverage query: a QI's record set
is the AND of its item bitsets, and a record's exposure is how many QI
masks have its bit set. :func:`risk_profile` batches every mined QI through
``kernels.coverage.CoverageEngine`` (host numpy, the plain PyTorch version
or the CUDA kernel, via the placement of the mining config) grouped by
itemset size, and derives per record:

* ``qi_count``     — how many quasi-identifiers cover the record;
* ``min_qi_size``  — the smallest covering QI (fewer attributes = easier to
  learn externally = worse), 0 when uncovered;
* ``risk``         — a scalar in [0, 1]: modelling each covering QI of size
  k as an independent 1/k chance of re-identification,

      risk = 1 - prod_k (1 - 1/k)^{count_k}

  so a size-1 QI (a unique-ish value) forces risk 1.0, and risk grows
  monotonically with coverage multiplicity and shrinks with QI size.

The numbers feed ``sdc.quasi.report_as_dict`` (top records + histogram)
and the anonymization planner's column prioritisation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.kyiv import MiningResult
from ..core.placement import resolve_placement
from ..kernels.coverage import CoverageEngine, acc_to_record_counts

__all__ = ["RiskProfile", "risk_profile", "risk_scores"]


def risk_scores(counts_by_size: np.ndarray) -> np.ndarray:
    """Scalar risk per record from the (kmax, n) per-size coverage counts:
    ``1 - prod_k (1 - 1/k)^{c_k}`` with the k=1 factor collapsing to 0."""
    counts_by_size = np.asarray(counts_by_size)
    kmax, n = counts_by_size.shape
    log_survival = np.zeros(n, dtype=np.float64)
    for k in range(2, kmax + 1):
        log_survival += counts_by_size[k - 1] * np.log1p(-1.0 / k)
    risk = -np.expm1(log_survival)
    if kmax >= 1:
        risk = np.where(counts_by_size[0] > 0, 1.0, risk)
    return risk


@dataclasses.dataclass
class RiskProfile:
    """Record-level risk of one mined table: everything the coverage kernels
    produce, plus the derived scalar scores."""

    n_rows: int
    tau: int
    kmax: int
    counts_by_size: np.ndarray  # (kmax, n_rows) int64: QIs of size k covering r
    qi_count: np.ndarray  # (n_rows,) int64
    min_qi_size: np.ndarray  # (n_rows,) int64, 0 = uncovered
    risk: np.ndarray  # (n_rows,) float64 in [0, 1]

    @property
    def records_at_risk(self) -> int:
        """Rows pinpointed by at least one τ-infrequent combination."""
        return int((self.qi_count > 0).sum())

    def top_records(self, n: int = 10) -> list[dict]:
        """The n most exposed records, ordered by (risk, coverage) desc."""
        if self.n_rows == 0:
            return []
        order = np.lexsort(
            (np.arange(self.n_rows), -self.qi_count, -self.risk)
        )
        out = []
        for r in order[:n]:
            if self.qi_count[r] == 0:
                break
            out.append(
                {
                    "row": int(r),
                    "risk": round(float(self.risk[r]), 6),
                    "qi_count": int(self.qi_count[r]),
                    "min_qi_size": int(self.min_qi_size[r]),
                }
            )
        return out

    def histogram(self, bins: int = 10) -> dict:
        """Risk histogram over all records: {"edges": [...], "counts": [...]}."""
        edges = np.linspace(0.0, 1.0, bins + 1)
        counts, _ = np.histogram(self.risk, bins=edges)
        return {
            "edges": [round(float(e), 6) for e in edges],
            "counts": [int(c) for c in counts],
        }

    def summary(self, top: int = 10) -> dict:
        """JSON-serialisable digest — the /risk endpoint payload body."""
        at_risk = self.records_at_risk
        return {
            "tau": self.tau,
            "kmax": self.kmax,
            "n_rows": self.n_rows,
            "records_at_risk": at_risk,
            "at_risk_fraction": round(at_risk / self.n_rows, 6) if self.n_rows else 0.0,
            "max_risk": round(float(self.risk.max(initial=0.0)), 6),
            "mean_risk": round(float(self.risk.mean()), 6) if self.n_rows else 0.0,
            "qi_total": int(self.counts_by_size.sum()),
            "top_records": self.top_records(top),
            "histogram": self.histogram(),
        }


def risk_profile(
    result: MiningResult,
    *,
    placement=None,
    max_batch_sets: int | None = None,
    word_map=None,
) -> RiskProfile:
    """Compute the record-risk profile of a mining result.

    Mined itemsets are grouped by size and streamed through one
    :class:`CoverageEngine` (one accumulation per arity); per-size record
    counts come back from one kernel accumulator each. ``placement``
    defaults to the mining config's own (``resolve_placement``), so a
    profile runs where its mine ran.

    A placement exposing ``record_counts_from_acc`` (a process-sharded
    placement, whose table bits are process-local word stripes) turns the
    local accumulator into global per-record counts through ``word_map``;
    every other placement's accumulator already is global.
    """
    table = result.prep.table
    config = result.config
    n = table.n_rows
    kmax = max(1, int(config.kmax))
    counts_by_size = np.zeros((kmax, n), dtype=np.int64)

    if result.itemsets and n:
        sets_by_size: dict[int, list[tuple[int, ...]]] = {}
        for ids, _cnt in result.itemsets:
            sets_by_size.setdefault(len(ids), []).append(ids)
        if placement is None:
            placement = resolve_placement(config)
        engine = CoverageEngine(
            table.bits,
            placement=placement,
            set_width=kmax,
            max_batch_sets=max_batch_sets,
        )
        to_global = getattr(placement, "record_counts_from_acc", None)
        for k, sets in sorted(sets_by_size.items()):
            acc = engine.accumulate(np.asarray(sets, dtype=np.int32))
            if to_global is not None:
                counts_by_size[k - 1] = to_global(acc, n, word_map)
            else:
                counts_by_size[k - 1] = acc_to_record_counts(acc, n)

    qi_count = counts_by_size.sum(axis=0)
    min_qi_size = np.zeros(n, dtype=np.int64)
    for k in range(kmax, 0, -1):
        min_qi_size = np.where(counts_by_size[k - 1] > 0, k, min_qi_size)
    return RiskProfile(
        n_rows=n,
        tau=int(config.tau),
        kmax=int(config.kmax),
        counts_by_size=counts_by_size,
        qi_count=qi_count,
        min_qi_size=min_qi_size,
        risk=risk_scores(counts_by_size),
    )
