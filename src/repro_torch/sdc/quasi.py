"""Statistical disclosure control application layer (paper §1, §1.1).

Wraps the miner into the quasi-identifier workflow the paper motivates with
the AOL incident: given a categorical table, report every minimal attribute
combination occurring ≤ τ times — the quasi-identifiers — plus k-anonymity
risk summaries, and the grouping transform of §1.1 (bucket values so each
value occurs at least k times).

Record-level numbers (``unique_records`` and the risk fields of
``report_as_dict``) are served by the privacy coverage engine
(``repro_torch.privacy.risk`` over the ``kernels.coverage`` kernel).
``find_quasi_identifiers`` takes ``KyivConfig``'s keywords: by default it
mines on the CUDA card; ``engine="torch", device="cpu"`` or
``engine="numpy"`` run it on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import KyivConfig, MiningResult, mine

__all__ = [
    "QuasiIdentifierReport",
    "find_quasi_identifiers",
    "k_anonymize_columns",
    "report_as_dict",
]


@dataclasses.dataclass
class QuasiIdentifierReport:
    result: MiningResult
    tau: int
    kmax: int
    _profile: "object | None" = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def n_quasi_identifiers(self) -> int:
        return len(self.result.itemsets)

    def profile(self):
        """The record-level :class:`repro_torch.privacy.risk.RiskProfile`, computed
        once through the coverage kernels (placement from the mining config)."""
        if self._profile is None:
            from ..privacy.risk import risk_profile

            self._profile = risk_profile(self.result)
        return self._profile

    def by_size(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for ids, _ in self.result.itemsets:
            out[len(ids)] = out.get(len(ids), 0) + 1
        return out

    def risky_columns(self) -> dict[int, int]:
        """How many quasi-identifiers touch each column — prioritises masking."""
        table = self.result.prep.table
        if not self.result.itemsets:
            return {}
        ids = np.fromiter(
            (i for itemset, _ in self.result.itemsets for i in itemset),
            dtype=np.int64,
        )
        counts = np.bincount(table.col[ids], minlength=table.n_cols)
        return {int(c): int(n) for c, n in enumerate(counts) if n}

    def unique_records(self) -> int:
        """Rows pinpointed by at least one τ-infrequent combination (thin
        wrapper over the coverage engine's record counts)."""
        return self.profile().records_at_risk


def find_quasi_identifiers(
    dataset: np.ndarray, tau: int = 1, kmax: int = 3, **config_kw
) -> QuasiIdentifierReport:
    res = mine(dataset, KyivConfig(tau=tau, kmax=kmax, **config_kw))
    return QuasiIdentifierReport(result=res, tau=tau, kmax=kmax)


def report_as_dict(report: QuasiIdentifierReport, *, top: int = 10) -> dict:
    """JSON-serialisable summary of a report: QI counts by size and column,
    records at risk, the top records and the risk histogram."""
    prof = report.profile()
    return {
        "tau": report.tau,
        "kmax": report.kmax,
        "n_quasi_identifiers": report.n_quasi_identifiers,
        "by_size": {str(k): v for k, v in sorted(report.by_size().items())},
        "risky_columns": {str(k): v for k, v in sorted(report.risky_columns().items())},
        "unique_records": report.unique_records(),
        "top_risk_records": prof.top_records(top),
        "risk_histogram": prof.histogram(),
        "n_rows": report.result.prep.table.n_rows,
    }


def k_anonymize_columns(dataset: np.ndarray, k: int = 5, seed: int = 0) -> np.ndarray:
    """§1.1 grouping transform: per column, bucket values occurring < k times
    into groups of >= k occurrences (values are replaced by a group id)."""
    rng = np.random.default_rng(seed)
    out = np.array(dataset, copy=True)
    n, m = out.shape
    for j in range(m):
        uniq, inv, counts = np.unique(out[:, j], return_inverse=True, return_counts=True)
        rare = np.nonzero(counts < k)[0]
        if len(rare) == 0:
            continue
        order = rng.permutation(rare)
        group_of = np.arange(len(uniq))
        # pack rare values into buckets whose total occurrence count >= k
        bucket, bucket_count, next_gid = [], 0, len(uniq)
        for v in order:
            bucket.append(v)
            bucket_count += counts[v]
            if bucket_count >= k:
                for b in bucket:
                    group_of[b] = next_gid
                next_gid += 1
                bucket, bucket_count = [], 0
        for b in bucket:  # leftover: merge into the last bucket
            group_of[b] = next_gid - 1 if next_gid > len(uniq) else len(uniq)
        out[:, j] = group_of[inv]
    return out
