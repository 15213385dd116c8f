"""MINIT baseline (Haglin & Manning 2007) — the paper's main comparison point.

MINIT mines minimal τ-infrequent itemsets by recursive depth-first search:
items are ranked by support ascending; for each item ``a`` the dataset is
*conditioned* on ``R_a`` and the search recurses over higher-ranked items
only. Candidate outputs are verified minimal with a support-set test.

Implementation notes (faithful to the published algorithm's structure, with
the standard pruning rules):
  * items with zero support in the conditional dataset are dropped;
  * items *uniform* in the conditional dataset cannot extend a minimal
    infrequent set (same argument as paper §4.1) and are dropped;
  * recursion depth is capped at ``k_max``;
  * minimality of an emitted set is verified against all (|I|-1)-subsets.

This is a host (numpy bitset) implementation — the baseline the paper itself
benchmarks against is a sequential CPU code, so a host baseline is the honest
comparison target for wall-clock benches. It runs on the port's own
``itemize`` and popcount and returns the reference package's answer.
"""

from __future__ import annotations

import numpy as np

from .bitops import popcount
from .items import itemize

__all__ = ["minit_minimal_infrequent"]


def minit_minimal_infrequent(dataset: np.ndarray, tau: int, kmax: int) -> set[tuple[int, ...]]:
    table = itemize(dataset)
    n = table.n_rows
    bits = table.bits
    freq = table.freq.astype(np.int64)

    full_mask = np.full(table.n_words, 0xFFFFFFFF, dtype=np.uint32)
    tail = n % 32
    if tail:
        full_mask[-1] = np.uint32((1 << tail) - 1)

    # drop globally-uniform items (cannot be in any minimal infrequent set)
    candidates = [i for i in range(table.n_items) if freq[i] < n]
    # rank ascending by support (MINIT ordering)
    candidates.sort(key=lambda i: (freq[i], table.col[i], table.min_row[i]))

    results: set[tuple[int, ...]] = set()

    def set_freq(itemset: tuple[int, ...]) -> int:
        m = full_mask
        for it in itemset:
            m = m & bits[it]
        return int(popcount(m).sum())

    def is_minimal(itemset: tuple[int, ...]) -> bool:
        if len(itemset) == 1:
            return True
        for drop in range(len(itemset)):
            sub = itemset[:drop] + itemset[drop + 1 :]
            if set_freq(sub) <= tau:
                return False
        return True

    def recurse(chosen: tuple[int, ...], row_mask: np.ndarray, items: list[int]) -> None:
        depth = len(chosen)
        if depth >= kmax:
            return
        # local supports in the conditional dataset
        local = []
        rows_in_mask = int(popcount(row_mask).sum())
        for it in items:
            inter = row_mask & bits[it]
            c = int(popcount(inter).sum())
            if c == 0:
                continue  # absent in conditional dataset
            if c == rows_in_mask and depth > 0:
                continue  # uniform in conditional dataset -> non-minimal ext.
            local.append((c, it, inter))
        local.sort(key=lambda x: x[0])
        for rank, (c, it, inter) in enumerate(local):
            cand = tuple(sorted(chosen + (it,)))
            if c <= tau:
                if is_minimal(cand):
                    results.add(cand)
            else:
                recurse(
                    cand,
                    inter,
                    [x[1] for x in local[rank + 1 :]],
                )

    recurse((), full_mask, candidates)
    return results
