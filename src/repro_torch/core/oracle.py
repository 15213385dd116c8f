"""Brute-force oracle for minimal τ-infrequent itemsets (Definition 3.7).

Enumerates every itemset of ``I_A`` up to ``k_max`` and checks τ-infrequency
and minimality directly from row sets. Exponential — for tests on tiny
datasets only. This is the ground truth the Kyiv miner is validated against.
"""

from __future__ import annotations

import itertools

import numpy as np

from .items import itemize

__all__ = ["brute_force_minimal_infrequent"]


def brute_force_minimal_infrequent(
    dataset: np.ndarray, tau: int, kmax: int
) -> set[tuple[int, ...]]:
    table = itemize(dataset)
    n_items = table.n_items
    rows = [frozenset(table.rows_of(i).tolist()) for i in range(n_items)]

    def freq(itemset: tuple[int, ...]) -> int:
        r = rows[itemset[0]]
        for it in itemset[1:]:
            r = r & rows[it]
        return len(r)

    found: set[tuple[int, ...]] = set()
    for k in range(1, kmax + 1):
        for combo in itertools.combinations(range(n_items), k):
            # items must come from distinct columns to co-occur meaningfully;
            # same-column distinct values have empty intersection -> freq 0,
            # but |R_S| = 0 <= tau would make them "infrequent". Def. 3.7 does
            # not exclude them, but such sets have an empty-row subset chain;
            # the paper's Alg. 1 line 32 explicitly skips absent itemsets, so
            # the reference excludes freq-0 sets as well.
            f = freq(combo)
            if f == 0 or f > tau:
                continue
            minimal = True
            if k > 1:
                for sub in itertools.combinations(combo, k - 1):
                    if freq(sub) <= tau:
                        minimal = False
                        break
            if minimal:
                found.add(combo)
    return found
