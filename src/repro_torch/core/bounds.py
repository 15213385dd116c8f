"""Count-only frequency bounds: Lemma 4.6 (line 27) and Corollary 4.7 (line 29).

Both tests prove "W is **not** τ-infrequent" from already-stored counts, so
at the last level (k = k_max) they remove row intersections entirely for the
pruned pairs. On the card the saving is structural: pruned pairs never enter the
intersection kernel's pair list, and the survivors use the *count-only* kernel
variant that never writes child bitsets back to device memory.

Notation for a candidate W = [p_1..p_{k-2}, a, b] joined from
I = [p.., a] and J = [p.., b] (both level k-1 rows):

* line 27 (direct Lemma 4.6 with I' = prefix):
    prune if |R_I| + |R_J| > |R_prefix| + τ
  where |R_prefix| comes from level k-2 (|R_∅| = n when k = 2).

* line 29 (Corollary 4.7) with c = p_{k-2} (k >= 3):
    Γ0 = |R_{prefix\\c + a + b}|   (level k-1 count — a support subset of W,
                                    guaranteed present after line 23)
    Γ1 = |R_{prefix\\c + a}| − |R_I|    (level k-2 count − level k-1 count)
    Γ2 = |R_{prefix\\c + b}| − |R_J|
    prune if Γ0 > min(Γ1, Γ2) + τ
"""

from __future__ import annotations

import numpy as np

from .prefix import CandidateBatch, Level
from .support import ItemsetIndex

__all__ = ["lemma_bound", "corollary_bound", "apply_bounds"]


def lemma_bound(
    cand: CandidateBatch,
    level: Level,
    grandparent_index: ItemsetIndex | None,
    n_rows: int,
    tau: int,
) -> np.ndarray:
    """True where Alg. 1 line 27 prunes the pair (W proven not τ-infrequent)."""
    m, kp1 = cand.itemsets.shape
    if m == 0:
        return np.zeros(0, dtype=bool)
    ci = level.counts[cand.i_idx]
    cj = level.counts[cand.j_idx]
    if kp1 == 2:
        prefix_counts = np.full(m, n_rows, dtype=np.int64)  # |R_∅| = n
    else:
        assert grandparent_index is not None
        prefix = cand.itemsets[:, : kp1 - 2]
        prefix_counts = grandparent_index.lookup_counts(prefix)
        # prefix of a stored I is itself stored (BFS invariant); assert in debug.
        if (prefix_counts < 0).any():  # pragma: no cover - invariant guard
            raise AssertionError("BFS invariant violated: stored itemset with unstored prefix")
    return ci + cj > prefix_counts + tau


def corollary_bound(
    cand: CandidateBatch,
    level: Level,
    level_index: ItemsetIndex,
    grandparent_index: ItemsetIndex | None,
    tau: int,
) -> np.ndarray:
    """True where Alg. 1 line 29 prunes the pair. Requires k+1 >= 3."""
    m, kp1 = cand.itemsets.shape
    if m == 0 or kp1 < 3:
        return np.zeros(m, dtype=bool)
    assert grandparent_index is not None or kp1 == 3
    its = cand.itemsets
    # W = [p_1..p_{k-2}, a, b]; c = p_{k-2} is column kp1-3.
    keep = np.ones(kp1, dtype=bool)
    keep[kp1 - 3] = False
    wo_c = its[:, keep]  # [p_1..p_{k-3}, a, b]
    gamma0 = level_index.lookup_counts(wo_c)
    if (gamma0 < 0).any():  # support test ran first; subsets must be present
        raise AssertionError("corollary_bound called before support_test filtered candidates")

    ci = level.counts[cand.i_idx]
    cj = level.counts[cand.j_idx]
    wo_c_a = wo_c[:, :-1]  # [p_1..p_{k-3}, a]
    wo_c_b = np.concatenate([wo_c[:, :-2], wo_c[:, -1:]], axis=1)  # [p_1.., b]
    if kp1 == 3:
        # prefix\c is empty: the (k-2)-sets are singletons {a}, {b} = level-1.
        assert grandparent_index is not None, "need singleton index for k=3"
    cnt_wo_c_a = grandparent_index.lookup_counts(wo_c_a)
    cnt_wo_c_b = grandparent_index.lookup_counts(wo_c_b)
    if (cnt_wo_c_a < 0).any() or (cnt_wo_c_b < 0).any():
        raise AssertionError("BFS invariant violated in corollary lookup")
    g1 = cnt_wo_c_a - ci
    g2 = cnt_wo_c_b - cj
    return gamma0 > np.minimum(g1, g2) + tau


def apply_bounds(
    cand: CandidateBatch,
    level: Level,
    level_index: ItemsetIndex,
    grandparent_index: ItemsetIndex | None,
    n_rows: int,
    tau: int,
) -> np.ndarray:
    """Combined line 27 + line 29 prune mask (True = prune, skip intersection)."""
    pruned = lemma_bound(cand, level, grandparent_index, n_rows, tau)
    if cand.itemsets.shape[1] >= 3:
        alive = ~pruned
        if alive.any():
            sub = CandidateBatch(
                i_idx=cand.i_idx[alive], j_idx=cand.j_idx[alive], itemsets=cand.itemsets[alive]
            )
            cor = corollary_bound(sub, level, level_index, grandparent_index, tau)
            idx = np.nonzero(alive)[0]
            pruned[idx[cor]] = True
    return pruned
