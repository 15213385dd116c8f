"""Level representation and breadth-first candidate generation (Alg. 1 lines 11-20).

A BFS level ``k`` is a lexicographically sorted ``(t, k)`` int32 table of
itemsets (entries are *positions* into the ordered list ``L^<``, so that
lexicographic order on positions equals prefix-tree order), together with the
``(t,)`` frequencies and the ``(t, W)`` uint32 bitset matrix of row sets.

Candidates at level ``k+1`` join two level-``k`` itemsets that share their
first ``k-1`` items (a prefix group). Pair enumeration is fully vectorised:
within a contiguous group of size ``c`` every row pairs with each of its
followers, which is expressed with ``repeat``/``cumsum`` arithmetic — no
Python-level loop over pairs or groups.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Level",
    "CandidateBatch",
    "generate_candidates",
    "prefix_group_sizes",
    "group_reps",
    "iter_group_spans",
]


@dataclasses.dataclass
class Level:
    """Stored BFS level (the paper's ``{P_i}``)."""

    k: int
    itemsets: np.ndarray  # (t, k) int32, lexicographically sorted rows
    counts: np.ndarray  # (t,) int64 frequencies |R_I|
    bits: np.ndarray | None  # (t, W) uint32; None once a level is retired

    @property
    def t(self) -> int:
        return int(self.itemsets.shape[0])


@dataclasses.dataclass
class CandidateBatch:
    """All candidate joins for one level transition.

    ``i_idx``/``j_idx`` index rows of the parent level; the candidate itemset
    is ``parent.itemsets[i] ∪ {last item of parent.itemsets[j]}`` which, with
    shared prefixes and lexicographic storage, is simply the concatenation
    ``[prefix..., last_i, last_j]`` and is itself lexicographically ordered.
    """

    i_idx: np.ndarray  # (M,) int64
    j_idx: np.ndarray  # (M,) int64
    itemsets: np.ndarray  # (M, k+1) int32

    @property
    def m(self) -> int:
        return int(self.i_idx.shape[0])


def prefix_group_sizes(itemsets: np.ndarray) -> np.ndarray:
    """Sizes of contiguous groups sharing the first k-1 columns."""
    t, k = itemsets.shape
    if t == 0:
        return np.zeros(0, dtype=np.int64)
    if k == 1:
        return np.asarray([t], dtype=np.int64)
    neq = np.any(itemsets[1:, : k - 1] != itemsets[:-1, : k - 1], axis=1)
    group_id = np.concatenate([[0], np.cumsum(neq)])
    return np.bincount(group_id).astype(np.int64)


def group_reps(itemsets: np.ndarray) -> np.ndarray:
    """Per-row join run lengths: row ``r`` (local index ``l`` in a prefix
    group of size ``c``) is the *I* of ``c - 1 - l`` candidate pairs. These
    run lengths are the input of both the host ``repeat``/``cumsum``
    enumeration and the device frontier's ``cumsum``/``searchsorted`` one."""
    t = itemsets.shape[0]
    sizes = prefix_group_sizes(itemsets)
    starts = np.zeros(len(sizes), dtype=np.int64)
    starts[1:] = np.cumsum(sizes)[:-1]
    group_id = np.repeat(np.arange(len(sizes)), sizes)
    local = np.arange(t, dtype=np.int64) - starts[group_id]
    return sizes[group_id] - 1 - local


def iter_group_spans(sizes: np.ndarray, max_pairs: int):
    """Yield ``(row_lo, row_hi, n_pairs)`` batch spans (paper §6.1 level
    streaming): consecutive prefix groups are packed until the pair budget
    is reached, so candidate tables never materialise a whole level's join
    at once. A single group larger than the budget is emitted alone (pairs
    cannot cross groups). Both the host path and the device frontier batch
    over the same spans, which is what keeps their per-level stats
    bit-identical."""
    pair_counts = sizes * (sizes - 1) // 2
    starts = np.zeros(len(sizes), dtype=np.int64)
    starts[1:] = np.cumsum(sizes)[:-1]
    g = 0
    while g < len(sizes):
        acc = 0
        g_end = g
        while g_end < len(sizes) and (acc == 0 or acc + pair_counts[g_end] <= max_pairs):
            acc += pair_counts[g_end]
            g_end += 1
        row_lo = int(starts[g])
        row_hi = int(starts[g_end - 1] + sizes[g_end - 1]) if g_end > g else row_lo
        yield row_lo, row_hi, int(acc)
        g = g_end


def iter_candidate_batches(level: Level, max_pairs: int):
    """Yield CandidateBatch objects bounded by ~max_pairs (see
    :func:`iter_group_spans` for the batching plan)."""
    t, k = level.itemsets.shape
    if t < 2:
        return
    sizes = prefix_group_sizes(level.itemsets)
    for row_lo, row_hi, n_pairs in iter_group_spans(sizes, max_pairs):
        if n_pairs == 0:
            continue
        sub = Level(
            k=level.k,
            itemsets=level.itemsets[row_lo:row_hi],
            counts=level.counts[row_lo:row_hi],
            bits=None,
        )
        batch = generate_candidates(sub)
        if batch.m:
            yield CandidateBatch(
                i_idx=batch.i_idx + row_lo,
                j_idx=batch.j_idx + row_lo,
                itemsets=batch.itemsets,
            )


def generate_candidates(level: Level) -> CandidateBatch:
    """Enumerate all (I, J) joins of a level (Alg. 1 lines 11-20), vectorised."""
    t, k = level.itemsets.shape
    empty = CandidateBatch(
        i_idx=np.zeros(0, dtype=np.int64),
        j_idx=np.zeros(0, dtype=np.int64),
        itemsets=np.zeros((0, k + 1), dtype=np.int32),
    )
    if t < 2:
        return empty

    reps = group_reps(level.itemsets)
    total = int(reps.sum())
    if total == 0:
        return empty
    i_idx = np.repeat(np.arange(t, dtype=np.int64), reps)
    offsets = np.zeros(t, dtype=np.int64)
    offsets[1:] = np.cumsum(reps)[:-1]
    j_idx = np.arange(total, dtype=np.int64) - np.repeat(offsets, reps) + i_idx + 1

    itemsets = np.empty((total, k + 1), dtype=np.int32)
    itemsets[:, :k] = level.itemsets[i_idx]
    itemsets[:, k] = level.itemsets[j_idx, k - 1]
    return CandidateBatch(i_idx=i_idx, j_idx=j_idx, itemsets=itemsets)
