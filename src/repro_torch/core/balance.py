"""Work balancing (paper §4.4.4, Example 4.10).

The paper estimates the work of a parallel unit by its number of row
intersections (pairs) and packs units greedily into the least-loaded thread
(the ``T``-array; leftmost cell on ties). :func:`greedy_assign` reproduces
this exactly — Example 4.10 (``T={4,3,3}`` at k=2 and ``T={6,3,1}`` at k=3)
is a golden test.

For the mesh miner (``core.sharded``) the greedy scheme is superseded by
:func:`balanced_blocks`: candidate pairs are *flat* after vectorised
generation, so we can partition them into exactly-equal padded blocks — every
shard performs the same number of intersections, which is the strongest form
of the paper's balance property and is what a lockstep mesh needs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["greedy_assign", "pair_work_per_unit", "balanced_blocks"]


def greedy_assign(work: np.ndarray, n_workers: int) -> tuple[np.ndarray, np.ndarray]:
    """Greedy least-loaded assignment (leftmost tie-break), the paper's T-array.

    Args:
      work: (u,) work estimate per unit, in level order.
      n_workers: thread count t.
    Returns:
      (assignment (u,) worker index per unit, loads (n_workers,)).
    """
    loads = np.zeros(n_workers, dtype=np.int64)
    assignment = np.zeros(len(work), dtype=np.int64)
    for u, w in enumerate(np.asarray(work, dtype=np.int64)):
        cell = int(np.argmin(loads))  # argmin returns leftmost minimum
        assignment[u] = cell
        loads[cell] += w
    return assignment, loads


def pair_work_per_unit(itemsets: np.ndarray, unit: str = "auto") -> np.ndarray:
    """Work units for one level transition, per §4.4.4.

    ``unit="vertex"``: one unit per stored itemset I, work = its pair count
    (number of following itemsets in its prefix group) — the k=2 case of
    Example 4.10. ``unit="group"``: one unit per prefix group, work =
    ``g*(g-1)/2`` — the k>=3 case. ``auto`` picks vertex for k==1 levels
    (joining to k=2) and group otherwise, matching the paper's example.
    """
    from .prefix import prefix_group_sizes

    t, k = itemsets.shape
    sizes = prefix_group_sizes(itemsets) if t else np.zeros(0, dtype=np.int64)
    if unit == "auto":
        unit = "vertex" if k == 1 else "group"
    if unit == "vertex":
        starts = np.zeros(len(sizes), dtype=np.int64)
        if len(sizes):
            starts[1:] = np.cumsum(sizes)[:-1]
        group_id = np.repeat(np.arange(len(sizes)), sizes)
        local = np.arange(t, dtype=np.int64) - starts[group_id]
        return sizes[group_id] - 1 - local
    if unit == "group":
        return sizes * (sizes - 1) // 2
    raise ValueError(f"unknown unit {unit!r}")


def balanced_blocks(m: int, n_shards: int) -> tuple[int, int]:
    """Exact SPMD partition: pad ``m`` pairs to ``n_shards`` equal blocks.

    Returns (padded_m, block). Every shard gets ``block`` pairs; padding pairs
    are (0, 0) self-intersections whose results are discarded by the caller.
    """
    block = (m + n_shards - 1) // n_shards
    return block * n_shards, block
