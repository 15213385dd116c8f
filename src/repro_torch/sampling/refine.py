"""Exact boundary-band recount for the sampled-mining fast path.

The sample mine classifies every emitted itemset as *certain* or
*boundary* (``sampler.classify_counts``); refinement resolves the
boundary band by recounting those itemsets against the full table. The
recount dispatches through the same placement / ``LevelPipeline``
machinery as a real mine, not a private numpy loop, so its semantics are
bit-identical under every placement: it is AND + popcount cascades over
the full-width word tiles. On a device each batch pads to its own
power-of-two bucket (``placement.padded_size``), as a mine's batches do.
"""

from __future__ import annotations

import numpy as np

from ..core.items import ItemTable, bits_popcount
from ..kernels.intersect import LevelPipeline
from ..obs import metrics as _om

__all__ = ["recount_supports"]

_RECOUNT_SETS = _om.counter(
    "repro_sampling_recounted_itemsets_total",
    "Boundary itemsets recounted exactly against the full table.",
)


def recount_supports(
    table: ItemTable,
    itemsets: list[tuple[int, ...]],
    *,
    placement,
    tau: int,
    fused_classify: bool = True,
) -> tuple[np.ndarray, dict]:
    """Exact full-table supports for ``itemsets`` (tuples of item ids).

    Cascades pairwise ANDs through a :class:`LevelPipeline` per arity
    group: partials for ``(i0, …, i_{p})`` are intersected with column
    ``p+1``'s bitsets in one padded batch. Returns ``(counts, info)``
    with ``counts`` aligned to ``itemsets`` order and ``info`` counting the
    dispatches.
    """
    counts = np.zeros(len(itemsets), dtype=np.int64)
    info = {"recounted": len(itemsets), "dispatches": 0}
    if not itemsets:
        return counts, info

    by_arity: dict[int, list[int]] = {}
    for pos, ids in enumerate(itemsets):
        by_arity.setdefault(len(ids), []).append(pos)

    for arity, positions in sorted(by_arity.items()):
        if arity == 1:
            items = np.fromiter(
                (itemsets[p][0] for p in positions), dtype=np.int64
            )
            counts[positions] = table.freq[items]
            continue
        mat = np.asarray([itemsets[p] for p in positions], dtype=np.int64)
        r = mat.shape[0]
        partial = table.bits[mat[:, 0]]
        for pos in range(1, arity):
            stacked = np.concatenate([partial, table.bits[mat[:, pos]]], axis=0)
            write = pos < arity - 1
            pipe = LevelPipeline(
                stacked,
                bits_popcount(stacked).astype(np.int64),
                tau=tau,
                placement=placement,
                fused_classify=fused_classify,
                locality_sort=False,
            )
            pairs = np.stack(
                [np.arange(r), np.arange(r) + r], axis=1
            ).astype(np.int32)
            handle = pipe.submit(pairs, write)
            info["dispatches"] += 1
            child, batch_counts, _ = handle.result()
            pipe.retire()
            if write:
                partial = child
            else:
                counts[positions] = batch_counts
    _RECOUNT_SETS.inc(len(itemsets))
    return counts, info
