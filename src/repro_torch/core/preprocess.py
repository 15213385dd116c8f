"""Pre-processing of the item table (paper §4.1) and item ordering (Def. 4.5).

Steps, exactly as the paper prescribes:
  1. Uniform items ``U_A`` (``|R_a| = n``) are dropped — they cannot belong to
     a minimal τ-infrequent itemset.
  2. τ-infrequent single items ``r_{A,τ}`` (``|R_a| <= τ``) are emitted
     directly — items are trivially minimal.
  3. The remaining items ``I'_{A,τ}`` are partitioned into a canonical set
     ``L_{A,τ}`` with pairwise-distinct row sets and a mirror set ``L̄`` of
     duplicates (Propositions 4.1/4.2): mining runs on ``L`` only and every
     result involving a canonical item ``w`` expands to results for every
     mirror ``w'`` with ``R_w = R_{w'}``.
  4. ``L`` is sorted ascending (Def. 4.5): by ``(|R_a|, j_a, min R_a)``.

Duplicate row-set detection hashes bitset rows (exact: hash, then verify
within hash buckets) — O(items × W).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .items import ItemTable

__all__ = ["Preprocessed", "preprocess", "ORDERINGS"]

ORDERINGS = ("ascending", "descending", "random")


@dataclasses.dataclass
class Preprocessed:
    """Output of §4.1 pre-processing.

    Attributes:
      table: the original item table.
      tau: threshold used.
      uniform_items: ids in ``U_A``.
      infrequent_items: ids in ``r_{A,τ}`` (emitted as 1-itemsets).
      l_items: ids of ``L_{A,τ}`` in the chosen order (``L^<`` when ascending).
      mirror_of: dict canonical item id -> list of duplicate item ids (``L̄``).
      l_bits: (|L|, W) uint32 bitsets of ``L`` rows, ordered like ``l_items``.
      l_freq: (|L|,) frequencies, same order.
    """

    table: ItemTable
    tau: int
    uniform_items: np.ndarray
    infrequent_items: np.ndarray
    l_items: np.ndarray
    mirror_of: dict[int, list[int]]
    l_bits: np.ndarray
    l_freq: np.ndarray

    @property
    def n_l(self) -> int:
        return int(self.l_items.shape[0])


def _row_set_groups(table: ItemTable, ids: np.ndarray) -> list[np.ndarray]:
    """Group item ids by identical row sets (bitset rows). Exact.

    Returns a list of arrays; each array holds the ids sharing one row set,
    in ascending item-id order.
    """
    if len(ids) == 0:
        return []
    sub = table.bits[ids]  # (g, W)
    # Hash each row, then verify within buckets to keep exactness.
    mix = np.uint64(0x9E3779B97F4A7C15)
    h = np.zeros(len(ids), dtype=np.uint64)
    for w in range(sub.shape[1]):
        h = (h ^ sub[:, w].astype(np.uint64)) * mix
        h ^= h >> np.uint64(29)
    order = np.argsort(h, kind="stable")
    ordered = ids[order]
    hs = h[order]
    buckets: list[np.ndarray] = []
    i = 0
    while i < len(ordered):
        j = i + 1
        while j < len(ordered) and hs[j] == hs[i]:
            j += 1
        buckets.append(ordered[i:j])
        i = j
    groups: list[np.ndarray] = []
    for bucket in buckets:
        if len(bucket) == 1:
            groups.append(bucket)
            continue
        # exact verification within a hash bucket
        rows = table.bits[bucket]  # (g, W)
        eq = (rows[:, None, :] == rows[None, :, :]).all(axis=2)
        rem = list(range(len(bucket)))
        while rem:
            head = rem[0]
            same = [r for r in rem if eq[head, r]]
            groups.append(np.asarray(sorted(int(bucket[r]) for r in same), dtype=np.int64))
            rem = [r for r in rem if r not in same]
    return groups


def preprocess(
    table: ItemTable,
    tau: int,
    ordering: str = "ascending",
    seed: int = 0,
) -> Preprocessed:
    """Run §4.1 pre-processing + Def. 4.5 ordering on an item table."""
    if tau <= 0:
        raise ValueError(f"tau must be positive (Def. 3.3 usage), got {tau}")
    if ordering not in ORDERINGS:
        raise ValueError(f"ordering must be one of {ORDERINGS}, got {ordering!r}")

    n = table.n_rows
    freq = table.freq
    uniform = np.nonzero(freq == n)[0]
    infrequent = np.nonzero(freq <= tau)[0]
    # Uniform items with n <= tau would satisfy both; the paper confines τ < n.
    keep_mask = (freq > tau) & (freq < n)
    remaining = np.nonzero(keep_mask)[0]

    groups = _row_set_groups(table, remaining)
    canonical = np.asarray([int(g[0]) for g in groups], dtype=np.int64)
    mirror_of = {int(g[0]): [int(x) for x in g[1:]] for g in groups if len(g) > 1}

    if ordering == "ascending":
        order = np.lexsort(
            (table.min_row[canonical], table.col[canonical], table.freq[canonical])
        )
    elif ordering == "descending":
        order = np.lexsort(
            (table.min_row[canonical], table.col[canonical], table.freq[canonical])
        )[::-1]
    else:  # random
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(canonical))
    l_items = canonical[order]

    return Preprocessed(
        table=table,
        tau=tau,
        uniform_items=uniform,
        infrequent_items=infrequent,
        l_items=l_items,
        mirror_of=mirror_of,
        l_bits=np.ascontiguousarray(table.bits[l_items]),
        l_freq=table.freq[l_items].astype(np.int64),
    )
