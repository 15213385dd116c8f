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

from ..obs.trace import span as _obs_span
from .items import ItemTable

__all__ = ["Preprocessed", "preprocess", "set_row_group_collective", "ORDERINGS"]

ORDERINGS = ("ascending", "descending", "random")

# Fleet rendezvous for duplicate-row-set detection: with process-sharded
# bitsets each process sees only its word stripes, so neither the hashes nor
# the exact verification are decidable locally. When a collective is
# installed, `_row_set_groups` combines all-gathered per-item hashes into a
# global hash and AND-reduces the within-bucket equality flags — two
# collective rounds per preprocess, after which every process holds the
# identical canonical/mirror partition.
_ROW_GROUP_COLLECTIVE = None


def set_row_group_collective(coll):
    """Install the fleet collective (``repro_torch.core.collective``) used to agree
    on duplicate row sets; ``None`` restores local-only grouping. Returns the
    previous value so callers can restore it."""
    global _ROW_GROUP_COLLECTIVE
    prev, _ROW_GROUP_COLLECTIVE = _ROW_GROUP_COLLECTIVE, coll
    return prev


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
    coll = _ROW_GROUP_COLLECTIVE
    if coll is not None:
        # round 1: fold every process's local hashes (pid order is fixed by
        # the all-gather) into one global hash — equal rows hash equal
        # everywhere, so the buckets below agree across the fleet
        mix2 = np.uint64(0xBF58476D1CE4E5B9)
        combined = np.zeros_like(h)
        for payload in coll.allgather(np.ascontiguousarray(h).tobytes()):
            ph = np.frombuffer(payload, dtype=np.uint64)
            combined = (combined ^ ph) * mix2
            combined ^= combined >> np.uint64(31)
        h = combined
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
    # exact verification within each multi-element bucket: all pairwise
    # equality flags in one flat vector. Locally that is just array_equal;
    # under a collective the flags AND-reduce (round 2: sum == nproc) so a
    # pair is grouped only when its rows agree on *every* process's stripes.
    multis = [b for b in buckets if len(b) > 1]
    eq_of: dict[int, np.ndarray] = {}
    if multis:
        flags = []
        for b in multis:
            rows = table.bits[b]  # (g, W)
            eq = (rows[:, None, :] == rows[None, :, :]).all(axis=2)
            flags.append(eq[np.triu_indices(len(b), 1)])
        flat = np.concatenate(flags).astype(np.int64)
        if coll is not None:
            flat = coll.allreduce_sum(flat) == coll.nproc
        else:
            flat = flat.astype(bool)
        off = 0
        for bi, b in enumerate(multis):
            g = len(b)
            npairs = g * (g - 1) // 2
            eq = np.eye(g, dtype=bool)
            iu = np.triu_indices(g, 1)
            eq[iu] = flat[off : off + npairs]
            eq.T[iu] = flat[off : off + npairs]
            eq_of[bi] = eq
            off += npairs
    groups: list[np.ndarray] = []
    bi = 0
    for bucket in buckets:
        if len(bucket) == 1:
            groups.append(bucket)
            continue
        eq = eq_of[bi]
        bi += 1
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
    with _obs_span("preprocess"):
        return _preprocess(table, tau, ordering, seed)


def _preprocess(table: ItemTable, tau: int, ordering: str, seed: int) -> Preprocessed:
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
