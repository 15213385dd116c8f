"""The zero-cost support-itemset test (paper §4.4.1) via packed-key lookup.

Because the BFS miner stores the whole previous level, testing whether every
``(k-1)``-subset of a candidate ``W`` survives reduces to table lookups
(Alg. 1 line 23). We realise the lookup with a sorted packed-key index:

* when ``k * bits_per_item <= 64`` the itemset packs exactly into a uint64 and
  ``searchsorted`` gives an exact match;
* otherwise rows are hashed (splitmix64 mix per column) into uint64, searched,
  and verified column-wise within the (astronomically rare) collision bucket —
  the result stays exact.

Both paths are fully vectorised numpy; the per-candidate device cost is zero,
which is precisely the paper's point.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ItemsetIndex", "support_test"]

_MIX = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _splitmix(h: np.ndarray) -> np.ndarray:
    h = (h ^ (h >> np.uint64(30))) * _MIX
    h = (h ^ (h >> np.uint64(27))) * _MIX2
    return h ^ (h >> np.uint64(31))


class ItemsetIndex:
    """Exact lookup index over a lexicographically sorted (t, k) int32 table."""

    def __init__(self, itemsets: np.ndarray, counts: np.ndarray | None = None, n_symbols: int | None = None):
        itemsets = np.asarray(itemsets, dtype=np.int64)
        self.itemsets = itemsets
        self.counts = None if counts is None else np.asarray(counts, dtype=np.int64)
        t, k = itemsets.shape
        self.k = k
        if n_symbols is None:
            n_symbols = int(itemsets.max()) + 1 if t else 1
        bits = max(1, int(n_symbols - 1).bit_length())
        self.exact = k * bits <= 64
        if self.exact:
            self._keys = self._pack_exact(itemsets, bits)
            self._bits = bits
        else:
            self._keys = self._hash(itemsets)
        self._order = np.argsort(self._keys, kind="stable")
        self._sorted_keys = self._keys[self._order]

    @staticmethod
    def _pack_exact(itemsets: np.ndarray, bits: int) -> np.ndarray:
        keys = np.zeros(itemsets.shape[0], dtype=np.uint64)
        for c in range(itemsets.shape[1]):
            keys = (keys << np.uint64(bits)) | itemsets[:, c].astype(np.uint64)
        return keys

    @staticmethod
    def _hash(itemsets: np.ndarray) -> np.ndarray:
        h = np.full(itemsets.shape[0], 0x51ED270B, dtype=np.uint64)
        for c in range(itemsets.shape[1]):
            h = _splitmix(h ^ itemsets[:, c].astype(np.uint64))
        return h

    def lookup(self, queries: np.ndarray) -> np.ndarray:
        """Row index of each query (q, k) itemset, or -1 when absent."""
        queries = np.asarray(queries, dtype=np.int64)
        if queries.ndim != 2 or queries.shape[1] != self.k:
            raise ValueError(f"queries must be (q, {self.k}), got {queries.shape}")
        if self.itemsets.shape[0] == 0 or queries.shape[0] == 0:
            return np.full(queries.shape[0], -1, dtype=np.int64)
        qk = self._pack_exact(queries, self._bits) if self.exact else self._hash(queries)
        pos = np.searchsorted(self._sorted_keys, qk)
        pos_c = np.minimum(pos, len(self._sorted_keys) - 1)
        hit = self._sorted_keys[pos_c] == qk
        rows = np.where(hit, self._order[pos_c], -1)
        if not self.exact:
            # verify (collisions possible): compare actual columns; on mismatch,
            # scan the equal-key run (runs are overwhelmingly length 1).
            cand = rows >= 0
            if cand.any():
                ok = np.all(self.itemsets[rows[cand]] == queries[cand], axis=1)
                bad = np.nonzero(cand)[0][~ok]
                for qi in bad:
                    rows[qi] = self._scan_run(int(pos[qi]), queries[qi])
        return rows

    def _scan_run(self, start: int, query: np.ndarray) -> int:
        key = self._hash(query[None])[0]
        i = start
        while i < len(self._sorted_keys) and self._sorted_keys[i] == key:
            row = self._order[i]
            if np.array_equal(self.itemsets[row], query):
                return int(row)
            i += 1
        return -1

    def lookup_counts(self, queries: np.ndarray, default: int = -1) -> np.ndarray:
        """Counts |R_S| for each query; ``default`` where absent."""
        if self.counts is None:
            raise ValueError("index built without counts")
        rows = self.lookup(queries)
        out = np.full(len(rows), default, dtype=np.int64)
        hit = rows >= 0
        out[hit] = self.counts[rows[hit]]
        return out


def support_test(candidates: np.ndarray, parent_index: ItemsetIndex) -> np.ndarray:
    """Alg. 1 line 23: True where **all** (k-1)-subsets of W survive in level k-1.

    The two subsets W\\{a} = J and W\\{b} = I are present by construction
    (candidates come from joining stored rows), so only the ``k-2`` subsets
    obtained by dropping a prefix position need lookups.
    """
    m, k = candidates.shape
    ok = np.ones(m, dtype=bool)
    if m == 0 or k <= 2:
        return ok  # k=2: both subsets are the (stored) singleton parents
    cols = np.arange(k)
    for drop in range(k - 2):  # drop each prefix position
        sub = candidates[:, cols != drop]
        ok &= parent_index.lookup(sub) >= 0
    return ok
