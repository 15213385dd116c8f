"""Host-side bucketing and per-level tables for the frontier bodies.

Parent-level key tables pad to a power of two (``table_pad``) so the
bisection step count is fixed per level; batch row and pair counts pad to the
power-of-two buckets the intersect pipeline uses (``next_bucket``).
"""

from __future__ import annotations

import numpy as np

from ...core.exec_cache import exec_family
from ...obs import metrics as _om
from ..intersect.ops import next_bucket
from .ref import key_table_np

__all__ = [
    "table_pad",
    "make_level_tables",
    "pad_reps",
    "gen_buckets",
    "EXEC_CACHE",
]

# The bound candidate-generation callables of the device placements, one per
# (k, symbols, table pad, row bucket, pair bucket): the ``frontier`` family of
# the process-wide ``repro_torch.core.exec_cache`` registry.
EXEC_CACHE = exec_family("frontier")

_LEVEL_TABLES = _om.counter(
    "repro_frontier_tables_total",
    "Per-level frontier id/key tables built for device candidate generation.",
)


def table_pad(t: int, minimum: int = 16) -> int:
    """Power-of-two padded table size with at least one sentinel row."""
    p = minimum
    while p < t + 1:
        p <<= 1
    return p


def make_level_tables(itemsets: np.ndarray, n_symbols: int):
    """The padded id table and the packed sorted parent key table of one
    level (``(t, k)`` ints, uploaded once per level by the placement)."""
    _LEVEL_TABLES.inc()
    t, k = itemsets.shape
    tp = table_pad(t)
    ids = np.zeros((tp, k), dtype=np.int32)
    ids[:t] = itemsets
    keys = key_table_np(itemsets, n_symbols, tp)
    return ids, keys, tp


def pad_reps(reps: np.ndarray, row_bucket: int) -> np.ndarray:
    """Zero-pad a batch's run-length slice to its row bucket."""
    out = np.zeros(row_bucket, dtype=np.int32)
    out[: len(reps)] = reps
    return out


def gen_buckets(n_rows: int, n_pairs: int) -> tuple[int, int]:
    """(row bucket, pair bucket) for one frontier batch."""
    return next_bucket(n_rows, 16), next_bucket(n_pairs)
