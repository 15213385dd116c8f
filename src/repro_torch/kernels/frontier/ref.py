"""Numpy mirrors of the frontier device bodies (kernel-level parity oracle).

Same packing, same bisection, same partition semantics as
``frontier.py`` — used by the frontier tests to check the torch bodies
op-by-op (the end-to-end oracle is the host mining path itself, which never
goes through these ops)."""

from __future__ import annotations

import numpy as np

from .frontier import SENTINEL, pack_params

__all__ = [
    "pack_rows_np",
    "key_table_np",
    "lookup_np",
    "gen_pairs_np",
    "partition_np",
]


def pack_rows_np(itemsets: np.ndarray, n_symbols: int) -> np.ndarray:
    """Pack a (T, k) int table into (T, w) int32 key words (big-endian)."""
    t, k = itemsets.shape
    b, ipw, w = pack_params(n_symbols, k)
    out = np.zeros((t, w), dtype=np.int64)
    for c in range(k):
        jw, s = divmod(c, ipw)
        out[:, jw] |= itemsets[:, c].astype(np.int64) << (b * (ipw - 1 - s))
    return out.astype(np.int32)


def key_table_np(itemsets: np.ndarray, n_symbols: int, t_pad: int) -> np.ndarray:
    """Sorted packed parent key table, sentinel-padded to ``t_pad`` rows.

    The parent level is lexicographically sorted already, and the packing is
    order-preserving, so no sort happens here (or on device)."""
    packed = pack_rows_np(itemsets, n_symbols)
    table = np.full((t_pad, packed.shape[1]), SENTINEL, dtype=np.int32)
    table[: packed.shape[0]] = packed
    return table


def lookup_np(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Exact membership via the same power-of-two bisection as the device."""
    t_pad, w = table.shape
    pos = np.zeros(queries.shape[0], dtype=np.int64)
    step = t_pad >> 1
    while step >= 1:
        cand = pos + step
        row = table[cand - 1]
        lt = np.zeros(queries.shape[0], dtype=bool)
        eq = np.ones(queries.shape[0], dtype=bool)
        for wi in range(w):
            lt |= eq & (row[:, wi] < queries[:, wi])
            eq &= row[:, wi] == queries[:, wi]
        pos = np.where(lt, cand, pos)
        step >>= 1
    row = table[np.minimum(pos, t_pad - 1)]
    return np.all(row == queries, axis=-1)


def gen_pairs_np(reps_b: np.ndarray, lo: int, mb: int, bucket: int):
    """Numpy mirror of ``gen_pairs_body`` (same padding semantics)."""
    p = np.arange(bucket, dtype=np.int64)
    cum = np.cumsum(reps_b.astype(np.int64))
    i_loc = np.searchsorted(cum, p, side="right")
    i_cl = np.minimum(i_loc, len(reps_b) - 1)
    off = cum[i_cl] - reps_b[i_cl]
    j_loc = p - off + i_cl + 1
    valid = p < mb
    i = np.where(valid, lo + i_cl, lo)
    j = np.where(valid, lo + j_loc, lo)
    return i.astype(np.int32), j.astype(np.int32), valid


def partition_np(classes: np.ndarray):
    order = np.argsort(classes, kind="stable")
    return order, int((classes == 1).sum()), int((classes == 2).sum())
