"""Itemization of a categorical dataset (paper §3, Definitions 3.1-3.5).

A dataset ``A`` is an ``(n, m)`` integer matrix. An *item* is a pair
``(value, column)`` together with the set of rows ``R_a`` in which it occurs
(Definition 3.1). The row set is represented as a *bitset row*:
``uint32[W]`` with ``W = ceil(n / 32)`` words, so that the paper's
row-intersection bottleneck (Algorithm 1, line 31) becomes a bitwise AND +
population count — the representation the CUDA kernels in
``repro_torch.kernels.intersect`` operate on (as ``int32`` views on the
device).

The item table is column-ordered: items are produced column by column, value
by value, and assigned dense integer ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..obs.trace import span as _obs_span
from .bitops import popcount_rows

__all__ = [
    "ItemTable",
    "itemize",
    "pack_rows_to_bits",
    "bits_popcount",
    "bits_to_rows",
    "WORD_BITS",
]

WORD_BITS = 32


def pack_rows_to_bits(row_sets: list[np.ndarray], n_rows: int, n_words: int | None = None) -> np.ndarray:
    """Pack a list of row-index arrays into a (len, W) uint32 bitset matrix."""
    if n_words is None:
        n_words = (n_rows + WORD_BITS - 1) // WORD_BITS
    bits = np.zeros((len(row_sets), n_words), dtype=np.uint32)
    for i, rows in enumerate(row_sets):
        if len(rows) == 0:
            continue
        w = rows // WORD_BITS
        b = rows % WORD_BITS
        np.bitwise_or.at(bits[i], w, np.uint32(1) << b.astype(np.uint32))
    return bits


def bits_popcount(bits: np.ndarray) -> np.ndarray:
    """Per-row population count of a (t, W) uint32 bitset matrix."""
    return popcount_rows(bits)


def bits_to_rows(bits_row: np.ndarray) -> np.ndarray:
    """Expand one bitset row back into sorted row indices.

    Vectorised: the words are forced little-endian and unpacked bit-by-bit,
    so bit ``b`` of word ``w`` lands at index ``w * 32 + b`` exactly —
    previously a per-word Python loop, now one ``np.unpackbits``.
    """
    words = np.ascontiguousarray(np.asarray(bits_row, dtype=np.uint32)).astype("<u4")
    unpacked = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(unpacked)[0].astype(np.int64)


@dataclasses.dataclass
class ItemTable:
    """All items of a dataset (the paper's ``I_A``) in bitset form.

    Attributes:
      n_rows, n_cols: dataset dimensions.
      n_words: bitset width ``W``.
      value: (n_items,) original value of each item.
      col: (n_items,) column index ``j_a``.
      freq: (n_items,) ``|R_a|``.
      min_row: (n_items,) ``min R_a`` (used by the ascending order, Def. 4.5).
      bits: (n_items, W) uint32 bitset rows.
    """

    n_rows: int
    n_cols: int
    n_words: int
    value: np.ndarray
    col: np.ndarray
    freq: np.ndarray
    min_row: np.ndarray
    bits: np.ndarray

    @property
    def n_items(self) -> int:
        return int(self.value.shape[0])

    def rows_of(self, item: int) -> np.ndarray:
        return bits_to_rows(self.bits[item])

    def describe(self, item: int) -> tuple[int, int]:
        """(value, column) — 1-based column in paper notation is col+1."""
        return int(self.value[item]), int(self.col[item])

    def to_dataset(self) -> np.ndarray:
        """Reconstruct the (n_rows, n_cols) dataset from the item bitsets.

        Every cell belongs to exactly one item by construction, so scattering
        each item's value over its row set rebuilds the table, for callers
        that keep only the itemized form.
        """
        out = np.zeros((self.n_rows, self.n_cols), dtype=np.int64)
        for i in range(self.n_items):
            rows = bits_to_rows(self.bits[i])
            out[rows[rows < self.n_rows], self.col[i]] = self.value[i]
        return out


def itemize(dataset: np.ndarray) -> ItemTable:
    """Build the item table ``I_A`` of an (n, m) integer dataset.

    Items are emitted column-major, values ascending within a column — a
    deterministic dense id assignment. Vectorised per column via np.unique.
    The ``itemize`` span's ``path`` reads ``"host"``; ``core.kyiv.prepare``
    builds the same table on one device's placement instead.
    """
    dataset = np.asarray(dataset)
    if dataset.ndim != 2:
        raise ValueError(f"dataset must be 2-D, got shape {dataset.shape}")
    with _obs_span("itemize") as sp:
        sp.set(path="host")
        return _itemize(dataset)


def device_dtype(dtype: np.dtype) -> bool:
    """Whether a table of ``dtype`` can be itemized on a device: a signed or
    unsigned integer of native byte order whose every value fits int64."""
    return dtype.isnative and (dtype.kind == "i" or (dtype.kind == "u" and dtype.itemsize < 8))


def _itemize(dataset: np.ndarray) -> ItemTable:
    n, m = dataset.shape
    n_words = (n + WORD_BITS - 1) // WORD_BITS

    values, cols, freqs, min_rows, bit_blocks = [], [], [], [], []
    row_idx = np.arange(n, dtype=np.int64)
    for j in range(m):
        colv = dataset[:, j]
        uniq, inverse, counts = np.unique(colv, return_inverse=True, return_counts=True)
        k = len(uniq)
        # min row per item: first occurrence when scanning rows ascending.
        order = np.argsort(inverse, kind="stable")
        starts = np.zeros(k, dtype=np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        first_rows = row_idx[order][starts]
        # bitset: scatter each row's bit into its item's row.
        bits = np.zeros((k, n_words), dtype=np.uint32)
        w = row_idx // WORD_BITS
        b = (row_idx % WORD_BITS).astype(np.uint32)
        np.bitwise_or.at(bits, (inverse, w), np.uint32(1) << b)
        values.append(uniq.astype(np.int64))
        cols.append(np.full(k, j, dtype=np.int64))
        freqs.append(counts.astype(np.int64))
        min_rows.append(first_rows)
        bit_blocks.append(bits)

    return ItemTable(
        n_rows=n,
        n_cols=m,
        n_words=n_words,
        value=np.concatenate(values),
        col=np.concatenate(cols),
        freq=np.concatenate(freqs),
        min_row=np.concatenate(min_rows),
        bits=np.concatenate(bit_blocks, axis=0),
    )
