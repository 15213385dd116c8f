"""Dataset IO: FIMI transaction format and CSV categorical tables.

``read_fimi`` ingests the http://fimi.ua.ac.be format used by the paper's
Connect/Pumsb files (one transaction per line, space-separated item ids) into
the tabular (n, m) form the miner consumes — FIMI transactions with a fixed
arity per line (Connect: 43, Pumsb: 74) map 1:1 onto table columns; ragged
files are padded with a per-line sentinel column value.

``encode_table`` densifies arbitrary categorical/string tables to the int64
matrix the itemizer expects, returning the codebooks for result decoding.
``read_csv`` wraps it for real categorical CSV files (the service's
``--preload`` path), so string-valued tables feed the miner without manual
densification.
"""

from __future__ import annotations

import csv

import numpy as np

__all__ = ["read_fimi", "encode_table", "read_csv"]


def read_fimi(path: str, pad_value: int = -1) -> np.ndarray:
    rows: list[list[int]] = []
    width = 0
    with open(path) as f:
        for line in f:
            parts = [int(x) for x in line.split()]
            if parts:
                rows.append(parts)
                width = max(width, len(parts))
    out = np.full((len(rows), width), pad_value, dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def read_csv(
    path: str, *, header: bool | None = None, delimiter: str = ","
) -> tuple[np.ndarray, list[str], list[np.ndarray]]:
    """Load a categorical CSV as a dense int table via :func:`encode_table`.

    Args:
      path: CSV file; every cell is treated as a categorical token (strings,
        mixed types and numerics all work — values are densified per column).
      header: True/False to force, None to sniff with ``csv.Sniffer`` (pass
        explicitly when the file is small or ambiguous — a mis-sniff would
        silently shift every support by one row).
      delimiter: CSV delimiter.
    Returns:
      (table (n, m) int64, column names, per-column codebooks) — decode cell
      ``table[i, j]`` back with ``codebooks[j][table[i, j]]``.
    """
    with open(path, newline="") as f:
        sample = f.read()
    rows = [r for r in csv.reader(sample.splitlines(), delimiter=delimiter) if r]
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        raise ValueError(f"{path}: ragged CSV (expected {width} columns)")
    if header is None:
        try:
            header = csv.Sniffer().has_header(sample)
        except csv.Error:
            header = False
    if header:
        names, data = list(rows[0]), rows[1:]
    else:
        names, data = [f"col{j}" for j in range(width)], rows
    if not data:
        raise ValueError(f"{path}: no data rows")
    columns = [np.asarray([r[j] for r in data]) for j in range(width)]
    table, books = encode_table(columns)
    return table, names, books


def encode_table(columns: list[np.ndarray]) -> tuple[np.ndarray, list[np.ndarray]]:
    """Encode arbitrary per-column data to dense ints; returns codebooks."""
    encoded = []
    books = []
    for col in columns:
        uniq, inv = np.unique(np.asarray(col), return_inverse=True)
        encoded.append(inv.astype(np.int64))
        books.append(uniq)
    return np.stack(encoded, axis=1), books
