"""Dataset IO: the FIMI transaction format used by the paper's Connect/Pumsb
files (one transaction per line, space-separated item ids). Fixed-arity
files map 1:1 onto table columns; ragged files are padded with
``pad_value``."""

from __future__ import annotations

import numpy as np

__all__ = ["read_fimi"]


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
