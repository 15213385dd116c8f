"""The plain PyTorch versions of the itemize kernels (``csrc/itemize.cu``),
on any device: what the ``torch`` engine runs, and what the CPU tests hold
the kernels' arithmetic to.

Both take the per-column plan as the host's ``(m, 5)`` int64 array of
``ops`` (columns ``LO``, ``OFF``, ``SPAN``, ``SROW``, ``BASE``), so that no
column's parameters are read back from the device; every step launches
device work only.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LO", "OFF", "SPAN", "SROW", "BASE", "presence_ref", "bits_stats_ref"]

LO, OFF, SPAN, SROW, BASE = range(5)


def presence_ref(table: torch.Tensor, plan: np.ndarray, present: torch.Tensor) -> None:
    """Mark in ``present`` (slots,) uint8 the slot ``off + (v - lo)`` of
    every value ``v`` of every dense column (``srow < 0``)."""
    present.zero_()
    for j in np.flatnonzero(plan[:, SROW] < 0):
        lo, off = int(plan[j, LO]), int(plan[j, OFF])
        present[off + (table[:, j] - lo)] = 1


def bits_stats_ref(table: torch.Tensor, plan: np.ndarray, ex: torch.Tensor,
                   sorted_ids: torch.Tensor, bits: torch.Tensor, freq: torch.Tensor,
                   min_row: torch.Tensor) -> None:
    """Fill ``bits`` (n_items, W) int32 with each item's row bits, ``freq``
    and ``min_row`` (n_items,) int64, from each cell's item id: ``base +
    ex[off + (v - lo)] - ex[off]`` in a dense column, ``base +
    sorted_ids[srow, r]`` in a sorted one."""
    n, m = table.shape
    n_items, w = bits.shape
    rows = torch.arange(n, device=table.device)
    word = rows // 32
    bit = torch.ones((), dtype=torch.int64, device=table.device) << (rows % 32)
    acc = torch.zeros(n_items * w, dtype=torch.int64, device=table.device)
    freq.zero_()
    min_row.fill_(np.iinfo(np.int64).max)
    for j in range(m):
        lo, off, _, srow, base = (int(x) for x in plan[j])
        if srow < 0:
            ids = base + ex[off + (table[:, j] - lo)] - ex[off]
        else:
            ids = base + sorted_ids[srow]
        # one bit per (row, item): the sum of a word's bits is their OR
        acc.index_add_(0, ids * w + word, bit)
        freq.index_add_(0, ids, torch.ones_like(ids))
        min_row.scatter_reduce_(0, ids, rows, "amin")
    bits.copy_(torch.where(acc >= 2**31, acc - 2**32, acc).view(n_items, w))
