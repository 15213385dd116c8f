"""Plain versions of the record-coverage accumulation.

The coverage primitive behind the record-risk profiles: given the item
bitset matrix ``bits (t, W)``, a batch of itemsets ``sets (M, K) int32``
(rows of item indices, short itemsets padded by *repeating* an index — AND
with itself is the identity) and per-set integer ``weights (M,)`` (padding
rows carry weight 0), produce the accumulator

    acc[b, w] = sum_m weights[m] * bit b of (AND_t bits[sets[m, t]])[w]

i.e. for every record ``r = w * 32 + b``, how many (weighted) itemsets of
the batch cover record ``r``. The ``(32, W)`` layout is the kernel's form
(per-word accumulation instead of a scalar per-record scatter) and converts
to per-record counts with :func:`acc_to_record_counts`. Sums are int32 and
wrap on overflow, as the reference's int32 sums do.

``coverage_accumulate_host`` is the numpy ground truth on ``uint32`` words;
``coverage_accumulate_ref`` is the same computation in PyTorch on the int32
word views the device holds, the plain version of the scanning CUDA kernel;
``coverage_accumulate_anchored_ref`` computes it again by walking each set's
anchor in a :class:`~.index.CoverageIndex`, the plain version of the
anchored CUDA kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.bitops import popcount_rows
from .index import ANCHOR_WORK_FACTOR, CoverageIndex, anchors, walk_anchors

__all__ = [
    "coverage_accumulate_host",
    "coverage_accumulate_ref",
    "coverage_accumulate_anchored_ref",
    "acc_to_record_counts",
]


def _batched_rows(sub: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Set-bit rows of every row of a (A, W) uint32 matrix, in one pass.

    Returns ``(rows, counts)``: ``rows`` holds each matrix row's set-bit
    indices ascending, concatenated in row order; ``counts[i]`` how many
    belong to row i. Only the nonzero *words* are unpacked, so cost is
    O(A * W) scan + O(total set bits) unpack — never a dense (A, W*32)
    boolean expansion.
    """
    nz_i, nz_w = np.nonzero(sub)
    vals = np.ascontiguousarray(sub[nz_i, nz_w]).astype("<u4")
    up = np.unpackbits(vals.view(np.uint8), bitorder="little").reshape(-1, 32)
    pos_r, pos_b = np.nonzero(up)
    rows = nz_w[pos_r] * 32 + pos_b
    counts = np.bincount(nz_i[pos_r], minlength=sub.shape[0]).astype(np.int64)
    return rows, counts


def _accumulate_dense(mask: np.ndarray, wt: np.ndarray) -> np.ndarray:
    """32-bit-plane sweep over a materialised (M, W) mask — mirrors the
    kernel; the dense path and the test oracle's shape."""
    acc = np.empty((32, mask.shape[1]), dtype=np.int32)
    for b in range(32):
        sel = ((mask >> np.uint32(b)) & np.uint32(1)).astype(np.int32)
        acc[b] = (sel * wt[:, None]).sum(axis=0, dtype=np.int32)
    return acc


def coverage_accumulate_host(
    bits: np.ndarray, sets: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """Numpy engine: (32, W) int32 weighted per-bit coverage counts.

    Two exact paths, picked by how much work each would touch:

    * **anchor enumeration** — a quasi-identifier's record set is no larger
      than its rarest member's, and mined QIs have tiny supports (<= τ for
      emitted ones). Each set is anchored at its minimum-popcount item, only
      the anchor's rows are enumerated, and the other members' membership
      bits are gathered per (set, row) pair — O(sum of anchor supports)
      word lookups instead of O(M * W) full-width ANDs.
    * **bit-plane sweep** — when the anchor supports are not small relative
      to M * W (dense random inputs, huge τ), materialise the AND masks and
      sweep the 32 bit planes, exactly like the kernel.

    Only the rows the batch references are popcounted (the reference counts
    the whole table on every call): the same counts, at a cost that does not
    grow with the table.
    """
    bits = np.asarray(bits, dtype=np.uint32)
    sets = np.asarray(sets)
    wt = np.asarray(weights, dtype=np.int32)
    m, width = sets.shape
    n_words = bits.shape[1]

    used, used_idx = np.unique(sets, return_inverse=True)
    set_pc = popcount_rows(bits[used])[used_idx.reshape(sets.shape)]
    anchor_col = np.argmin(set_pc, axis=1)
    anchor_item = sets[np.arange(m), anchor_col]
    total_pairs = int(set_pc[np.arange(m), anchor_col].sum())
    if total_pairs * ANCHOR_WORK_FACTOR > m * n_words:
        mask = bits[sets[:, 0]]  # fancy index -> fresh array, safe as out=
        for t in range(1, width):
            np.bitwise_and(mask, bits[sets[:, t]], out=mask)
        return _accumulate_dense(mask, wt)

    # anchor path: candidate (set, row) pairs from each set's rarest item
    uniq_anchors, inverse = np.unique(anchor_item, return_inverse=True)
    anchor_rows, anchor_counts = _batched_rows(bits[uniq_anchors])
    offsets = np.cumsum(anchor_counts) - anchor_counts
    counts = anchor_counts[inverse]
    set_idx = np.repeat(np.arange(m), counts)
    # ragged gather: each set's rows are one contiguous anchor_rows range
    within = np.arange(len(set_idx)) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    row_idx = anchor_rows[np.repeat(offsets[inverse], counts) + within]
    alive = np.ones(len(set_idx), dtype=bool)
    w_idx = row_idx // 32
    b_idx = (row_idx % 32).astype(np.uint32)
    for t in range(width):
        member = sets[set_idx, t]
        check = member != anchor_item[set_idx]  # anchor rows trivially pass
        if not check.any():
            continue
        words = bits[member[check], w_idx[check]]
        alive[check] &= ((words >> b_idx[check]) & np.uint32(1)).astype(bool)
    acc_records = np.zeros(n_words * 32, dtype=np.int32)
    np.add.at(acc_records, row_idx[alive], wt[set_idx[alive]])
    return np.ascontiguousarray(acc_records.reshape(n_words, 32).T)


def coverage_accumulate_ref(
    bits: torch.Tensor, sets: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the coverage kernel: (t, W) int32 words,
    (M, K) int32 sets, (M,) int32 weights -> acc (32, W) int32.

    ``>>`` on int32 is arithmetic, so every shifted plane is masked with
    ``& 1`` (bit 31 of a sign-bit word would otherwise read as -1). Each
    plane is summed in int64 and wrapped to int32, as the reference's int32
    sum wraps; one (M, W) temporary lives per plane, never (M, 32, W).
    """
    idx = sets.long()
    mask = bits[idx[:, 0]]
    for t in range(1, sets.shape[1]):
        mask &= bits[idx[:, t]]
    wt = weights.to(torch.int32)[:, None]
    planes = []
    for b in range(32):
        sel = (mask >> b) & 1
        planes.append((sel * wt).sum(dim=0, dtype=torch.int64))
    return _wrap_int32(torch.stack(planes))


def _wrap_int32(acc: torch.Tensor) -> torch.Tensor:
    """int64 sums -> int32 with the reference's wraparound."""
    return ((acc + 2**31) % 2**32 - 2**31).to(torch.int32)


def coverage_accumulate_anchored_ref(
    bits: torch.Tensor, index: CoverageIndex, sets: torch.Tensor, weights: torch.Tensor,
    *, chunk_pairs: int = 1 << 20,
) -> torch.Tensor:
    """Plain PyTorch version of the anchored coverage kernel: the same acc
    (32, W) int32 as :func:`coverage_accumulate_ref`, walking only the
    nonzero words of each live set's anchor, its member with the fewest in
    ``index`` (the first on ties).

    Every (set, anchor word) pair ANDs the members' words there, and each
    set bit adds the set's weight at (bit, word), summed in int64 and
    wrapped to int32. Sets are taken in chunks of about ``chunk_pairs``
    pairs, so the (pairs, 32) bit temporaries stay bounded.
    """
    w = bits.shape[1]
    acc = torch.zeros(32 * w, dtype=torch.int64, device=bits.device)
    live = weights != 0
    idx = sets[live].long()
    wt = weights[live].long()
    if idx.shape[0] == 0 or w == 0:
        return _wrap_int32(acc.view(32, w))
    anchor = anchors(index, idx)
    ends = np.cumsum((index.offsets[anchor + 1] - index.offsets[anchor]).cpu().numpy())
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    lo = 0
    while lo < len(ends):
        base = ends[lo - 1] if lo else 0
        hi = max(lo + 1, int(np.searchsorted(ends, base + chunk_pairs, side="right")))
        walk = walk_anchors(bits, index, idx[lo:hi], anchor[lo:hi])
        pair, bit = torch.nonzero((walk.x[:, None] >> shifts) & 1, as_tuple=True)
        acc.index_add_(0, bit * w + walk.word[pair], wt[lo:hi][walk.set_of[pair]])
        lo = hi
    return _wrap_int32(acc.view(32, w))


def acc_to_record_counts(acc: np.ndarray, n_rows: int) -> np.ndarray:
    """Convert a (32, W) accumulator into per-record counts (n_rows,) int64.

    Record ``r`` lives at word ``r // 32``, bit ``r % 32`` — i.e.
    ``acc.T`` flattened row-major is exactly record order.
    """
    acc = np.asarray(acc)
    return acc.T.reshape(-1)[:n_rows].astype(np.int64)
