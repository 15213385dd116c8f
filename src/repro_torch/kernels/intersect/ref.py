"""Plain PyTorch versions of the bitset intersection kernels.

``R_W = R_I ∩ R_J`` on bitset rows is a bitwise AND; ``|R_W|`` is a popcount
reduce. Bitsets are ``(t, W)`` int32 views of the uint32 words. These
functions fix the semantics the CUDA kernels must reproduce bit for bit (the
ops are integer, so the tolerance is zero); the CPU path of every kernel
wrapper and the ``torch`` engine run them directly.

Two families, as in the kernels: the *indexed* functions take the parent
table ``bits`` and ``(M, 2)`` pair indices; the *gathered* ones take the two
operand rows already gathered, ``a`` and ``b`` of shape ``(M, W)``, and for
the classify variants the per-pair ``minp = min(pc[i], pc[j])``.
The tiled function takes ``(T,)`` *block* indices into ``bits`` cut in
blocks of ``bm`` rows and counts every row pair of each block pair.
"""

from __future__ import annotations

import torch

from ...core.bitops import popcount32, popcount_rows_torch

__all__ = [
    "popcount_rows_ref",
    "intersect_gathered_ref",
    "intersect_count_gathered_ref",
    "intersect_classify_gathered_ref",
    "intersect_classify_count_gathered_ref",
    "intersect_pairs_ref",
    "intersect_count_ref",
    "classify_counts_ref",
    "intersect_classify_ref",
    "intersect_classify_count_ref",
    "min_parent_ref",
    "intersect_count_tiled_ref",
    "CLASS_SKIP",
    "CLASS_EMIT",
    "CLASS_STORE",
]

# Per-pair class codes of the fused intersect-classify step (Alg. 1 lines
# 32-41). SKIP = absent (|R_W| = 0) or uniform (|R_W| = min parent count, so
# W's row set equals a parent's and W is non-minimal); EMIT = minimal
# τ-infrequent (0 < |R_W| <= τ); STORE = survives to the next level.
CLASS_SKIP = 0
CLASS_EMIT = 1
CLASS_STORE = 2


def popcount_rows_ref(bits: torch.Tensor) -> torch.Tensor:
    """(t, W) int32 bitsets -> (t,) int32 population counts."""
    return popcount_rows_torch(bits)


def intersect_gathered_ref(
    a: torch.Tensor, b: torch.Tensor, *, out: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """AND + popcount of two aligned (M, W) bitset matrices.

    Returns (child (M, W) int32, counts (M,) int32). ``out=a`` writes the
    child over ``a`` (the plain version of the in-place kernel)."""
    child = torch.bitwise_and(a, b, out=out)
    return child, popcount_rows_ref(child)


def intersect_count_gathered_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Count-only variant over aligned operands: no child bitset is kept."""
    return intersect_gathered_ref(a, b)[1]


def intersect_pairs_ref(bits: torch.Tensor, pairs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather rows ``pairs[:, 0]``/``pairs[:, 1]`` of (t, W) ``bits``, AND, popcount.

    Returns (child_bits (M, W) int32, counts (M,) int32).
    """
    # the second gathered operand is freed before the popcount's temporaries
    child = bits[pairs[:, 0]]
    child &= bits[pairs[:, 1]]
    return child, popcount_rows_ref(child)


def intersect_count_ref(bits: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """Count-only variant (k = k_max path): no child bitset is kept."""
    return intersect_pairs_ref(bits, pairs)[1]


def classify_counts_ref(counts: torch.Tensor, minp: torch.Tensor, tau: int) -> torch.Tensor:
    """Alg. 1 lines 32-41: counts + min parent counts -> int32 class codes."""
    skip = (counts == 0) | (counts == minp)
    emit = ~skip & (counts <= int(tau))
    cls = torch.full_like(counts, CLASS_STORE, dtype=torch.int32)
    cls[emit] = CLASS_EMIT
    cls[skip] = CLASS_SKIP
    return cls


def min_parent_ref(parent_counts: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """(M,) ``min(pc[i], pc[j])`` of each pair: the gathered kernels' ``minp``."""
    return torch.minimum(parent_counts[pairs[:, 0]], parent_counts[pairs[:, 1]])


def intersect_classify_gathered_ref(
    a: torch.Tensor, b: torch.Tensor, minp: torch.Tensor, tau: int,
    *, out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused over aligned operands: child + popcounts + class codes.
    ``out=a`` writes the child over ``a``."""
    child, counts = intersect_gathered_ref(a, b, out=out)
    return child, counts, classify_counts_ref(counts, minp, tau)


def intersect_classify_count_gathered_ref(
    a: torch.Tensor, b: torch.Tensor, minp: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused count-only over aligned operands: counts + class codes."""
    counts = intersect_count_gathered_ref(a, b)
    return counts, classify_counts_ref(counts, minp, tau)


def intersect_classify_ref(
    bits: torch.Tensor, pairs: torch.Tensor, parent_counts: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused: child bitsets + popcounts + per-pair class codes."""
    child, counts = intersect_pairs_ref(bits, pairs)
    return child, counts, classify_counts_ref(counts, min_parent_ref(parent_counts, pairs), tau)


def intersect_classify_count_ref(
    bits: torch.Tensor, pairs: torch.Tensor, parent_counts: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused count-only (k = k_max): counts + class codes, no child bitset."""
    counts = intersect_count_ref(bits, pairs)
    return counts, classify_counts_ref(counts, min_parent_ref(parent_counts, pairs), tau)


# words of the (chunk, bm, bm, W) AND the tiled plain version holds at once
# (each of popcount32's temporaries is this size)
_TILED_CHUNK_WORDS = 1 << 25


def intersect_count_tiled_ref(
    bits: torch.Tensor, tile_i: torch.Tensor, tile_j: torch.Tensor, bm: int
) -> torch.Tensor:
    """(T, bm, bm) int32 popcount cross-matrices of block pairs.

    ``out[s, a, b] = popcount(bits[tile_i[s]*bm + a] & bits[tile_j[s]*bm + b])``
    over all W words, for ``(t, W)`` int32 ``bits`` cut in ``t // bm`` blocks
    of ``bm`` rows. A block index outside ``[0, t // bm)`` gives a zero
    matrix, as the kernel does. Chunked over block pairs so that the
    ``(chunk, bm, bm, W)`` AND stays bounded."""
    t, w = bits.shape
    n_tiles = tile_i.shape[0]
    out = torch.zeros((n_tiles, bm, bm), dtype=torch.int32, device=bits.device)
    n_blocks = t // bm
    if n_tiles == 0 or w == 0 or n_blocks == 0:
        return out
    ti, tj = tile_i.long(), tile_j.long()
    valid = (ti >= 0) & (ti < n_blocks) & (tj >= 0) & (tj < n_blocks)
    rows = torch.arange(bm, device=bits.device)
    chunk = max(1, _TILED_CHUNK_WORDS // (bm * bm * w))
    for s in range(0, n_tiles, chunk):
        v = valid[s : s + chunk]
        a = bits[torch.where(v, ti[s : s + chunk], 0)[:, None] * bm + rows]  # (c, bm, W)
        b = bits[torch.where(v, tj[s : s + chunk], 0)[:, None] * bm + rows]
        cnt = popcount32(a[:, :, None, :] & b[:, None, :, :]).sum(dim=-1, dtype=torch.int32)
        out[s : s + chunk] = torch.where(v[:, None, None], cnt, 0)
    return out
