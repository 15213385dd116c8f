"""Plain PyTorch versions of the bitset intersection kernels.

``R_W = R_I ∩ R_J`` on bitset rows is a bitwise AND; ``|R_W|`` is a popcount
reduce. Bitsets are ``(t, W)`` int32 views of the uint32 words. These
functions fix the semantics the CUDA kernels must reproduce bit for bit (the
ops are integer, so the tolerance is zero); the CPU path of every kernel
wrapper and the ``torch`` engine run them directly.
"""

from __future__ import annotations

import torch

from ...core.bitops import popcount_rows_torch

__all__ = [
    "popcount_rows_ref",
    "intersect_pairs_ref",
    "intersect_count_ref",
    "classify_counts_ref",
    "intersect_classify_ref",
    "intersect_classify_count_ref",
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


def intersect_pairs_ref(bits: torch.Tensor, pairs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather rows ``pairs[:, 0]``/``pairs[:, 1]`` of (t, W) ``bits``, AND, popcount.

    Returns (child_bits (M, W) int32, counts (M,) int32).
    """
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


def _min_parent(parent_counts: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    return torch.minimum(parent_counts[pairs[:, 0]], parent_counts[pairs[:, 1]])


def intersect_classify_ref(
    bits: torch.Tensor, pairs: torch.Tensor, parent_counts: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused: child bitsets + popcounts + per-pair class codes."""
    child, counts = intersect_pairs_ref(bits, pairs)
    return child, counts, classify_counts_ref(counts, _min_parent(parent_counts, pairs), tau)


def intersect_classify_count_ref(
    bits: torch.Tensor, pairs: torch.Tensor, parent_counts: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused count-only (k = k_max): counts + class codes, no child bitset."""
    counts = intersect_count_ref(bits, pairs)
    return counts, classify_counts_ref(counts, _min_parent(parent_counts, pairs), tau)
