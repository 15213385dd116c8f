"""The per-item index of nonzero words behind the anchored coverage path,
and the rule that picks the anchored or the scanning kernel for a batch.

A quasi-identifier covers no more records than its rarest member, and a
mined QI's rarest member is rare: at 500,000 rows of the exposed table its
item has ~200 nonzero words out of 15,625. The anchored path walks only
those words. :func:`build_coverage_index` lists each item's nonzero words
once, when a table's bitsets become resident; :func:`anchored_plan` decides
from the host copy of the per-item counts, with no device synchronisation,
whether a batch walks anchors or scans every word; :func:`anchors` and
:func:`walk_anchors` are the walk itself in torch ops, which the plain
version of the anchored kernel sums and the smoke's bound counts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "CoverageIndex",
    "build_coverage_index",
    "anchored_plan",
    "anchors",
    "walk_anchors",
    "AnchorWalk",
    "ANCHOR_WORK_FACTOR",
]

# a batch walks anchors when its anchors' nonzero words, times this factor,
# are no more than its live sets times the words a scan reads: the host
# engine's rule (``ref.coverage_accumulate_host``), with nonzero words in
# place of popcounts
ANCHOR_WORK_FACTOR = 8


class CoverageIndex(NamedTuple):
    """Nonzero words of every row of a ``(t, W)`` bitset matrix.

    Row ``i``'s nonzero words are ``words[offsets[i]:offsets[i + 1]]``,
    ascending; ``counts`` is the host copy of ``offsets``' differences."""

    offsets: torch.Tensor  # (t + 1,) int64, on the bitsets' device
    words: torch.Tensor  # (nnz,) int32, on the bitsets' device
    counts: np.ndarray  # (t,) int64, on the host

    def nbytes(self) -> int:
        return self.offsets.numel() * 8 + self.words.numel() * 4


class AnchorWalk(NamedTuple):
    """The walk of ``L`` sets over their anchors' nonzero words: one entry
    per (set, anchor word) pair, ``P`` in all."""

    set_of: torch.Tensor  # (P,) int64, the pair's set (a row of the walked sets)
    word: torch.Tensor  # (P,) int64, the pair's word
    x: torch.Tensor  # (P,) int32, the AND of the set's members' words there
    reads: torch.Tensor | None  # (R,) int64, item * W + word of every member word read


def build_coverage_index(bits: torch.Tensor, block_elems: int = 1 << 26) -> CoverageIndex:
    """The index of ``bits`` (``(t, W)`` int32 words), built with torch ops
    on the bitsets' own device, ``block_elems`` words of rows at a time so
    that ``torch.nonzero``'s temporaries stay bounded. Zero words (the word
    padding among them) never appear."""
    if bits.dim() != 2:
        raise ValueError(f"bits must be (t, W), got {tuple(bits.shape)}")
    t, w = bits.shape
    rows = max(1, block_elems // max(w, 1))
    words, counts = [], []
    for s in range(0, t, rows):
        block = bits[s : s + rows]
        nz = torch.nonzero(block)  # (n, 2) int64, row-major: words ascend per row
        words.append(nz[:, 1].to(torch.int32))
        counts.append(torch.bincount(nz[:, 0], minlength=block.shape[0]))
    dev = bits.device
    counts_t = torch.cat(counts) if counts else torch.zeros(0, dtype=torch.int64, device=dev)
    offsets = torch.zeros(t + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts_t, 0)
    words_t = torch.cat(words) if words else torch.zeros(0, dtype=torch.int32, device=dev)
    return CoverageIndex(offsets, words_t, counts_t.cpu().numpy().astype(np.int64))


def anchored_plan(counts: np.ndarray, sets: np.ndarray, weights: np.ndarray,
                  n_words: int) -> tuple[bool, int]:
    """``(anchored, max_anchor_words)`` for one batch: whether it walks
    anchors, and the most nonzero words of a live set's anchor (the member
    with the fewest). Weight-0 sets need no work."""
    live = np.asarray(weights) != 0
    if not live.any():
        return True, 0
    anchor_words = np.asarray(counts)[np.asarray(sets)[live]].min(axis=1)
    anchored = int(anchor_words.sum()) * ANCHOR_WORK_FACTOR <= int(live.sum()) * int(n_words)
    return anchored, int(anchor_words.max())


def anchors(index: CoverageIndex, sets: torch.Tensor) -> torch.Tensor:
    """Each set's anchor: of the ``(L, K)`` int64 ``sets``, the member with
    the fewest nonzero words in ``index``, the first on ties."""
    counts = index.offsets[1:] - index.offsets[:-1]
    return sets.gather(1, torch.argmin(counts[sets], dim=1)[:, None])[:, 0]


def walk_anchors(bits: torch.Tensor, index: CoverageIndex, sets: torch.Tensor,
                 anchor: torch.Tensor, *, reads: bool = False) -> AnchorWalk:
    """The anchored kernel's walk over ``sets`` (``(L, K)`` int64) and their
    ``anchor`` items (``(L,)``, from :func:`anchors`): every nonzero word of
    each set's anchor and the AND of the set's members' words there. With
    ``reads``, also the member words the kernel reads: the anchor's, then
    each other member's until the AND is 0."""
    w = bits.shape[1]
    dev = bits.device
    n, start = index.offsets[anchor + 1] - index.offsets[anchor], index.offsets[anchor]
    total = int(n.sum().item())
    set_of = torch.repeat_interleave(torch.arange(len(n), device=dev), n)
    pos = (torch.arange(total, device=dev) - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
           + torch.repeat_interleave(start, n))
    word = index.words[pos].long()
    a = anchor[set_of]
    x = bits[a, word]
    keys = [a * w + word] if reads else None
    for j in range(sets.shape[1]):
        item = sets[set_of, j]
        if reads:
            read = (x != 0) & (item != a)
            keys.append(item[read] * w + word[read])
        x &= bits[item, word]
    return AnchorWalk(set_of, word, x, torch.cat(keys) if reads else None)
