"""Device bodies of the BFS level frontier (Alg. 1 lines 11-29), as plain
torch ops that run wherever their tensors lie.

Three ops make a level transition device-to-device:

1. **Candidate-pair generation** (:func:`gen_support_body`): the prefix-join
   pair list of a batch of prefix groups is materialised from the groups'
   run lengths with ``repeat_interleave``/``cumsum`` — the device analogue
   of ``core.prefix.generate_candidates``, bit-identical in pair order.
2. **Support-itemset test** (same fused body): every candidate's prefix-drop
   subsets are packed into multiword int31 keys and binary-searched against
   the packed **parent key table** — the device analogue of
   ``core.support.ItemsetIndex``. Support-pruned pairs are then neutralised
   in place (:func:`mask_pruned_body`: self-pairs, which the fused
   classifier marks CLASS_SKIP), so pair order stays candidate order.
3. **Emit/store partitioning** (:func:`partition_body`): stable per-class
   ranks via ``cumsum`` + scatter (no sort) group a classified batch into
   [skip | emit | store] segments in candidate order.

Key packing: items are positions into ``L^<`` (``n_symbols`` of them), each
``b = bit_length(n_symbols - 1)`` bits. ``31 // b`` items pack big-endian
into each int32 word (no item straddles words, so word-wise lexicographic
order equals itemset order, and the lex-sorted parent table needs no sort).
Sentinel padding rows are ``INT32_MAX`` in every word; a real subset query
never equals one, because itemsets have strictly increasing members.

The numpy mirrors used by the parity tests live in ``ref.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SENTINEL",
    "pack_params",
    "pack_cols",
    "lower_bound",
    "lookup_keys",
    "gen_pairs_body",
    "support_ok_body",
    "gen_support_body",
    "mask_pruned_body",
    "partition_body",
]

SENTINEL = np.int32(2**31 - 1)


def pack_params(n_symbols: int, k: int) -> tuple[int, int, int]:
    """``(bits per item, items per word, words)`` for width-``k`` keys."""
    b = max(1, int(n_symbols - 1).bit_length()) if n_symbols > 1 else 1
    ipw = max(1, 31 // b)
    w = (k + ipw - 1) // ipw
    return b, ipw, w


def pack_cols(cols, b: int, ipw: int) -> torch.Tensor:
    """Pack ``k`` item columns (list of (M,) int tensors, lexicographic
    order) into ``(M, w)`` int32 key words, big-endian within each word."""
    k = len(cols)
    words = []
    for jw in range((k + ipw - 1) // ipw):
        word = torch.zeros_like(cols[0], dtype=torch.int32)
        for s, col in enumerate(cols[jw * ipw : (jw + 1) * ipw]):
            word |= col.to(torch.int32) << (b * (ipw - 1 - s))
        words.append(word)
    return torch.stack(words, dim=1)


def _lex_lt(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < q`` over ``(..., w)`` word vectors."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for wi in range(a.shape[-1]):
        lt |= eq & (a[..., wi] < q[..., wi])
        eq &= a[..., wi] == q[..., wi]
    return lt


def lower_bound(table: torch.Tensor, queries: torch.Tensor, *, t_pad: int) -> torch.Tensor:
    """First index whose key >= query, per query row.

    ``table`` is ``(t_pad, w)`` sorted (sentinel-padded to a power of two);
    branchless bisection in ``log2(t_pad)`` gather + compare steps.
    """
    pos = torch.zeros(queries.shape[0], dtype=torch.int64, device=queries.device)
    step = t_pad >> 1
    while step >= 1:
        cand = pos + step
        pos = torch.where(_lex_lt(table[cand - 1], queries), cand, pos)
        step >>= 1
    return pos


def lookup_keys(table: torch.Tensor, queries: torch.Tensor, *, t_pad: int) -> torch.Tensor:
    """Exact membership of each query key in the sorted table."""
    pos = lower_bound(table, queries, t_pad=t_pad)
    row = table[torch.clamp(pos, max=t_pad - 1)]
    return torch.all(row == queries, dim=-1)


def gen_pairs_body(reps_b: torch.Tensor, lo: int, mb: int, *, bucket: int):
    """Candidate (i, j) pair indices for one prefix-group batch.

    ``reps_b`` is the zero-padded run-length slice ``reps[lo:hi]`` (row ``r``
    of the batch is the *I* of ``reps_b[r]`` joins, and the runs sum to
    ``mb``). Row indices repeat by their run lengths and each pair's *J*
    offset is its rank within the row's run. Rows ``p >= mb`` are padding,
    masked invalid (their indices collapse to ``lo``).
    """
    dev = reps_b.device
    p = torch.arange(bucket, dtype=torch.int32, device=dev)
    reps_i = reps_b.to(torch.int32)
    cum = torch.cumsum(reps_i, 0, dtype=torch.int32)
    rows = torch.arange(reps_b.shape[0], dtype=torch.int32, device=dev)
    # repeat_interleave needs the exact total; the padding past the mb pairs
    # repeats the final row, as the reference's total_repeat_length does
    i_cl = torch.cat([
        torch.repeat_interleave(rows, reps_i, output_size=mb),
        rows[-1:].expand(bucket - mb),
    ])
    i_cl = i_cl.long()
    off = cum[i_cl] - reps_i[i_cl]
    j_loc = p - off + i_cl + 1
    valid = p < mb
    i = torch.where(valid, lo + i_cl, lo).to(torch.int32)
    j = torch.where(valid, lo + j_loc, lo).to(torch.int32)
    return i, j, valid


def support_ok_body(
    itemsets: torch.Tensor,
    key_table: torch.Tensor,
    pairs: torch.Tensor,
    valid: torch.Tensor,
    *,
    k: int,
    t_pad: int,
    bits: int,
    ipw: int,
) -> torch.Tensor:
    """Support-itemset test (Alg. 1 line 23) for generated pairs.

    The candidate of pair ``(i, j)`` is ``itemsets[i] + last(itemsets[j])``;
    the two subsets dropping one of the joined parents are stored by
    construction, so only the ``k-1`` prefix-drop subsets need lookups.
    Verdicts are identical to ``core.support.support_test``.
    """
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    prefix = itemsets[i]  # (m, k) — the I parent supplies the prefix
    last_j = itemsets[j, k - 1]  # J's last item completes the candidate
    ok = valid
    if k >= 2:
        cand_cols = [prefix[:, c] for c in range(k)] + [last_j]
        for drop in range(k - 1):
            sub_cols = [cand_cols[c] for c in range(k + 1) if c != drop]
            queries = pack_cols(sub_cols, bits, ipw)
            ok = ok & lookup_keys(key_table, queries, t_pad=t_pad)
    return ok


def gen_support_body(
    itemsets: torch.Tensor,
    key_table: torch.Tensor,
    reps_b: torch.Tensor,
    lo: int,
    mb: int,
    *,
    k: int,
    bucket: int,
    t_pad: int,
    bits: int,
    ipw: int,
):
    """Fused candidate generation + support-itemset test for one batch.

    Returns ``(pairs (bucket, 2) int32, ok (bucket,) bool)`` where ``ok`` is
    False for padding rows and for candidates with a missing (k-1)-subset.
    """
    i, j, valid = gen_pairs_body(reps_b, lo, mb, bucket=bucket)
    pairs = torch.stack([i, j], dim=1)
    ok = support_ok_body(itemsets, key_table, pairs, valid, k=k, t_pad=t_pad, bits=bits, ipw=ipw)
    return pairs, ok


def mask_pruned_body(pairs: torch.Tensor, ok: torch.Tensor):
    """Neutralise support-pruned candidates in place (no reorder).

    Pruned (and padding) rows become self-pairs of the batch's first row,
    which the fused classifier marks CLASS_SKIP. Returns ``(pairs, n_ok)``
    with ``n_ok`` an int32 device scalar.
    """
    fill = pairs[0, 0]
    out = torch.where(ok[:, None], pairs, fill)
    return out, ok.sum(dtype=torch.int32)


def partition_body(classes: torch.Tensor):
    """Stable ranks per class (``cumsum`` + scatter, no sort) group the batch
    into [skip | emit | store] segments, each in candidate order. Returns
    ``(order, n_emit, n_store)`` where ``order`` lists original batch indices
    segment by segment — exactly a stable argsort by class code."""
    emit = classes == 1
    store = classes == 2
    e_i = emit.to(torch.int32)
    s_i = store.to(torch.int32)
    n_emit = e_i.sum(dtype=torch.int32)
    n_store = s_i.sum(dtype=torch.int32)
    b = classes.shape[0]
    n_skip = b - n_emit - n_store
    skip_i = 1 - e_i - s_i
    pos = torch.where(
        emit,
        n_skip + torch.cumsum(e_i, 0, dtype=torch.int32) - 1,
        torch.where(
            store,
            n_skip + n_emit + torch.cumsum(s_i, 0, dtype=torch.int32) - 1,
            torch.cumsum(skip_i, 0, dtype=torch.int32) - 1,
        ),
    )
    order = torch.empty(b, dtype=torch.int32, device=classes.device)
    order[pos.long()] = torch.arange(b, dtype=torch.int32, device=classes.device)
    return order, n_emit, n_store
