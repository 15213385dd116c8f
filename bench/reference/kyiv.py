"""Plain reference of a cold mine: every minimal τ-infrequent itemset up to
``kmax`` with its support, and the Kyiv algorithm's count of each level.

It works from the raw table alone. Supports come from grouping the rows on
their values (a ``bincount`` over each column tuple's mixed-radix keys); no
bitset, no kernel, nothing of the program is used. The level counts follow
the paper's Algorithm 1 as sets:

* items: per column its values ascending, columns in order; the uniform
  items (support n) go, the τ-infrequent ones are answers of size 1, and
  items with one row set (mirrors, Prop. 4.1) keep the one with the lowest id
  as their canonical item; the rest are ordered by (support, column, first
  row) (Def. 4.5);
* level k joins the stored (k-1)-itemsets that share their first k-2 items
  (``candidates``), drops those with an unstored (k-1)-subset
  (``support_pruned``), and at ``k = kmax`` those that Lemma 4.6 or
  Corollary 4.7 prove frequent (``bound_pruned``); the rest are counted
  (``intersections``) and are skipped when absent or as frequent as their
  rarer join parent, emitted when at most τ, stored otherwise (below kmax);
* ``level_bytes`` is the level's stored rows and its parent rows at
  ``ceil(n / 32)`` 32-bit words a row.

Answers are ``((column, value), ...)`` tuples, column ascending, with their
support; an answer with a mirror item stands for every swap of mirrors.
``count_dtype`` is the integer type supports are held in: ``torch.int16``
is the control, which breaks the exact supports the configuration states.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["STAT_FIELDS", "Answer", "mine"]

STAT_FIELDS = (
    "k",
    "candidates",
    "support_pruned",
    "bound_pruned",
    "intersections",
    "emitted",
    "skipped_absent_uniform",
    "stored",
    "level_bytes",
)

# elements of one bincount's (rows x column tuples) key block
_KEY_BLOCK = 1 << 26


@dataclass
class Answer:
    itemsets: list  # sorted [(((column, value), ...), support), ...]
    stats: list  # [(k, candidates, ..., level_bytes), ...] per level


class _Items:
    """The table's items: column-major, values ascending (the program's ids)."""

    def __init__(self, table: torch.Tensor, cast):
        n, m = table.shape
        self.n = n
        codes, values, cols, freq, first = [], [], [], [], []
        rows = torch.arange(n, device=table.device)
        for c in range(m):
            uniq, inv, cnt = torch.unique(table[:, c], return_inverse=True, return_counts=True)
            fr = torch.full((len(uniq),), n, dtype=torch.int64, device=table.device)
            fr.scatter_reduce_(0, inv, rows, reduce="amin")
            codes.append(inv)
            values.append(uniq.cpu().numpy())
            cols.append(np.full(len(uniq), c, dtype=np.int64))
            freq.append(cast(cnt).cpu().numpy())
            first.append(fr.cpu().numpy())
        self.codes = torch.stack(codes, dim=1)  # (n, m) value code of each cell
        self.card = np.array([len(v) for v in values], dtype=np.int64)
        self.value = np.concatenate(values)
        self.col = np.concatenate(cols)
        self.code = np.concatenate([np.arange(k) for k in self.card])
        self.freq = np.concatenate(freq)
        self.first_row = np.concatenate(first)


def _supports(items: _Items, sets: np.ndarray, cast) -> np.ndarray:
    """Support of each row of ``sets`` (item ids, (s, k)) counted from the
    table: 0 where two items share a column."""
    s, k = sets.shape
    out = np.zeros(s, dtype=np.int64)
    if s == 0:
        return out
    cols = items.col[sets]
    order = np.argsort(cols, axis=1, kind="stable")
    cols = np.take_along_axis(cols, order, 1)
    codes = np.take_along_axis(items.code[sets], order, 1)
    live = np.all(cols[:, 1:] != cols[:, :-1], axis=1) if k > 1 else np.ones(s, bool)
    if not live.any():
        return out
    cols, codes = cols[live], codes[live]
    tuples, tuple_of = np.unique(cols, axis=0, return_inverse=True)
    tuple_of = tuple_of.reshape(-1)
    card = items.card[tuples]  # (u, k)
    # mixed-radix value key of a row within its tuple: last column fastest
    stride = np.ones_like(card)
    for i in range(k - 2, -1, -1):
        stride[:, i] = stride[:, i + 1] * card[:, i + 1]
    bins = stride[:, 0] * card[:, 0]
    counts = np.zeros(int(bins.sum()), dtype=np.int64)
    base = np.concatenate([[0], np.cumsum(bins)[:-1]])
    dev = items.codes.device
    per_block = max(1, _KEY_BLOCK // max(items.n, 1))
    for lo in range(0, len(tuples), per_block):
        hi = min(lo + per_block, len(tuples))
        t_cols = torch.as_tensor(tuples[lo:hi], device=dev)
        t_stride = torch.as_tensor(stride[lo:hi], device=dev)
        key = torch.as_tensor(base[lo:hi] - base[lo], device=dev).expand(items.n, -1).clone()
        for i in range(k):
            key += items.codes[:, t_cols[:, i]] * t_stride[:, i]
        span = int(base[hi - 1] + bins[hi - 1] - base[lo])
        counts[base[lo] : base[lo] + span] = torch.bincount(key.reshape(-1), minlength=span).cpu().numpy()
    at = base[tuple_of] + (codes * stride[tuple_of]).sum(axis=1)
    out[live] = cast(torch.as_tensor(counts[at])).numpy()
    return out


def _mirror_groups(items: _Items, kept: np.ndarray, cast) -> dict[int, list[int]]:
    """Canonical item -> its other items with the same row set (Prop. 4.1)."""
    fk = items.freq[kept]
    # two items share a row set when their joint support is each's support;
    # only items of equal support in different columns can
    a_idx, b_idx = np.nonzero((fk[:, None] == fk[None, :]) & np.triu(np.ones((len(kept),) * 2, bool), 1))
    a, b = kept[a_idx], kept[b_idx]
    diff = items.col[a] != items.col[b]
    a, b = a[diff], b[diff]
    same = _supports(items, np.stack([a, b], axis=1), cast) == items.freq[a]
    parent = {int(x): int(x) for x in kept}

    def root(x: int) -> int:
        while parent[x] != x:
            x = parent[x]
        return x

    for x, y in zip(a[same].tolist(), b[same].tolist()):
        rx, ry = root(x), root(y)
        if rx != ry:
            parent[max(rx, ry)] = min(rx, ry)
    groups: dict[int, list[int]] = {}
    for x in kept.tolist():
        groups.setdefault(root(x), []).append(x)
    return {r: sorted(g)[1:] for r, g in groups.items() if len(g) > 1}


def _keys(rows: np.ndarray, base: int) -> np.ndarray:
    key = np.zeros(rows.shape[0], dtype=np.int64)
    for c in range(rows.shape[1]):
        key = key * base + rows[:, c]
    return key


class _Level:
    """A stored level: itemsets as L positions (ascending in a row), rows in
    lexicographic order, with their supports."""

    def __init__(self, sets: np.ndarray, counts: np.ndarray, base: int):
        key = _keys(sets, base)
        order = np.argsort(key, kind="stable")
        self.sets, self.counts, self.key = sets[order], counts[order], key[order]
        self.base = base

    def lookup(self, sets: np.ndarray) -> np.ndarray:
        """Supports of ``sets``, -1 where not stored (the level is not empty)."""
        key = _keys(sets, self.base)
        at = np.minimum(np.searchsorted(self.key, key), len(self.key) - 1)
        return np.where(self.key[at] == key, self.counts[at], -1)


def _join(level: _Level) -> tuple[np.ndarray, np.ndarray]:
    """Every pair (i, j), i < j, of rows that share their first k-2 items."""
    t, k = level.sets.shape
    if k == 1:
        gid = np.zeros(t, dtype=np.int64)
    else:
        new = np.concatenate([[True], np.any(level.sets[1:, :-1] != level.sets[:-1, :-1], axis=1)])
        gid = np.cumsum(new) - 1
    sizes = np.bincount(gid)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    local = np.arange(t) - starts[gid]
    reps = sizes[gid] - 1 - local  # partners after each row in its group
    i = np.repeat(np.arange(t), reps)
    first = np.concatenate([[0], np.cumsum(reps)[:-1]])
    j = i + 1 + (np.arange(len(i)) - np.repeat(first, reps))
    return i, j


def _expand(ids: tuple[int, ...], mirrors: dict[int, list[int]]) -> list[tuple[int, ...]]:
    classes = [[i] + mirrors.get(i, []) for i in ids]
    return sorted({tuple(sorted(c)) for c in itertools.product(*classes)})


def mine(table, tau: int, kmax: int, *, device="cpu", count_dtype=torch.int64) -> Answer:
    """The reference answer and level counts of ``table`` ((n, m) integers)."""
    if count_dtype == torch.int64:
        cast = lambda x: torch.as_tensor(x).to(torch.int64)  # noqa: E731
    else:
        cast = lambda x: torch.as_tensor(x).to(count_dtype).to(torch.int64)  # noqa: E731
    tab = torch.as_tensor(np.asarray(table), dtype=torch.int64, device=device)
    items = _Items(tab, cast)
    n = items.n
    words = (n + 31) // 32
    freq = items.freq
    answers: list[tuple[tuple[int, ...], int]] = []

    infrequent = np.nonzero(freq <= tau)[0]
    answers += [((int(i),), int(freq[i])) for i in infrequent]
    kept = np.nonzero((freq > tau) & (freq < n))[0]
    mirrors = _mirror_groups(items, kept, cast)
    hidden = {x for g in mirrors.values() for x in g}
    canon = np.array([x for x in kept.tolist() if x not in hidden], dtype=np.int64)
    l_items = canon[np.lexsort((items.first_row[canon], items.col[canon], freq[canon]))]
    n_l = len(l_items)
    base = max(n_l, 2)
    stats = [(1, 0, 0, 0, 0, len(infrequent), 0, n_l, n_l * words * 4)]

    level = _Level(np.arange(n_l, dtype=np.int64)[:, None], freq[l_items].astype(np.int64), base)
    grand: _Level | None = None
    k = 2
    while k <= kmax and len(level.counts) >= 2:
        i, j = _join(level)
        cand = np.concatenate([level.sets[i], level.sets[j, -1:]], axis=1)
        n_cand = len(cand)
        ok = np.ones(n_cand, dtype=bool)
        for d in range(k - 2):  # the subsets that drop a prefix item
            ok &= level.lookup(np.delete(cand, d, axis=1)) >= 0
        i, j, cand = i[ok], j[ok], cand[ok]
        ci, cj = level.counts[i], level.counts[j]
        pruned = np.zeros(len(cand), dtype=bool)
        if k == kmax:
            # Lemma 4.6 with the prefix as I'
            prefix = grand.lookup(cand[:, : k - 2]) if k > 2 else np.full(len(cand), n)
            pruned = ci + cj > prefix + tau
            if k >= 3:  # Corollary 4.7 with c the prefix's last item
                wo_c = np.delete(cand, k - 3, axis=1)
                g0 = level.lookup(wo_c)
                g1 = grand.lookup(wo_c[:, :-1]) - ci
                g2 = grand.lookup(np.delete(wo_c, -2, axis=1)) - cj
                pruned |= g0 > np.minimum(g1, g2) + tau
        live = ~pruned
        i, j, cand, ci, cj = i[live], j[live], cand[live], ci[live], cj[live]
        cnt = _supports(items, l_items[cand], cast)
        skip = (cnt == 0) | (cnt == np.minimum(ci, cj))
        emit = ~skip & (cnt <= tau)
        store = ~skip & ~emit & (k < kmax)
        for row, c in zip(l_items[cand[emit]].tolist(), cnt[emit].tolist()):
            answers += [(ids, int(c)) for ids in _expand(tuple(sorted(row)), mirrors)]
        n_store = int(store.sum())
        stats.append((k, n_cand, n_cand - int(ok.sum()), int(pruned.sum()), len(cand),
                      int(emit.sum()), int(skip.sum()), n_store,
                      (n_store + len(level.counts)) * words * 4))
        grand, level = level, _Level(cand[store], cnt[store], base)
        k += 1

    itemsets = sorted(
        (tuple(sorted((int(items.col[i]), int(items.value[i])) for i in ids)), c) for ids, c in answers
    )
    return Answer(itemsets=itemsets, stats=stats)
