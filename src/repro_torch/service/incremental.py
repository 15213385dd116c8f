"""Incremental re-mining after row-block appends (support monotonicity).

Appending rows can only *grow* an itemset's support. That single fact pins
down exactly how the answer set evolves between a cached base result and the
current store version:

* A minimal τ-infrequent itemset of the base table stays minimal as long as
  its own support stays ≤ τ — its proper subsets were frequent and frequency
  is append-monotone. So every cached result only needs a **recount on the
  appended rows** (``DatasetStore.delta_bits``): new support = old support +
  delta support, at a cost proportional to the delta block, not the table.
* A cached result whose support crossed τ is **promoted** to frequent. Any
  *new* minimal itemset ``S`` (one not in the base answer) was τ-infrequent
  in the base table too (monotonicity), hence contained a base-minimal
  subset; that subset is a proper subset of ``S``, is frequent now, and was
  therefore promoted. New items (values first seen in the delta) are the one
  exception — they had no base support at all; frequent new singletons seed
  the same way. So the full frontier of change is::

      seeds = promoted base results  ∪  frequent brand-new singleton items

  and every new minimal itemset is a strict superset of a seed.
* Seeds sit *near the τ boundary by construction*: a promoted itemset has
  new support ≤ τ + d (d = appended rows), so its frequent supersets live in
  the thin band (τ, τ + d] — the expansion work shrinks with the delta.
* One family has no base-minimal subset to seed from: itemsets that were
  **absent** (support 0) in the base table. Cold Kyiv skips absent
  candidates, so nothing about them is cached. But support 0 at the base
  means their entire support lies in the delta block — every such itemset
  is a subset of some appended row's items, so ``_delta_born`` enumerates
  the ≤kmax column combinations of each appended row (cost per row is a
  function of table *width*, not history) and classifies them directly.

``_expand_seeds`` explores exactly that band: a BFS over supersets of each
seed within the frequent item universe, pruning any infrequent node (an
infrequent proper subset disqualifies every superset from minimality) and
verifying minimality of emitted sets directly against the store bitsets.
Mirror items need no special casing — the BFS enumerates concrete item ids,
which is precisely the ``expansion="full"`` closure the cold miner produces
(incremental mining therefore requires ``KyivConfig.expansion == "full"``,
the default).

Past a configurable delta fraction — or if the boundary band turns out not
to be thin (expansion budget exhausted) — ``mine_incremental`` signals the
caller to fall back to a cold ``mine()``; the result is bit-identical either
way (tested against cold mining in ``tests/test_torch_incremental.py``).

Two refinements ride on top of the base scheme:

* **Near-boundary bands** (:class:`ResultBands`): the result cache persists
  per-arity, count-sorted matrices of the cached itemsets. At recount time
  the per-item delta frequencies bound each cached itemset's delta support
  from above (``ub = min dfreq over members``); ``ub == 0`` proves the delta
  support is exactly 0, so only itemsets whose *every* member actually
  appears in the appended rows pay the bitset AND — the recount floor is
  delta-proportional instead of O(|cached results|), and the promotion scan
  is confined to the ``(τ - d, τ]`` band the sorted counts expose.
* **The resident frontier**: the seed expansion's (node × extension-item)
  support counts run as batched intersect dispatches through the service's
  placement, their extension rows gathered on the device from the store's
  resident bitsets (``DatasetStore.device_bits``).
* **Fleet mode**: when the store is process-sharded and ``placement`` is a
  :class:`~repro_torch.core.fleet.FleetPlacement`, every popcount in this
  module is a partial sum over local word stripes. Host count vectors funnel
  through one ``allreduce_sum`` per stage (recount, expansion minimality,
  delta-born delta supports); every count dispatched through the placement
  (the expansion waves, the delta-born full supports) is all-reduced by
  the placement itself. Delta-born candidates are unioned by one all-gather
  (each process sees only its own delta rows), and budget decisions are
  taken on the *global* pool so every process falls back — or doesn't — in
  lockstep.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.bitops import popcount_rows
from ..core.items import WORD_BITS, ItemTable
from ..core.kyiv import KyivConfig, LevelStats, MiningResult
from ..core.placement import HostPlacement
from ..core.preprocess import Preprocessed
from ..kernels.intersect.ops import LevelPipeline, _pad_pairs
from .store import DatasetStore, mask_delta_words, mask_delta_words_local

__all__ = ["IncrementalConfig", "ResultBands", "mine_incremental", "delta_support"]


@dataclasses.dataclass
class IncrementalConfig:
    """Knobs for the append-delta mining path."""

    # past this appended-rows fraction of the current table, recounting +
    # boundary expansion loses to simply re-mining cold
    max_delta_fraction: float = 0.25
    # frontier-node limit for the boundary expansion BFS; exhausted => the
    # boundary band is not thin, fall back to cold mining
    expansion_budget: int = 4096
    # cap on deduplicated delta-born candidate itemsets (subsets of appended
    # rows); exhausted => fall back to cold mining
    delta_candidate_budget: int = 262_144
    enabled: bool = True


def _delta_word_lo(word_map: np.ndarray, base_rows: int) -> int:
    """First local word of a process-sharded snapshot that holds a delta
    row (the word map is increasing)."""
    return int(np.searchsorted(word_map, base_rows // WORD_BITS))


def _delta_bits_of(
    table: ItemTable, base_rows: int, word_map: np.ndarray | None = None
) -> np.ndarray:
    """Delta-row bitsets derived from an immutable snapshot table (same
    contract as ``DatasetStore.delta_bits``, but safe against appends that
    land while this mining request is running). ``word_map`` marks the
    snapshot as process-sharded: delta words are scattered round-robin, so
    pre-existing rows are zeroed in place (``mask_delta_words_local``), and
    the local words before the first delta word are sliced off as the
    unsharded path slices them (their map is ``word_map[_delta_word_lo:]``):
    a full local width would make the delta-born gather ``dbits[candidates]``
    as large as the table for every candidate (about 50 GB for 200,000
    candidates at a million rows)."""
    if word_map is not None:
        lo = _delta_word_lo(word_map, base_rows)
        sub = np.ascontiguousarray(table.bits[:, lo:])
        return mask_delta_words_local(sub, base_rows, word_map[lo:])
    return mask_delta_words(table.bits, base_rows)[0]


def delta_support(
    dbits: np.ndarray, itemsets: list[tuple[int, ...]]
) -> np.ndarray:
    """Support of each itemset restricted to the delta rows.

    ``dbits`` is the ``DatasetStore.delta_bits`` slice: (n_items, W_delta).
    Itemsets are grouped by arity and AND-reduced vectorised; total cost is
    O(sum_k r_k * k * W_delta).
    """
    out = np.zeros(len(itemsets), dtype=np.int64)
    by_k: dict[int, list[int]] = {}
    for idx, ids in enumerate(itemsets):
        by_k.setdefault(len(ids), []).append(idx)
    for k, idxs in by_k.items():
        mat = np.asarray([itemsets[i] for i in idxs], dtype=np.int64)  # (r, k)
        inter = np.bitwise_and.reduce(dbits[mat], axis=1)  # (r, Wd)
        out[idxs] = popcount_rows(inter)
    return out


@dataclasses.dataclass
class ResultBands:
    """Per-arity, count-sorted views of a cached result set.

    Built once when a mining result enters the cache and persisted beside
    it (``CacheEntry.bands``), so an append burst pays only the recount this
    structure admits: ``recount`` bounds each itemset's delta support by the
    minimum delta frequency of its members and runs the exact bitset AND
    only where that bound is non-zero; the ascending base counts confine
    promotion candidates to the thin ``(τ - d, τ]`` boundary band.
    """

    mats: dict[int, np.ndarray]  # arity -> (r, k) int64 ids, count-ascending
    counts: dict[int, np.ndarray]  # arity -> (r,) int64 base counts, ascending
    index: dict[int, np.ndarray]  # arity -> (r,) position in cached order

    @classmethod
    def from_result(cls, itemsets: list[tuple[tuple[int, ...], int]]) -> "ResultBands":
        by_k: dict[int, list[tuple[int, tuple[int, ...], int]]] = {}
        for pos, (ids, cnt) in enumerate(itemsets):
            by_k.setdefault(len(ids), []).append((pos, ids, cnt))
        mats, counts, index = {}, {}, {}
        for k, rows in by_k.items():
            cnt = np.asarray([c for _, _, c in rows], dtype=np.int64)
            order = np.argsort(cnt, kind="stable")
            mats[k] = np.asarray([ids for _, ids, _ in rows], dtype=np.int64)[order]
            counts[k] = cnt[order]
            index[k] = np.asarray([p for p, _, _ in rows], dtype=np.int64)[order]
        return cls(mats=mats, counts=counts, index=index)

    def nbytes(self) -> int:
        return sum(
            a.nbytes
            for d in (self.mats, self.counts, self.index)
            for a in d.values()
        )

    def recount(
        self,
        dbits: np.ndarray,
        dfreq: np.ndarray,
        tau: int,
        d: int,
        reduce_fn=None,
    ) -> tuple[np.ndarray, dict]:
        """New (base + delta) support of every cached itemset, in cached
        order, touching bitsets only where the ``dfreq`` upper bound admits a
        non-zero delta. ``dfreq`` must be the *global* per-item delta
        frequency; under a fleet ``reduce_fn`` sums the partial popcounts
        (one collective for all arities — the upper-bound filter is computed
        from global values, so every process recounts the identical rows).
        Returns ``(new_counts, stats)``."""
        total = sum(len(c) for c in self.counts.values())
        new = np.zeros(total, dtype=np.int64)
        n_recounted = 0
        n_band = 0
        chunks: list[tuple[int, np.ndarray, np.ndarray]] = []
        for k in sorted(self.mats):
            mat, cnt = self.mats[k], self.counts[k]
            if len(cnt) == 0:
                continue
            # ascending base counts: everything past this point could cross τ
            n_band += len(cnt) - int(np.searchsorted(cnt, tau - d, side="right"))
            if k == 1:
                # singleton delta support IS the delta frequency — no AND
                new[self.index[k]] = cnt + dfreq[mat[:, 0]]
                continue
            ub = dfreq[mat].min(axis=1)
            need = np.nonzero(ub > 0)[0]
            n_recounted += len(need)
            new[self.index[k]] = cnt  # ub == 0 rows are exact as-is
            if len(need):
                inter = np.bitwise_and.reduce(dbits[mat[need]], axis=1)
                chunks.append((k, need, popcount_rows(inter).astype(np.int64)))
        if chunks:
            flat = np.concatenate([c for _, _, c in chunks])
            if reduce_fn is not None:
                flat = reduce_fn(flat)
            off = 0
            for k, need, c in chunks:
                new[self.index[k][need]] += flat[off : off + len(need)]
                off += len(need)
        stats = {
            "n_recounted": n_recounted,
            "n_recount_skipped": total - n_recounted,
            "n_promotion_band": n_band,
        }
        return new, stats


def _filter_minimal(
    table: ItemTable, cands: dict[frozenset, int], tau: int, reduce_fn=None
) -> dict[frozenset, int]:
    """Keep the minimal members of a τ-infrequent candidate pool, batched.

    Every distinct (|S|-1)-subset across all arity ≥ 3 candidates is counted
    once in one vectorised pass instead of one leave-one-out probe per
    candidate — under a fleet that is a single partial-popcount all-reduce.
    Arity 1 is minimal by definition; arity 2 checks global frequencies.
    """
    freq = table.freq
    bits = table.bits
    sub_index: dict[tuple[int, ...], int] = {}
    sub_list: list[tuple[int, ...]] = []
    refs_of: dict[frozenset, list[int]] = {}
    for cs in cands:
        if len(cs) <= 2:
            continue
        ids = tuple(sorted(cs))
        refs = []
        for drop in range(len(ids)):
            sub = ids[:drop] + ids[drop + 1 :]
            ix = sub_index.get(sub)
            if ix is None:
                ix = len(sub_list)
                sub_index[sub] = ix
                sub_list.append(sub)
            refs.append(ix)
        refs_of[cs] = refs
    sup = np.zeros(len(sub_list), dtype=np.int64)
    if sub_list:
        by_k: dict[int, list[int]] = {}
        for ix, sub in enumerate(sub_list):
            by_k.setdefault(len(sub), []).append(ix)
        parts = []
        for kk in sorted(by_k):
            idxs = by_k[kk]
            mat = np.asarray([sub_list[i] for i in idxs], dtype=np.int64)
            inter = np.bitwise_and.reduce(bits[mat], axis=1)
            parts.append((idxs, popcount_rows(inter).astype(np.int64)))
        flat = np.concatenate([p for _, p in parts])
        if reduce_fn is not None:
            flat = reduce_fn(flat)
        off = 0
        for idxs, p in parts:
            sup[idxs] = flat[off : off + len(p)]
            off += len(p)
    out: dict[frozenset, int] = {}
    for cs, cnt in cands.items():
        if len(cs) == 1:
            ok = True
        elif len(cs) == 2:
            a, b = tuple(cs)
            ok = bool(freq[a] > tau and freq[b] > tau)
        else:
            ok = all(sup[ix] > tau for ix in refs_of[cs])
        if ok:
            out[cs] = cnt
    return out


def _expand_seeds(
    table: ItemTable,
    seeds: list[tuple[int, ...]],
    tau: int,
    kmax: int,
    budget: int,
    *,
    placement=None,
    resident_bits=None,
    reduce_fn=None,
) -> dict[frozenset, int] | None:
    """All minimal τ-infrequent strict supersets of any seed, up to kmax.

    Level-synchronous BFS over the **resident frontier**: each wave's
    (node × extension-item) support counts are one batched intersect
    dispatch through the service's :class:`~repro_torch.kernels.intersect.ops.LevelPipeline`
    — the extension items gather on the device from the store's resident
    bitset tensor (``resident_bits``, int32 words with a padded word axis)
    instead of re-gathering host levels, so the hot popcount loop runs
    wherever mining itself runs (host numpy or the card). Only surviving
    nodes' bitsets are re-derived on the host (two-row ANDs) to seed the
    next wave.

    Returns None when the explored node count exceeds ``budget`` (caller
    re-mines cold). Every wave node is a *frequent* superset of a seed; an
    infrequent node is classified once (emit if minimal) and never extended,
    because its supersets all contain an infrequent proper subset.
    """
    n = table.n_rows
    freq = table.freq
    bits = table.bits
    ext_universe = np.nonzero((freq > tau) & (freq < n))[0].astype(np.int64)
    found: dict[frozenset, int] = {}
    if len(ext_universe) == 0:
        return found
    visited: set[frozenset] = set()
    wave: list[tuple[frozenset, np.ndarray]] = []
    for ids in seeds:
        fs = frozenset(int(i) for i in ids)
        if len(fs) >= kmax or fs in visited:
            continue
        visited.add(fs)
        wave.append((fs, np.bitwise_and.reduce(bits[list(fs)], axis=0)))

    if placement is None:
        placement = HostPlacement()
    on_device = placement.kind != "host" and resident_bits is not None
    ext_host = bits[ext_universe]  # host copy: seeds the next wave's bits
    if on_device:
        # gathered where the resident rows live; they keep its word padding
        ext_res = placement.take_rows(resident_bits, ext_universe)
    else:
        ext_res = ext_host

    e_count, w_words = ext_host.shape
    # two budgets: nodes whose bitsets join the resident matrix per segment
    # (the extension block is re-placed once per *segment* — usually once
    # per wave; placing it exactly once per call would need a two-block
    # pair addressing scheme the placement API doesn't speak, and waves are
    # shallow by the thin-boundary-band premise), and rows per submit
    # bounding the dispatch working set: the host placement materialises
    # both gathered operands plus the AND, ~3 * pairs * W words per submit
    seg_nodes = max(1, (1 << 24) // max(w_words, 1))
    rows_per_submit = max(1, (1 << 23) // max(e_count * max(w_words, 1), 1))
    popped = 0
    while wave:
        popped += len(wave)
        if popped > budget:
            return None
        next_wave: list[tuple[frozenset, np.ndarray]] = []
        for s0 in range(0, len(wave), seg_nodes):
            seg = wave[s0 : s0 + seg_nodes]
            f_count = len(seg)
            wave_bits = np.stack([wb for _, wb in seg])
            if on_device:
                mat = placement.cat_rows([ext_res, placement.put_bits(wave_bits)])
            else:
                mat = np.concatenate([ext_res, wave_bits], axis=0)
            pipe = LevelPipeline(
                mat,
                np.zeros(e_count + f_count, dtype=np.int64),
                tau=0,
                placement=placement,
                fused_classify=False,
                locality_sort=False,
                n_words=w_words,
            )
            for s in range(0, f_count, rows_per_submit):
                chunk = seg[s : s + rows_per_submit]
                c_count = len(chunk)
                fi = (
                    np.repeat(np.arange(s, s + c_count, dtype=np.int64), e_count)
                    + e_count
                )
                ei = np.tile(np.arange(e_count, dtype=np.int64), c_count)
                pairs = np.stack([fi, ei], axis=1).astype(np.int32)
                _, counts, _ = pipe.submit(pairs, False).result()
                counts = counts.reshape(c_count, e_count)
                for fidx, (fs, fb) in enumerate(chunk):
                    # absent extensions (the overwhelming majority in sparse
                    # data) die before any set building
                    for eidx in np.nonzero(counts[fidx])[0]:
                        x = int(ext_universe[eidx])
                        if x in fs:
                            continue
                        cs = fs | {x}
                        if cs in visited:
                            continue
                        visited.add(cs)
                        cnt = int(counts[fidx, eidx])
                        if cnt > tau:
                            if len(cs) < kmax:
                                next_wave.append((cs, fb & ext_host[eidx]))
                        else:
                            # minimality is deferred: one batched subset-
                            # support pass after the BFS (a single
                            # collective under a fleet) replaces
                            # per-emission probes
                            found[cs] = cnt
            pipe.retire()
        wave = next_wave
    return _filter_minimal(table, found, tau, reduce_fn)


def _delta_born(
    table: ItemTable,
    dbits: np.ndarray,
    base_rows: int,
    tau: int,
    kmax: int,
    budget: int,
    *,
    placement=None,
    resident_bits=None,
    word_map: np.ndarray | None = None,
    coll=None,
) -> dict[frozenset, int] | None:
    """Minimal τ-infrequent itemsets whose base support was 0.

    Their whole support lies in the appended rows, so every one is a subset
    of the items of at least one delta row. Delta rows are reconstructed
    from the item-major delta bitsets, each row's items are filtered to the
    frequent non-uniform universe (an infrequent or uniform member disquali-
    fies minimality immediately), and the surviving ≤kmax combinations whose
    delta support lies in [1, τ] (the full support is at least that) are
    counted against the full-width bitsets and checked for minimality
    directly. The full-width count runs on the service's device from the
    store's resident bitsets when ``placement``/``resident_bits`` are given
    (an append of a thousand Poker-hand rows sends about 200,000 candidates,
    each reading half a megabyte at a million rows), else on the host.
    Returns None when the deduplicated candidate pool exceeds ``budget``.

    Under a fleet (``word_map`` + ``coll``) each process reconstructs only
    the delta rows living in its own word stripes, so the candidate pools
    are unioned by one all-gather and the budget verdict is taken on the
    *global* pool — either every process falls back to cold mining or none
    does. The delta supports are all-reduced before the [1, τ] filter, and
    the full-width counts are global (the placement's all-reduce, or one
    collective over the host counts).
    """
    import itertools

    n = table.n_rows
    freq = table.freq
    bits = table.bits
    d = n - base_rows
    if d <= 0 or kmax < 2:
        return {}
    # item-major delta bits -> per-row item lists (delta-scaled unpack)
    flat = np.unpackbits(
        np.ascontiguousarray(dbits).view(np.uint8), axis=1, bitorder="little"
    )  # (n_items, W*32); column j of word w = that word's row (w*32 + j)
    if word_map is None:
        lo = (base_rows // 32) * 32
        row_items = flat[:, base_rows - lo : n - lo]  # (n_items, d)
    else:
        # sharded width: column c covers global row word_map[c // 32]*32 +
        # c % 32; keep this process's columns inside the delta row range
        wm = np.asarray(word_map, dtype=np.int64)
        grow = wm.repeat(32) * 32 + np.tile(np.arange(32, dtype=np.int64), len(wm))
        row_items = flat[:, (grow >= base_rows) & (grow < n)]
    keep = (freq > tau) & (freq < n)

    cands: set[tuple[int, ...]] = set()
    overflow = False
    for r in range(row_items.shape[1]):
        items = np.nonzero(row_items[:, r])[0]
        items = items[keep[items]]
        for k in range(2, min(kmax, len(items)) + 1):
            for combo in itertools.combinations(items.tolist(), k):
                cands.add(combo)
                if len(cands) > budget:
                    if coll is None:
                        return None
                    overflow = True  # verdict deferred to the global union
                    break
            if overflow:
                break
        if overflow:
            break
    if coll is not None:
        pools = coll.allgather_obj((sorted(cands), overflow))
        if any(o for _, o in pools):
            return None
        union: set[tuple[int, ...]] = set()
        for pool, _ in pools:
            union.update(tuple(c) for c in pool)
        if len(union) > budget:
            return None
        cands = union
    reduce_fn = coll.allreduce_sum if coll is not None else None

    pre: dict[frozenset, int] = {}
    by_k: dict[int, list[tuple[int, ...]]] = {}
    for c in sorted(cands):
        by_k.setdefault(len(c), []).append(c)
    for k in sorted(by_k):
        sets_k = by_k[k]
        mat = np.asarray(sets_k, dtype=np.int64)  # (r, k)
        dcounts = popcount_rows(np.bitwise_and.reduce(dbits[mat], axis=1))
        if reduce_fn is not None:
            dcounts = reduce_fn(dcounts)
        # the full support is at least the delta support, so only 1 <= dcnt
        # <= tau can qualify: only those pay the full-width count
        live = np.nonzero((dcounts >= 1) & (dcounts <= tau))[0]
        if placement is not None and placement.kind != "host" and resident_bits is not None:
            full = _full_supports_resident(placement, resident_bits, mat[live], table.n_words)
        else:
            full = _full_supports(bits, mat[live])
            if reduce_fn is not None:
                full = reduce_fn(full)
        for i, cnt in zip(live.tolist(), full.tolist()):
            # cnt == dcnt <=> base support 0: itemsets present at the base are
            # exactly the family already covered by recount + seed expansion
            if cnt == int(dcounts[i]):
                pre[frozenset(sets_k[i])] = cnt
    return _filter_minimal(table, pre, tau, reduce_fn)


def _full_supports(bits: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Full-table supports of the ``(r, k)`` itemsets ``mat``, gathered in
    row chunks of about 64 MB: a million-row table's words make each
    itemset's gathered rows half a megabyte."""
    if len(mat) == 0:
        return np.zeros(0, dtype=np.int64)
    step = max(1, (1 << 26) // (mat.shape[1] * bits.shape[1] * 4))
    return np.concatenate([
        popcount_rows(np.bitwise_and.reduce(bits[mat[s : s + step]], axis=1))
        for s in range(0, len(mat), step)
    ])


_RESIDENT_CHUNK_BYTES = 1 << 30


def _full_supports_resident(placement, resident, mat: np.ndarray, n_words: int) -> np.ndarray:
    """Full-table supports of the ``(r, k)`` itemsets ``mat`` on the
    placement's device, from the store's resident rows (``resident``: int32
    words, padded word axis; row i is item i). Per chunk, ``k - 1`` pairwise
    AND dispatches through the level pipeline: the partial ANDs stay on the
    device beside the resident rows, and only the counts come back. A
    chunk's partial rows take at most ``_RESIDENT_CHUNK_BYTES``, in a
    power-of-two count of rows (a full bucket: no padding pairs)."""
    r, k = mat.shape
    out = np.zeros(r, dtype=np.int64)
    t = int(resident.shape[0])
    rows_fit = _RESIDENT_CHUNK_BYTES // (int(resident.shape[1]) * 4)
    step = 1 << max(0, rows_fit.bit_length() - 1)
    for s in range(0, r, step):
        sub = mat[s : s + step]
        c = len(sub)
        rows, left = resident, sub[:, 0]
        for pos in range(1, k):
            write = pos < k - 1
            pipe = LevelPipeline(
                rows,
                np.zeros(len(rows), dtype=np.int64),
                tau=0,
                placement=placement,
                fused_classify=False,
                locality_sort=False,
                n_words=n_words,
            )
            pairs = np.stack([left, sub[:, pos]], axis=1).astype(np.int32)
            handle = pipe.submit_padded(_pad_pairs(pairs, placement.padded_size(c)), c, write)
            if write:
                rows = placement.cat_rows(
                    [resident, placement.take_rows(handle.raw()[0], np.arange(c))])
                left = np.arange(t, t + c)
            else:
                out[s : s + c] = handle.result()[1]
            pipe.retire()
    return out


def _light_prep(table: ItemTable, tau: int) -> Preprocessed:
    """A Preprocessed container for incremental results: correct item
    partitions and ordering metadata, but no mirror hashing and no l_bits
    gather — the incremental path never re-enters the level miner, and
    skipping the O(items * W) work keeps its cost delta-dominated."""
    freq = table.freq
    n = table.n_rows
    uniform = np.nonzero(freq == n)[0]
    infrequent = np.nonzero(freq <= tau)[0]
    keep = np.nonzero((freq > tau) & (freq < n))[0]
    order = np.lexsort((table.min_row[keep], table.col[keep], freq[keep]))
    l_items = keep[order]
    return Preprocessed(
        table=table,
        tau=tau,
        uniform_items=uniform,
        infrequent_items=infrequent,
        l_items=l_items,
        mirror_of={},
        l_bits=np.zeros((0, table.n_words), dtype=np.uint32),
        l_freq=freq[l_items].astype(np.int64),
    )


def mine_incremental(
    store: DatasetStore,
    base_result: MiningResult,
    base_version: int,
    config: KyivConfig,
    inc_config: IncrementalConfig | None = None,
    *,
    table: ItemTable | None = None,
    placement=None,
    resident_bits=None,
    bands: "ResultBands | None" = None,
) -> tuple[MiningResult, dict] | None:
    """Delta-mine the store against a cached base result.

    ``table`` is an optional immutable snapshot (``DatasetStore.item_table``)
    to mine; when omitted one is taken now. Only the historical watermarks of
    ``store`` are consulted otherwise, so concurrent appends cannot skew the
    delta. ``placement``/``resident_bits`` route the promoted/new-item seed
    expansion through the service's placement and the store's
    device-resident bitsets (``DatasetStore.device_bits``) instead of
    rebuilding host levels; omitted, the expansion runs on host numpy —
    results are bit-identical either way. ``bands`` is the cached
    :class:`ResultBands` companion of ``base_result`` (built on the fly when
    absent, so callers without a cache still get the shrunken recount).
    Returns ``(result, info)`` or ``None`` when the
    caller should fall back to a cold mine (delta too large, expansion
    budget exhausted, or a config the incremental invariants don't cover).
    """
    inc = inc_config or IncrementalConfig()
    if not inc.enabled or config.expansion != "full" or config.kmax < 1:
        return None
    try:
        base_rows = store.rows_at(base_version)
        base_items = store.items_at(base_version)
    except KeyError:
        return None  # base watermark compacted away -> cold remine
    if base_rows == 0:
        return None
    t0 = time.perf_counter()
    if table is None:
        table = store.item_table()
    n = table.n_rows
    delta_rows = n - base_rows
    if delta_rows <= 0:
        return None
    if delta_rows > inc.max_delta_fraction * n:
        return None

    tau, kmax = config.tau, config.kmax

    if placement is None:
        placement = getattr(config, "placement", None)
    if isinstance(placement, str):
        placement = None  # an engine name: the expansion runs on the host
    # fleet mode: partial popcounts over local word stripes, reduced through
    # the placement's collective; every budget/branch decision below is a
    # function of global values so the processes stay in lockstep
    fleet = getattr(placement, "kind", None) == "fleet"
    coll = placement.collective if fleet else None
    reduce_fn = coll.allreduce_sum if fleet else None
    word_map = store.word_map(table.n_words) if store.shard[1] > 1 else None

    # 1. recount cached results on the appended rows — only where the
    # per-item delta-frequency bound admits a non-zero delta support
    dbits = _delta_bits_of(table, base_rows, word_map)
    delta_map = None if word_map is None else word_map[_delta_word_lo(word_map, base_rows):]
    dfreq = popcount_rows(dbits).astype(np.int64)
    if reduce_fn is not None:
        dfreq = reduce_fn(dfreq)
    if bands is None:
        bands = ResultBands.from_result(base_result.itemsets)
    old_sets = [ids for ids, _ in base_result.itemsets]
    new_counts, band_stats = bands.recount(dbits, dfreq, tau, delta_rows, reduce_fn)

    results: list[tuple[tuple[int, ...], int]] = []
    seeds: list[tuple[int, ...]] = []
    for ids, cnt in zip(old_sets, new_counts):
        if cnt <= tau:
            results.append((ids, int(cnt)))
        else:
            seeds.append(ids)
    n_promoted = len(seeds)

    # 2. brand-new items (values first seen in the delta)
    freq = table.freq
    n_new_items = table.n_items - base_items
    for a in range(base_items, table.n_items):
        if freq[a] <= tau:
            results.append(((a,), int(freq[a])))
        elif freq[a] < n:
            seeds.append((a,))

    # 3. boundary expansion: previously-present new minimal itemsets are
    # strict supersets of a seed, explored through the resident frontier
    expanded = _expand_seeds(
        table,
        seeds,
        tau,
        kmax,
        inc.expansion_budget,
        placement=placement,
        resident_bits=resident_bits,
        reduce_fn=reduce_fn,
    )
    if expanded is None:
        return None

    # 4. delta-born itemsets: absent at the base (support 0 is never cached),
    # supported entirely inside the appended block
    born = _delta_born(
        table,
        dbits,
        base_rows,
        tau,
        kmax,
        inc.delta_candidate_budget,
        placement=placement,
        resident_bits=resident_bits,
        word_map=delta_map,
        coll=coll,
    )
    if born is None:
        return None
    n_expanded = len(expanded)
    expanded.update(born)

    # no dedup needed: kept results had base support >= 1 and support <= tau,
    # expansion finds only sets with a base-infrequent (promoted) proper
    # subset, and delta-born sets had base support 0 — the families are
    # pairwise disjoint (expansion/delta-born overlap merged in `expanded`)
    for cs, cnt in sorted(expanded.items(), key=lambda e: (len(e[0]), sorted(e[0]))):
        results.append((tuple(sorted(cs)), cnt))

    stats = []
    by_size: dict[int, int] = {}
    for ids, _ in results:
        by_size[len(ids)] = by_size.get(len(ids), 0) + 1
    for k in range(1, kmax + 1):
        stats.append(LevelStats(k=k, emitted=by_size.get(k, 0)))
    elapsed = time.perf_counter() - t0
    stats[0].time_total = elapsed

    result = MiningResult(
        itemsets=results,
        stats=stats,
        prep=_light_prep(table, tau),
        config=config,
        wall_time=elapsed,
    )
    info = {
        "delta_rows": int(delta_rows),
        "n_promoted": n_promoted,
        "n_new_items": int(n_new_items),
        "n_seeds": len(seeds),
        "n_expanded": n_expanded,
        "n_delta_born": len(born),
        "n_cached": len(old_sets),
        **band_stats,
    }
    if fleet:
        info["fleet"] = coll.stats()
    return result, info
