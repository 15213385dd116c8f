"""The BFS level frontier (Alg. 1 lines 11-41 per level).

:class:`LevelFrontier` is one stored level: the itemset id table and counts
as host mirrors (``(t, k)`` ints) plus the level *bitsets* wherever the
placement keeps them (host numpy, or int32 words on a torch device).
:func:`mine_levels` is the one level-transition engine both paths share:

* **Host reference** (``HostPlacement``, or ``fused_classify=False``, or
  ``device_frontier=False``): the numpy path, routed through the host
  frontier methods — bit-identical by construction and the parity oracle.
* **Device frontier** (``DevicePlacement`` with ``fused_classify=True``):
  candidate pair indices are generated from the prefix-group run lengths on
  the device, the support test binary-searches a packed parent key table on
  the device, the fused intersect+classify kernels consume the device pair
  indices directly (``LevelPipeline.submit_padded``), and one stable
  compaction pass partitions each classified batch into [skip | emit |
  store] segments. The host drains only the emitted itemsets and the stored
  ``(i, j, count)`` triples for the next level's id mirror; stored child
  bitsets never leave the device. Host sync points per batch: the survivor
  count and the two partition counts, plus the emit/store index blocks.

Remaining host sync points: Lemma 4.6 / Corollary 4.7 bound pruning at
``k = k_max`` (``use_bounds=True``) pulls that final count-only level's
surviving candidates to the host, and an ``on_level_end`` checkpoint hook
copies the level bitsets into the :class:`~repro_torch.core.kyiv.MiningState`.

Both paths batch over the same prefix-group spans
(``prefix.iter_group_spans``) and emit in the same candidate order, so
results *and* per-level stats are bit-identical.

Levels retire eagerly: once a transition completes, the parent pipeline's
placement-owned buffers, the frontier id/key tables and the parent bitsets
are dropped, so device memory holds the transition's two live levels
(``MiningResult.peak_level_bytes``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any

import numpy as np

from ..kernels.intersect.ref import CLASS_EMIT, CLASS_STORE
from ..obs import cost as _obs_cost
from ..obs import metrics as _om
from ..obs.trace import device_sync as _obs_device_sync
from ..obs.trace import span as _obs_span
from .bitops import host_bits
from .bounds import apply_bounds
from .placement import HostPlacement
from .prefix import (
    CandidateBatch,
    Level,
    iter_group_spans,
    prefix_group_sizes,
)
from .support import ItemsetIndex

__all__ = ["LevelFrontier", "expand_mirrors", "mine_levels"]

_HOST_REFERENCE = HostPlacement()

# Per-stage level timings land in the fixed log-scale time ladder — the
# paper's Fig. 2 time-distribution view, as a live histogram per stage.
_LEVEL_SECONDS = _om.histogram(
    "repro_mine_level_seconds",
    "Per-level wall time by mining stage (candidates=gen+support+bounds, "
    "intersect=dispatch+sync, classify=partition/consume, total).",
    ("stage",),
)
_LEVEL_PAIRS = _om.counter(
    "repro_mine_pairs_total",
    "Candidate-pair outcomes across all mined levels.",
    ("outcome",),
)
_LEVELS_TOTAL = _om.counter(
    "repro_mine_levels_total",
    "Level transitions mined, by frontier path.",
    ("path",),
)


def _record_level(ls, path: str, sp, n_rows: int = 0) -> None:
    """Fold one finished level's stats into the registry, its span, and the
    request's CostEnvelope (no-op without one attached)."""
    env = _obs_cost.current()
    if env is not None:
        env.add(
            levels=1,
            candidate_pairs=ls.candidates,
            rows_scanned=ls.intersections * n_rows,
            device_bytes=ls.level_bytes if path == "device" else 0,
            itemsets_emitted=ls.emitted,
        )
        if path == "device":
            env.add_device_time(ls.time_intersect)
    _LEVEL_SECONDS.observe(ls.time_candidates, stage="candidates")
    _LEVEL_SECONDS.observe(ls.time_intersect, stage="intersect")
    _LEVEL_SECONDS.observe(ls.time_classify, stage="classify")
    _LEVEL_SECONDS.observe(ls.time_total, stage="total")
    _LEVEL_PAIRS.inc(ls.candidates, outcome="candidates")
    _LEVEL_PAIRS.inc(ls.support_pruned, outcome="support_pruned")
    _LEVEL_PAIRS.inc(ls.bound_pruned, outcome="bound_pruned")
    _LEVEL_PAIRS.inc(ls.intersections, outcome="intersections")
    _LEVEL_PAIRS.inc(ls.skipped_absent_uniform, outcome="skipped")
    _LEVEL_PAIRS.inc(ls.emitted, outcome="emitted")
    _LEVEL_PAIRS.inc(ls.stored, outcome="stored")
    _LEVELS_TOTAL.inc(path=path)
    sp.set(
        path=path,
        candidates=ls.candidates,
        emitted=ls.emitted,
        stored=ls.stored,
        level_bytes=ls.level_bytes,
    )


def expand_mirrors(
    itemset_ids: tuple[int, ...],
    count: int,
    mirror_of: dict[int, list[int]],
    mode: str,
) -> list[tuple[tuple[int, ...], int]]:
    """Proposition 4.1 expansion of a canonical result over duplicate items.

    ``mode="paper"`` reproduces Alg. 1 lines 36-38 exactly (one swap at a
    time). ``mode="full"`` closes over all combinations of swaps — Prop. 4.1
    applies inductively, so every member of the product is minimal
    τ-infrequent; the brute-force oracle confirms the full closure is the
    complete answer (see tests).
    """
    out = [(tuple(sorted(itemset_ids)), count)]
    classes = [[i] + mirror_of.get(i, []) for i in itemset_ids]
    if mode == "paper":
        for pos, cls in enumerate(classes):
            for repl in cls[1:]:
                swapped = list(itemset_ids)
                swapped[pos] = repl
                out.append((tuple(sorted(swapped)), count))
    else:  # full product closure
        if any(len(c) > 1 for c in classes):
            for combo in itertools.product(*classes):
                out.append((tuple(sorted(combo)), count))
    # dedupe, preserve order
    seen: set[tuple[int, ...]] = set()
    uniq = []
    for ids, c in out:
        if ids not in seen:
            seen.add(ids)
            uniq.append((ids, c))
    return uniq


@dataclasses.dataclass
class LevelFrontier:
    """One stored BFS level, frontier form.

    ``itemsets``/``counts`` are host mirrors (cheap — ``(t, k)`` int32 /
    ``(t,)`` int64; emission, resume checkpoints and the k_max bound pruning
    read them), ``bits`` lives wherever the placement keeps level bitsets:
    ``(t, W)`` uint32 host numpy for the reference path, ``(t, padded W)``
    int32 words on the device, chained level to level, for the device
    frontier.
    """

    k: int
    itemsets: np.ndarray
    counts: np.ndarray
    bits: Any

    @property
    def t(self) -> int:
        return int(self.itemsets.shape[0])

    def as_level(self, *, n_words: int | None = None) -> Level:
        """The level as a ``prefix.Level``; with ``n_words`` its bitsets
        come back as host uint32 words, the device word padding stripped."""
        bits = self.bits
        if n_words is not None and bits is not None:
            bits = host_bits(bits, n_words)
        return Level(k=self.k, itemsets=self.itemsets, counts=self.counts, bits=bits)

    @classmethod
    def from_level(cls, level: Level) -> "LevelFrontier":
        return cls(
            k=level.k,
            itemsets=np.asarray(level.itemsets),
            counts=np.asarray(level.counts),
            bits=level.bits,
        )

    def retire(self) -> None:
        """Drop the level's bitsets (a device tensor is freed with its last
        reference)."""
        self.bits = None


def _device_frontier_capable(placement, pipe, config) -> bool:
    """Device frontier preconditions: a non-host placement that implements
    the frontier ops, fused classification (the partition pass consumes
    class codes), and a pipeline that accepts device pair batches."""
    return (
        placement.kind != "host"
        and config.device_frontier
        # a placement may veto per backend (a CPU mesh, the fleet)
        and getattr(placement, "use_device_frontier", True)
        # the pipeline's own flag: the partition pass consumes class codes
        and pipe.fused_classify
    )


def _emit_rows(results, ls, prep, expansion, lpos_mat, cnts) -> None:
    """Drain one batch's emitted minimal itemsets (vectorised; the per-item
    mirror expansion only runs for itemsets that touch a duplicate-rowset
    item, which is rare)."""
    ids_mat = prep.l_items[lpos_mat]  # L-positions -> original item ids
    ids_mat = np.sort(ids_mat, axis=1)  # canonical ascending ids
    if prep.mirror_of:
        mirror_items = np.fromiter(prep.mirror_of.keys(), dtype=np.int64)
        has_mirror = np.isin(ids_mat, mirror_items).any(axis=1)
    else:
        has_mirror = np.zeros(ids_mat.shape[0], dtype=bool)
    plain = ~has_mirror
    results.extend(zip(map(tuple, ids_mat[plain].tolist()), cnts[plain].tolist()))
    for r in np.nonzero(has_mirror)[0]:
        results.extend(
            expand_mirrors(
                tuple(ids_mat[r].tolist()), int(cnts[r]), prep.mirror_of, expansion
            )
        )
    ls.emitted += ids_mat.shape[0]


def _candidate_lpos(frontier: LevelFrontier, pairs: np.ndarray) -> np.ndarray:
    """Candidate L-position itemsets of (i, j) parent pairs: the I parent's
    row plus the J parent's last item (shared-prefix join)."""
    return np.concatenate(
        [frontier.itemsets[pairs[:, 0]], frontier.itemsets[pairs[:, 1], -1:]], axis=1
    ).astype(np.int32)


def mine_levels(
    prep,
    config,
    make_pipeline,
    results: list,
    stats: list,
    *,
    frontier: LevelFrontier,
    grandparent_index: ItemsetIndex | None,
    start_k: int,
    on_level_end=None,
    make_state=None,
    control=None,
) -> None:
    """Run Alg. 1's outer loop from level ``start_k - 1``'s stored frontier.

    Appends emitted itemsets to ``results`` and a ``LevelStats`` per level to
    ``stats`` (both in the exact order of the reference miner);
    ``make_state(k, frontier, grandparent_index)`` builds the
    ``MiningState`` handed to ``on_level_end``. ``control`` (a
    ``repro_torch.core.kyiv.RunControl``) is checked at every batch
    boundary and at level boundaries — a tripped deadline or cancellation
    raises ``MiningInterrupted`` with everything emitted so far already in
    ``results`` (partial-result semantics; the caller decides what to do
    with them).
    """
    tau, kmax = config.tau, config.kmax
    n = prep.table.n_rows
    k = start_k

    n_words = prep.l_bits.shape[1]
    batch_cap = max(4096, (1 << 28) // max(n_words, 1))
    batch_pairs = min(config.max_pairs_per_chunk, batch_cap)

    while k <= kmax and frontier.t >= 2:
        from .kyiv import LevelStats  # deferred: kyiv imports this module

        if control is not None:
            control.check()
        with _obs_span("mine.level", k=k) as _lsp:
            ls = LevelStats(k=k)
            lt0 = time.perf_counter()
            write_children = k < kmax

            pipe = make_pipeline(frontier.bits, frontier.counts, tau)
            placement = pipe.placement
            device_path = _device_frontier_capable(placement, pipe, config)

            # the host index of this parent level is needed beyond the host
            # path when checkpoints will serialise it, or when this / the next
            # transition runs the k_max bound pruning (its grandparent lookups)
            need_index = on_level_end is not None or (
                config.use_bounds and kmax - 1 <= k <= kmax
            )

            if device_path:
                nxt, level_index = _advance_device(
                    frontier,
                    pipe,
                    placement,
                    prep,
                    config,
                    ls,
                    results,
                    k,
                    write_children,
                    batch_pairs,
                    grandparent_index,
                    n,
                    need_index,
                    control,
                )
            else:
                nxt, level_index = _advance_host(
                    frontier,
                    pipe,
                    placement,
                    prep,
                    config,
                    ls,
                    results,
                    k,
                    write_children,
                    batch_pairs,
                    grandparent_index,
                    n,
                    control,
                )

            ls.time_total = time.perf_counter() - lt0
            stats.append(ls)
            _record_level(ls, "device" if device_path else "host", _lsp, n)

            # eager retirement: the parent level's pipeline residency,
            # frontier tables and parent bitsets all drop now — device
            # memory holds only the transition's two live levels
            # (peak_level_bytes)
            pipe.retire()
            grandparent_index = level_index
            old = frontier
            frontier = nxt
            k += 1

            if on_level_end is not None:
                with _obs_span("mine.checkpoint", k=k - 1):
                    on_level_end(k - 1, make_state(k, frontier, grandparent_index))
            old.retire()

    frontier.retire()


def _advance_host(
    frontier,
    pipe,
    placement,
    prep,
    config,
    ls,
    results,
    k,
    write_children,
    batch_pairs,
    grandparent_index,
    n,
    control=None,
):
    """One level transition on the host reference path (also serves
    ``fused_classify=False`` and ``device_frontier=False``) — the numpy flow,
    batch for batch and bit for bit. Children come back to the host."""
    tau = config.tau
    host_frontier = placement if placement.kind == "host" else _HOST_REFERENCE
    with _obs_span("frontier.candidates", phase="prepare"):
        ct0 = time.perf_counter()
        fstate = host_frontier.prepare_frontier(
            frontier.itemsets, frontier.counts, prep.n_l
        )
        level_index = fstate  # the host frontier state *is* the support index
        sizes = prefix_group_sizes(frontier.itemsets)
        ls.time_candidates += time.perf_counter() - ct0

    level = frontier.as_level()
    new_itemsets, new_counts, new_bits = [], [], []

    def consume(entry):
        """Block on a dispatched batch and consume its classified output."""
        sel_itemsets, pairs, handle = entry
        it0 = time.perf_counter()
        with _obs_span("intersect.sync"):
            child, counts, classes = handle.result()
        ls.time_intersect += time.perf_counter() - it0

        with _obs_span("level.classify"):
            ct0 = time.perf_counter()
            if classes is None:
                # host classification (fused_classify=False)
                ci = level.counts[pairs[:, 0]]
                cj = level.counts[pairs[:, 1]]
                minp = np.minimum(ci, cj)
                absent_uniform = (counts == 0) | (counts == minp)
                infrequent = (~absent_uniform) & (counts <= tau)
                store = (~absent_uniform) & (~infrequent)
                inf_rows = np.nonzero(infrequent)[0]
                n_skipped = int(absent_uniform.sum())
            else:
                # fused path: the engine already classified every pair
                inf_rows = np.nonzero(classes == CLASS_EMIT)[0]
                store = classes == CLASS_STORE
                n_skipped = len(classes) - len(inf_rows) - int(store.sum())
            # the classify clock stops here, before emission/store
            # bookkeeping, as in the reference miner
            ls.time_classify += time.perf_counter() - ct0
        ls.skipped_absent_uniform += n_skipped

        if len(inf_rows):
            _emit_rows(
                results, ls, prep, config.expansion,
                sel_itemsets[inf_rows], counts[inf_rows],
            )

        if write_children and store.any():
            rows = np.nonzero(store)[0]
            new_itemsets.append(sel_itemsets[rows])
            new_counts.append(counts[rows])
            new_bits.append(child[rows])

    # double-buffered batch pipeline: batch n intersects on device while
    # batch n+1 is generated, support-tested and bound-pruned on the host.
    pending = None
    for lo, hi, n_pairs in iter_group_spans(sizes, batch_pairs):
        if n_pairs == 0:
            continue
        if control is not None:
            control.check()
        with _obs_span("frontier.candidates"):
            ct0 = time.perf_counter()
            cand, ok = host_frontier.frontier_dispatch(fstate, lo, hi, n_pairs)
            ls.candidates += cand.m
            ls.support_pruned += int((~ok).sum())
            ls.time_candidates += time.perf_counter() - ct0

            if k == config.kmax and config.use_bounds and ok.any():
                ct0 = time.perf_counter()
                alive_idx = np.nonzero(ok)[0]
                sub = CandidateBatch(
                    i_idx=cand.i_idx[alive_idx],
                    j_idx=cand.j_idx[alive_idx],
                    itemsets=cand.itemsets[alive_idx],
                )
                pruned = apply_bounds(
                    sub, level, level_index, grandparent_index, n, tau
                )
                ls.bound_pruned += int(pruned.sum())
                ok[alive_idx[pruned]] = False
                ls.time_candidates += time.perf_counter() - ct0

        sel = np.nonzero(ok)[0]
        ls.intersections += len(sel)
        if len(sel) == 0:
            continue
        pairs = np.stack([cand.i_idx[sel], cand.j_idx[sel]], axis=1).astype(np.int32)
        it0 = time.perf_counter()
        with _obs_span("intersect.dispatch", pairs=len(sel)):
            handle = pipe.submit(pairs, write_children)  # async dispatch
        ls.time_intersect += time.perf_counter() - it0
        entry = (cand.itemsets[sel], pairs, handle)
        if not config.double_buffer:
            consume(entry)
            continue
        if pending is not None:
            consume(pending)
        pending = entry
    if pending is not None:
        consume(pending)

    if write_children and new_itemsets:
        nxt_itemsets = np.concatenate(new_itemsets, axis=0)
        nxt_counts = np.concatenate(new_counts, axis=0)
        nxt_bits = np.concatenate(new_bits, axis=0)
    else:
        nxt_itemsets = np.zeros((0, k), dtype=np.int32)
        nxt_counts = np.zeros(0, dtype=np.int64)
        nxt_bits = np.zeros((0, prep.l_bits.shape[1]), dtype=np.uint32)

    ls.stored = nxt_itemsets.shape[0]
    # logical sizes (t * W * 4 bytes), whatever padding the device holds
    ls.level_bytes = nxt_bits.nbytes + (
        frontier.t * prep.l_bits.shape[1] * 4 if frontier.bits is not None else 0
    )
    return (
        LevelFrontier(k=k, itemsets=nxt_itemsets, counts=nxt_counts, bits=nxt_bits),
        level_index,
    )


def _advance_device(
    frontier,
    pipe,
    placement,
    prep,
    config,
    ls,
    results,
    k,
    write_children,
    batch_pairs,
    grandparent_index,
    n,
    need_index,
    control=None,
):
    """One level transition on the device frontier.

    Per batch: candidate gen + support test + survivor compaction + fused
    intersect/classify + emit/store partition, all device-to-device; the
    host syncs on three scalars and the emit/store index blocks. Only the
    ``k = k_max`` bound pruning (``use_bounds``) pulls survivors to the host
    — that level is count-only, so no bitsets move either way.
    """
    tau = config.tau
    with _obs_span("frontier.candidates", phase="prepare"):
        ct0 = time.perf_counter()
        fstate = placement.prepare_frontier(
            frontier.itemsets, frontier.counts, prep.n_l
        )
        sizes = prefix_group_sizes(frontier.itemsets)
        ls.time_candidates += time.perf_counter() - ct0

    host_bounds = k == config.kmax and config.use_bounds
    level_index = None
    if host_bounds or need_index:
        level_index = ItemsetIndex(frontier.itemsets, frontier.counts, n_symbols=prep.n_l)

    new_pairs, new_counts, new_children = [], [], []

    def consume(entry):
        if entry[0] == "host":
            _, lpos, pairs, handle = entry
            it0 = time.perf_counter()
            with _obs_span("intersect.sync"):
                child, counts, classes = handle.result()
            ls.time_intersect += time.perf_counter() - it0
            with _obs_span("level.classify"):
                ct0 = time.perf_counter()
                inf_rows = np.nonzero(classes == CLASS_EMIT)[0]
                store = classes == CLASS_STORE
                ls.time_classify += time.perf_counter() - ct0
            ls.skipped_absent_uniform += len(classes) - len(inf_rows) - int(store.sum())
            if len(inf_rows):
                _emit_rows(
                    results, ls, prep, config.expansion,
                    lpos[inf_rows], counts[inf_rows],
                )
            return

        _, mb, cpairs, n_ok_dev, handle = entry
        it0 = time.perf_counter()
        with _obs_span("intersect.sync"):
            child_d, cnt_d, cls_d = handle.raw()
            n_ok = int(n_ok_dev.item())  # first host sync of the batch
        ls.time_intersect += time.perf_counter() - it0
        ls.support_pruned += mb - n_ok
        ls.intersections += n_ok
        if n_ok == 0:
            return

        with _obs_span("level.classify"):
            ct0 = time.perf_counter()
            order, n_emit_d, n_store_d = placement.frontier_partition(cls_d)
            # the batch's bookkeeping arrays (segment order, pairs, counts)
            # are a few ints per pair — fetch them whole and slice on the
            # host
            order_h = order.cpu().numpy()
            pairs_h = cpairs.cpu().numpy()
            cnt_h = cnt_d.cpu().numpy().astype(np.int64)
            n_emit, n_store = int(n_emit_d.item()), int(n_store_d.item())
            bucket = int(pairs_h.shape[0])
            seg = bucket - n_emit - n_store  # skip segment incl. padding
            # classify clock covers partition + fetches, not emission/store
            # bookkeeping — mirroring the host path's historical attribution
            ls.time_classify += time.perf_counter() - ct0
        ls.skipped_absent_uniform += n_ok - n_emit - n_store

        if n_emit:
            emit_rows = order_h[seg : seg + n_emit]
            _emit_rows(
                results, ls, prep, config.expansion,
                _candidate_lpos(frontier, pairs_h[emit_rows]), cnt_h[emit_rows],
            )
        if write_children and n_store:
            store_rows = order_h[seg + n_emit : seg + n_emit + n_store]
            new_pairs.append(pairs_h[store_rows])
            new_counts.append(cnt_h[store_rows])
            # child bitsets stay on the device: gather the store segment
            new_children.append(placement.take_rows(child_d, store_rows))

    pending = None
    for lo, hi, n_pairs in iter_group_spans(sizes, batch_pairs):
        if n_pairs == 0:
            continue
        if control is not None:
            control.check()
        ls.candidates += n_pairs
        with _obs_span("frontier.candidates"):
            ct0 = time.perf_counter()
            pairs_d, ok_d = placement.frontier_dispatch(fstate, lo, hi, n_pairs)
            ls.time_candidates += time.perf_counter() - ct0
            _obs_device_sync(pairs_d, ok_d)

        if host_bounds:
            # the one remaining host-assisted step: Lemma 4.6/Cor. 4.7 needs
            # the grandparent lookups, so survivors come to the host here
            with _obs_span("frontier.candidates", phase="bounds"):
                ct0 = time.perf_counter()
                okh = ok_d.cpu().numpy()
                pairs_h = pairs_d.cpu().numpy()[okh]
                n_sup = int(okh.sum())
                ls.support_pruned += n_pairs - n_sup
                if n_sup == 0:
                    ls.time_candidates += time.perf_counter() - ct0
                    continue
                lpos = _candidate_lpos(frontier, pairs_h)
                sub = CandidateBatch(
                    i_idx=pairs_h[:, 0].astype(np.int64),
                    j_idx=pairs_h[:, 1].astype(np.int64),
                    itemsets=lpos,
                )
                pruned = apply_bounds(
                    sub, frontier.as_level(), level_index, grandparent_index,
                    n, tau,
                )
                ls.bound_pruned += int(pruned.sum())
                keep = ~pruned
                ls.intersections += int(keep.sum())
                ls.time_candidates += time.perf_counter() - ct0
            if not keep.any():
                continue
            sel_pairs = np.ascontiguousarray(pairs_h[keep])
            it0 = time.perf_counter()
            with _obs_span("intersect.dispatch", pairs=int(keep.sum())):
                handle = pipe.submit(sel_pairs, write_children)
            ls.time_intersect += time.perf_counter() - it0
            entry = ("host", lpos[keep], sel_pairs, handle)
        else:
            with _obs_span("frontier.candidates", phase="mask"):
                ct0 = time.perf_counter()
                cpairs, n_ok_dev = placement.frontier_mask(fstate, pairs_d, ok_d)
                ls.time_candidates += time.perf_counter() - ct0
            it0 = time.perf_counter()
            with _obs_span("intersect.dispatch", pairs=n_pairs):
                handle = pipe.submit_padded(cpairs, n_pairs, write_children)
            ls.time_intersect += time.perf_counter() - it0
            entry = ("dev", n_pairs, cpairs, n_ok_dev, handle)

        if not config.double_buffer:
            consume(entry)
            continue
        if pending is not None:
            consume(pending)
        pending = entry
    if pending is not None:
        consume(pending)

    # logical dataset word count, not frontier.bits.shape[1]: device rows
    # carry word padding, and the level_bytes accounting must match the host
    # reference exactly
    w_words = int(prep.l_bits.shape[1])
    if write_children and new_pairs:
        sp = np.concatenate(new_pairs, axis=0)
        nxt_itemsets = _candidate_lpos(frontier, sp)
        nxt_counts = np.concatenate(new_counts, axis=0)
        # the next level's bitsets, assembled device to device
        nxt_bits = placement.cat_rows(new_children)
        new_children.clear()
    else:
        nxt_itemsets = np.zeros((0, k), dtype=np.int32)
        nxt_counts = np.zeros(0, dtype=np.int64)
        nxt_bits = np.zeros((0, w_words), dtype=np.uint32)

    ls.stored = nxt_itemsets.shape[0]
    ls.level_bytes = nxt_itemsets.shape[0] * w_words * 4 + frontier.t * w_words * 4
    placement.release(fstate)
    return (
        LevelFrontier(k=k, itemsets=nxt_itemsets, counts=nxt_counts, bits=nxt_bits),
        level_index,
    )
