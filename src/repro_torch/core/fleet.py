"""Multi-process fleet placement: lockstep mining over process-sharded bitsets.

The paper's level body needs exactly one collective — the popcount sum over
the word axis (§4.4.4's "no inter-thread communication" property holds
within a process; across processes one all-reduce per batch is the
irreducible minimum). :class:`FleetPlacement` therefore runs the whole BFS
**lockstep**:
every process executes the identical mining loop over its *local* word
stripes (a ``DatasetStore`` built with ``shard=(pid, nproc)``) through an
ordinary inner placement (host numpy, one device, or an in-process mesh),
and the only cross-process traffic is

* one ``allreduce_sum`` of each batch's partial popcounts
  (``repro_torch.core.collective``, over the ``TCPStore``), after which
  classification runs host-side on the now-global counts, and
* the row-set-grouping rendezvous in ``core.preprocess`` (local hashes are
  combined globally so duplicate detection agrees everywhere).

Everything after the global counts — candidate generation, support tests,
bound pruning, emission order — is a deterministic function of global
metadata (itemsets, counts, frequencies), so every process walks the exact
same levels and emits bit-identical results without further communication.
That lockstep determinism is also why batch sizing must be process-invariant:
the sharded store pads the global word axis to ``word_tile * nproc`` so all
local widths are equal.

The fleet deliberately reports ``use_device_frontier = False`` — frontier
transitions run the host reference path (``core.frontier._advance_host``),
whose candidate pipeline reads only global host mirrors. The inner
placement still runs every batch's count on its device: with a card that is
``intersect_{write,count}_indexed``, the unfused kernels.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from ..kernels.intersect import ops as _ops
from ..obs import metrics as _om
from .collective import Collective, LoopbackCollective
from .placement import count_dispatch

__all__ = ["FleetPlacement"]

_FLEET_REDUCES = _om.counter(
    "repro_fleet_allreduce_total",
    "Cross-process count all-reduces by mining seam.",
    ("site",),
)


class FleetPlacement:
    """Wrap an inner single-process placement into a multi-process fleet.

    ``inner`` executes every batch against the process-local word stripes;
    this wrapper all-reduces the resulting partial popcounts through
    ``collective`` and classifies on the global counts. With the default
    :class:`~repro_torch.core.collective.LoopbackCollective` (one process) the
    reduction is the identity — the loopback fleet is bit-identical to the
    inner placement by construction, which is what the parity tests pin.
    """

    kind = "fleet"
    # frontier transitions must stay on the host reference path: candidate
    # generation there reads only global host mirrors (see module docstring)
    use_device_frontier = False

    def __init__(
        self,
        inner,
        *,
        collective: Collective | None = None,
        shard: tuple[int, int] | None = None,
    ):
        if getattr(inner, "kind", None) == "fleet":
            raise ValueError("fleet placements do not nest")
        self.inner = inner
        self.collective = collective if collective is not None else LoopbackCollective()
        self.shard = (
            tuple(shard)
            if shard is not None
            else (self.collective.pid, self.collective.nproc)
        )
        if self.shard != (self.collective.pid, self.collective.nproc):
            raise ValueError(
                f"shard {self.shard} disagrees with collective "
                f"({self.collective.pid}, {self.collective.nproc})"
            )
        self.store_word_tile = int(getattr(inner, "store_word_tile", 1) or 1)
        # one record per prepared level (a mining level, or an incremental
        # wave): its batches' all-reduce rounds, seconds and payload bytes
        self.level_reduces: collections.deque = collections.deque(maxlen=32)

    # -- mining levels -------------------------------------------------------

    def prepare(self, bits, parent_counts, tau: int, *, fused_classify: bool):
        # the inner placement counts only (fused_classify=False): its local
        # class codes would be wrong — classification must wait for the
        # global counts, so it happens host-side after the all-reduce
        pc = np.asarray(parent_counts, dtype=np.int64)
        inner_state = self.inner.prepare(bits, pc, tau, fused_classify=False)
        self.level_reduces.append({"rows": int(len(pc)), "batches": 0, "pairs": 0,
                                   "seconds": 0.0, "payload_bytes": 0})
        return (inner_state, pc, int(tau), bool(fused_classify))

    def padded_size(self, m: int, *, pad_buckets: bool = True) -> int:
        return self.inner.padded_size(m, pad_buckets=pad_buckets)

    def dispatch(self, state, padded_pairs, write_children: bool):
        count_dispatch("dispatch", "fleet")
        inner_state, pc, tau, fused = state
        child, local_counts, _ = self.inner.dispatch(
            inner_state, padded_pairs, write_children
        )
        local = _ops._host(local_counts).astype(np.int64, copy=False)
        t0, b0 = time.perf_counter(), self.collective.payload_bytes
        counts = self.collective.allreduce_sum(local)
        _FLEET_REDUCES.inc(site="dispatch")
        if self.level_reduces:
            rec = self.level_reduces[-1]
            rec["batches"] += 1
            rec["pairs"] += int(len(local))
            rec["seconds"] += time.perf_counter() - t0
            rec["payload_bytes"] += self.collective.payload_bytes - b0
        classes = None
        if fused:
            pairs = _ops._host(padded_pairs)
            minp = np.minimum(pc[pairs[:, 0]], pc[pairs[:, 1]])
            classes = _ops.classify_counts_host(counts, minp, tau)
        return child, counts, classes

    def put_bits(self, bits):
        return self.inner.put_bits(bits)

    def take_rows(self, bits, rows):
        return self.inner.take_rows(bits, rows)

    def cat_rows(self, parts):
        return self.inner.cat_rows(parts)

    # -- coverage (privacy risk engine) --------------------------------------

    def prepare_coverage(self, bits):
        return self.inner.prepare_coverage(bits)

    def coverage_dispatch(self, state, padded_sets, padded_weights):
        # the accumulator stays local-width; ``CoverageEngine`` sums batches
        # host-side and the fleet reduction happens once per query in
        # :meth:`record_counts_from_acc` — one collective per arity, not per
        # batch
        return self.inner.coverage_dispatch(state, padded_sets, padded_weights)

    def record_counts_from_acc(
        self, acc: np.ndarray, n_rows: int, word_map: np.ndarray | None = None
    ) -> np.ndarray:
        """Global per-record coverage counts from a *local* ``(32, W_local)``
        accumulator: scatter local records to their global row positions via
        the store's ``word_map``, then all-reduce. The risk engine calls this
        through ``getattr`` — non-fleet placements keep the plain
        ``acc_to_record_counts`` path. ``word_map=None`` means the local
        width *is* the global width (loopback fleet / unsharded store)."""
        acc = np.asarray(acc)
        if word_map is None:
            word_map = np.arange(acc.shape[1], dtype=np.int64)
        word_map = np.asarray(word_map, dtype=np.int64)
        w_local = acc.shape[1]
        local = acc.T.astype(np.int64)  # (W_local, 32) in local record order
        # size the global scatter by the ROW count, not by this process's
        # highest owned stripe — stripe ownership is round-robin, so the max
        # owned index differs per process and the all-reduce needs one shape
        n_global_words = (int(n_rows) + 31) // 32
        if w_local:
            n_global_words = max(n_global_words, int(word_map.max()) + 1)
        full = np.zeros((n_global_words, 32), dtype=np.int64)
        full[word_map[:w_local]] = local
        counts = self.collective.allreduce_sum(full.reshape(-1)[:n_rows])
        _FLEET_REDUCES.inc(site="coverage")
        return counts

    # -- frontier (never exercised: use_device_frontier is False, and
    # mine_levels routes non-host kinds through its host reference) ----------

    def prepare_frontier(self, itemsets, counts, n_symbols: int):
        return self.inner.prepare_frontier(itemsets, counts, n_symbols)

    def frontier_dispatch(self, state, lo: int, hi: int, n_pairs: int):
        return self.inner.frontier_dispatch(state, lo, hi, n_pairs)

    def frontier_mask(self, state, pairs, ok):
        return self.inner.frontier_mask(state, pairs, ok)

    def frontier_partition(self, classes):
        return self.inner.frontier_partition(classes)

    def release(self, state) -> None:
        if isinstance(state, tuple) and len(state) == 4:
            self.inner.release(state[0])
        else:
            self.inner.release(state)

    def describe(self) -> dict:
        return {
            "kind": self.kind,
            "shard": list(self.shard),
            "inner": self.inner.describe(),
            "collective": self.collective.stats(),
            "level_reduces": list(self.level_reduces),
        }

    def __repr__(self) -> str:
        return f"FleetPlacement(shard={self.shard}, inner={self.inner!r})"
