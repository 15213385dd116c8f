"""Engine dispatch and batching for the coverage kernel.

The engine-specific binding lives in :func:`build_coverage_dispatch`, and
the generic orchestration — batch splitting, bucket padding with weight-0
rows, cross-batch accumulation — lives once in :class:`CoverageEngine`,
which is placement-generic: a ``repro_torch.core.placement`` placement
supplies residency (``prepare_coverage``) and per-batch execution
(``coverage_dispatch``), so host numpy, the plain PyTorch version and the
CUDA kernel all serve the same record-risk queries bit-identically.
"""

from __future__ import annotations

import numpy as np
import torch

from ...obs import metrics as _om
from ...obs.trace import span as _obs_span
from . import coverage as _k
from .index import CoverageIndex, anchored_plan
from .ref import acc_to_record_counts, coverage_accumulate_ref

_COV_BATCHES = _om.counter(
    "repro_coverage_batches_total",
    "Coverage accumulator batches dispatched through the placement.",
)

__all__ = ["CoverageEngine", "build_coverage_dispatch"]


def _upload(bits: torch.Tensor, sets: np.ndarray, weights: np.ndarray):
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(bits.device)
    return as_dev(sets), as_dev(weights)


def _torch_dispatch(bits: torch.Tensor, index, sets: np.ndarray, weights: np.ndarray):
    return coverage_accumulate_ref(bits, *_upload(bits, sets, weights))


def _cuda_dispatch(bits: torch.Tensor, index: CoverageIndex, sets: np.ndarray,
                   weights: np.ndarray):
    """One batch through the anchored kernel or the scanning one, chosen
    from the index's host counts (no synchronisation)."""
    sets_t, weights_t = _upload(bits, sets, weights)
    anchored, longest = anchored_plan(index.counts, sets, weights, bits.shape[1])
    if anchored:
        return _k.coverage_accumulate_anchored(bits, index, sets_t, weights_t, longest)
    return _k.coverage_accumulate_indexed(bits, sets_t, weights_t)


def build_coverage_dispatch(engine: str):
    """The coverage function of a device engine:
    ``fn(bits, index, sets, weights) -> acc (32, W) int32`` on the bitsets'
    device, for host ``(M, K)`` sets and ``(M,)`` weights — ``torch`` the
    plain scanning version (``index`` unused), ``cuda`` the kernels'
    wrappers: the anchored kernel where the batch's anchors are sparse
    (:func:`~.index.anchored_plan`), the scanning kernel otherwise."""
    if engine == "torch":
        return _torch_dispatch
    if engine == "cuda":
        return _cuda_dispatch
    raise ValueError(f"engine must be torch|cuda, got {engine!r}")


class CoverageEngine:
    """Placement-generic batched coverage accumulation over one bitset matrix.

    Construction hands the item bitsets to the placement once
    (``placement.prepare_coverage`` — the host array, or one upload to the
    device); every :meth:`accumulate` call then ships only the (tiny)
    itemset index batch. ``set_width`` bounds the itemset arity (normally
    ``kmax``).
    """

    def __init__(
        self,
        bits,
        *,
        placement,
        set_width: int,
        max_batch_sets: int | None = None,
    ):
        self.placement = placement
        self.set_width = max(1, int(set_width))
        self.n_words = int(bits.shape[1])
        # cap the per-dispatch working set (M * W int32 temporaries of the
        # plain version) while keeping batches large enough to amortize
        # dispatch
        self.max_batch_sets = max_batch_sets or max(
            256, (1 << 26) // max(self.n_words, 1)
        )
        self._state = placement.prepare_coverage(bits)

    def accumulate(
        self, sets: np.ndarray, weights: np.ndarray | None = None
    ) -> np.ndarray:
        """Weighted coverage accumulator over a batch of itemsets.

        ``sets`` is (M, k) int with k <= set_width; ``weights`` defaults to
        all-ones. Returns acc (32, n_words) int64, summed across dispatch
        batches.
        """
        sets = np.asarray(sets, dtype=np.int32)
        if sets.ndim != 2 or sets.shape[1] > self.set_width:
            raise ValueError(
                f"sets must be (M, <= {self.set_width}), got shape {sets.shape}"
            )
        m = sets.shape[0]
        total = np.zeros((32, self.n_words), dtype=np.int64)
        if m == 0:
            return total
        wt = (
            np.ones(m, dtype=np.int32)
            if weights is None
            else np.asarray(weights, dtype=np.int32)
        )
        with _obs_span("coverage.accumulate", sets=m):
            for s in range(0, m, self.max_batch_sets):
                chunk = sets[s : s + self.max_batch_sets]
                wchunk = wt[s : s + self.max_batch_sets]
                padded_m = self.placement.padded_size(chunk.shape[0])
                if padded_m != chunk.shape[0]:
                    pad = padded_m - chunk.shape[0]
                    chunk = np.pad(chunk, ((0, pad), (0, 0)), mode="edge")
                    wchunk = np.pad(wchunk, (0, pad))  # weight-0 padding rows
                _COV_BATCHES.inc()
                acc = self.placement.coverage_dispatch(self._state, chunk, wchunk)
                if isinstance(acc, torch.Tensor):
                    acc = acc.cpu().numpy()
                # device placements pad the word axis; the pad words carry
                # no record bits, so slicing back to n_words is lossless
                total += acc[:, : self.n_words].astype(np.int64)
        return total

    def record_counts(
        self, sets: np.ndarray, n_rows: int, weights: np.ndarray | None = None
    ) -> np.ndarray:
        """Per-record coverage counts (n_rows,) int64 for one itemset batch."""
        return acc_to_record_counts(self.accumulate(sets, weights), n_rows)
