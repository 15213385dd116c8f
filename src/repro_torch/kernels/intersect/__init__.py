"""Bitset row intersection: the CUDA kernels, their plain PyTorch versions
and the level pipeline that dispatches batches to them."""

from .intersect import (
    LAUNCHES,
    intersect_classify_count_indexed,
    intersect_classify_write_indexed,
    intersect_count_indexed,
    intersect_write_indexed,
    reset_launches,
)
from .ops import (
    CLASS_EMIT,
    CLASS_SKIP,
    CLASS_STORE,
    ENGINES,
    BatchHandle,
    LevelPipeline,
    build_engine_dispatch,
    classify_counts_host,
    locality_order,
    next_bucket,
)
from .ref import (
    classify_counts_ref,
    intersect_classify_count_ref,
    intersect_classify_ref,
    intersect_count_ref,
    intersect_pairs_ref,
    popcount_rows_ref,
)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "intersect_classify_count_indexed",
    "intersect_classify_write_indexed",
    "intersect_count_indexed",
    "intersect_write_indexed",
    "CLASS_SKIP",
    "CLASS_EMIT",
    "CLASS_STORE",
    "ENGINES",
    "BatchHandle",
    "LevelPipeline",
    "build_engine_dispatch",
    "classify_counts_host",
    "locality_order",
    "next_bucket",
    "classify_counts_ref",
    "intersect_classify_count_ref",
    "intersect_classify_ref",
    "intersect_count_ref",
    "intersect_pairs_ref",
    "popcount_rows_ref",
]
