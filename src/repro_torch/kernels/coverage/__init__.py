"""Record coverage: the CUDA kernels (scanning and anchored), their plain
versions, the index of nonzero words and the batching engine that the
privacy path dispatches through."""

from .coverage import (
    LAUNCHES,
    coverage_accumulate_anchored,
    coverage_accumulate_indexed,
    reset_launches,
)
from .index import CoverageIndex, anchored_plan, build_coverage_index
from .ops import (
    EXEC_CACHE,
    CoverageEngine,
    build_coverage_dispatch,
    coverage_cache_stats,
    reset_coverage_cache,
)
from .ref import (
    acc_to_record_counts,
    coverage_accumulate_anchored_ref,
    coverage_accumulate_host,
    coverage_accumulate_ref,
)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "coverage_accumulate_indexed",
    "coverage_accumulate_anchored",
    "CoverageIndex",
    "build_coverage_index",
    "anchored_plan",
    "CoverageEngine",
    "EXEC_CACHE",
    "coverage_cache_stats",
    "reset_coverage_cache",
    "build_coverage_dispatch",
    "acc_to_record_counts",
    "coverage_accumulate_host",
    "coverage_accumulate_ref",
    "coverage_accumulate_anchored_ref",
]
