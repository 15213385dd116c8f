"""Record coverage: the CUDA kernel, its plain versions and the batching
engine that the privacy path dispatches through."""

from .coverage import LAUNCHES, coverage_accumulate_indexed, reset_launches
from .ops import CoverageEngine, build_coverage_dispatch
from .ref import acc_to_record_counts, coverage_accumulate_host, coverage_accumulate_ref

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "coverage_accumulate_indexed",
    "CoverageEngine",
    "build_coverage_dispatch",
    "acc_to_record_counts",
    "coverage_accumulate_host",
    "coverage_accumulate_ref",
]
