"""Sampled-mining fast path: ε-confident answers from uniform row samples.

``sampler`` draws deterministic uniform row samples straight from the
word-tiled bitsets and classifies sample-mined itemsets into certain vs
boundary confidence bands; ``refine`` recounts the boundary band exactly
against the full table through the shared placement machinery. The mining service composes the two into
``mine(mode="approx")`` + background exact refinement.
"""

from .sampler import (
    SamplePlan,
    SamplingConfig,
    build_sample,
    classify_counts,
    derive_seed,
    gather_sample_bits,
    sample_item_table,
    sample_rows,
    sample_size,
    scaled_tau,
)
from .refine import recount_supports

__all__ = [
    "SamplePlan",
    "SamplingConfig",
    "build_sample",
    "classify_counts",
    "derive_seed",
    "gather_sample_bits",
    "recount_supports",
    "sample_item_table",
    "sample_rows",
    "sample_size",
    "scaled_tau",
]
