"""The BFS level frontier's device bodies (torch ops) and their numpy
mirrors."""

from .frontier import (
    SENTINEL,
    gen_pairs_body,
    gen_support_body,
    lookup_keys,
    lower_bound,
    mask_pruned_body,
    pack_cols,
    pack_params,
    partition_body,
    support_ok_body,
)
from .ops import (
    EXEC_CACHE,
    frontier_cache_stats,
    gen_buckets,
    make_level_tables,
    pad_reps,
    reset_frontier_cache,
    table_pad,
)
from .ref import gen_pairs_np, key_table_np, lookup_np, pack_rows_np, partition_np

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
    "table_pad",
    "make_level_tables",
    "pad_reps",
    "gen_buckets",
    "EXEC_CACHE",
    "frontier_cache_stats",
    "reset_frontier_cache",
    "pack_rows_np",
    "key_table_np",
    "lookup_np",
    "gen_pairs_np",
    "partition_np",
]
