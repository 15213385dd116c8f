"""The Kyiv breadth-first minimal τ-infrequent itemset miner (Demchuk &
Leith 2014) in bitset form, on the host or on a torch device, plus a
brute-force oracle and the MINIT baseline.

``bitops`` is imported first: the kernels package reads it while this
package is still initialising.
"""

from .bitops import popcount_rows
from .items import ItemTable, bits_popcount, bits_to_rows, itemize, pack_rows_to_bits
from .placement import DevicePlacement, HostPlacement, make_placement, resolve_placement
from .preprocess import ORDERINGS, Preprocessed, preprocess
from .prefix import (
    CandidateBatch,
    Level,
    generate_candidates,
    group_reps,
    iter_group_spans,
    prefix_group_sizes,
)
from .support import ItemsetIndex, support_test
from .bounds import apply_bounds, corollary_bound, lemma_bound
from .frontier import LevelFrontier, expand_mirrors, mine_levels
from .kyiv import (
    KyivConfig,
    LevelStats,
    MiningInterrupted,
    MiningResult,
    MiningState,
    RunControl,
    mine,
    mine_preprocessed,
    prepare,
)
from .minit import minit_minimal_infrequent
from .oracle import brute_force_minimal_infrequent

__all__ = [
    "popcount_rows",
    "ItemTable",
    "itemize",
    "pack_rows_to_bits",
    "bits_popcount",
    "bits_to_rows",
    "HostPlacement",
    "DevicePlacement",
    "make_placement",
    "resolve_placement",
    "Preprocessed",
    "preprocess",
    "ORDERINGS",
    "Level",
    "CandidateBatch",
    "generate_candidates",
    "group_reps",
    "iter_group_spans",
    "prefix_group_sizes",
    "LevelFrontier",
    "expand_mirrors",
    "mine_levels",
    "ItemsetIndex",
    "support_test",
    "lemma_bound",
    "corollary_bound",
    "apply_bounds",
    "KyivConfig",
    "LevelStats",
    "MiningInterrupted",
    "MiningResult",
    "MiningState",
    "RunControl",
    "mine",
    "mine_preprocessed",
    "prepare",
    "brute_force_minimal_infrequent",
    "minit_minimal_infrequent",
]
