"""Carry state across packages: a level-boundary ``MiningState`` and the
resident service's ``DatasetStore``, each in plain numpy form, and back.

The numpy form is a dict::

    {"results": [(item ids tuple, count), ...],
     "stats": [LevelStats fields as a tuple, in field order, ...],
     "level": {"k": int, "itemsets": (t, k) int32, "counts": (t,) int64,
               "bits": (t, W) uint32 or None},
     "grandparent": {"itemsets": ..., "counts": ...} or None,
     "next_k": int}

:func:`state_to_numpy` reads any object shaped like a ``MiningState`` — the
reference package's or this one's — so a run checkpointed by the reference
miner resumes here (``mine_preprocessed(..., resume_state=state_from_numpy(d))``)
and both compute the same thing.

A store's numpy form is its ``export_state()`` dict (ints and numpy arrays:
watermarks, item metadata and the ``(n_items, n_words)`` uint32 bitsets), the
same in both packages: :func:`store_from_numpy` rebuilds this package's
``DatasetStore`` from the reference's export unchanged, so a table appended
in the reference service answers ``/mine`` here identically.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core.bitops import host_bits
from .core.kyiv import LevelStats, MiningState
from .core.prefix import Level
from .core.support import ItemsetIndex
from .service.store import DatasetStore

__all__ = ["state_to_numpy", "state_from_numpy", "store_to_numpy", "store_from_numpy"]

_STAT_FIELDS = tuple(f.name for f in dataclasses.fields(LevelStats))


def state_to_numpy(state) -> dict:
    """Plain numpy form of a ``MiningState`` (of either package)."""
    level = state.level
    gp = state.grandparent_index
    bits = level.bits
    return {
        "results": [(tuple(int(i) for i in ids), int(c)) for ids, c in state.results],
        "stats": [tuple(getattr(s, f) for f in _STAT_FIELDS) for s in state.stats],
        "level": {
            "k": int(level.k),
            "itemsets": np.asarray(level.itemsets, dtype=np.int32),
            "counts": np.asarray(level.counts, dtype=np.int64),
            "bits": None if bits is None else host_bits(bits, np.shape(bits)[1]),
        },
        "grandparent": None
        if gp is None
        else {
            "itemsets": np.asarray(gp.itemsets, dtype=np.int32),
            "counts": np.asarray(gp.counts, dtype=np.int64),
        },
        "next_k": int(state.next_k),
    }


def state_from_numpy(d: dict) -> MiningState:
    """This package's ``MiningState`` from the numpy form."""
    lv = d["level"]
    gp = d["grandparent"]
    return MiningState(
        results=[(tuple(ids), int(c)) for ids, c in d["results"]],
        stats=[LevelStats(**dict(zip(_STAT_FIELDS, s))) for s in d["stats"]],
        level=Level(
            k=int(lv["k"]),
            itemsets=np.asarray(lv["itemsets"], dtype=np.int32),
            counts=np.asarray(lv["counts"], dtype=np.int64),
            bits=None if lv["bits"] is None else np.asarray(lv["bits"], dtype=np.uint32),
        ),
        grandparent_index=None
        if gp is None
        else ItemsetIndex(np.asarray(gp["itemsets"]), np.asarray(gp["counts"], dtype=np.int64)),
        next_k=int(d["next_k"]),
    )


def store_to_numpy(store) -> dict:
    """Plain numpy form of a ``DatasetStore`` (of either package): its
    ``export_state()``, arrays copied."""
    return {k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in store.export_state().items()}


def store_from_numpy(d: dict, *, placement=None, **kw):
    """This package's ``DatasetStore`` from the numpy form; ``placement``
    (and ``compact_threshold`` / ``keep_versions`` / ``shard``) as for
    ``DatasetStore.from_state``."""
    return DatasetStore.from_state(d, placement=placement, **kw)
