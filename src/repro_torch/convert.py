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

An LM's parameters cross as the reference's pytree in numpy form (nested
dicts and lists of arrays): :func:`lm_params_from_numpy` unstacks its
scanned groups into this package's per-layer modules and returns a state
dict that ``models.zoo.Model.load`` takes, so both packages compute the
same thing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.bitops import host_bits
from .core.kyiv import LevelStats, MiningState
from .core.prefix import Level
from .core.support import ItemsetIndex
from .models.layers.common import F32_LEAVES
from .models.lm import layout
from .models.zoo import build
from .service.store import DatasetStore

__all__ = ["state_to_numpy", "state_from_numpy", "store_to_numpy", "store_from_numpy",
           "lm_params_from_numpy", "reference_rank2_names"]

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


def _flatten(prefix: str, tree, out: dict) -> None:
    """Dotted names of the array leaves of nested dicts (None: an absent leaf)."""
    for key, v in tree.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}{key}.", v, out)
        elif v is not None:
            out[f"{prefix}{key}"] = v


def _index(tree, i: int):
    """Slice i of every leaf of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return None if tree is None else tree[i]


def lm_params_from_numpy(tree: dict, cfg, device=None, dtype: torch.dtype | None = None) -> dict:
    """This package's LM state dict from the reference's parameter pytree.

    ``tree`` is ``jax.tree.map(np.asarray, params)`` of ``build(cfg).init``:
    stacked ``groups[pos]`` leaves (n_groups, ...) go to layer
    ``prefix + gi * len(pattern) + pos``, and the encoder-decoder's stacked
    ``enc_layers`` / ``dec_layers`` to one layer each. With ``dtype`` every
    leaf that the layers read only through a cast to the activation dtype
    (projections, experts, embedding, biases) is stored in it; the leaves of
    ``F32_LEAVES`` (norm scales, ``A_log``, ``dt_bias``, ``D``, ``lam``) stay
    float32.
    """
    flat: dict = {}
    _flatten("embed.", tree["embed"], flat)
    if cfg.family == "audio":
        for key in ("enc_norm", "final_norm"):
            flat[key] = tree[key]
        for key, n in (("enc_layers", cfg.enc_layers), ("dec_layers", cfg.n_layers)):
            for li in range(n):
                _flatten(f"{key}.{li}.", _index(tree[key], li), flat)
    else:
        flat["final_norm"] = tree["final_norm"]
        prefix, n_groups, _ = layout(cfg)
        glen = len(cfg.pattern)
        for i, bp in enumerate(tree["prefix"]):
            _flatten(f"layers.{i}.", bp, flat)
        for pos, gp in enumerate(tree["groups"]):
            for gi in range(n_groups if gp is not None else 0):
                _flatten(f"layers.{prefix + gi * glen + pos}.", _index(gp, gi), flat)
        base = prefix + n_groups * glen
        for i, bp in enumerate(tree["suffix"]):
            _flatten(f"layers.{base + i}.", bp, flat)
    state = {}
    for name, a in flat.items():
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        keep = dtype is None or name.rsplit(".", 1)[-1] in F32_LEAVES
        state[name] = t.to(device=device, dtype=torch.float32 if keep else dtype)
    return state


def _stacked(name: str, cfg) -> bool:
    """Whether the reference stacks parameter ``name`` (a port name) along a
    leading layer axis: a layer of a scanned group, or any encoder-decoder
    layer."""
    parts = name.split(".")
    if parts[0] in ("enc_layers", "dec_layers"):
        return True
    if parts[0] != "layers":
        return False
    prefix, n_groups, _ = layout(cfg)
    return prefix <= int(parts[1]) < prefix + n_groups * len(cfg.pattern)


def reference_rank2_names(cfg) -> frozenset[str]:
    """The port's parameter names whose reference leaf has rank 2 or more.

    The reference weight-decays these leaves and casts them to bfloat16
    before the forward of a train step; its rank counts the stacking axis
    of the layout that :func:`lm_params_from_numpy` unstacks, so a norm
    scale of a grouped layer is in the set and one of a prefix or suffix
    layer is not."""
    net = build(cfg).abstract_params()
    return frozenset(name for name, p in net.named_parameters()
                     if p.dim() + _stacked(name, cfg) >= 2)
