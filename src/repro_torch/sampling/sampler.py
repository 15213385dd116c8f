"""ε-confident uniform row sampling over word-tiled bitsets.

Hildebrant et al. (arXiv 2211.13882) prove that a uniform row sample of
size Õ(m/ε) certifies quasi-identifiers to ε-separation accuracy. This
module turns that bound into the sampled-mining fast path:

* :func:`sample_size` — the Õ(m/ε) bound with explicit constants
  (``oversample`` / ``delta`` knobs, clamped to the table size);
* :func:`derive_seed` — one deterministic sampler seed per
  ``(dataset_version, epsilon, base_seed)`` tuple, so repeated approx
  requests at the same version draw the *same* sample (and therefore
  coalesce on one cache key) and results are reproducible across runs;
* :func:`gather_sample_bits` — extracts the sampled bitset view straight
  from the store's ``(n_items, W)`` word tiles: one vectorized word
  gather + shift per item row, then a ``np.packbits`` repack into the
  sample's own word tiles. No per-row host loop, and the output width is
  padded to any placement's ``store_word_tile`` so the sampled table is
  directly placeable;
* :func:`build_sample` — the request-facing bundle: sampled
  :class:`~repro_torch.core.items.ItemTable` (same item ids as the full table,
  which is what lets boundary itemsets be recounted against the full
  store later) plus the scaled sample-space threshold;
* :func:`classify_counts` — the per-itemset confidence classifier:
  scaled support estimates split into *certain* (clearly ≤ tau or
  clearly > tau) vs the undecidable ``(tau·(1−ε), tau·(1+ε)]`` boundary
  band that only an exact recount can resolve.

Import discipline: this package sits beside ``core`` (it imports only
``repro_torch.core``) so the service, launch and benchmark layers can all use
it without cycles.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.items import WORD_BITS, ItemTable, bits_popcount

__all__ = [
    "SamplingConfig",
    "SamplePlan",
    "sample_size",
    "derive_seed",
    "sample_rows",
    "gather_sample_bits",
    "sample_item_table",
    "scaled_tau",
    "classify_counts",
    "build_sample",
]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Knobs of the ε-separation sample-size bound.

    ``epsilon`` is the default accuracy when a request doesn't pass its
    own; ``oversample`` is the leading constant of the Õ(m/ε) bound;
    ``delta`` the union-bound failure budget; ``min_rows`` a floor so
    tiny tables never sample below statistical usefulness; ``seed`` the
    base entropy mixed into every per-version sampler seed.
    """

    epsilon: float = 0.1
    delta: float = 1e-3
    oversample: float = 8.0
    min_rows: int = 256
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """One deterministic sample of a table version, ready to mine.

    ``table`` reuses the full table's item ids/columns/values — only the
    row axis (and hence bitset words, freqs, min_rows) is resampled — so
    itemsets mined on the sample are directly comparable to, and
    recountable against, the full store.
    """

    table: ItemTable
    rows: np.ndarray  # sorted sampled row indices into the full table
    seed: int  # derived sampler seed (reproducibility surface)
    epsilon: float
    n_rows_full: int
    tau_sample: int  # sample-space mining threshold
    scale: float  # n_rows_full / len(rows)


def sample_size(
    n_rows: int,
    n_cols: int,
    epsilon: float,
    *,
    config: SamplingConfig | None = None,
) -> int:
    """The Õ(m/ε) ε-separation sample-size bound, clamped to the table.

    ``oversample * (m + log2(1/delta)) / epsilon`` rows: linear in the
    column count (the union-bound dimension of 2211.13882), logarithmic
    in the failure budget, inverse in the accuracy.
    """
    cfg = config or SamplingConfig()
    if not (0.0 < epsilon < 1.0):
        raise ValueError(f"epsilon must be in (0, 1), got {epsilon}")
    bound = cfg.oversample * (n_cols + math.log2(1.0 / cfg.delta)) / epsilon
    return int(min(n_rows, max(cfg.min_rows, math.ceil(bound))))


def derive_seed(version: int, epsilon: float, base_seed: int = 0) -> int:
    """Deterministic sampler seed for a ``(version, epsilon, seed)`` tuple.

    Same tuple -> same seed -> same sample -> same approx cache key, so
    repeated approx requests coalesce; a new dataset version (or a
    different ε) draws a fresh, but still reproducible, sample.
    """
    ss = np.random.SeedSequence(
        [int(base_seed), int(version), int(round(float(epsilon) * 1e9))]
    )
    return int(ss.generate_state(1, np.uint32)[0])


def sample_rows(n_rows: int, size: int, seed: int) -> np.ndarray:
    """``size`` distinct row indices drawn uniformly, sorted ascending."""
    if size >= n_rows:
        return np.arange(n_rows, dtype=np.int64)
    rng = np.random.default_rng(int(seed))
    rows = rng.choice(n_rows, size=int(size), replace=False)
    return np.sort(rows.astype(np.int64))


def gather_sample_bits(
    bits: np.ndarray, rows: np.ndarray, *, word_tile: int = 1
) -> np.ndarray:
    """Extract sampled columns of a ``(t, W)`` uint32 bitset matrix.

    Bit ``j`` of the output corresponds to full-table row ``rows[j]``.
    Fully vectorized: one fancy-indexed word gather, one shift/mask, one
    little-endian ``packbits`` repack — the word-tile analogue of a row
    gather, with no Python loop over rows or items. The output width is
    padded (with zero words) to a multiple of ``word_tile``, the
    placement's store word tile.
    """
    rows = np.asarray(rows, dtype=np.int64)
    s = int(rows.shape[0])
    word_tile = max(1, int(word_tile))
    w_exact = (s + WORD_BITS - 1) // WORD_BITS
    tiles = max(1, (w_exact + word_tile - 1) // word_tile)
    n_words = tiles * word_tile
    if s == 0:
        return np.zeros((bits.shape[0], n_words), dtype=np.uint32)
    gw = rows // WORD_BITS
    gb = (rows % WORD_BITS).astype(np.uint32)
    # (t, s) 0/1 matrix of the sampled bits — one gather + shift, no loop
    sampled = ((bits[:, gw] >> gb[None, :]) & np.uint32(1)).astype(np.uint8)
    pad = n_words * WORD_BITS - s
    if pad:
        sampled = np.pad(sampled, ((0, 0), (0, pad)))
    packed = np.packbits(sampled, axis=1, bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32)


def sample_item_table(
    table: ItemTable, rows: np.ndarray, *, word_tile: int = 1
) -> ItemTable:
    """The sampled view of an item table: same items, sampled row axis.

    Item ids (array positions), columns and values are preserved
    verbatim; bitsets, frequencies and min-rows are recomputed on the
    sample. Items absent from the sample keep their ids with frequency 0
    — the classifier treats their estimate as any other scaled count.
    """
    rows = np.asarray(rows, dtype=np.int64)
    bits = gather_sample_bits(table.bits, rows, word_tile=word_tile)
    freq = bits_popcount(bits).astype(np.int64)
    s = int(rows.shape[0])
    if s:
        sampled = ((table.bits[:, rows // WORD_BITS]
                    >> (rows % WORD_BITS).astype(np.uint32)[None, :])
                   & np.uint32(1))
        first = np.argmax(sampled, axis=1)
        present = sampled.any(axis=1)
        min_row = np.where(present, first, np.iinfo(np.int64).max).astype(np.int64)
    else:
        min_row = np.full(table.bits.shape[0], np.iinfo(np.int64).max, np.int64)
    return ItemTable(
        n_rows=s,
        n_cols=table.n_cols,
        n_words=int(bits.shape[1]),
        value=table.value,
        col=table.col,
        freq=freq,
        min_row=min_row,
        bits=bits,
    )


def scaled_tau(tau: int, epsilon: float, n_rows: int, n_sample: int) -> int:
    """Sample-space mining threshold covering the full boundary band.

    An itemset whose scaled estimate could still be ≤ tau·(1+ε) must be
    emitted by the sample mine, so the sample threshold is
    ``floor(tau·(1+ε)·s/n)`` — floored at 1 because the miner requires a
    positive threshold (integer flooring slack is re-checked by the
    classifier, which pushes over-covered emissions into the boundary
    band rather than calling them certain).
    """
    if n_sample >= n_rows:
        return int(tau)
    t = math.floor(tau * (1.0 + epsilon) * n_sample / n_rows)
    return max(1, int(t))


def classify_counts(
    counts: np.ndarray,
    *,
    tau: int,
    epsilon: float,
    n_rows: int,
    n_sample: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Scale sample supports to full-table estimates and split confidence.

    Returns ``(estimates, boundary_mask)``. An estimate is *certain*
    when it lands clearly at or below tau — at most ``tau·(1−ε)`` — and
    *boundary* (undecidable by the sample) anywhere above that: the
    ``(tau·(1−ε), tau·(1+ε)]`` band proper, plus any emission the integer
    sample threshold over-covered past the band, which the sample is by
    construction also unsure about. Boundary itemsets are exactly the
    set the background refinement recounts against the full table.
    """
    counts = np.asarray(counts, dtype=np.int64)
    scale = 1.0 if n_sample >= n_rows else n_rows / max(1, n_sample)
    est = np.rint(counts * scale).astype(np.int64)
    if n_sample >= n_rows:
        boundary = np.zeros(counts.shape[0], dtype=bool)
    else:
        boundary = est > tau * (1.0 - epsilon)
    return est, boundary


def build_sample(
    table: ItemTable,
    *,
    version: int,
    tau: int,
    epsilon: float,
    config: SamplingConfig | None = None,
    word_tile: int = 1,
) -> SamplePlan:
    """Deterministic sample of one table version, ready for the miner."""
    cfg = config or SamplingConfig()
    seed = derive_seed(version, epsilon, cfg.seed)
    size = sample_size(table.n_rows, table.n_cols, epsilon, config=cfg)
    rows = sample_rows(table.n_rows, size, seed)
    sampled = sample_item_table(table, rows, word_tile=word_tile)
    return SamplePlan(
        table=sampled,
        rows=rows,
        seed=seed,
        epsilon=float(epsilon),
        n_rows_full=table.n_rows,
        tau_sample=scaled_tau(tau, epsilon, table.n_rows, int(rows.shape[0])),
        scale=(
            1.0
            if rows.shape[0] >= table.n_rows
            else table.n_rows / max(1, int(rows.shape[0]))
        ),
    )
