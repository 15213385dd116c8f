"""Dataset generators for the paper's experiments.

``randomized_dataset`` follows §5.2.1 exactly: each column's domain size D is
drawn i.i.d. uniform from {10..100} and elements are drawn i.i.d. uniform
from {1..D}. The paper uses 50,000 x 25; benchmarks scale (n, m) down/up.

The domain-specific datasets (§5.3.1) are not bundled, so structural
analogues are generated with matching shape and
density character; each generator documents what is matched and what is not.
Each generator gives the same array as the reference package's for the
same arguments and seed.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "randomized_dataset",
    "exposed_dataset",
    "connect_like",
    "pumsb_like",
    "poker_like",
    "uscensus_like",
    "DATASETS",
]


def exposed_dataset(
    n: int,
    m: int = 6,
    base_domain: int = 5,
    exposed_frac: float = 0.1,
    pair_domains: tuple[int, int] = (120, 127),
    seed: int = 0,
) -> np.ndarray:
    """Frequent background with planted rare structure — the privacy-risk
    stress shape (§1's AOL exposure, controllable at any row count).

    A ``base_domain``-ary random table (every item frequent) in which an
    ``exposed_frac`` fraction of rows is made re-identifiable:

    * half carry a **unique value** in column 0 — singleton quasi-identifiers;
    * half carry an engineered value **pair** in columns 1-2: values cycle
      through coprime domains, so each *value* occurs ~``e / domain`` times
      (frequent, for τ below that) while each *combination* occurs at most
      ``ceil(e / (P * Q))`` times — minimal infrequent pairs.

    The number of planted QIs scales linearly with n and mining stays cheap,
    so record-coverage and planner runs can use paper-scale row counts.
    """
    rng = np.random.default_rng(seed)
    out = rng.integers(0, base_domain, size=(n, m)).astype(np.int64)
    e = int(n * exposed_frac)
    if e == 0 or m < 3:
        return out
    rows = rng.choice(n, size=e, replace=False)
    half = e // 2
    out[rows[:half], 0] = 10_000 + np.arange(half)
    pair_rows = rows[half:]
    k = len(pair_rows)
    p, q = pair_domains
    out[pair_rows, 1] = 10_000 + (np.arange(k) % p)
    out[pair_rows, 2] = 10_000 + (np.arange(k) % q)
    return out


def randomized_dataset(
    n: int = 50_000,
    m: int = 25,
    d_low: int = 10,
    d_high: int = 100,
    seed: int = 0,
) -> np.ndarray:
    """§5.2.1 randomised dataset: per-column domain D ~ U{d_low..d_high}."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(m):
        d = int(rng.integers(d_low, d_high + 1))
        cols.append(rng.integers(1, d + 1, size=n))
    return np.stack(cols, axis=1).astype(np.int64)


def connect_like(n: int = 67_557, m: int = 43, seed: int = 0) -> np.ndarray:
    """Connect-4 analogue: 42 board columns with 3 values (x/o/blank) whose
    marginals are position-dependent (edges mostly blank), plus an outcome
    column with 3 skewed values. Matches: shape 67557x43, 129 items, high
    density/low domain. Does not match: true game-tree correlations."""
    rng = np.random.default_rng(seed)
    cols = []
    for j in range(m - 1):
        row_depth = j % 6  # connect-4 boards fill bottom-up: deeper = fuller
        p_blank = 0.15 + 0.13 * row_depth
        p_blank = min(p_blank, 0.9)
        rem = 1.0 - p_blank
        cols.append(rng.choice(3, size=n, p=[p_blank, rem * 0.5, rem * 0.5]))
    cols.append(rng.choice(3, size=n, p=[0.65, 0.25, 0.10]))  # win/lose/draw
    return np.stack(cols, axis=1).astype(np.int64)


def pumsb_like(n: int = 49_046, m: int = 74, seed: int = 0) -> np.ndarray:
    """PUMS census analogue: 74 columns with Zipf-ish marginals and domain
    sizes drawn to land near the paper's ~1,958 items (~26 values/column)."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(m):
        d = int(rng.integers(4, 50))
        # Zipf-like marginal over d values
        w = 1.0 / np.arange(1, d + 1) ** 1.1
        w /= w.sum()
        cols.append(rng.choice(d, size=n, p=w))
    return np.stack(cols, axis=1).astype(np.int64)


def poker_like(n: int = 1_000_000, m: int = 10, seed: int = 0) -> np.ndarray:
    """Poker-hand analogue: 5 cards x (suit in {1..4}, rank in {1..13}),
    drawn without replacement within a hand — 117 items like the original."""
    rng = np.random.default_rng(seed)
    # sample 5 distinct cards out of 52 per row, vectorised
    cards = np.argsort(rng.random((n, 52)), axis=1)[:, :5]
    suit = cards // 13 + 1
    rank = cards % 13 + 1
    out = np.empty((n, 10), dtype=np.int64)
    out[:, 0::2] = suit
    out[:, 1::2] = rank
    return out[:, :m]


def uscensus_like(n: int = 200_000, m: int = 68, seed: int = 0) -> np.ndarray:
    """USCensus1990 analogue: wide, many items (~8k in the original). Mix of
    small-domain flags and large-domain codes with heavy skew."""
    rng = np.random.default_rng(seed)
    cols = []
    for j in range(m):
        if j % 3 == 0:
            d = int(rng.integers(2, 6))  # flags
            w = 1.0 / np.arange(1, d + 1) ** 0.8
        else:
            d = int(rng.integers(50, 400))  # detailed codes
            w = 1.0 / np.arange(1, d + 1) ** 1.3
        w = w / w.sum()
        cols.append(rng.choice(d, size=n, p=w))
    return np.stack(cols, axis=1).astype(np.int64)


DATASETS = {
    "randomized": randomized_dataset,
    "connect": connect_like,
    "pumsb": pumsb_like,
    "poker": poker_like,
    "uscensus": uscensus_like,
}
