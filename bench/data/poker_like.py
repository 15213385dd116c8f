"""Generator ``poker_like``: Poker Hand tables, frozen.

A copy of ``poker_like`` from ``repro_torch.data.synth`` (itself a copy of
``repro.data.synth``), kept here so that a later change to the program
cannot change the tables the benchmark measures on.
``bench/tests/test_bench_data.py`` holds it equal to the program's generator
for the same arguments and seed. It draws the same numbers in row blocks and
picks each row's five smallest with a partial sort instead of a full one:
the same array in less time and memory.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make"]


def make(n: int = 1_000_000, m: int = 10, seed: int = 0) -> np.ndarray:
    """Poker hands: 5 cards x (suit in {1..4}, rank in {1..13}), drawn
    without replacement within a hand (UCI Poker Hand's 10 attribute columns,
    the class column dropped)."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, 10), dtype=np.int64)
    block = 1 << 17
    for lo in range(0, n, block):
        r = rng.random((min(block, n - lo), 52))
        # the row's five smallest draws, in ascending order: argsort's first 5
        idx = np.argpartition(r, 4, axis=1)[:, :5]
        idx = np.take_along_axis(idx, np.argsort(np.take_along_axis(r, idx, 1), axis=1), 1)
        out[lo : lo + len(r), 0::2] = idx // 13 + 1
        out[lo : lo + len(r), 1::2] = idx % 13 + 1
    return out[:, :m]
