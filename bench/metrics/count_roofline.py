"""count_roofline: the least time of the window's counting work over the
device time of the kernels that did it, in %.

The work of level k >= 2 of a mine, from its level counts and its word
count W = ceil(rows / 32):

* bytes: the parent level's rows read once (stored at k-1, W 32-bit words
  each) with their supports (4 B), each counted pair's two int32 indices
  read and its int32 count and class code written, and the level's stored
  children written once (W words each);
* logic operations: an AND and two carry-save operations per counted pair
  and word.

The least time of a level is the larger of bytes at the card's HBM rate and
operations at its LOP3 rate (``bench/hw.json``); the work is summed over
every level of every mine in the window. The device time is the summed
duration of the trace's kernels whose names hold a pattern of
``count_roofline.json``.
"""

import json
from pathlib import Path

_KERNELS = json.loads(Path(__file__).with_suffix(".json").read_text())["kernels"]


def least_seconds(stats, words: int, hw: dict) -> float:
    """Least time of one mine's counting work, from its level tuples
    ``(k, candidates, support_pruned, bound_pruned, intersections, emitted,
    skipped, stored, level_bytes)``."""
    total = 0.0
    for parent, level in zip(stats, stats[1:]):
        t, pairs, stored = parent[7], level[4], level[7]
        nbytes = 4 * (t * words + t) + 16 * pairs + 4 * stored * words
        ops = 3 * pairs * words
        total += max(nbytes / hw["hbm_bytes_per_s"], ops / hw["lop3_per_s"])
    return total


def read(run):
    dev = run.device
    if dev is None:
        return None
    kernel_s = sum(s for name, s in dev.time_by_name().items() if any(k in name for k in _KERNELS))
    if kernel_s <= 0:
        return None
    least = sum(least_seconds(r["stats"], r["words"], run.hw) for r in run.requests)
    return 100.0 * least / kernel_s
