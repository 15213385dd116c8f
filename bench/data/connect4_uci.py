"""Generator ``connect4_uci``: the UCI Connect-4 table, built from the source's
own definition (https://archive.ics.uci.edu/dataset/26/connect+4).

The source holds every legal position after 8 plies (4 x, 4 o, x to move)
in which neither player has won and the next move is not forced, with the
game's value for x under perfect play: 67,557 rows of 43 columns, the cells
a1..a6, b1..b6, ..., g6 (by board column, bottom to top; x, o or blank) and
the outcome (win, loss, draw). Read here as: nobody has four in a row, and
neither side has a playable cell that would complete four; of each pair of
left-right mirror images one is kept. That gives exactly the source's 67,557
rows. Of a mirror pair the position kept is the one whose bitboards
(all stones, then x's) read lower with column a in the lowest bits; rows are
in ascending order of them.

The boards are enumerated here (a few seconds). The outcome column is read
from ``connect4_uci.txt`` beside this file, one letter a row in that order
(``w`` win, ``l`` loss, ``d`` draw for x), written by

    python3 bench/data/connect4_uci.py --solve [--jobs N]

which runs the weak solver ``connect4_solve.c`` (about 15 CPU-hours). Its
counts are the source's: 44,473 wins, 16,635 losses and 6,449 draws.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

__all__ = ["COLUMNS", "OUTCOMES", "ROWS", "make", "positions"]

HERE = Path(__file__).resolve().parent
LABELS = HERE / "connect4_uci.txt"
ROWS, COLUMNS = 67_557, 43
BLANK, X, O = 0, 1, 2  # cell values
OUTCOMES = "wld"  # outcome value i is OUTCOMES[i]: win, loss, draw for x

_H1 = 7  # bits a board column: 6 cells and a sentinel
_BOTTOM = sum(1 << (c * _H1) for c in range(7))
_BOARD = _BOTTOM * 63


def _won(p: int) -> bool:
    for s in (1, _H1, _H1 - 1, _H1 + 1):
        m = p & (p >> s)
        if m & (m >> 2 * s):
            return True
    return False


def _threats(p: int, mask: int) -> int:
    """Cells a move there would complete four of the stones ``p``, that are
    playable now."""
    r = (p << 1) & (p << 2) & (p << 3)
    for s in (_H1, _H1 - 1, _H1 + 1):
        q = (p << s) & (p << 2 * s)
        r |= q & (p << 3 * s) | q & (p >> s)
        q = (p >> s) & (p >> 2 * s)
        r |= q & (p << s) | q & (p >> 3 * s)
    return r & (_BOARD ^ mask) & ((mask + _BOTTOM) & _BOARD)


def _mirror(b: int) -> int:
    return sum(((b >> (c * _H1)) & 0x7F) << ((6 - c) * _H1) for c in range(7))


@functools.lru_cache(maxsize=1)
def positions() -> tuple[tuple[int, int], ...]:
    """The source's positions as ``(all stones, x's stones)`` bitboards, in
    the table's row order."""
    level = {(0, 0)}  # (x's stones, all stones)
    for ply in range(8):
        nxt = set()
        for x, mask in level:
            for c in range(7):
                if mask & (1 << (c * _H1 + 5)):
                    continue  # column full
                grown = mask | (mask + (1 << (c * _H1)))
                nx = x | (grown ^ mask) if ply % 2 == 0 else x
                if not (_won(nx) or _won(grown ^ nx)):
                    nxt.add((nx, grown))
        level = nxt
    kept = {
        min((mask, x), (_mirror(mask), _mirror(x)))
        for x, mask in level
        if not (_threats(x, mask) or _threats(mask ^ x, mask))
    }
    return tuple(sorted(kept))


def boards() -> np.ndarray:
    """The 42 cell columns, ``(ROWS, 42)`` of ``BLANK``, ``X``, ``O``."""
    pos = np.array(positions(), dtype=np.uint64)
    shift = np.array([c * _H1 + r for c in range(7) for r in range(6)], dtype=np.uint64)
    stone = (pos[:, :1] >> shift) & np.uint64(1)
    xs = (pos[:, 1:] >> shift) & np.uint64(1)
    return (xs * X + (stone - xs) * O).astype(np.int64)


def outcomes() -> np.ndarray:
    """The outcome column from ``connect4_uci.txt``."""
    text = LABELS.read_text().strip()
    if len(text) != ROWS or set(text) - set(OUTCOMES):
        raise ValueError(f"{LABELS.name}: expected {ROWS} letters of {OUTCOMES!r}")
    return np.array([OUTCOMES.index(ch) for ch in text], dtype=np.int64)


def make(n: int = ROWS, m: int = COLUMNS, seed: int = 0) -> np.ndarray:
    """The whole table; it is fixed, so ``seed`` changes nothing. Only the
    source's size is made."""
    if (n, m) != (ROWS, COLUMNS):
        raise ValueError(f"connect4_uci makes the source's {ROWS} x {COLUMNS} table only, not {n} x {m}")
    return np.concatenate([boards(), outcomes()[:, None]], axis=1)


def solve_positions(pos, exe: Path) -> list[int]:
    """The game value for the side to move (1, 0, -1) of each ``(all stones,
    stones of the side to move)`` by the compiled solver ``exe``."""
    text = "".join(f"{x} {mask}\n" for mask, x in pos)
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True, check=True).stdout
    return [int(v) for v in out.split()]


def build_solver(build: Path) -> Path:
    build.mkdir(parents=True, exist_ok=True)
    exe = build / "connect4_solve"
    subprocess.run([os.environ.get("CC", "cc"), "-O3", "-o", str(exe), str(HERE / "connect4_solve.c")], check=True)
    return exe


def solve(jobs: int, chunk: int = 500) -> None:
    """Work the outcome column out again with ``connect4_solve.c`` in ``jobs``
    processes over contiguous chunks of rows, and write ``connect4_uci.txt``."""
    from concurrent.futures import ThreadPoolExecutor

    exe = build_solver(HERE.parent.parent / "build" / "connect4")
    pos = positions()
    with ThreadPoolExecutor(jobs) as pool:
        parts = pool.map(lambda i: solve_positions(pos[i:i + chunk], exe), range(0, len(pos), chunk))
        values = [v for part in parts for v in part]
    assert len(values) == ROWS
    LABELS.write_text("".join({1: "w", -1: "l", 0: "d"}[v] for v in values) + "\n")


if __name__ == "__main__":
    if sys.argv[1:2] != ["--solve"]:
        sys.exit(__doc__)
    solve(int(sys.argv[3]) if sys.argv[2:3] == ["--jobs"] else os.cpu_count() or 1)
