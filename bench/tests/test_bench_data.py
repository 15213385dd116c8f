"""The table generators: the frozen Poker Hand generator starts equal to the
program's, and the Connect-4 table meets the source's definition."""

import collections

import numpy as np
import pytest

from bench.data import connect4_uci, poker_like
from repro_torch.data import synth as program


@pytest.mark.parametrize("n", [1, 7, 1000, (1 << 17) + 3])
def test_poker_like_equals_program(n):
    for seed in (0, 2**31 + 11):
        assert np.array_equal(poker_like.make(n=n, seed=seed), program.poker_like(n=n, seed=seed))


def _fours(board):
    """Four in a row of one player on a (7 columns, 6 rows) board of cell values."""
    found = set()
    for c in range(7):
        for r in range(6):
            for dc, dr in ((0, 1), (1, 0), (1, 1), (1, -1)):
                cells = [(c + i * dc, r + i * dr) for i in range(4)]
                if all(0 <= x < 7 and 0 <= y < 6 for x, y in cells):
                    vals = {int(board[x, y]) for x, y in cells}
                    if len(vals) == 1 and vals != {connect4_uci.BLANK}:
                        found.add(vals.pop())
    return found


def _threat(board, player):
    """A playable cell that would complete four for ``player``."""
    for c in range(7):
        free = [r for r in range(6) if board[c, r] == connect4_uci.BLANK]
        if free:
            b = board.copy()
            b[c, free[0]] = player
            if player in _fours(b):
                return True
    return False


def test_connect4_boards_meet_the_source_definition():
    table = connect4_uci.make()
    assert table.shape == (67_557, 43)
    boards = table[:, :42].reshape(-1, 7, 6)  # a1..a6, b1..b6, ...: (column, row from the bottom)
    assert ((boards == connect4_uci.X).sum((1, 2)) == 4).all() and ((boards == connect4_uci.O).sum((1, 2)) == 4).all()
    assert not ((boards[:, :, 1:] != 0) & (boards[:, :, :-1] == 0)).any()  # no stone above a blank
    keys = {b.tobytes() for b in boards}
    assert len(keys) == len(boards)
    assert not any(b[::-1].tobytes() in keys for b in boards if not np.array_equal(b, b[::-1]))
    rng = np.random.default_rng(7)
    for i in rng.choice(len(boards), 400, replace=False):
        b = boards[i]
        assert not _fours(b) and not _threat(b, connect4_uci.X) and not _threat(b, connect4_uci.O)


def test_connect4_outcome_counts_are_the_sources():
    counts = collections.Counter(connect4_uci.make()[:, 42].tolist())
    assert {connect4_uci.OUTCOMES[k]: v for k, v in counts.items()} == {"w": 44_473, "l": 16_635, "d": 6_449}


def test_connect4_outcomes_are_the_solvers(tmp_path):
    """A sample of the stored outcome column worked out again."""
    import shutil

    if shutil.which("cc") is None:
        pytest.skip("needs a C compiler")
    exe = connect4_uci.build_solver(tmp_path)
    pos = connect4_uci.positions()
    rows = [0, 1, 33_000, 67_556]
    got = connect4_uci.solve_positions([pos[i] for i in rows], exe)
    want = connect4_uci.outcomes()[rows]
    assert [connect4_uci.OUTCOMES[{1: 0, -1: 1, 0: 2}[v]] for v in got] == \
        [connect4_uci.OUTCOMES[w] for w in want]
