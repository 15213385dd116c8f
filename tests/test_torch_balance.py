"""The port's work balancing (``repro_torch.core.balance``): the paper's
Example 4.10 golden case, and parity of all three functions with the
reference's ``repro.core.balance`` on random inputs."""

import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core import balance as ref_balance
from repro_torch.core.balance import balanced_blocks, greedy_assign, pair_work_per_unit


def test_example_410_k2():
    """5 items at level 1, 3 threads -> T = {4, 3, 3}."""
    work = pair_work_per_unit(np.arange(5, dtype=np.int32)[:, None])
    assert work.tolist() == [4, 3, 2, 1, 0]
    _, loads = greedy_assign(work, 3)
    assert loads.tolist() == [4, 3, 3]


def test_example_410_k3():
    """9 2-itemsets in prefix groups of sizes 4/3/2 -> group work {6, 3, 1},
    3 threads -> T = {6, 3, 1}."""
    its = np.array(
        [[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [1, 3], [1, 4], [2, 3], [2, 4]],
        dtype=np.int32,
    )
    work = pair_work_per_unit(its)
    assert work.tolist() == [6, 3, 1]
    _, loads = greedy_assign(work, 3)
    assert loads.tolist() == [6, 3, 1]


@given(st.lists(st.integers(0, 100), min_size=0, max_size=200), st.integers(1, 16))
@settings(max_examples=60, deadline=None)
def test_greedy_assign_equals_reference(work, t):
    got, want = greedy_assign(np.asarray(work), t), ref_balance.greedy_assign(np.asarray(work), t)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@st.composite
def _levels(draw):
    """A sorted, deduplicated (t, k) itemset table."""
    k = draw(st.integers(1, 3))
    rows = draw(st.lists(st.lists(st.integers(0, 7), min_size=k, max_size=k, unique=True),
                         min_size=0, max_size=40))
    its = sorted({tuple(sorted(r)) for r in rows})
    return np.asarray(its, dtype=np.int32).reshape(len(its), k)


@given(_levels(), st.sampled_from(["auto", "vertex", "group"]))
@settings(max_examples=60, deadline=None)
def test_pair_work_per_unit_equals_reference(its, unit):
    np.testing.assert_array_equal(pair_work_per_unit(its, unit),
                                  ref_balance.pair_work_per_unit(its, unit))


@given(st.integers(0, 10_000), st.integers(1, 512))
@settings(max_examples=100, deadline=None)
def test_balanced_blocks_equals_reference(m, shards):
    padded, block = balanced_blocks(m, shards)
    assert (padded, block) == ref_balance.balanced_blocks(m, shards)
    assert padded % shards == 0 and padded >= m and block * shards == padded
