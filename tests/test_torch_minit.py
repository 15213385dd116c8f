"""The port's MINIT baseline against the reference's and against the port's
brute-force oracle, over ``tests/test_kyiv.py``'s parameter grid (n in
[5, 25], m in [2, 5], domain in [2, 5], data seed in [0, 10000], tau in
{1, 2}, kmax in [2, 4]), sampled with a fixed seed. Set equality, exact."""

import numpy as np
import pytest

from repro.core import minit_minimal_infrequent as r_minit
from repro_torch.core import KyivConfig, brute_force_minimal_infrequent, mine
from repro_torch.core import minit_minimal_infrequent

_GRID = np.random.default_rng(1403).integers(
    [5, 2, 2, 0, 1, 2], [26, 6, 6, 10_001, 3, 5], size=(40, 6)
)


@pytest.mark.parametrize("n,m,dom,seed,tau,kmax", [tuple(int(v) for v in row) for row in _GRID])
def test_minit_grid(n, m, dom, seed, tau, kmax):
    D = np.random.default_rng(seed).integers(0, dom, size=(n, m))
    got = minit_minimal_infrequent(D, tau, kmax)
    assert got == r_minit(D, tau, kmax)
    assert got == brute_force_minimal_infrequent(D, tau, kmax)


@pytest.mark.parametrize("tau,kmax", [(1, 3), (2, 4)])
def test_minit_equals_kyiv_on_a_wider_table(tau, kmax):
    """Beyond the oracle's reach: MINIT, the reference's MINIT and the
    port's Kyiv miner find the same itemsets."""
    D = np.random.default_rng(9).integers(0, 4, size=(400, 8))
    got = minit_minimal_infrequent(D, tau, kmax)
    assert got == r_minit(D, tau, kmax)
    assert got == mine(D, KyivConfig(tau=tau, kmax=kmax, engine="numpy")).canonical_set()
