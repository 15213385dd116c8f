"""The per-family helpers of the executable-bucket cache, ported from the
reference's ``tests/test_frontier.py`` unified-cache checks: a mine on a
device placement (torch on the CPU) binds entries in both the ``frontier``
and ``intersect`` families of ``core.exec_cache``, the registry's totals are
the sum over its families, each family's helper reads its own entries, and
clearing one family leaves the other's."""

import numpy as np

from repro_torch.core import KyivConfig, exec_cache, mine
from repro_torch.kernels.coverage.ops import coverage_cache_stats
from repro_torch.kernels.frontier.ops import frontier_cache_stats, reset_frontier_cache
from repro_torch.kernels.intersect.ops import executable_cache_stats, reset_executable_cache

RNG = np.random.default_rng(0)
CFG = dict(engine="torch", device="cpu")


def test_unified_exec_cache_families():
    mine(RNG.integers(0, 4, size=(60, 4)), KyivConfig(tau=1, kmax=3, **CFG))
    stats = exec_cache.stats()
    assert "frontier" in stats["families"] and "intersect" in stats["families"]
    assert stats["entries"] == sum(f["entries"] for f in stats["families"].values())
    assert exec_cache.exec_family("frontier").stats()["entries"] == \
        stats["families"]["frontier"]["entries"] == frontier_cache_stats()["entries"]
    assert executable_cache_stats()["entries"] == stats["families"]["intersect"]["entries"]


def test_family_clear_is_isolated():
    mine(RNG.integers(0, 4, size=(50, 4)), KyivConfig(tau=1, kmax=2, **CFG))
    assert executable_cache_stats()["entries"] >= 1
    assert frontier_cache_stats()["entries"] >= 1
    before_intersect = executable_cache_stats()["entries"]
    before_coverage = coverage_cache_stats()["entries"]
    reset_frontier_cache()
    assert frontier_cache_stats()["entries"] == 0
    assert executable_cache_stats()["entries"] == before_intersect
    reset_executable_cache()
    assert executable_cache_stats()["entries"] == 0
    assert coverage_cache_stats()["entries"] == before_coverage
    mine(RNG.integers(0, 4, size=(50, 4)), KyivConfig(tau=1, kmax=2, **CFG))
    assert executable_cache_stats()["misses"] >= 1 and executable_cache_stats()["entries"] >= 1
