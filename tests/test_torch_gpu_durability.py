"""The durable service on a card: a mine killed at a level checkpoint
(``KillPoint`` at ``mine.level_end``, the flight ring frozen by ``halt()``)
resumes in a fresh service over the same ``wal_dir`` on the scheduler's
worker thread, through the CUDA kernels, and equals a cold ``cuda`` mine;
after the recovery an append is answered incrementally over the recovered
store's resident rows (rows 3-4). Marked ``gpu``; every test skips where
torch sees no CUDA card (run them there with
``python -m pytest -m gpu tests/test_torch_gpu_durability.py``)."""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import KyivConfig, mine
from repro_torch.kernels import intersect
from repro_torch.service import FaultInjector, KillPoint, MiningService

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rand(seed, n, m, dom):
    return np.random.default_rng(seed).integers(0, dom, size=(n, m))


def _value_sets(result):
    return {(frozenset(ids), int(c)) for ids, c in result.as_value_sets()}


def _stat_tuples(result):
    return [(s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections,
             s.emitted, s.skipped_absent_uniform, s.stored) for s in result.stats]


@pytest.mark.parametrize("kill_after", [0, 1], ids=["after-level-2", "after-level-3"])
def test_killed_mine_resumes_on_the_card(cuda, tmp_path, kill_after):
    base, delta = _rand(0, 5000, 6, 7), _rand(1, 300, 6, 8)
    cfg = dict(tau=1, kmax=4)
    d = str(tmp_path / "wal")
    inj = FaultInjector()
    svc = MiningService(wal_dir=d, fault_injector=inj)  # the default: engine cuda
    assert svc.placement.device.type == "cuda"
    svc.append(base)
    inj.arm("mine.level_end", action="raise", exc=KillPoint("die"), after=kill_after)
    with pytest.raises(KillPoint):
        svc.mine(**cfg)
    svc.flight.halt()
    svc.close()

    intersect.reset_launches()
    svc2 = MiningService(wal_dir=d)
    try:
        level = svc2.last_crash.last_checkpoint["level"]
        assert level == kill_after + 2 and not svc2.last_crash.clean_shutdown
        assert svc2.stats()["durability"]["resumed_jobs"] == 1
        r = svc2.mine(**cfg)  # coalesces onto the resumed run
        assert r.source == "cold" and r.info["resumed_from_level"] == level + 1
        cold = mine(base, KyivConfig(engine="cuda", device=str(cuda), **cfg))
        assert _value_sets(r.result) == _value_sets(cold)
        assert _stat_tuples(r.result) == _stat_tuples(cold)
        assert intersect.LAUNCHES["intersect_classify_count_indexed"] > 0
        if level + 1 < cfg["kmax"]:
            assert intersect.LAUNCHES["intersect_classify_write_indexed"] > 0
        assert os.listdir(os.path.join(d, "jobs")) == []
        # one upload of the recovered version, resident on the card
        assert list(svc2.store._device) == [1]
        assert svc2.store.device_bits().device.type == "cuda"

        # incremental after the recovery, over the resident rows
        before = dict(intersect.LAUNCHES)
        svc2.append(delta)
        inc = svc2.mine(**cfg)
        assert inc.source == "incremental"
        want = mine(np.concatenate([base, delta]), KyivConfig(engine="cuda", device=str(cuda), **cfg))
        assert _value_sets(inc.result) == _value_sets(want)
        assert (intersect.LAUNCHES["intersect_write_indexed"] > before["intersect_write_indexed"]
                or intersect.LAUNCHES["intersect_count_indexed"] > before["intersect_count_indexed"])
        stats = svc2.stats()
        assert stats["resilience"]["unavailable_mines"] == 0
        assert stats["resilience"]["device_retries"] == 0
    finally:
        svc2.close()
