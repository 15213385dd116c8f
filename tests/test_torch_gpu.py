"""The CUDA kernels on a card: each against its plain PyTorch version, bit
for bit, and a small mine against the numpy engine. Marked ``gpu``; every
test skips where torch sees no CUDA card (run them there with
``python -m pytest -m gpu tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.core import KyivConfig, mine
from repro_torch.kernels.intersect import LAUNCHES, intersect as tk, ref as tref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(t, w, m, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
    bits &= rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
    bits[0] = 0
    bits[1] = 0xFFFFFFFF
    bits[3] = bits[2]
    pairs = np.sort(rng.integers(0, t, size=(m, 2)), axis=1).astype(np.int32)
    pairs[: min(m, 3)] = np.array([[1, 1], [2, 3], [0, 1]], dtype=np.int32)[: min(m, 3)]
    pc = np.bitwise_count(bits).sum(axis=1).astype(np.int32)
    return (torch.from_numpy(bits.view(np.int32)), torch.from_numpy(pairs), torch.from_numpy(pc))


@pytest.mark.parametrize("w", [1, 3, 4, 33, 1024, 31250, 31252])
@pytest.mark.parametrize("m", [0, 1, 7, 300])
def test_kernels_match_plain_versions(cuda, w, m):
    b, p, c = _case(40, w, m, seed=w + m)
    bd, pd, cd = b.to(cuda), p.to(cuda), c.to(cuda)
    for tau in (0, 1, 5):
        want = tref.intersect_classify_ref(b, p, c, tau)
        got = tk.intersect_classify_write_indexed(bd, pd, cd, tau)
        for g, x in zip(got, want):
            assert torch.equal(g.cpu(), x)
        want2 = tref.intersect_classify_count_ref(b, p, c, tau)
        got2 = tk.intersect_classify_count_indexed(bd, pd, cd, tau)
        for g, x in zip(got2, want2):
            assert torch.equal(g.cpu(), x)
    for g, x in zip(tk.intersect_write_indexed(bd, pd), tref.intersect_pairs_ref(b, p)):
        assert torch.equal(g.cpu(), x)
    assert torch.equal(tk.intersect_count_indexed(bd, pd).cpu(), tref.intersect_count_ref(b, p))
    torch.cuda.synchronize()


def test_launch_counts(cuda):
    b, p, c = (x.to(cuda) for x in _case(16, 8, 5, seed=1))
    before = dict(LAUNCHES)
    tk.intersect_classify_write_indexed(b, p, c, 1)
    tk.intersect_count_indexed(b, p[:0])  # an empty batch launches nothing
    torch.cuda.synchronize()
    assert LAUNCHES["intersect_classify_write_indexed"] == before["intersect_classify_write_indexed"] + 1
    assert LAUNCHES["intersect_count_indexed"] == before["intersect_count_indexed"]


@pytest.mark.parametrize("fused", [True, False])
def test_mine_on_card_matches_numpy_engine(cuda, fused):
    D = np.random.default_rng(3).integers(0, 5, size=(3000, 7))
    kw = dict(tau=2, kmax=4, fused_classify=fused)
    got = mine(D, KyivConfig(engine="cuda", **kw))
    want = mine(D, KyivConfig(engine="numpy", **kw))
    assert sorted(got.itemsets) == sorted(want.itemsets)
    tup = lambda s: (s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections,
                     s.emitted, s.skipped_absent_uniform, s.stored)
    assert list(map(tup, got.stats)) == list(map(tup, want.stats))


def test_traced_dispatches_carry_their_device_time(cuda):
    """Under a trace, each dispatch's CUDA events resolve into ``device_s``
    on its span: positive, no longer than from the dispatch's start to its
    result on the host (the batch's ``intersect.sync``), and summed into
    the request's cost envelope; read events serve later launches."""
    from repro_torch.obs import cost
    from repro_torch.obs.trace import TRACER

    D = np.random.default_rng(3).integers(0, 5, size=(3000, 7))
    for _ in range(2):  # the second mine records on the first one's events again
        with cost.attach() as env, TRACER.start("request"):
            res = mine(D, KyivConfig(tau=2, kmax=4, max_pairs_per_chunk=256))
        trace = TRACER.last(1)[0]
        assert res.completed
        total = 0.0
        for level in trace.find("mine.level"):
            kids = sorted(trace.children_of(level), key=lambda s: s.t0)
            dispatches = [s for s in kids if s.name == "intersect.dispatch"]
            syncs = [s for s in kids if s.name == "intersect.sync"]
            assert dispatches and len(dispatches) == len(syncs)
            for d, s in zip(dispatches, syncs):
                assert 0 < d.attrs["device_s"] <= s.t1 - d.t0
                total += d.attrs["device_s"]
        assert env.device_s == pytest.approx(total)
