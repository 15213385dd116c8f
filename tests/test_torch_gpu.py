"""The CUDA kernels on a card: each against its plain PyTorch version, bit
for bit, and a small mine against the numpy engine. Marked ``gpu``; every
test skips where torch sees no CUDA card (run them there with
``python -m pytest -m gpu tests/test_torch_gpu.py``)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import KyivConfig, mine
from repro_torch.core.items import _itemize
from repro_torch.kernels.intersect import LAUNCHES, intersect as tk, ref as tref
from repro_torch.kernels.itemize import LAUNCHES as ITEMIZE_LAUNCHES, itemize_on_device
from repro_torch.obs.trace import TRACER
from test_torch_itemize_helpers import CASES, ROWS, assert_same_table

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


# the item table built by the itemize kernels (kernels/itemize/csrc/itemize.cu)


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_itemize_kernels_equal_the_host(cuda, case, n):
    D = CASES[case](n)
    before = dict(ITEMIZE_LAUNCHES)
    got, attrs = itemize_on_device(D, cuda, "cuda")
    assert_same_table(got, _itemize(D))
    assert attrs["path"] == "cuda"
    assert ITEMIZE_LAUNCHES["itemize_bits"] == before["itemize_bits"] + 1
    assert ITEMIZE_LAUNCHES["itemize_stats"] == before["itemize_stats"] + 1
    assert ITEMIZE_LAUNCHES["itemize_presence"] == before["itemize_presence"] + (attrs["dense_cols"] > 0)


def _bench_table(generator: str) -> np.ndarray:
    """A benchmark table at full size from the benchmark's own generator
    (``bench/data/<generator>.py``), its rows in a drawn order as there."""
    path = Path(__file__).resolve().parents[1] / "bench" / "data" / f"{generator}.py"
    spec = importlib.util.spec_from_file_location(f"bench_data_{generator}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    D = mod.make(n=1_025_010, m=10, seed=0) if generator == "poker_like" else mod.make()
    return np.ascontiguousarray(D[np.random.default_rng(2**31 + 5).permutation(len(D))])


@pytest.mark.parametrize("generator", ["poker_like", "connect4_uci"])
def test_itemize_kernels_on_the_benchmark_tables(cuda, generator):
    """Equal to the host, as the plain version on the card is; every column
    dense; nothing left allocated, and Connect-4's temporary peak well under
    its mine's 113 MB level loop."""
    D = _bench_table(generator)
    want = _itemize(D)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, attrs = itemize_on_device(D, cuda, "cuda")
    peak = torch.cuda.max_memory_allocated() - held
    assert torch.cuda.memory_allocated() == held
    assert_same_table(got, want)
    assert (attrs["dense_cols"], attrs["sorted_cols"]) == (D.shape[1], 0)
    assert attrs["bytes_up"] == D.nbytes + D.shape[1] * 40
    if generator == "connect4_uci":
        assert peak < 60e6
    plain, attrs = itemize_on_device(D, cuda, "torch")
    assert attrs["path"] == "torch"
    assert_same_table(plain, want)


def test_mine_on_the_cuda_route_equals_the_numpy_engine(cuda):
    """``mine`` itemizes on the card (the span's ``path``), one column by the
    sort route, and gives the numpy engine's table, itemsets and levels."""
    rng = np.random.default_rng(7)
    D = np.concatenate([rng.integers(0, 5, size=(3000, 6)),
                        rng.choice(np.array([-(10**12), 0, 5, 10**12]), size=(3000, 1))], axis=1)
    with TRACER.start("request"):
        got = mine(D, KyivConfig(tau=2, kmax=3))
    (sp,) = TRACER.last(1)[0].find("itemize")
    assert (sp.attrs["path"], sp.attrs["dense_cols"], sp.attrs["sorted_cols"]) == ("cuda", 6, 1)
    want = mine(D, KyivConfig(tau=2, kmax=3, engine="numpy"))
    assert_same_table(got.prep.table, want.prep.table)
    assert sorted(got.itemsets) == sorted(want.itemsets)
    tup = lambda s: (s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections,
                     s.emitted, s.skipped_absent_uniform, s.stored)
    assert list(map(tup, got.stats)) == list(map(tup, want.stats))
