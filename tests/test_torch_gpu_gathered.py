"""The gathered CUDA kernels on a card: each against its plain PyTorch
version, bit for bit, the donating one writing in place, and
``indexed_kernel=False`` mines against the numpy engine. Marked ``gpu``;
every test skips where torch sees no CUDA card (run them there with
``python -m pytest -m gpu tests/test_torch_gpu_gathered.py``)."""

import numpy as np
import pytest
import torch

from repro_torch.core import DevicePlacement, KyivConfig, mine
from repro_torch.distributed.checkpoint import load_pytree, save_pytree
from repro_torch.kernels.intersect import LAUNCHES, intersect as tk, ref as tref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _operands(m, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(m, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(m, w), dtype=np.uint32) & a
    a[: min(m, 2)] = 0xFFFFFFFF  # sign bits
    b[:1] = 0
    if m > 2:
        b[2] = a[2]
    minp = np.minimum(np.bitwise_count(a).sum(1), np.bitwise_count(b).sum(1) + 3).astype(np.int32)
    return (torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)),
            torch.from_numpy(minp))


def _equal(got, want):
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x)


@pytest.mark.parametrize("w", [1, 3, 4, 33, 1024, 31250, 31252])
@pytest.mark.parametrize("m", [0, 1, 7, 300])
def test_gathered_kernels_match_plain_versions(cuda, w, m):
    a, b, minp = _operands(m, w, seed=w + m)
    ad, bd, md = a.to(cuda), b.to(cuda), minp.to(cuda)
    for tau in (0, 1, 5):
        want = tref.intersect_classify_gathered_ref(a, b, minp, tau)
        _equal(tk.intersect_classify_write_gathered(ad, bd, md, tau), want)
        own = ad.clone()
        got = tk.intersect_classify_write_gathered_donating(own, bd, md, tau)
        assert got[0] is own and got[0].data_ptr() == own.data_ptr()
        _equal(got, want)
        _equal(tk.intersect_classify_count_gathered(ad, bd, md, tau),
               tref.intersect_classify_count_gathered_ref(a, b, minp, tau))
    _equal(tk.intersect_write_gathered(ad, bd), tref.intersect_gathered_ref(a, b))
    assert torch.equal(tk.intersect_count_gathered(ad, bd).cpu(), tref.intersect_count_gathered_ref(a, b))
    torch.cuda.synchronize()


def test_gathered_launch_counts(cuda):
    a, b, minp = (x.to(cuda) for x in _operands(5, 8, seed=1))
    before = dict(LAUNCHES)
    tk.intersect_classify_write_gathered_donating(a, b, minp, 1)
    tk.intersect_count_gathered(a[:0], b[:0])  # an empty batch launches nothing
    torch.cuda.synchronize()
    name = "intersect_classify_write_gathered_donating"
    assert LAUNCHES[name] == before[name] + 1
    assert LAUNCHES["intersect_count_gathered"] == before["intersect_count_gathered"]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("donate", [True, False])
def test_gathered_mine_on_card_matches_numpy_engine(cuda, fused, donate):
    D = np.random.default_rng(3).integers(0, 5, size=(3000, 7))
    kw = dict(tau=2, kmax=4, fused_classify=fused)
    placement = DevicePlacement("cuda", indexed=False)
    assert placement.donate, "a card donates by default"
    placement.donate = donate
    got = mine(D, KyivConfig(placement=placement, **kw))
    want = mine(D, KyivConfig(engine="numpy", **kw))
    assert sorted(got.itemsets) == sorted(want.itemsets)
    tup = lambda s: (s.k, s.candidates, s.support_pruned, s.bound_pruned, s.intersections,
                     s.emitted, s.skipped_absent_uniform, s.stored)
    assert list(map(tup, got.stats)) == list(map(tup, want.stats))


def test_checkpoint_of_card_tensors(cuda, tmp_path):
    x = torch.arange(12, dtype=torch.int32, device=cuda).reshape(3, 4)
    save_pytree(str(tmp_path / "ck"), {"bits": x})
    tree, _ = load_pytree(str(tmp_path / "ck"))
    assert isinstance(tree["bits"], np.ndarray) and np.array_equal(tree["bits"], x.cpu().numpy())
