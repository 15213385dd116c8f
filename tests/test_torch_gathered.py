"""The gathered kernel family (``indexed_kernel=False``) of the port on the
CPU: the five CUDA wrappers' plain path and the four plain versions against
the reference's gathered Pallas kernels in interpret mode (as the
reference's own tests run them on the CPU); the one-shot helpers and the
engine dispatch with ``indexed=False``; whole mines against the reference's
``engine="pallas", indexed_kernel=False`` mines. Integer ops: tolerance is
zero."""

import numpy as np
import pytest
import torch

from repro.core import KyivConfig as RConfig
from repro.core import mine as r_mine
from repro.kernels.intersect import intersect as jk
from repro.kernels.intersect import ops as jops
from repro_torch.core import KyivConfig, mine
from repro_torch.core.placement import DevicePlacement, make_placement, resolve_placement
from repro_torch.kernels.intersect import (
    LAUNCHES,
    build_engine_dispatch,
    intersect as tk,
    intersect_and_count,
    intersect_classify,
    ref as tref,
)

TAUS = (0, 1, 3)
GATHERED_WRAPPERS = (
    "intersect_classify_write_gathered",
    "intersect_classify_write_gathered_donating",
    "intersect_classify_count_gathered",
    "intersect_write_gathered",
    "intersect_count_gathered",
)


def _case(t, w, m, seed):
    """Sparse random parents with crafted rows — 0 empty, 1 all ones (sign
    bits set), 2 == 3, 4/5 sharing few bits, 5 with a sign bit — and pairs
    with self-pairs; every class code occurs across the sweep."""
    rng = np.random.default_rng(seed)
    bits = (rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
            & rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
            & rng.integers(0, 2**32, size=(t, w), dtype=np.uint32))
    bits[0] = 0
    bits[1] = 0xFFFFFFFF
    bits[3] = bits[2]
    bits[4] = 0
    bits[4, 0] = 0b1011
    bits[5] = bits[6]
    bits[5, 0] = 0b0011 | 0x80000000
    pairs = np.sort(rng.integers(0, t, size=(m, 2)), axis=1).astype(np.int32)
    fixed = np.array([[4, 5], [1, 1], [2, 3], [0, 7], [1, 8], [6, 6], [4, 1]], dtype=np.int32)
    pairs[: min(m, len(fixed))] = fixed[: min(m, len(fixed))]
    pc = np.bitwise_count(bits).sum(axis=1).astype(np.int32)
    return bits, pairs, pc


def _operands(bits, pairs, pc):
    """Host (a, b, minp) as the gathered dispatch gathers them."""
    a, b = bits[pairs[:, 0]], bits[pairs[:, 1]]
    return a, b, np.minimum(pc[pairs[:, 0]], pc[pairs[:, 1]]).astype(np.int32)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 and x.ndim == 2 else x


def _pallas(a, b, minp, tau):
    """The reference's four gathered Pallas kernels, interpret mode, with
    tiles that divide (M, W); M = 0 has no grid, so its outputs are empty."""
    m, w = a.shape
    if m == 0:
        z = np.zeros(0, np.int32)
        return {"write_cls": (a.copy(), z, z), "count_cls": (z, z), "write": (a.copy(), z),
                "count": (z,)}
    tiles = dict(block_pairs=jops._largest_divisor_tile(m, 8), block_words=w, interpret=True)
    out = {
        "write_cls": jk.intersect_classify_write_gathered(a, b, minp, tau, **tiles),
        "count_cls": jk.intersect_classify_count_gathered(a, b, minp, tau, **tiles),
        "write": jk.intersect_write_gathered(a, b, **tiles),
        "count": (jk.intersect_count_gathered(a, b, **tiles),),
    }
    return {k: tuple(_u(np.asarray(x)) for x in v) for k, v in out.items()}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = _u(g)
        assert g.shape == w.shape and np.array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("m", [0, 1, 7, 16])
@pytest.mark.parametrize("w", [5, 33])
def test_plain_versions_and_wrappers_match_pallas(m, w):
    """The four plain versions and the five wrappers (CPU path) equal the
    reference's gathered Pallas kernels, word for word; the donating
    wrapper is held against the non-donating kernel, as the reference
    never donates on the CPU."""
    bits, pairs, pc = _case(24, w, m, seed=10 * w + m)
    a, b, minp = _operands(bits, pairs, pc)
    ta, tb, tm = _t(a), _t(b), _t(minp)
    before = dict(LAUNCHES)
    for tau in TAUS:
        want = _pallas(a, b, minp, tau)
        _same(tref.intersect_classify_gathered_ref(ta, tb, tm, tau), want["write_cls"])
        _same(tref.intersect_classify_count_gathered_ref(ta, tb, tm, tau), want["count_cls"])
        _same(tref.intersect_gathered_ref(ta, tb), want["write"])
        _same((tref.intersect_count_gathered_ref(ta, tb),), want["count"])
        _same(tk.intersect_classify_write_gathered(ta, tb, tm, tau), want["write_cls"])
        _same(tk.intersect_classify_count_gathered(ta, tb, tm, tau), want["count_cls"])
        _same(tk.intersect_write_gathered(ta, tb), want["write"])
        _same((tk.intersect_count_gathered(ta, tb),), want["count"])
        own = ta.clone()
        got = tk.intersect_classify_write_gathered_donating(own, tb, tm, tau)
        assert got[0] is own and got[0].data_ptr() == own.data_ptr()
        _same(got, want["write_cls"])
    assert LAUNCHES == before, "the CPU path launches nothing"


def test_gathered_equals_indexed_plain_versions():
    """Gathering first changes nothing: each gathered plain version equals
    its indexed counterpart on the same pairs."""
    bits, pairs, pc = _case(40, 33, 64, seed=3)
    tb, tp, tc = _t(bits), _t(pairs), _t(pc)
    a, b = tb[tp[:, 0]], tb[tp[:, 1]]
    minp = tref.min_parent_ref(tc, tp)
    for tau in TAUS:
        _same(tref.intersect_classify_gathered_ref(a, b, minp, tau),
              tuple(_u(x) for x in tref.intersect_classify_ref(tb, tp, tc, tau)))
        _same(tref.intersect_classify_count_gathered_ref(a, b, minp, tau),
              tuple(_u(x) for x in tref.intersect_classify_count_ref(tb, tp, tc, tau)))
    _same(tref.intersect_gathered_ref(a, b), tuple(_u(x) for x in tref.intersect_pairs_ref(tb, tp)))


def test_gathered_wrappers_refuse_other_devices_and_bad_inputs():
    bits, pairs, pc = _case(16, 8, 4, seed=6)
    a, b, minp = (_t(x) for x in _operands(bits, pairs, pc))
    with pytest.raises(ValueError):  # not a CPU tensor: no plain fallback
        tk.intersect_count_gathered(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError):  # mixed devices
        tk.intersect_classify_write_gathered_donating(a, b, minp.to("meta"), 1)
    with pytest.raises(ValueError):
        tk.intersect_write_gathered(a, b[:, :-1].contiguous())  # shapes differ
    with pytest.raises(ValueError):
        tk.intersect_classify_count_gathered(a, b, minp[:-1], 1)
    with pytest.raises(ValueError):
        tk.intersect_classify_write_gathered(a.to(torch.int64), b, minp, 1)
    with pytest.raises(ValueError):
        tk.intersect_write_gathered(a.t().contiguous().t(), b)  # not contiguous


def test_empty_batch_returns_empty_outputs():
    a = torch.zeros((0, 9), dtype=torch.int32)
    minp = torch.zeros(0, dtype=torch.int32)
    child, cnt, cls = tk.intersect_classify_write_gathered_donating(a, a.clone(), minp, 1)
    assert child is a and cnt.shape == (0,) and cls.shape == (0,)
    assert tk.intersect_count_gathered(a, a).shape == (0,)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("write", [True, False])
@pytest.mark.parametrize("donate", [True, False])
def test_build_engine_dispatch_gathered_equals_indexed(engine, fused, write, donate):
    bits, pairs, pc = _case(32, 33, 90, seed=12)
    tb, tp, tc = _t(bits), _t(pairs), _t(pc)
    args = dict(fused_classify=fused, write_children=write)
    want = build_engine_dispatch(engine, **args)(tb, tp, tc, 3)
    got = build_engine_dispatch(engine, indexed=False, donate=donate, **args)(tb, tp, tc, 3)
    for g, x in zip(got, want):
        assert (g is None) == (x is None)
        if g is not None:
            assert torch.equal(g, x)


@pytest.mark.parametrize("write", [True, False])
@pytest.mark.parametrize("m", [0, 9, 40])
def test_one_shot_helpers_match_reference(write, m):
    """``intersect_and_count`` / ``intersect_classify`` with ``indexed=False``
    (and True) on every engine equal the reference's helpers on its
    gathered Pallas path."""
    bits, pairs, pc = _case(24, 33, m, seed=20 + m)
    pairs = pairs[np.random.default_rng(m).permutation(m)]  # the locality sort un-permutes
    want_c = jops.intersect_and_count(bits, pairs, write_children=write, engine="pallas",
                                      indexed=False, interpret=True)
    want_k = jops.intersect_classify(bits, pairs, pc.astype(np.int64), tau=3,
                                     write_children=write, engine="pallas", indexed=False,
                                     interpret=True)
    for engine in ("numpy", "torch", "cuda"):
        for indexed in (False, True):
            kw = dict(write_children=write, engine=engine, device="cpu", indexed=indexed)
            child, counts = intersect_and_count(bits, pairs, **kw)
            assert counts.dtype == np.int64 and np.array_equal(counts, want_c[1])
            if write:
                assert child.dtype == np.uint32 and np.array_equal(child, want_c[0])
            else:
                assert child is None
            child, counts, classes = intersect_classify(bits, pairs, pc.astype(np.int64), tau=3, **kw)
            assert np.array_equal(counts, want_k[1]) and np.array_equal(classes, want_k[2])
            if write:
                assert np.array_equal(child, want_k[0])


def test_placement_reads_indexed_kernel():
    p = resolve_placement(KyivConfig(engine="torch", device="cpu", indexed_kernel=False))
    assert isinstance(p, DevicePlacement) and p.indexed is False
    assert p.donate is False, "the CPU never donates, as in the reference"
    assert "indexed=False" in repr(p)
    assert make_placement("cuda", device="cpu").indexed is True
    assert resolve_placement(KyivConfig(engine="torch", device="cpu")).indexed is True


def tup(s):
    return (s.k, s.candidates, s.support_pruned, s.bound_pruned,
            s.intersections, s.emitted, s.skipped_absent_uniform, s.stored)


def _assert_same(got, want):
    assert sorted(got.itemsets) == sorted(want.itemsets)
    assert list(map(tup, got.stats)) == list(map(tup, want.stats))
    assert [s.level_bytes for s in got.stats] == [s.level_bytes for s in want.stats]


D_SMALL = np.random.default_rng(77).integers(0, 5, size=(160, 6))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("use_bounds", [True, False])
def test_mine_matches_reference_gathered_pallas(fused, use_bounds):
    """Whole mines (n <= 300: interpret mode is slow): the port's
    ``indexed_kernel=False`` on both engines equals the reference's."""
    kw = dict(tau=1, kmax=4, fused_classify=fused, use_bounds=use_bounds)
    want = r_mine(D_SMALL, RConfig(engine="pallas", indexed_kernel=False, **kw))
    for engine in ("torch", "cuda"):
        got = mine(D_SMALL, KyivConfig(engine=engine, device="cpu", indexed_kernel=False, **kw))
        _assert_same(got, want)


@pytest.mark.parametrize("tau,kmax", [(1, 3), (2, 4), (3, 4)])
def test_donating_mine_matches_reference(tau, kmax):
    """The donating write path, as a card runs it, in a whole mine: the
    child is written over the gathered operand and nothing changes."""
    D = np.random.default_rng(tau).integers(0, 5, size=(260, 7))
    placement = DevicePlacement("torch", device="cpu", indexed=False)
    placement.donate = True
    got = mine(D, KyivConfig(tau=tau, kmax=kmax, placement=placement))
    _assert_same(got, r_mine(D, RConfig(tau=tau, kmax=kmax, engine="numpy")))
