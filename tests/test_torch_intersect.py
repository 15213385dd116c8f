"""The plain PyTorch versions of the four ported intersection kernels
against the reference Pallas kernels (run in interpret mode, as the
reference's own tests run them on the CPU) and the reference jnp oracle;
the CUDA wrappers' CPU path and their refusal of other devices; the level
pipeline's padding contract. Integer ops: tolerance is zero."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.intersect import intersect as jk
from repro.kernels.intersect import ref as jref
from repro_torch.core.placement import DevicePlacement, HostPlacement, make_placement
from repro_torch.kernels.intersect import (
    CLASS_EMIT,
    CLASS_SKIP,
    CLASS_STORE,
    LAUNCHES,
    LevelPipeline,
    intersect as tk,
    next_bucket,
    ref as tref,
)
from repro_torch.kernels.intersect.ops import _pad_pairs

TAUS = (0, 1, 3)


def _case(t, w, m, seed):
    """Sparse random parents with crafted rows — 0 empty, 1 all ones (sign
    bits set), 2 == 3, 4/5 sharing few bits — and pairs with self-pairs;
    every class code occurs across the sweep."""
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


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _u(x):
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype == np.int32 else np.asarray(x)


def _port(bits, pairs, pc, tau):
    b, p, c = _t(bits), _t(pairs), _t(pc)
    child, cnt, cls = tref.intersect_classify_ref(b, p, c, tau)
    cnt2, cls2 = tref.intersect_classify_count_ref(b, p, c, tau)
    child3, cnt3 = tref.intersect_pairs_ref(b, p)
    cnt4 = tref.intersect_count_ref(b, p)
    for x in (cnt, cls, cnt2, cls2, cnt3, cnt4):
        assert x.dtype == torch.int32
    return {
        "row1": (_u(child.numpy()), cnt.numpy(), cls.numpy()),
        "row2": (cnt2.numpy(), cls2.numpy()),
        "row3": (_u(child3.numpy()), cnt3.numpy()),
        "row4": (cnt4.numpy(),),
    }


_JREF = {
    "row1": jax.jit(jref.intersect_classify_ref),
    "row2": jax.jit(jref.intersect_classify_count_ref),
    "row3": jax.jit(lambda b, p, c, t: jref.intersect_pairs_ref(b, p)),
    "row4": jax.jit(lambda b, p, c, t: (jref.intersect_count_ref(b, p),)),
}


def _jnp_ref(bits, pairs, pc, tau):
    args = (jnp.asarray(bits), jnp.asarray(pairs), jnp.asarray(pc), jnp.int32(tau))
    return {row: tuple(map(np.asarray, fn(*args))) for row, fn in _JREF.items()}


def _pallas(bits, pairs, pc, tau):
    w = bits.shape[1]
    b, p, c = jnp.asarray(bits), jnp.asarray(pairs), jnp.asarray(pc)
    t = jnp.int32(tau)
    kw = dict(block_words=w, interpret=True)
    return {
        "row1": tuple(map(np.asarray, jk.intersect_classify_write_indexed(b, p, c, t, **kw))),
        "row2": tuple(map(np.asarray, jk.intersect_classify_count_indexed(b, p, c, t, **kw))),
        "row3": tuple(map(np.asarray, jk.intersect_write_indexed(b, p, **kw))),
        "row4": (np.asarray(jk.intersect_count_indexed(b, p, **kw)),),
    }


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for row in got:
        assert len(got[row]) == len(want[row]), row
        for g, w in zip(got[row], want[row]):
            assert g.shape == w.shape, row
            assert np.array_equal(g.astype(np.int64), np.asarray(w).astype(np.int64)), row


@pytest.mark.parametrize("w", [1, 3, 33, 130])
@pytest.mark.parametrize("m", [0, 1, 7, 256])
def test_plain_versions_match_jnp_oracle(w, m):
    bits, pairs, pc = _case(16, w, m, seed=w * 1000 + m)
    for tau in TAUS:
        _assert_same(_port(bits, pairs, pc, tau), _jnp_ref(bits, pairs, pc, tau))


# interpret mode compiles each kernel per shape (~0.5 s), so the Pallas
# comparison covers every W and every non-empty M of the sweep above in six
# shapes rather than their full product
@pytest.mark.parametrize("w,m", [(1, 1), (1, 256), (3, 7), (33, 256), (130, 1), (130, 7)])
def test_plain_versions_match_pallas_interpret(w, m):
    bits, pairs, pc = _case(16, w, m, seed=w * 1000 + m)
    seen = set()
    for tau in TAUS:
        port = _port(bits, pairs, pc, tau)
        _assert_same(port, _pallas(bits, pairs, pc, tau))
        seen |= set(port["row1"][2].tolist())
    if m >= 7:
        assert {CLASS_SKIP, CLASS_EMIT, CLASS_STORE} <= seen or w > 3


@pytest.mark.parametrize("m", [1, 7, 200])
def test_padded_bucket_rows_classify_skip(m):
    """Pad rows are self-pairs (0, 0): uniform, so CLASS_SKIP, and the real
    rows are unchanged by the padding."""
    bits, pairs, pc = _case(16, 33, m, seed=m)
    padded = _pad_pairs(pairs, next_bucket(m))
    assert padded.shape[0] == next_bucket(m) and not padded[m:].any()
    for tau in TAUS:
        full = _port(bits, padded, pc, tau)
        real = _port(bits, pairs, pc, tau)
        assert (full["row1"][2][m:] == CLASS_SKIP).all()
        assert np.array_equal(full["row1"][1][:m], real["row1"][1])
        assert np.array_equal(full["row1"][2][:m], real["row1"][2])
        _assert_same(full, _jnp_ref(bits, padded, pc, tau))
        if m == 7:
            _assert_same(full, _pallas(bits, padded, pc, tau))


def test_cuda_wrappers_take_plain_path_on_cpu():
    bits, pairs, pc = _case(16, 33, 64, seed=5)
    b, p, c = _t(bits), _t(pairs), _t(pc)
    before = dict(LAUNCHES)
    for tau in TAUS:
        want = _port(bits, pairs, pc, tau)
        child, cnt, cls = tk.intersect_classify_write_indexed(b, p, c, tau)
        assert np.array_equal(_u(child.numpy()), want["row1"][0])
        assert np.array_equal(cls.numpy(), want["row1"][2])
        cnt2, cls2 = tk.intersect_classify_count_indexed(b, p, c, tau)
        assert np.array_equal(cnt2.numpy(), want["row2"][0]) and np.array_equal(cls2.numpy(), want["row2"][1])
        child3, cnt3 = tk.intersect_write_indexed(b, p)
        assert np.array_equal(_u(child3.numpy()), want["row3"][0])
        assert np.array_equal(tk.intersect_count_indexed(b, p).numpy(), want["row4"][0])
    assert LAUNCHES == before, "the CPU path launches nothing"


def test_cuda_wrappers_refuse_other_devices_and_bad_inputs():
    bits, pairs, pc = _case(16, 8, 4, seed=6)
    b, p, c = _t(bits), _t(pairs), _t(pc)
    with pytest.raises(ValueError):  # not a CPU tensor: no plain fallback
        tk.intersect_count_indexed(b.to("meta"), p.to("meta"))
    with pytest.raises(ValueError):  # mixed devices
        tk.intersect_count_indexed(b, p.to("meta"))
    with pytest.raises(ValueError):
        tk.intersect_count_indexed(b.to(torch.int64), p)
    with pytest.raises(ValueError):
        tk.intersect_classify_count_indexed(b, p, c[:-1], 1)
    with pytest.raises(ValueError):
        tk.intersect_write_indexed(b, p.t().contiguous().t())  # not contiguous


def test_cuda_engine_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePlacement("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_placement("torch", device="cuda")
    assert isinstance(make_placement("numpy"), HostPlacement)
    assert DevicePlacement("cuda", device="cpu").device.type == "cpu"


@pytest.mark.parametrize("engine", ["numpy", "torch", "cuda"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("write", [True, False])
def test_level_pipeline_engines_agree(engine, fused, write):
    """LevelPipeline.submit on every engine: children (word padding
    stripped), counts and classes equal the reference oracle, in the
    caller's pair order even when the locality sort permutes them."""
    bits, pairs, pc = _case(32, 33, 150, seed=9)
    pairs = pairs[np.random.default_rng(1).permutation(len(pairs))]
    placement = make_placement(engine, device="cpu")
    pipe = LevelPipeline(bits, pc.astype(np.int64), tau=3, placement=placement,
                         fused_classify=fused)
    child, counts, classes = pipe.submit(pairs, write).result()
    want = _jnp_ref(bits, pairs, pc, 3)["row1"]
    assert counts.dtype == np.int64 and np.array_equal(counts, want[1])
    if write:
        assert child.dtype == np.uint32 and np.array_equal(child, want[0])
    else:
        assert child is None
    if fused:
        assert np.array_equal(classes, want[2])
    else:
        assert classes is None
    pipe.retire()
