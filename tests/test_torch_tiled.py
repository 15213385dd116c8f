"""The port's group-tiled count against the reference: the wrapper's CPU
path (its plain PyTorch version) against ``repro``'s Pallas
``intersect_count_tiled`` in interpret mode (as the reference's own tests
run it on the CPU), the host helpers ``build_group_tiles`` and
``counts_from_tiles`` against the reference's, and the whole path on a mined
level-3 frontier against the pairwise count kernel's CPU path and numpy.
Integer ops: the tolerance is zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.intersect.tiled import build_group_tiles as r_build_group_tiles
from repro.kernels.intersect.tiled import counts_from_tiles as r_counts_from_tiles
from repro.kernels.intersect.tiled import intersect_count_tiled as r_intersect_count_tiled
from repro_torch.core import KyivConfig, prepare
from repro_torch.core.kyiv import mine_preprocessed
from repro_torch.core.prefix import prefix_group_sizes
from repro_torch.data.synth import poker_like
from repro_torch.kernels.intersect import (
    build_group_tiles,
    counts_from_tiles,
    intersect_count_indexed,
    intersect_count_tiled,
    intersect_count_tiled_ref,
)
from repro_torch.kernels.intersect import tiled as ttiled

# group sizes with empty and one-row groups, groups of exactly a block and
# groups that spill into a ragged last block
GROUPS = np.array([5, 0, 12, 1, 3, 8, 16, 0, 1])


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _group_aligned(bits: np.ndarray, row_map: np.ndarray) -> np.ndarray:
    """The (t_padded, W) layout of ``row_map``: real rows in place, zero
    padding rows."""
    out = np.zeros((len(row_map), bits.shape[1]), dtype=np.uint32)
    real = row_map >= 0
    out[real] = bits[row_map[real]]
    return out


def _rows(t: int, w: int, seed: int) -> np.ndarray:
    """Random rows with an all-ones row (every sign bit set), an empty row
    and two duplicates."""
    bits = np.random.default_rng(seed).integers(0, 2**32, size=(t, w), dtype=np.uint32)
    bits[0] = 0xFFFFFFFF
    bits[1] = 0
    bits[3] = bits[2]
    return bits


def _pairwise(bits: np.ndarray, sizes) -> dict:
    """(i, j) -> |R_i ∩ R_j| for every within-group pair, in numpy."""
    out, start = {}, 0
    for g in sizes:
        for i in range(start, start + g):
            for j in range(i + 1, start + g):
                out[(i, j)] = int(np.bitwise_count(bits[i] & bits[j]).sum())
        start += g
    return out


@pytest.mark.parametrize(
    "bm,W,bw",
    [(4, 128, 128), (8, 128, 128), (4, 256, 256), (1, 3, 3), (8, 5, 5), (2, 6, 3),
     (8, 64, 1024), (16, 33, 33), (3, 7, 7)],
)
def test_tiled_counts_match_reference(bm, W, bw):
    row_map, ti, tj = build_group_tiles(GROUPS, bm)
    bits = _rows(int(GROUPS.sum()), W, seed=bm * 1000 + W)
    pad = _group_aligned(bits, row_map)
    want = np.asarray(r_intersect_count_tiled(
        jnp.asarray(pad), jnp.asarray(ti), jnp.asarray(tj),
        block_rows=bm, block_words=bw, interpret=True))
    got = intersect_count_tiled(_t(pad), _t(ti), _t(tj), block_rows=bm, block_words=bw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(ti), bm, bm)
    assert np.array_equal(got.numpy(), want)
    pairs, counts = counts_from_tiles(got.numpy(), ti, tj, row_map, bm)
    assert {tuple(p): int(c) for p, c in zip(pairs.tolist(), counts)} == _pairwise(bits, GROUPS)


def test_value_errors_match_reference():
    bits = np.zeros((10, 128), np.uint32)  # 10 % 8 != 0
    idx = np.zeros(1, np.int32)
    with pytest.raises(ValueError):
        r_intersect_count_tiled(jnp.asarray(bits), jnp.asarray(idx), jnp.asarray(idx),
                                block_rows=8, interpret=True)
    with pytest.raises(ValueError):
        intersect_count_tiled(_t(bits), _t(idx), _t(idx), block_rows=8)
    bits = np.zeros((8, 1536), np.uint32)  # 1536 % 1024 != 0
    with pytest.raises(ValueError):
        r_intersect_count_tiled(jnp.asarray(bits), jnp.asarray(idx), jnp.asarray(idx),
                                block_rows=8, block_words=1024, interpret=True)
    with pytest.raises(ValueError):
        intersect_count_tiled(_t(bits), _t(idx), _t(idx), block_rows=8, block_words=1024)


def test_no_block_pairs_returns_empty_where_the_reference_raises():
    """T = 0: the reference's Pallas call raises a TypeError (its scalar
    prefetch slices an empty index array); the port returns an empty
    (0, bm, bm) result and launches nothing."""
    bits = np.zeros((8, 4), np.uint32)
    idx = np.zeros(0, np.int32)
    with pytest.raises(TypeError):
        r_intersect_count_tiled(jnp.asarray(bits), jnp.asarray(idx), jnp.asarray(idx),
                                block_rows=8, interpret=True)
    before = ttiled.LAUNCHES["intersect_count_tiled"]
    got = intersect_count_tiled(_t(bits), _t(idx), _t(idx), block_rows=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (0, 8, 8)
    assert ttiled.LAUNCHES["intersect_count_tiled"] == before


def test_out_of_range_blocks_give_zero_tiles():
    """A block index outside [0, t // bm) never reads outside ``bits``: its
    cross-matrix is zero, on the CPU path as in the kernel."""
    bits = _t(np.full((16, 5), 0xFFFFFFFF, np.uint32))
    ti = torch.tensor([0, 2, -1, 1, 0], dtype=torch.int32)
    tj = torch.tensor([1, 0, 0, 1, 7], dtype=torch.int32)
    got = intersect_count_tiled(bits, ti, tj, block_rows=8, block_words=5)
    assert torch.equal(got[[0, 3]], torch.full((2, 8, 8), 160, dtype=torch.int32))
    assert torch.equal(got[[1, 2, 4]], torch.zeros((3, 8, 8), dtype=torch.int32))


def test_plain_version_chunks_over_block_pairs(monkeypatch):
    """Chunks of one block pair give the same result as one chunk."""
    row_map, ti, tj = build_group_tiles(GROUPS, 4)
    pad = _t(_group_aligned(_rows(int(GROUPS.sum()), 9, seed=5), row_map))
    whole = intersect_count_tiled_ref(pad, _t(ti), _t(tj), 4)
    monkeypatch.setattr("repro_torch.kernels.intersect.ref._TILED_CHUNK_WORDS", 1)
    assert torch.equal(intersect_count_tiled_ref(pad, _t(ti), _t(tj), 4), whole)


def test_wrapper_refuses_bad_inputs():
    bits = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        intersect_count_tiled(bits.to(torch.int64), idx, idx)
    with pytest.raises(ValueError):
        intersect_count_tiled(bits, idx.to(torch.int64), idx)
    with pytest.raises(ValueError):
        intersect_count_tiled(bits, idx, idx[:1])
    with pytest.raises(ValueError):
        intersect_count_tiled(bits, idx, idx, block_rows=0)
    with pytest.raises(ValueError):
        intersect_count_tiled(bits, idx, idx.to("meta"))


@pytest.mark.parametrize("bm", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_helpers_match_reference(bm, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 3 * bm + 2, size=int(rng.integers(0, 40)))
    if seed == 0:
        sizes = np.concatenate([[0, 1], sizes, [0]])
    want = r_build_group_tiles(sizes, bm)
    got = build_group_tiles(sizes, bm)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    row_map, ti, tj = want
    cnt = rng.integers(0, 1000, size=(len(ti), bm, bm)).astype(np.int32)
    for w, g in zip(r_counts_from_tiles(cnt, ti, tj, row_map, bm),
                    counts_from_tiles(cnt, ti, tj, row_map, bm)):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def test_traffic_reduction_formula():
    """Tile traffic beats pairwise traffic roughly by bm/2 for large groups."""
    bm, g = 8, 64
    _, ti, _ = build_group_tiles(np.array([g] * 16), bm)
    pairwise = 2 * 16 * g * (g - 1) // 2
    tiled = 2 * len(ti) * bm
    assert pairwise / tiled > bm / 2 * 0.85


def test_level3_frontier_path():
    """A mined level-3 frontier (the state ``on_level_end`` hands over before
    level 4): the tiled counts of its within-group pairs equal the pairwise
    count kernel's CPU path, the reference's tiled kernel and numpy, and the
    pairs are the level-4 candidates."""
    D = poker_like(n=3000, seed=0)[:, :6]
    cfg = KyivConfig(tau=1, kmax=4, engine="torch", device="cpu")
    states = {}
    res = mine_preprocessed(prepare(D, cfg), cfg,
                            on_level_end=lambda k, st: states.setdefault(st.next_k, st.level))
    level = states[4]
    sizes = prefix_group_sizes(level.itemsets)
    bm = 8
    row_map, ti, tj = build_group_tiles(sizes, bm)
    pad = _group_aligned(level.bits, row_map)
    w = pad.shape[1]
    cnt = intersect_count_tiled(_t(pad), _t(ti), _t(tj), block_rows=bm, block_words=w)
    pairs, counts = counts_from_tiles(cnt.numpy(), ti, tj, row_map, bm)

    assert len(pairs) == int((sizes * (sizes - 1) // 2).sum())
    assert len(pairs) == next(s.candidates for s in res.stats if s.k == 4)
    pairwise = intersect_count_indexed(_t(level.bits), _t(pairs.astype(np.int32)))
    assert np.array_equal(pairwise.numpy().astype(np.int64), counts)
    want = np.asarray(r_intersect_count_tiled(
        jnp.asarray(pad), jnp.asarray(ti), jnp.asarray(tj),
        block_rows=bm, block_words=w, interpret=True))
    assert np.array_equal(cnt.numpy(), want)
    assert counts.tolist() == [
        int(np.bitwise_count(level.bits[i] & level.bits[j]).sum()) for i, j in pairs
    ]
