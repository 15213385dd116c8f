"""The CUDA group-tiled count kernel on a card: bit for bit against its plain
PyTorch version over block sizes, widths (128-bit and 32-bit loads, one
tile of wide rows), group layouts and out-of-range block indices, and on a mined
level-3 frontier against the pairwise count kernel. Marked ``gpu``; every
test skips where torch sees no CUDA card (run them there with
``python -m pytest -m gpu tests/test_torch_gpu_tiled.py``)."""

import numpy as np
import pytest
import torch

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
from repro_torch.kernels.intersect.tiled import LAUNCHES

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _case(sizes, bm, w, seed, device):
    """Group-aligned random rows (an all-ones row, an empty row, duplicates)
    and the block pairs of ``sizes``."""
    row_map, ti, tj = build_group_tiles(np.asarray(sizes), bm)
    rng = np.random.default_rng(seed)
    t = int(np.sum(sizes))
    bits = rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
    if t >= 4:
        bits[0], bits[1], bits[3] = 0xFFFFFFFF, 0, bits[2]
    pad = np.zeros((len(row_map), w), dtype=np.uint32)
    pad[row_map >= 0] = bits[row_map[row_map >= 0]]
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return as_dev(pad.view(np.int32)), as_dev(ti), as_dev(tj)


@pytest.mark.parametrize("bm", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("w", [1, 5, 33, 3128])
@pytest.mark.parametrize("layout", ["edge", "many"])
def test_kernel_matches_plain_version(cuda, bm, w, layout):
    rng = np.random.default_rng(bm * 7 + w)
    sizes = ([0, 1, 2, bm, bm + 1, 0, 3 * bm - 1] if layout == "edge"
             else rng.integers(0, 3 * bm + 2, size=40 if w > 33 else 400))
    bits, ti, tj = _case(sizes, bm, w, seed=w, device=cuda)
    got = intersect_count_tiled(bits, ti, tj, block_rows=bm, block_words=w)
    want = intersect_count_tiled_ref(bits, ti, tj, bm)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bm", [1, 3, 8, 16])
def test_one_tile_of_wide_rows(cuda, bm):
    """T = 1 at the Poker-hand width: one CTA per sub-block walks all the
    words."""
    bits, ti, tj = _case([bm], bm, 31_252, seed=bm, device=cuda)
    got = intersect_count_tiled(bits, ti, tj, block_rows=bm, block_words=31_252)
    assert torch.equal(got, intersect_count_tiled_ref(bits, ti, tj, bm))


@pytest.mark.parametrize("bm", [2, 5, 8, 16])
@pytest.mark.parametrize("w", [4, 12, 16, 20, 36, 31252])
def test_partial_word_chunks_on_the_128_bit_path(cuda, bm, w):
    """W a multiple of 4 but not of 16: the last 16-word chunk is partly
    past the row and loads zero words there."""
    bits, ti, tj = _case([bm + 3, 2 * bm, 1, 3 * bm - 1], bm, w, seed=w + bm, device=cuda)
    got = intersect_count_tiled(bits, ti, tj, block_rows=bm, block_words=w)
    assert torch.equal(got, intersect_count_tiled_ref(bits, ti, tj, bm))


def test_unaligned_rows_take_the_32_bit_path(cuda):
    """W % 4 == 0 on storage that is not 16-byte aligned."""
    bits, ti, tj = _case([5, 9, 16], 4, 64, seed=3, device=cuda)
    flat = torch.zeros(bits.numel() + 1, dtype=torch.int32, device=cuda)
    flat[1:] = bits.reshape(-1)
    shifted = flat[1:].view(bits.shape)
    assert shifted.data_ptr() % 16 != 0
    got = intersect_count_tiled(shifted, ti, tj, block_rows=4, block_words=64)
    assert torch.equal(got, intersect_count_tiled_ref(bits, ti, tj, 4))


def test_out_of_range_blocks_give_zero_tiles(cuda):
    bits, _, _ = _case([16], 8, 40, seed=4, device=cuda)
    ti = torch.tensor([0, 2, -1, 1, 0, 1 << 30], dtype=torch.int32, device=cuda)
    tj = torch.tensor([1, 0, 0, 1, 7, 0], dtype=torch.int32, device=cuda)
    got = intersect_count_tiled(bits, ti, tj, block_rows=8, block_words=40)
    want = intersect_count_tiled_ref(bits, ti, tj, 8)
    assert torch.equal(got, want)
    assert not got[[1, 2, 4, 5]].any()


def test_launch_counts(cuda):
    bits, ti, tj = _case([9, 3], 4, 12, seed=5, device=cuda)
    before = LAUNCHES["intersect_count_tiled"]
    intersect_count_tiled(bits, ti, tj, block_rows=4, block_words=12)
    empty = intersect_count_tiled(bits, ti[:0], tj[:0], block_rows=4, block_words=12)
    assert LAUNCHES["intersect_count_tiled"] == before + 1
    assert tuple(empty.shape) == (0, 4, 4)
    with pytest.raises(ValueError):
        intersect_count_tiled(bits, ti.cpu(), tj, block_rows=4, block_words=12)


def test_level3_frontier_against_the_pairwise_kernel(cuda):
    D = poker_like(n=20_000, seed=0)
    cfg = KyivConfig(tau=1, kmax=4, device=str(cuda))
    states = {}
    res = mine_preprocessed(prepare(D, cfg), cfg,
                            on_level_end=lambda k, st: states.setdefault(st.next_k, st.level))
    level = states[4]
    sizes = prefix_group_sizes(level.itemsets)
    row_map, ti, tj = build_group_tiles(sizes, 8)
    pad = np.zeros((len(row_map), level.bits.shape[1]), dtype=np.uint32)
    pad[row_map >= 0] = level.bits[row_map[row_map >= 0]]
    bits = torch.from_numpy(pad.view(np.int32)).to(cuda)
    cnt = intersect_count_tiled(bits, torch.from_numpy(ti).to(cuda), torch.from_numpy(tj).to(cuda),
                                block_rows=8, block_words=bits.shape[1])
    pairs, counts = counts_from_tiles(cnt.cpu().numpy(), ti, tj, row_map, 8)
    assert len(pairs) == next(s.candidates for s in res.stats if s.k == 4)
    rows = torch.from_numpy(np.ascontiguousarray(level.bits).view(np.int32)).to(cuda)
    pairwise = intersect_count_indexed(rows, torch.from_numpy(pairs.astype(np.int32)).to(cuda))
    assert np.array_equal(pairwise.cpu().numpy().astype(np.int64), counts)
