"""The port's bit substrate: the int32 SWAR popcount and the host/device
bitset forms, against numpy's popcount. Integer ops: tolerance is zero."""

import numpy as np
import pytest
import torch

from repro.core.bitops import popcount_rows as ref_popcount_rows
from repro_torch.core.bitops import (
    WORD_ALIGN,
    device_bits,
    host_bits,
    padded_words,
    popcount32,
    popcount_rows,
    popcount_rows_torch,
)

EDGE = np.array([0xFFFFFFFF, 0x80000000, 0, 1, 0x7FFFFFFF, 0x80000001, 0xAAAAAAAA, 0x55555555],
                dtype=np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_swar_popcount_matches_numpy(seed):
    words = np.random.default_rng(seed).integers(0, 2**32, size=4096, dtype=np.uint32)
    words = np.concatenate([EDGE, words])
    got = popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    assert np.array_equal(got, np.bitwise_count(words).astype(got.dtype))


def test_swar_popcount_edge_words():
    got = popcount32(torch.from_numpy(EDGE.view(np.int32))).tolist()
    assert got == [32, 1, 0, 1, 31, 2, 16, 16]


@pytest.mark.parametrize("t,w", [(1, 1), (5, 3), (17, 130)])
def test_row_popcounts_agree(t, w):
    bits = np.random.default_rng(t * w).integers(0, 2**32, size=(t, w), dtype=np.uint32)
    bits[0] = 0xFFFFFFFF  # every sign bit set
    want = ref_popcount_rows(bits)
    assert np.array_equal(popcount_rows(bits), want)
    got = popcount_rows_torch(torch.from_numpy(bits.view(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [1, 3, 4, 5, 31250])
def test_device_bits_pad_and_strip(w):
    bits = np.random.default_rng(w).integers(0, 2**32, size=(3, w), dtype=np.uint32)
    dev = device_bits(bits, "cpu")
    assert dev.dtype == torch.int32
    assert dev.shape == (3, padded_words(w)) and dev.shape[1] % WORD_ALIGN == 0
    assert not dev[:, w:].any(), "padding words must be zero"
    back = host_bits(dev, w)
    assert back.dtype == np.uint32 and np.array_equal(back, bits)
    assert np.array_equal(host_bits(bits, w), bits)
