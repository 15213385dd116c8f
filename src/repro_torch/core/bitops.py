"""Population counts of bitset words, on the host and in torch, and the
move of bitsets between the host and a torch device.

Bitsets are ``uint32`` words on the host (numpy) and ``torch.int32`` views of
the same words on a torch device: torch has no popcount op, and its ``>>`` on
``torch.uint32`` is not implemented on the CPU. ``>>`` on int32 is arithmetic
and smears the sign bit, so :func:`popcount32` masks after every shift, and it
counts bit 31 apart so that no intermediate sum overflows int32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "WORD_ALIGN",
    "device_bits",
    "host_bits",
    "padded_words",
    "popcount",
    "popcount32",
    "popcount_rows",
    "popcount_rows_torch",
]


def popcount(words: np.ndarray) -> np.ndarray:
    """Elementwise population count of an unsigned integer array."""
    return np.bitwise_count(words)


def popcount_rows(bits: np.ndarray) -> np.ndarray:
    """Per-row popcount of a (..., W) bitset matrix, summed over words (int64)."""
    return popcount(bits).sum(axis=-1).astype(np.int64)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 words (each read as 32 unsigned bits).

    SWAR on the low 31 bits, all intermediates non-negative; the sign bit is
    counted separately."""
    top = (x >> 31) & 1
    x = x & 0x7FFFFFFF
    x = (x & 0x55555555) + ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + ((x >> 4) & 0x0F0F0F0F)) & 0x0F0F0F0F
    x = x + ((x >> 8) & 0x00FF00FF)
    x = x + ((x >> 16) & 0x0000FFFF)
    return (x & 0x3F) + top


def popcount_rows_torch(bits: torch.Tensor) -> torch.Tensor:
    """(t, W) int32 bitset words -> (t,) int32 population counts."""
    return popcount32(bits).sum(dim=-1, dtype=torch.int32)


# Device rows are padded with zero words to a multiple of WORD_ALIGN so every
# row starts 16-byte aligned for the kernels' 128-bit loads. Zero words change
# no count, children inherit the padding, and the host view strips it.
WORD_ALIGN = 4


def padded_words(n_words: int) -> int:
    return -(-n_words // WORD_ALIGN) * WORD_ALIGN


def device_bits(bits: np.ndarray, device) -> torch.Tensor:
    """(t, W) uint32 host bitsets -> (t, padded W) int32 words on ``device``."""
    bits = np.asarray(bits, dtype=np.uint32)
    t, w = bits.shape
    out = np.zeros((t, padded_words(w)), dtype=np.uint32)
    out[:, :w] = bits
    return torch.from_numpy(out.view(np.int32)).to(device)


def host_bits(bits, n_words: int) -> np.ndarray:
    """Host uint32 view of device (or host) bitsets, word padding stripped."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy().view(np.uint32)
    return np.ascontiguousarray(bits[:, :n_words])
