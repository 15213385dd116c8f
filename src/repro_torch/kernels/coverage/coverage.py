"""Wrappers of the hand-written CUDA coverage kernels (``csrc/coverage.cu``),
which replace the Pallas ``coverage_accumulate_indexed``: the scanning
kernel, which reads every word of every set, and the anchored kernel, which
walks only the nonzero words of each set's rarest member through a
:class:`~.index.CoverageIndex`. Both compute the same function; the
dispatch (``ops.build_coverage_dispatch``) picks one per batch.

Each takes ``(t, W)`` int32 bitset words, ``(M, K)`` int32 itemset indices
(short itemsets padded by repeating an item) and ``(M,)`` int32 weights
(0 on batch padding), and returns ``acc (32, W)`` int32. On its inputs:

* all tensors on the CPU: the plain PyTorch version (``ref.py``) computes
  the result — the path the CPU tests take;
* all tensors on one CUDA device: the kernel launches on the current stream
  (no synchronisation) into an output allocated here, and its launch count
  goes up by one. A batch of ``M = 0`` sets (or ``W = 0`` words)
  launches nothing and returns zeros.

Anything else raises: there is no fallback from the kernel to the plain
version, and a build or launch failure is an error.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..intersect.intersect import _on_cuda
from . import ref as _ref
from .index import CoverageIndex

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "coverage_accumulate_indexed",
    "coverage_accumulate_anchored",
]

# launches of each kernel since the last reset_launches()
LAUNCHES: dict[str, int] = {"coverage_accumulate_indexed": 0, "coverage_accumulate_anchored": 0}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("coverage")
    if lib.coverage_accumulate.argtypes is None:
        lib.coverage_accumulate.argtypes = [_VP, _LL, _LL, _VP, _LL, _INT, _VP, _VP, _VP]
        lib.coverage_accumulate.restype = _INT
        lib.coverage_anchored.argtypes = [_VP, _LL, _LL, _VP, _VP, _VP, _LL, _INT, _VP, _VP, _LL, _VP]
        lib.coverage_anchored.restype = _INT
        lib.coverage_error_string.argtypes = [_INT]
        lib.coverage_error_string.restype = ctypes.c_char_p
    return lib


def _check(bits: torch.Tensor, sets: torch.Tensor, weights: torch.Tensor) -> None:
    if bits.dtype != torch.int32 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(
            f"bits must be a contiguous (t, W) int32 tensor, got {bits.dtype} {tuple(bits.shape)}"
        )
    if (sets.dtype != torch.int32 or sets.dim() != 2 or sets.shape[1] < 1
            or not sets.is_contiguous()):
        raise ValueError(
            f"sets must be a contiguous (M, K >= 1) int32 tensor, got {sets.dtype} {tuple(sets.shape)}"
        )
    if (weights.dtype != torch.int32 or tuple(weights.shape) != (sets.shape[0],)
            or not weights.is_contiguous()):
        raise ValueError(
            f"weights must be a contiguous ({sets.shape[0]},) int32 tensor, "
            f"got {weights.dtype} {tuple(weights.shape)}"
        )
    if sets.shape[1] >= 2**31:
        raise ValueError(f"at most 2**31 - 1 items per set, got {sets.shape[1]}")


def coverage_accumulate_indexed(
    bits: torch.Tensor, sets: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """acc (32, W) int32: ``acc[b, w] = sum_m weights[m] * bit b of
    (AND_k bits[sets[m, k]])[w]``, wrapping on int32 overflow — replaces the
    Pallas ``coverage_accumulate_indexed``."""
    _check(bits, sets, weights)
    if not _on_cuda(bits, sets, weights):
        return _ref.coverage_accumulate_ref(bits, sets, weights)
    (t, w), (m, k) = bits.shape, sets.shape
    acc = torch.empty((32, w), dtype=torch.int32, device=bits.device)
    if m == 0 or w == 0:
        return acc.zero_()
    lib = _lib()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coverage_accumulate(
            bits.data_ptr(), t, w, sets.data_ptr(), m, k, weights.data_ptr(), acc.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"coverage_accumulate_indexed: launch failed: {lib.coverage_error_string(err).decode()}"
        )
    LAUNCHES["coverage_accumulate_indexed"] += 1
    return acc


def _check_index(bits: torch.Tensor, index: CoverageIndex) -> None:
    offsets, words = index.offsets, index.words
    if (offsets.dtype != torch.int64 or tuple(offsets.shape) != (bits.shape[0] + 1,)
            or not offsets.is_contiguous()):
        raise ValueError(
            f"index offsets must be a contiguous ({bits.shape[0] + 1},) int64 tensor, "
            f"got {offsets.dtype} {tuple(offsets.shape)}"
        )
    if words.dtype != torch.int32 or words.dim() != 1 or not words.is_contiguous():
        raise ValueError(
            f"index words must be a contiguous 1-D int32 tensor, got {words.dtype} {tuple(words.shape)}"
        )


def coverage_accumulate_anchored(
    bits: torch.Tensor, index: CoverageIndex, sets: torch.Tensor, weights: torch.Tensor,
    max_anchor_words: int,
) -> torch.Tensor:
    """The same acc (32, W) int32 as :func:`coverage_accumulate_indexed`,
    walking only the nonzero words of each live set's anchor (its member
    with the fewest in ``index``, the index of ``bits``).

    ``max_anchor_words``, the most nonzero words of a live set's anchor
    (:func:`~.index.anchored_plan` reads it from the host counts), sizes
    the split of long anchor lists over warps; every value gives the same
    result."""
    _check(bits, sets, weights)
    _check_index(bits, index)
    if not _on_cuda(bits, sets, weights, index.offsets, index.words):
        return _ref.coverage_accumulate_anchored_ref(bits, index, sets, weights)
    (t, w), (m, k) = bits.shape, sets.shape
    acc = torch.empty((32, w), dtype=torch.int32, device=bits.device)
    if m == 0 or w == 0:
        return acc.zero_()
    lib = _lib()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coverage_anchored(
            bits.data_ptr(), t, w, index.offsets.data_ptr(), index.words.data_ptr(), sets.data_ptr(),
            m, k, weights.data_ptr(), acc.data_ptr(), max(1, int(max_anchor_words)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"coverage_accumulate_anchored: launch failed: {lib.coverage_error_string(err).decode()}"
        )
    LAUNCHES["coverage_accumulate_anchored"] += 1
    return acc
