"""Group-tiled count: the ``k = kmax`` count over a level's within-group
candidate pairs, one block pair of parent rows at a time.

The candidate pairs of a level are exactly the pairs inside its prefix
groups, so they tile into ``(bm x bm)`` block pairs of parent rows. Each
block pair loads its two row blocks once and gives the whole ``bm x bm``
popcount cross-matrix, so a row is read about ``bm/2`` times less often
than when every pair fetches its two rows. The operations are unchanged:
each pair's AND and popcount happens once.

Layout: the caller supplies a *group-aligned* parent matrix, each prefix
group zero-padded to a multiple of ``bm`` rows (:func:`build_group_tiles`),
and maps the cross-matrices back to ``(pair, count)`` with
:func:`counts_from_tiles`, which drops padding rows and the lower triangle.

:func:`intersect_count_tiled` wraps the hand-written CUDA kernel
(``csrc/tiled.cu``) that replaces the Pallas ``intersect_count_tiled``. On
its inputs:

* all tensors on the CPU: the plain PyTorch version
  (``ref.intersect_count_tiled_ref``) computes the result — the path the
  CPU tests take;
* all tensors on one CUDA device: the kernel launches on the current stream
  (no synchronisation) into an output allocated here, and its launch count
  goes up by one. ``T = 0`` block pairs launch nothing and give an empty
  ``(0, bm, bm)`` result.

Anything else raises: there is no fallback from the kernel to the plain
version, and a build or launch failure is an error. A block index outside
``[0, t // bm)`` gives a zero matrix on both paths (no read outside
``bits``, no synchronisation to check the indices).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import ref as _ref
from .intersect import _on_cuda

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "intersect_count_tiled",
    "build_group_tiles",
    "counts_from_tiles",
]

# launches of the kernel since the last reset_launches()
LAUNCHES: dict[str, int] = {"intersect_count_tiled": 0}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("tiled")
    if lib.tiled_count.argtypes is None:
        lib.tiled_count.argtypes = [_VP, _LL, _LL, _INT, _VP, _VP, _LL, _INT, _VP, _VP]
        lib.tiled_count.restype = _INT
        lib.tiled_error_string.argtypes = [_INT]
        lib.tiled_error_string.restype = ctypes.c_char_p
    return lib


def _check(bits: torch.Tensor, tile_i: torch.Tensor, tile_j: torch.Tensor,
           bm: int, block_words: int) -> None:
    if bits.dtype != torch.int32 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(
            f"bits must be a contiguous (t, W) int32 tensor, got {bits.dtype} {tuple(bits.shape)}"
        )
    for name, x in (("tile_i", tile_i), ("tile_j", tile_j)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous (T,) int32 tensor, got {x.dtype} {tuple(x.shape)}"
            )
    if tile_i.shape != tile_j.shape:
        raise ValueError(f"tile_i and tile_j differ in shape: {tuple(tile_i.shape)}, "
                         f"{tuple(tile_j.shape)}")
    if tile_i.shape[0] >= 2**31:
        raise ValueError(f"at most 2**31 - 1 block pairs per launch, got {tile_i.shape[0]}")
    if not 1 <= bm <= 8 * 255:  # the kernel's 8 x 8 sub-blocks index gridDim.y
        raise ValueError(f"block_rows must be in [1, 2040], got {bm}")
    if block_words < 1:
        raise ValueError(f"block_words must be >= 1, got {block_words}")
    # the reference's layout contract, kept though the kernel walks every
    # word of a block pair itself and does not tile the word axis
    t, w = bits.shape
    if t % bm:
        raise ValueError(f"t={t} not group-aligned to block_rows={bm}")
    bw = min(block_words, w)
    if bw == 0 or w % bw:
        raise ValueError(f"W={w} not divisible by block_words={bw}")


def intersect_count_tiled(
    bits: torch.Tensor,
    tile_i: torch.Tensor,
    tile_j: torch.Tensor,
    *,
    block_rows: int = 8,
    block_words: int = 1024,
) -> torch.Tensor:
    """Popcount cross-matrices for block pairs of parent rows — replaces the
    Pallas ``intersect_count_tiled``.

    bits: (t, W) int32 words, ``t % block_rows == 0`` (group-aligned,
    zero-padded). tile_i / tile_j: (T,) int32 *block* indices (block r
    covers rows ``[r*bm, (r+1)*bm)``). Returns (T, bm, bm) int32:
    ``out[s, a, b] = |rows(tile_i[s]*bm + a) ∩ rows(tile_j[s]*bm + b)|``.
    ``W % min(block_words, W)`` must be 0, as in the reference: the check is
    kept so that a caller sees one contract in both packages, though the
    kernel walks every word of a block pair itself and ignores
    ``block_words``."""
    bm = int(block_rows)
    _check(bits, tile_i, tile_j, bm, int(block_words))
    if not _on_cuda(bits, tile_i, tile_j):
        return _ref.intersect_count_tiled_ref(bits, tile_i, tile_j, bm)
    (t, w), n_tiles = bits.shape, tile_i.shape[0]
    out = torch.empty((n_tiles, bm, bm), dtype=torch.int32, device=bits.device)
    if n_tiles == 0:
        return out
    vec4 = w % 4 == 0 and bits.data_ptr() % 16 == 0
    lib = _lib()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tiled_count(
            bits.data_ptr(), t, w, bm, tile_i.data_ptr(), tile_j.data_ptr(), n_tiles,
            int(vec4), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"intersect_count_tiled: launch failed: {lib.tiled_error_string(err).decode()}")
    LAUNCHES["intersect_count_tiled"] += 1
    return out


def build_group_tiles(group_sizes: np.ndarray, bm: int = 8):
    """Group-aligned layout + tile list for a level's prefix groups.

    Returns:
      row_map: (t_padded,) int64 original row index per padded row (-1 =
        padding); each group starts on a block boundary
      tile_i, tile_j: (T,) int32 block indices, the upper-triangular block
        pairs of every group in group order
    """
    sizes = np.asarray(group_sizes, dtype=np.int64).reshape(-1)
    n_blocks = -(-sizes // bm)
    first_block = np.cumsum(n_blocks) - n_blocks
    row_map = np.full(int(n_blocks.sum()) * bm, -1, dtype=np.int64)
    # row r of group g lands at g's first padded row + (r - g's first row)
    shift = np.repeat(first_block * bm - (np.cumsum(sizes) - sizes), sizes)
    rows = np.arange(int(sizes.sum()), dtype=np.int64)
    row_map[rows + shift] = rows
    tiles_i, tiles_j = [np.zeros(0, dtype=np.int64)], [np.zeros(0, dtype=np.int64)]
    for start, nb in zip(first_block.tolist(), n_blocks.tolist()):
        a, b = np.triu_indices(nb)
        tiles_i.append(start + a)
        tiles_j.append(start + b)
    return (
        row_map,
        np.concatenate(tiles_i).astype(np.int32),
        np.concatenate(tiles_j).astype(np.int32),
    )


def counts_from_tiles(
    cnt_tiles: np.ndarray,
    tile_i: np.ndarray,
    tile_j: np.ndarray,
    row_map: np.ndarray,
    bm: int = 8,
):
    """Flatten tile cross-matrices back to (pair -> count) for the valid
    within-group pairs (i < j, both real rows), in tile, then row, then
    column order. Returns (pairs (M, 2) int64 original row ids, counts (M,)
    int64)."""
    cnt_tiles = np.asarray(cnt_tiles)
    row_map = np.asarray(row_map)
    n = cnt_tiles.shape[0]
    offs = np.arange(bm, dtype=np.int64)
    ra = row_map[np.asarray(tile_i[:n], dtype=np.int64)[:, None] * bm + offs]  # (T, bm)
    rb = row_map[np.asarray(tile_j[:n], dtype=np.int64)[:, None] * bm + offs]
    ra3, rb3 = np.broadcast_arrays(ra[:, :, None], rb[:, None, :])
    keep = (ra3 >= 0) & (rb3 > ra3)  # both real rows, upper triangle
    pairs = np.stack([ra3[keep], rb3[keep]], axis=1).astype(np.int64)
    return pairs, cnt_tiles[keep].astype(np.int64)
