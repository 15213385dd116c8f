"""Launchers of the CRC-32 kernels (``csrc/crc32.cu``) and of the library's
device-to-host row copy, which the job checkpoint streams a level through.

A tensor's bytes are handled as :func:`rows_view` gives them: a 2-D uint8
view ``[rows, row_bytes]`` whose rows lie ``pitch`` bytes apart, so a
padded word matrix viewed as its first ``n_words`` words is read in place,
its padding skipped. The kernels run on CUDA tensors only; their plain
version is ``zlib.crc32`` of the same bytes on the host.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["LAUNCHES", "copy_rows", "crc32", "crc32_launch", "reset_launches", "rows_view"]

# launches of each kernel in this process
LAUNCHES: dict[str, int] = {"crc32_blocks": 0, "crc32_finish": 0}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("crc32")
    if lib.crc32_rows.argtypes is None:
        lib.crc32_max_blocks.argtypes = []
        lib.crc32_max_blocks.restype = _INT
        lib.crc32_rows.argtypes = [_VP, _LL, _LL, _LL, _VP, _VP, _VP]
        lib.crc32_rows.restype = _INT
        lib.crc32_copy_rows.argtypes = [_VP, _VP, _LL, _LL, _LL, _VP]
        lib.crc32_copy_rows.restype = _INT
        lib.crc32_error_string.argtypes = [_INT]
        lib.crc32_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: launch failed: {lib.crc32_error_string(err).decode()}")


def rows_view(t: torch.Tensor) -> torch.Tensor:
    """The row-major bytes of ``t`` as a 2-D uint8 view ``[rows,
    row_bytes]`` with a unit inner stride: a contiguous tensor as one row, a
    2-D tensor with contiguous rows (a padded matrix's leading columns) row
    by row, in place. Any other layout is made contiguous first (a copy on
    its device)."""
    if t.dim() != 2 or t.stride(1) != 1 or t.is_contiguous():
        t = t.contiguous().reshape(1, -1)
    if t.numel() == 0:
        return torch.empty((0, 0), dtype=torch.uint8, device=t.device)
    return t.view(torch.uint8)


def _pitch(u8: torch.Tensor) -> int:
    return u8.stride(0) if u8.shape[0] > 1 else u8.shape[1]


def crc32_launch(u8: torch.Tensor) -> torch.Tensor:
    """Queue the CRC-32 of a CUDA :func:`rows_view` on the current stream;
    returns the 1-element int32 device tensor it lands in (its low 32 bits,
    as a uint32, are the CRC)."""
    if u8.device.type != "cuda" or u8.dtype != torch.uint8 or u8.dim() != 2:
        raise ValueError(f"crc32_launch: a 2-D uint8 CUDA tensor, not {u8.dtype} {tuple(u8.shape)} "
                         f"on {u8.device}")
    if u8.numel() and u8.stride(1) != 1:
        raise ValueError("crc32_launch: rows must be contiguous")
    lib = _lib()
    with torch.cuda.device(u8.device):
        scratch = torch.empty(lib.crc32_max_blocks() + 1, dtype=torch.int32, device=u8.device)
        out = scratch[-1:]
        rows, width = u8.shape
        err = lib.crc32_rows(u8.data_ptr() if u8.numel() else None, rows, width, _pitch(u8),
                             scratch.data_ptr(), out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "crc32_rows")
    if u8.numel():
        LAUNCHES["crc32_blocks"] += 1
        LAUNCHES["crc32_finish"] += 1
    return out


def crc32(t: torch.Tensor) -> int:
    """zlib's CRC-32 of the row-major bytes of a CUDA tensor ``t``, by the
    kernels (waiting for them)."""
    return int(crc32_launch(rows_view(t)).item()) & 0xFFFFFFFF


def copy_rows(dst: torch.Tensor, u8: torch.Tensor, row0: int, rows: int, col0: int, width: int,
              stream: torch.cuda.Stream) -> None:
    """Queue on ``stream`` the copy of ``rows`` rows of ``u8`` (a CUDA
    :func:`rows_view`) from row ``row0``, bytes ``col0`` to ``col0 +
    width`` of each, into the pinned host uint8 tensor ``dst``, back to
    back."""
    lib = _lib()
    src = u8.data_ptr() + row0 * _pitch(u8) + col0
    with torch.cuda.device(u8.device):
        err = lib.crc32_copy_rows(dst.data_ptr(), src, rows, width, _pitch(u8), stream.cuda_stream)
    _raise_on(lib, err, "crc32_copy_rows")
