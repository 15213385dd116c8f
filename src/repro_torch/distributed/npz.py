"""The checkpoint's ``arrays.npz``, written by hand: a stored (uncompressed)
ZIP64 archive of ``.npy`` members, as ``np.savez`` writes it, that
``np.load`` and ``zipfile`` read as they read one of ``np.savez``'s.

``np.savez`` goes through ``zipfile``'s writer, which CRCs every byte of a
member and copies it in 16 MB pieces. Here the caller hands the data's
CRC-32 over once it has it (taken in place on the host, or on the card
while the bytes stream down), and a member's zip CRC, that of its ``.npy``
header followed by its data, comes from the two by ``crc32_combine``,
without a second pass over the data. Each member's local header is written
with its sizes and the CRC left 0, the data after it with ``os.write``,
and the CRC put into the header in place once the member ends. Every
member carries the ZIP64 sizes (and the central directory the ZIP64
offset), at any size.

Also the GF(2) arithmetic of zlib's ``crc32_combine`` on Python ints: the
CRC-32 (zlib's, the reflected polynomial 0xEDB88320) of ``A || B`` is
``crc32(A)`` times ``x^(8 len(B))`` modulo the polynomial, XOR ``crc32(B)``.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import os
import struct
import zlib

import numpy as np
from numpy.lib import format as npy_format

__all__ = ["NpzWriter", "crc32_combine", "multmodp", "npy_header", "x8nmodp"]

_ZIP64 = 45  # version needed to extract: ZIP64
_DOS_DATE = (1 << 5) | 1  # 1980-01-01, 00:00
_MASK32 = 0xFFFFFFFF
_WRITE_MAX = 1 << 30  # bytes handed to one write(2)
_POLY = 0xEDB88320


def multmodp(a: int, b: int) -> int:
    """``a * b`` modulo the CRC-32 polynomial, bit-reflected (zlib's
    ``multmodp``)."""
    m, p = 1 << 31, 0
    while m:
        if a & m:
            p ^= b
        m >>= 1
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1
    return p


@functools.cache
def _x2n() -> tuple[int, ...]:
    """``x^(2^k)`` modulo the polynomial, k = 0 .. 31."""
    out, p = [], 1 << 30  # x^1
    for _ in range(32):
        out.append(p)
        p = multmodp(p, p)
    return tuple(out)


def x8nmodp(n: int) -> int:
    """``x^(8 n)`` modulo the polynomial (zlib's ``x2nmodp(n, 3)``)."""
    p, k = 1 << 31, 3
    while n:
        if n & 1:
            p = multmodp(_x2n()[k & 31], p)
        n >>= 1
        k += 1
    return p


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of ``A || B`` from ``crc1 = crc32(A)``, ``crc2 =
    crc32(B)`` and ``len2 = len(B)`` (zlib's ``crc32_combine``), without
    reading either."""
    return multmodp(x8nmodp(len2), crc1) ^ crc2


def npy_header(dtype: np.dtype, shape: tuple) -> bytes:
    """The ``.npy`` header ``np.save`` writes for a C-ordered array of this
    dtype and shape (format 1.0, or 2.0 where 1.0 cannot hold it)."""
    d = {"descr": npy_format.dtype_to_descr(np.dtype(dtype)), "fortran_order": False,
         "shape": tuple(int(s) for s in shape)}
    buf = io.BytesIO()
    try:
        npy_format.write_array_header_1_0(buf, d)
    except ValueError:
        buf = io.BytesIO()
        npy_format.write_array_header_2_0(buf, d)
    return buf.getvalue()


@dataclasses.dataclass
class _Member:
    name: bytes
    offset: int  # of the local header
    header_crc: int  # of the .npy header
    header_len: int
    nbytes: int  # of the data
    written: int = 0
    crc: int = 0  # the zip CRC: header and data


class NpzWriter:
    """Write an ``.npz`` at ``path`` member by member: :meth:`begin` a
    member (its key, dtype and shape), :meth:`write` its ``nbytes`` of data
    in row-major order, in as many pieces as the caller likes, :meth:`end`
    it with the data's CRC-32; :meth:`close` writes the central directory.
    A member of the wrong size raises."""

    def __init__(self, path: str):
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        self._offset = 0
        self._members: list[_Member] = []
        self._open: _Member | None = None

    def __enter__(self) -> "NpzWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            os.close(self._fd)

    def _put(self, data) -> None:
        view = _byte_view(data)
        while view.nbytes:
            n = os.write(self._fd, view[:_WRITE_MAX])
            view = view[n:]
            self._offset += n

    def begin(self, key: str, dtype: np.dtype, shape: tuple) -> None:
        if self._open is not None:
            raise RuntimeError(f"member {self._open.name!r} not ended")
        header = npy_header(dtype, shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        name = f"{key}.npy".encode()
        m = _Member(name, self._offset, zlib.crc32(header), len(header), nbytes)
        size = len(header) + nbytes
        self._put(struct.pack("<IHHHHHIIIHH", 0x04034B50, _ZIP64, _utf8(name), 0, 0, _DOS_DATE,
                              0, _MASK32, _MASK32, len(name), 20))
        self._put(name)
        self._put(struct.pack("<HHQQ", 0x0001, 16, size, size))
        self._put(header)
        self._open = m

    def write(self, data) -> None:
        """Append a piece of the open member's data (any buffer)."""
        m = self._open
        data = _byte_view(data)
        n = data.nbytes
        if m.written + n > m.nbytes:
            raise ValueError(f"{m.name!r}: {m.written + n} bytes written, the member holds {m.nbytes}")
        self._put(data)
        m.written += n

    def end(self, data_crc: int) -> None:
        """End the open member, whose data's CRC-32 is ``data_crc``."""
        m, self._open = self._open, None
        if m.written != m.nbytes:
            raise ValueError(f"{m.name!r}: {m.written} bytes written, the member holds {m.nbytes}")
        m.crc = crc32_combine(m.header_crc, data_crc & _MASK32, m.nbytes)
        os.pwrite(self._fd, struct.pack("<I", m.crc), m.offset + 14)
        self._members.append(m)

    def close(self) -> None:
        if self._open is not None:
            raise RuntimeError(f"member {self._open.name!r} not ended")
        start = self._offset
        for m in self._members:
            size = m.header_len + m.nbytes
            self._put(struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, _ZIP64, _ZIP64, _utf8(m.name),
                                  0, 0, _DOS_DATE, m.crc, _MASK32, _MASK32, len(m.name), 28, 0,
                                  0, 0, 0o600 << 16, _MASK32))
            self._put(m.name)
            self._put(struct.pack("<HHQQQ", 0x0001, 24, size, size, m.offset))
        end = self._offset
        count = len(self._members)
        self._put(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, _ZIP64, _ZIP64, 0, 0, count, count,
                              end - start, start))
        self._put(struct.pack("<IIQI", 0x07064B50, 0, end, 1))
        self._put(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(count, 0xFFFF),
                              min(count, 0xFFFF), _MASK32, _MASK32, 0))
        os.close(self._fd)


def _byte_view(data) -> memoryview:
    """A flat byte view of a C-contiguous buffer (a numpy array of any
    dtype, bytes)."""
    if isinstance(data, np.ndarray):
        data = data.reshape(-1).view(np.uint8)
    view = memoryview(data)
    return view if view.format == "B" and view.ndim == 1 else view.cast("B")


def _utf8(name: bytes) -> int:
    """The flag bit of a member name that is not plain ASCII."""
    return 0 if name.isascii() else 0x800
