"""The item table built on one torch device: the launchers of the CUDA
kernels (``csrc/itemize.cu``) and the pass around them.

:func:`itemize_on_device` gives the :class:`~repro_torch.core.items.ItemTable`
of an integer table, equal field for field to the host's
``core.items._itemize``: items column-major, values ascending, with the
same ``value``, ``col``, ``freq``, ``min_row`` and ``bits``. One pass, with
three reads back to the host whatever the table's width:

1. the table goes up once as it is (unsigned 16- and 32-bit values as the
   signed words of their width, made int64 on the device);
2. one reduction gives every column's min and max (read back: 2m numbers).
   A column whose range holds at most ``n`` values is *dense*, any other
   *sorted*;
3. dense columns: the presence kernel marks their values in a slot table,
   and its exclusive scan numbers them; sorted columns: a sort of each
   column ranks its values. Each column's item count is read back (m
   numbers);
4. the bitset kernel writes every (item, word) once and the stats kernel
   reduces each item's words to ``freq`` and ``min_row``; ``value`` is the
   table's cell at ``(min_row, col)``;
5. bits, ``freq``, ``min_row`` and ``value`` sit in one device buffer, read
   back in one copy.

On engine ``cuda`` on a CUDA device the kernels run; otherwise their plain
PyTorch versions (``ref.py``) do, on the table's device. Every step but the
three reads only launches device work, and nothing allocated here outlives
the call.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np
import torch

from ...core.items import WORD_BITS, ItemTable, device_dtype
from .. import _build
from .ref import BASE, LO, OFF, SPAN, SROW, bits_stats_ref, presence_ref

__all__ = ["LAUNCHES", "itemize_on_device", "reset_launches"]

# launches of each kernel in this process
LAUNCHES: dict[str, int] = {"itemize_presence": 0, "itemize_bits": 0, "itemize_stats": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# bytes of table rows staged in pinned memory per host-to-device copy
_STAGE_BYTES = 8 << 20

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("itemize")
    if lib.itemize_presence.argtypes is None:
        lib.itemize_presence.argtypes = [_VP, _LL, _LL, _VP, _VP, _LL, _VP]
        lib.itemize_presence.restype = _INT
        lib.itemize_bits.argtypes = [_VP, _LL, _LL, _LL, _VP, _VP, _VP, _VP, _LL, _VP, _VP, _VP]
        lib.itemize_bits.restype = _INT
        lib.itemize_error_string.argtypes = [_INT]
        lib.itemize_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: launch failed: {lib.itemize_error_string(err).decode()}")


def _upload(dataset: np.ndarray, device: torch.device) -> tuple[torch.Tensor, int]:
    """The (n, m) table as contiguous int64 on ``device``, and the bytes sent.

    To a CUDA device the rows go through pinned staging, a block of about
    ``_STAGE_BYTES`` at a time: the host's copy of a block into pinned memory
    overlaps the DMA of the one before, where a copy from pageable memory
    runs at a third of the speed (16.7 ms against 5.3 ms for the Poker-hand
    table's 82 MB on the H100's host). Each stage returns to torch's pinned
    cache, which reuses it only once its copy is done."""
    a = np.ascontiguousarray(dataset)
    size = a.dtype.itemsize
    unsigned = a.dtype.kind == "u" and size > 1  # torch has uint8, not uint16/32 ops
    if unsigned:
        a = a.view(np.dtype(f"i{size}"))
    with warnings.catch_warnings():  # a read-only array: the tensor is only read
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(a)
    if device.type == "cuda":
        table = torch.empty(host.shape, dtype=host.dtype, device=device)
        rows = max(1, _STAGE_BYTES // host[0].nbytes)
        for lo in range(0, host.shape[0], rows):
            part = host[lo : lo + rows]
            stage = torch.empty(part.shape, dtype=part.dtype, pin_memory=True).copy_(part)
            table[lo : lo + rows].copy_(stage, non_blocking=True)
    else:
        table = host.to(device)
    if table.dtype != torch.int64:
        table = table.to(torch.int64)
        if unsigned:
            table &= (1 << (8 * size)) - 1
    return table, host.nbytes


def _plan(lo: np.ndarray, hi: np.ndarray, n: int) -> tuple[np.ndarray, int]:
    """The per-column parameters ``(m, 5)`` int64 (``ref.LO`` ...) with
    ``BASE`` still 0, and the dense slot count: a column whose range holds
    at most ``n`` values is dense, so its slots are no more than its rows."""
    m = lo.shape[0]
    plan = np.zeros((m, 5), dtype=np.int64)
    plan[:, LO] = lo
    slots = sorted_cols = 0
    for j in range(m):
        span = int(hi[j]) - int(lo[j]) + 1  # Python ints: any int64 pair
        if span <= n:
            plan[j, OFF], plan[j, SPAN], plan[j, SROW] = slots, span, -1
            slots += span
        else:
            plan[j, SROW] = sorted_cols
            sorted_cols += 1
    plan[plan[:, SROW] >= 0, OFF] = slots  # an empty stretch at the slot table's end
    return plan, slots


def _sorted_ids(column: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Write each cell's id within its column (the rank of its value among
    the column's distinct values) into ``out``; return the column's item
    count as a 1-element device tensor."""
    values, order = torch.sort(column)
    new = torch.ones_like(values, dtype=torch.bool)
    torch.ne(values[1:], values[:-1], out=new[1:])
    rank = torch.cumsum(new, 0) - 1
    out.scatter_(0, order, rank)
    return rank[-1:] + 1


def _presence(table, plan, params, present, kernel: bool) -> None:
    if not kernel:
        presence_ref(table, plan, present)
        return
    lib = _lib()
    n, m = table.shape
    with torch.cuda.device(table.device):
        err = lib.itemize_presence(table.data_ptr(), n, m, params.data_ptr(), present.data_ptr(),
                                   present.numel(), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "itemize_presence")
    LAUNCHES["itemize_presence"] += 1


def _bits_stats(table, plan, params, ex, sorted_ids, bits, freq, min_row, kernel: bool) -> None:
    if not kernel:
        bits_stats_ref(table, plan, ex, sorted_ids, bits, freq, min_row)
        return
    lib = _lib()
    n, m = table.shape
    n_items, w = bits.shape
    with torch.cuda.device(table.device):
        err = lib.itemize_bits(
            table.data_ptr(), n, m, w, params.data_ptr(), ex.data_ptr(),
            sorted_ids.data_ptr() if sorted_ids.numel() else None, bits.data_ptr(), n_items,
            freq.data_ptr(), min_row.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "itemize_bits")
    LAUNCHES["itemize_bits"] += 1
    LAUNCHES["itemize_stats"] += 1


def itemize_on_device(dataset: np.ndarray, device, engine: str) -> tuple[ItemTable, dict]:
    """The item table of a non-empty (n, m) table whose dtype passes
    :func:`~repro_torch.core.items.device_dtype`, built on ``device``; and the ``itemize`` span's
    attributes: ``path`` (``"cuda"`` where the kernels ran, else
    ``"torch"``), ``dense_cols``, ``sorted_cols`` and ``bytes_up``."""
    n, m = dataset.shape
    if n == 0 or m == 0 or not device_dtype(dataset.dtype):
        raise ValueError(f"no device itemize for a {dataset.dtype} table of shape {dataset.shape}")
    device = torch.device(device)
    kernel = engine == "cuda" and device.type == "cuda"
    n_words = (n + WORD_BITS - 1) // WORD_BITS
    table, bytes_up = _upload(dataset, device)

    lo, hi = torch.aminmax(table, dim=0)
    lo_hi = torch.stack((lo, hi)).cpu().numpy()  # read 1: the ranges
    plan, slots = _plan(lo_hi[0], lo_hi[1], n)
    params = torch.from_numpy(plan).to(device, non_blocking=True, copy=True)
    bytes_up += plan.nbytes
    sorted_cols = np.flatnonzero(plan[:, SROW] >= 0)

    present = torch.empty(slots, dtype=torch.uint8, device=device)
    if slots:
        _presence(table, plan, params, present, kernel)
    ex = torch.zeros(slots + 1, dtype=torch.int64, device=device)
    torch.cumsum(present, 0, dtype=torch.int64, out=ex[1:])
    del present
    counts = ex[params[:, OFF] + params[:, SPAN]] - ex[params[:, OFF]]
    sorted_ids = torch.empty((len(sorted_cols), n), dtype=torch.int64, device=device)
    for row, j in enumerate(sorted_cols):
        counts[j : j + 1] += _sorted_ids(table[:, j], sorted_ids[row])
    host_counts = counts.cpu().numpy()  # read 2: the item count of each column
    n_items = int(host_counts.sum())
    plan[:, BASE] = np.cumsum(host_counts) - host_counts
    params[:, BASE] = torch.cumsum(counts, 0) - counts

    # one buffer: freq, min_row, value (int64 each), then the bits' int32 words
    buf = torch.empty(3 * n_items + (n_items * n_words + 1) // 2, dtype=torch.int64, device=device)
    freq, min_row, value = buf[: 3 * n_items].view(3, n_items)
    bits = buf[3 * n_items :].view(torch.int32)[: n_items * n_words].view(n_items, n_words)
    _bits_stats(table, plan, params, ex, sorted_ids, bits, freq, min_row, kernel)
    col = torch.repeat_interleave(torch.arange(m, device=device), counts, output_size=n_items)
    torch.take(table, min_row * m + col, out=value)
    host = buf.cpu().numpy()  # read 3: the item table

    item_table = ItemTable(
        n_rows=n,
        n_cols=m,
        n_words=n_words,
        # the small arrays are copies: a caller that keeps one keeps no bits
        value=host[2 * n_items : 3 * n_items].copy(),
        col=np.repeat(np.arange(m, dtype=np.int64), host_counts),
        freq=host[:n_items].copy(),
        min_row=host[n_items : 2 * n_items].copy(),
        bits=host[3 * n_items :].view(np.uint32)[: n_items * n_words].reshape(n_items, n_words),
    )
    attrs = {
        "path": "cuda" if kernel else "torch",
        "dense_cols": m - len(sorted_cols),
        "sorted_cols": len(sorted_cols),
        "bytes_up": bytes_up,
    }
    return item_table, attrs
