"""Wrappers of the hand-written CUDA intersection kernels
(``csrc/intersect.cu``), one per Pallas kernel they replace.

The *indexed* wrappers take ``(t, W)`` int32 bitset words, ``(M, 2)`` int32
pair indices and, for the classify variants, ``(t,)`` int32 parent
popcounts and an integer ``tau``. The *gathered* wrappers take the operand
rows already gathered, ``a`` and ``b`` of shape ``(M, W)`` int32, and for the
classify variants ``(M,)`` int32 ``minp = min(pc[i], pc[j])`` and ``tau``.
Every wrapper, on its inputs:

* all tensors on the CPU: the plain PyTorch version (``ref.py``) computes
  the result — the path the CPU tests take;
* all tensors on one CUDA device: the kernel launches on the current stream
  (no synchronisation) into outputs allocated here, and its launch count
  goes up by one. A batch of ``M = 0`` pairs launches nothing. Inside a
  :func:`timed_launches` block the launcher also records a CUDA event on the
  stream just before and just after the kernel (in C, so no host work falls
  between them and the launch), and its device time can be read once the
  stream has passed them.

The donating wrapper writes the child over ``a`` and returns ``a`` itself,
on either device.

Anything else raises: there is no fallback from the kernel to the plain
version, and a build or launch failure is an error.
"""

from __future__ import annotations

import contextvars
import ctypes
from contextlib import contextmanager

import torch

from .. import _build
from . import ref as _ref

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "timed_launches",
    "launch_seconds",
    "intersect_classify_write_indexed",
    "intersect_classify_count_indexed",
    "intersect_write_indexed",
    "intersect_count_indexed",
    "intersect_classify_write_gathered",
    "intersect_classify_write_gathered_donating",
    "intersect_classify_count_gathered",
    "intersect_write_gathered",
    "intersect_count_gathered",
]

# launches of each kernel since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "intersect_classify_write_indexed": 0,
    "intersect_classify_count_indexed": 0,
    "intersect_write_indexed": 0,
    "intersect_count_indexed": 0,
    "intersect_classify_write_gathered": 0,
    "intersect_classify_write_gathered_donating": 0,
    "intersect_classify_count_gathered": 0,
    "intersect_write_gathered": 0,
    "intersect_count_gathered": 0,
}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_TIMED: "contextvars.ContextVar[list | None]" = contextvars.ContextVar(
    "repro_torch_timed_launches", default=None
)
# read event pairs kept for reuse, per device: creating and destroying a pair
# costs ~60 µs of host time on the H100's host, recording it again ~9 µs
_EVENT_POOL: dict[int, list] = {}


@contextmanager
def timed_launches():
    """Collect the CUDA events recorded on the stream around every kernel
    launched inside the block (none on the CPU), as ``(device index, start,
    end)``; read them with :func:`launch_seconds`. Nothing here waits for
    the device."""
    events: list = []
    token = _TIMED.set(events)
    try:
        yield events
    finally:
        _TIMED.reset(token)


def _launch_events(stream) -> tuple:
    """Inside a :func:`timed_launches` block, the handles of a
    ``(start, end)`` pair of CUDA events, added to the block's list, for the
    launcher to record around its kernel; else ``(None, None)``."""
    timed = _TIMED.get()
    if timed is None:
        return None, None
    pool = _EVENT_POOL.setdefault(stream.device_index, [])
    try:
        start, end = pool.pop()
    except IndexError:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)  # creates each event; the launcher records it again
        end.record(stream)
    timed.append((stream.device_index, start, end))
    return start.cuda_event, end.cuda_event


def launch_seconds(events: list) -> float | None:
    """Device seconds of the launches a :func:`timed_launches` block
    recorded, once the stream has passed all of them (None before then:
    reading them waits for nothing). Read events go back to the pool."""
    if not all(end.query() for _, _, end in events):
        return None
    seconds = sum(start.elapsed_time(end) for _, start, end in events) / 1e3
    for device, start, end in events:
        _EVENT_POOL[device].append((start, end))
    return seconds


def _lib() -> ctypes.CDLL:
    lib = _build.load("intersect")
    if lib.intersect_indexed.argtypes is None:
        lib.intersect_indexed.argtypes = [
            _VP, _LL, _LL, _VP, _LL, _VP, _INT, _VP, _VP, _VP, _INT, _INT, _INT, _VP, _VP, _VP,
        ]
        lib.intersect_indexed.restype = _INT
        lib.intersect_gathered.argtypes = [
            _VP, _VP, _LL, _LL, _VP, _INT, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP, _VP, _VP,
        ]
        lib.intersect_gathered.restype = _INT
        lib.intersect_error_string.argtypes = [_INT]
        lib.intersect_error_string.restype = ctypes.c_char_p
    return lib


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs must share one device, got {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no CUDA kernel for device {device}")


def _check(bits: torch.Tensor, pairs: torch.Tensor, parent_counts: torch.Tensor | None) -> None:
    if bits.dtype != torch.int32 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(
            f"bits must be a contiguous (t, W) int32 tensor, got {bits.dtype} {tuple(bits.shape)}"
        )
    if (pairs.dtype != torch.int32 or pairs.dim() != 2 or pairs.shape[1] != 2
            or not pairs.is_contiguous()):
        raise ValueError(
            f"pairs must be a contiguous (M, 2) int32 tensor, got {pairs.dtype} {tuple(pairs.shape)}"
        )
    if pairs.shape[0] >= 2**31:
        raise ValueError(f"at most 2**31 - 1 pairs per launch, got {pairs.shape[0]}")
    if parent_counts is not None and (
        parent_counts.dtype != torch.int32
        or tuple(parent_counts.shape) != (bits.shape[0],)
        or not parent_counts.is_contiguous()
    ):
        raise ValueError(
            f"parent_counts must be a contiguous ({bits.shape[0]},) int32 tensor, "
            f"got {parent_counts.dtype} {tuple(parent_counts.shape)}"
        )


def _launch(name, bits, pairs, parent_counts, tau, child, cnt, cls) -> None:
    m = pairs.shape[0]
    if m == 0:
        return
    if not -(2**31) <= tau < 2**31:
        raise ValueError(f"tau must fit int32, got {tau}")
    t, w = bits.shape
    vec4 = w % 4 == 0 and bits.data_ptr() % 16 == 0 and (child is None or child.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream()
        start, end = _launch_events(stream)
        err = lib.intersect_indexed(
            bits.data_ptr(), t, w, pairs.data_ptr(), m,
            None if parent_counts is None else parent_counts.data_ptr(), int(tau),
            None if child is None else child.data_ptr(), cnt.data_ptr(),
            None if cls is None else cls.data_ptr(),
            int(child is not None), int(cls is not None), int(vec4), stream.cuda_stream,
            start, end,
        )
    if err != 0:
        raise RuntimeError(f"{name}: launch failed: {lib.intersect_error_string(err).decode()}")
    LAUNCHES[name] += 1


def _empty(m: int, w: int | None, device) -> torch.Tensor:
    shape = (m,) if w is None else (m, w)
    return torch.empty(shape, dtype=torch.int32, device=device)


def intersect_classify_write_indexed(
    bits: torch.Tensor, pairs: torch.Tensor, parent_counts: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(child (M, W), counts (M,), classes (M,)) — replaces the Pallas
    ``intersect_classify_write_indexed``."""
    _check(bits, pairs, parent_counts)
    if not _on_cuda(bits, pairs, parent_counts):
        return _ref.intersect_classify_ref(bits, pairs, parent_counts, tau)
    m, w = pairs.shape[0], bits.shape[1]
    child, cnt, cls = _empty(m, w, bits.device), _empty(m, None, bits.device), _empty(m, None, bits.device)
    _launch("intersect_classify_write_indexed", bits, pairs, parent_counts, tau, child, cnt, cls)
    return child, cnt, cls


def intersect_classify_count_indexed(
    bits: torch.Tensor, pairs: torch.Tensor, parent_counts: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts (M,), classes (M,)), no child — replaces the Pallas
    ``intersect_classify_count_indexed``."""
    _check(bits, pairs, parent_counts)
    if not _on_cuda(bits, pairs, parent_counts):
        return _ref.intersect_classify_count_ref(bits, pairs, parent_counts, tau)
    m = pairs.shape[0]
    cnt, cls = _empty(m, None, bits.device), _empty(m, None, bits.device)
    _launch("intersect_classify_count_indexed", bits, pairs, parent_counts, tau, None, cnt, cls)
    return cnt, cls


def intersect_write_indexed(
    bits: torch.Tensor, pairs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(child (M, W), counts (M,)) — replaces the Pallas
    ``intersect_write_indexed``."""
    _check(bits, pairs, None)
    if not _on_cuda(bits, pairs):
        return _ref.intersect_pairs_ref(bits, pairs)
    m, w = pairs.shape[0], bits.shape[1]
    child, cnt = _empty(m, w, bits.device), _empty(m, None, bits.device)
    _launch("intersect_write_indexed", bits, pairs, None, 0, child, cnt, None)
    return child, cnt


def intersect_count_indexed(bits: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """counts (M,) only — replaces the Pallas ``intersect_count_indexed``."""
    _check(bits, pairs, None)
    if not _on_cuda(bits, pairs):
        return _ref.intersect_count_ref(bits, pairs)
    cnt = _empty(pairs.shape[0], None, bits.device)
    _launch("intersect_count_indexed", bits, pairs, None, 0, None, cnt, None)
    return cnt


# -- gathered ----------------------------------------------------------------


def _check_gathered(a: torch.Tensor, b: torch.Tensor, minp: torch.Tensor | None) -> None:
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous (M, W) int32 tensor, got {x.dtype} {tuple(x.shape)}"
            )
    if a.shape != b.shape:
        raise ValueError(f"a and b must have one shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] >= 2**31:
        raise ValueError(f"at most 2**31 - 1 pairs per launch, got {a.shape[0]}")
    if minp is not None and (
        minp.dtype != torch.int32 or tuple(minp.shape) != (a.shape[0],) or not minp.is_contiguous()
    ):
        raise ValueError(
            f"minp must be a contiguous ({a.shape[0]},) int32 tensor, "
            f"got {minp.dtype} {tuple(minp.shape)}"
        )


def _launch_gathered(name, a, b, minp, tau, child, cnt, cls, inplace=False) -> None:
    m, w = a.shape
    if m == 0:
        return
    if not -(2**31) <= tau < 2**31:
        raise ValueError(f"tau must fit int32, got {tau}")
    vec4 = (w % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
            and (child is None or child.data_ptr() % 16 == 0))
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream()
        start, end = _launch_events(stream)
        err = lib.intersect_gathered(
            a.data_ptr(), b.data_ptr(), w, m,
            None if minp is None else minp.data_ptr(), int(tau),
            None if child is None else child.data_ptr(), cnt.data_ptr(),
            None if cls is None else cls.data_ptr(),
            int(inplace or child is not None), int(cls is not None), int(inplace), int(vec4),
            stream.cuda_stream, start, end,
        )
    if err != 0:
        raise RuntimeError(f"{name}: launch failed: {lib.intersect_error_string(err).decode()}")
    LAUNCHES[name] += 1


def intersect_classify_write_gathered(
    a: torch.Tensor, b: torch.Tensor, minp: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(child (M, W), counts (M,), classes (M,)) of pre-gathered operands —
    replaces the Pallas ``intersect_classify_write_gathered``."""
    _check_gathered(a, b, minp)
    if not _on_cuda(a, b, minp):
        return _ref.intersect_classify_gathered_ref(a, b, minp, tau)
    m, w = a.shape
    child, cnt, cls = _empty(m, w, a.device), _empty(m, None, a.device), _empty(m, None, a.device)
    _launch_gathered("intersect_classify_write_gathered", a, b, minp, tau, child, cnt, cls)
    return child, cnt, cls


def intersect_classify_write_gathered_donating(
    a: torch.Tensor, b: torch.Tensor, minp: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(a, counts (M,), classes (M,)): the child is written over ``a``,
    which is returned as the child — replaces the Pallas
    ``intersect_classify_write_gathered_donating`` (its donated ``a``)."""
    _check_gathered(a, b, minp)
    if not _on_cuda(a, b, minp):
        return _ref.intersect_classify_gathered_ref(a, b, minp, tau, out=a)
    m = a.shape[0]
    cnt, cls = _empty(m, None, a.device), _empty(m, None, a.device)
    _launch_gathered("intersect_classify_write_gathered_donating", a, b, minp, tau, None, cnt, cls,
                     inplace=True)
    return a, cnt, cls


def intersect_classify_count_gathered(
    a: torch.Tensor, b: torch.Tensor, minp: torch.Tensor, tau: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts (M,), classes (M,)) of pre-gathered operands, no child —
    replaces the Pallas ``intersect_classify_count_gathered``."""
    _check_gathered(a, b, minp)
    if not _on_cuda(a, b, minp):
        return _ref.intersect_classify_count_gathered_ref(a, b, minp, tau)
    m = a.shape[0]
    cnt, cls = _empty(m, None, a.device), _empty(m, None, a.device)
    _launch_gathered("intersect_classify_count_gathered", a, b, minp, tau, None, cnt, cls)
    return cnt, cls


def intersect_write_gathered(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(child (M, W), counts (M,)) of pre-gathered operands — replaces the
    Pallas ``intersect_write_gathered``."""
    _check_gathered(a, b, None)
    if not _on_cuda(a, b):
        return _ref.intersect_gathered_ref(a, b)
    m, w = a.shape
    child, cnt = _empty(m, w, a.device), _empty(m, None, a.device)
    _launch_gathered("intersect_write_gathered", a, b, None, 0, child, cnt, None)
    return child, cnt


def intersect_count_gathered(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """counts (M,) of pre-gathered operands only — replaces the Pallas
    ``intersect_count_gathered``."""
    _check_gathered(a, b, None)
    if not _on_cuda(a, b):
        return _ref.intersect_count_gathered_ref(a, b)
    cnt = _empty(a.shape[0], None, a.device)
    _launch_gathered("intersect_count_gathered", a, b, None, 0, None, cnt, None)
    return cnt
