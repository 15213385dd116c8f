"""Wrapper of the throughput probes in ``csrc/rates.cu``.

Each probe runs a loop of one operation on every SM of a CUDA card and is
timed with CUDA events around one launch. :func:`measure_rate` sizes the
loop so that the timed launch takes about ``target_ms`` and returns the
operations per second. The probes run only on a CUDA device: there is no
plain version, and on anything else they raise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["KINDS", "measure_rate", "measure_rates"]

# probe kind -> its number in rates.cu. lop3 and popc count instructions of
# one thread; the mma kinds count bit products (M * N * K per mma)
KINDS = {"lop3": 0, "popc": 1, "mma_m8n8k128": 2, "mma_m16n8k256": 3}
_CTAS_PER_SM = 8

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("probe")
    if lib.probe_rate.argtypes is None:
        lib.probe_rate.argtypes = [_INT, _LL, _LL, _VP, _VP,
                                   ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)]
        lib.probe_rate.restype = _INT
        lib.probe_threads_per_cta.restype = _INT
        lib.probe_error_string.argtypes = [_INT]
        lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def _run(lib, kind: int, n_ctas: int, iters: int, out: torch.Tensor) -> tuple[float, float]:
    ms, ops = ctypes.c_float(), ctypes.c_double()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.probe_rate(kind, n_ctas, iters, out.data_ptr(), stream, ctypes.byref(ms), ctypes.byref(ops))
    if err != 0:
        raise RuntimeError(f"probe kind {kind}: {lib.probe_error_string(err).decode()}")
    return ms.value, ops.value


def measure_rate(kind: str, device="cuda", target_ms: float = 60.0) -> dict:
    """``{"ops": n, "ms": t, "ops_per_s": n / t}`` of probe ``kind`` (a key
    of :data:`KINDS`) on a CUDA ``device``, from one launch of at least
    ``target_ms / 2`` after a short warm-up launch that sizes it."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the rate probes run on a CUDA device, got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = _lib()
    n_ctas = _CTAS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(n_ctas * lib.probe_threads_per_cta(), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        iters = 64
        ms, ops = _run(lib, KINDS[kind], n_ctas, iters, out)
        while ms < target_ms / 2:
            iters = max(2 * iters, int(iters * target_ms / max(ms, 1e-3)))
            ms, ops = _run(lib, KINDS[kind], n_ctas, iters, out)
    return {"ops": ops, "ms": ms, "ops_per_s": ops / (ms * 1e-3), "iters": iters, "ctas": n_ctas}


def measure_rates(device="cuda", target_ms: float = 60.0) -> dict[str, dict]:
    """:func:`measure_rate` of every probe kind."""
    return {kind: measure_rate(kind, device, target_ms) for kind in KINDS}
