"""Build the CUDA sources under ``kernels/*/csrc`` with ``nvcc`` into shared
libraries with a plain C interface, and load them with ``ctypes``.

Each source compiles on its first use into ``build/kernels/`` at the root of
the checkout, named by a digest of the source and the flags, so an edited
source builds anew and an unchanged one is reused. :func:`build` starts one
``nvcc`` per missing source, all at once. A build failure raises; nothing
falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
SOURCES = {
    "intersect": _PKG / "intersect" / "csrc" / "intersect.cu",
    "coverage": _PKG / "coverage" / "csrc" / "coverage.cu",
    "tiled": _PKG / "intersect" / "csrc" / "tiled.cu",
    "probe": _PKG / "probe" / "csrc" / "rates.cu",
    "itemize": _PKG / "itemize" / "csrc" / "itemize.cu",
    "crc32": _PKG / "crc32" / "csrc" / "crc32.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# compiler output of each library (register and shared-memory use from
# -Xptxas -v), kept beside the library for later processes
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or ``nvcc`` on ``PATH``."""
    for cand in (
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc",
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def _lib_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named source (default: all) that has no library yet,
    one ``nvcc`` per source in parallel. Returns the library paths."""
    names = list(SOURCES) if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].is_file()]
    for n in names:
        if n not in todo and n not in BUILD_LOGS:
            log = paths[n].with_suffix(".log")
            BUILD_LOGS[n] = log.read_text() if log.is_file() else "cached"
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        # compile to a private name, then rename: a concurrent build never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{n}-", suffix=".so")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
            os.unlink(tmp)
        else:
            paths[n].with_suffix(".log").write_text(out)
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
