"""Plain reader of a job checkpoint on disk: a directory holding
``manifest.json`` (per array its shape, dtype and the CRC32 of its bytes)
and ``arrays.npz``. It imports nothing but ``json``, ``zlib`` and
``numpy``, so it holds the program's files to their manifest without the
program's own loader."""

import json
import zlib

import numpy as np

__all__ = ["faults"]


def faults(path: str) -> list[str]:
    """What is wrong with the checkpoint at ``path``: one line per array
    whose shape, dtype or CRC32 differs from the manifest, or that is
    missing or unreadable; empty where every array matches."""
    try:
        with open(f"{path}/manifest.json") as f:
            manifest = json.load(f)["arrays"]
        out = []
        with np.load(f"{path}/arrays.npz") as z:
            for key, meta in manifest.items():
                if key not in z.files:
                    out.append(f"{key}: missing")
                    continue
                arr = np.ascontiguousarray(z[key])
                if list(arr.shape) != meta["shape"] or str(arr.dtype) != meta["dtype"]:
                    out.append(f"{key}: {arr.dtype}{list(arr.shape)}, manifest {meta['dtype']}{meta['shape']}")
                elif zlib.crc32(arr) != meta["crc32"]:
                    out.append(f"{key}: CRC32 {zlib.crc32(arr)}, manifest {meta['crc32']}")
                del arr
        return out if manifest else ["no arrays"]
    except Exception as exc:  # an unreadable checkpoint is a fault, not a crash of the check
        return [f"unreadable: {type(exc).__name__}: {exc}"]
