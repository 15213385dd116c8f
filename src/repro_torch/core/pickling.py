"""Restricted unpickling for blobs that come from outside the process.

Pickles read back from disk (WAL frames and level-checkpoint blobs in
``service``) and object payloads that cross the fleet's socket
(``core.collective``) load through :func:`restricted_loads`, which resolves
only this package's classes, numpy's and plain builtin types: a blob that
names another package's class (the reference's
``repro.core.kyiv.MiningState``) fails to load instead of importing it.
"""

from __future__ import annotations

import io
import pickle

__all__ = ["restricted_loads"]

# the builtins a pickled record or mining state may name: plain data types
_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "range", "set", "slice", "str", "tuple",
})


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        top = module.split(".")[0]
        if top in ("repro_torch", "numpy") or (
            module == "builtins" and name in _SAFE_BUILTINS
        ):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name}")


def restricted_loads(data: bytes):
    """``pickle.loads`` that resolves only ``repro_torch.*``, ``numpy.*`` and
    plain builtin types; any other global raises ``UnpicklingError``."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()
