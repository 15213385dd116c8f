"""Fault-tolerant checkpointing for mining: the port's own copy of the
reference package's ``repro.distributed.checkpoint``, with its on-disk
format.

  * **atomicity** — state is written to a temp directory and renamed into
    place; a manifest (`manifest.json`) is the commit record and is written
    last. A crash mid-write leaves the previous checkpoint intact.
  * **async** — `save(..., blocking=False)` hands the state to a background
    thread so the mining loop is not stalled by IO (at most one outstanding
    write; the next save joins it).
  * **retention** — keeps the last `keep` checkpoints, pruning older ones.
  * **integrity** — every array records shape/dtype + a CRC32 in the
    manifest; `load` verifies before handing state back.

State is a pytree (nested dicts, lists, tuples) of numpy arrays, torch
tensors and JSON-able leaves, stored as `arrays.npz` + `manifest.json`, the
files the reference package writes: a checkpoint written by either package
loads in the other. The `.npz` is written by hand (`npz.NpzWriter`), each
array's bytes once, and each is CRC'd once:

  * a host leaf in place on the host (`zlib.crc32`): a numpy array, or a
    CPU tensor's row-major bytes (made contiguous inside one
    `checkpoint.copy` span, attr `bytes`);
  * a CUDA tensor leaf streams: it goes to the host in pieces of at most
    `STAGE_BYTES` through two pinned buffers on a copy stream, one piece
    copied while the one before is written, and its CRC is taken on the
    card from the same words (`kernels.crc32`); a padded matrix's leading
    columns are read at their pitch, nothing copied on the card. One
    `checkpoint.copy` span (attr `bytes`) a piece: the host's wait for it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..obs.trace import span as _obs_span
from .npz import NpzWriter

__all__ = ["CheckpointManager", "STAGE_BYTES", "Saved", "save_pytree", "load_pytree"]

# bytes of a torch tensor leaf copied and written at a time (the size of each
# of a CUDA device's two pinned staging buffers)
STAGE_BYTES = 64 << 20


def _flatten(prefix: str, obj, out: dict):
    if isinstance(obj, dict):
        for k in sorted(obj):
            _flatten(f"{prefix}.{k}" if prefix else str(k), obj[k], out)
    elif isinstance(obj, (list, tuple)):
        out[f"{prefix}#type"] = "list" if isinstance(obj, list) else "tuple"
        for i, v in enumerate(obj):
            _flatten(f"{prefix}.{i}", v, out)
    else:
        out[prefix] = obj


def _to_host(obj):
    """``obj`` with every torch tensor replaced by a host numpy copy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class _Staging:
    """A CUDA device's two pinned host buffers and its copy stream, made at
    the first save of a tensor on it and kept for the process (pinning
    memory takes time); one save streams through them at a time."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.bufs = [torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)]
        self.lock = threading.Lock()


_STAGING: dict[torch.device, _Staging] = {}
_STAGING_LOCK = threading.Lock()


def _staging(device: torch.device) -> _Staging:
    with _STAGING_LOCK:
        st = _STAGING.get(device)
        if st is None:
            st = _STAGING[device] = _Staging(device)
        return st


def _pieces(u8: torch.Tensor, limit: int) -> list[tuple[int, int, int, int]]:
    """``(row0, rows, col0, width)`` pieces of a ``rows_view`` in row-major
    order, each at most ``limit`` bytes: whole rows where a row fits."""
    rows, width = u8.shape
    if rows == 1 or width > limit:
        return [(r, 1, c, min(limit, width - c)) for r in range(rows) for c in range(0, width, limit)]
    step = limit // width
    return [(r, min(step, rows - r), 0, width) for r in range(0, rows, step)]


def _stream_cuda(out: NpzWriter, u8: torch.Tensor) -> int:
    """Write a CUDA ``rows_view``'s bytes through the device's pinned
    staging; its CRC-32, taken on the card."""
    from ..kernels.crc32 import copy_rows, crc32_launch

    st = _staging(u8.device)
    with st.lock:
        # the words were written on the current stream: the copies follow
        # them, and the CRC runs beside the copies
        st.stream.wait_stream(torch.cuda.current_stream(u8.device))
        crc = crc32_launch(u8)
        pieces = _pieces(u8, st.bufs[0].numel())

        def issue(i: int) -> None:
            r0, rows, c0, width = pieces[i]
            copy_rows(st.bufs[i % 2], u8, r0, rows, c0, width, st.stream)
            st.events[i % 2].record(st.stream)

        try:
            for i in range(min(2, len(pieces))):
                issue(i)
            for i, (_, rows, _, width) in enumerate(pieces):
                with _obs_span("checkpoint.copy", bytes=rows * width):
                    st.events[i % 2].synchronize()
                out.write(st.bufs[i % 2].numpy()[: rows * width])
                if i + 2 < len(pieces):  # the buffer just written is free again
                    issue(i + 2)
        finally:
            # no copy outlives the save into a buffer the next save reuses
            st.stream.synchronize()
        return int(crc.item()) & 0xFFFFFFFF


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


class Saved(NamedTuple):
    """What :func:`save_pytree` wrote: ``nbytes``, the arrays' bytes;
    ``streamed``, those of its CUDA tensor leaves, which went from the card
    to the file through the staging; ``crc``, where the CRCs of those were
    taken, ``"cuda"``, or ``"host"`` where no leaf streamed."""

    nbytes: int
    streamed: int
    crc: str


def save_pytree(path: str, tree, extra_meta: dict | None = None) -> Saved:
    """Atomic write of a pytree of arrays/scalars to ``path`` (a directory)."""
    from ..kernels.crc32 import rows_view

    flat: dict = {}
    _flatten("", tree, flat)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"arrays": {}, "scalars": {}, "meta": extra_meta or {}, "time": time.time()}
    written = streamed = 0
    with NpzWriter(os.path.join(tmp, "arrays.npz")) as out:
        for key, val in flat.items():
            if key.endswith("#type") or not (hasattr(val, "shape") and hasattr(val, "dtype")):
                manifest["scalars"][key] = val
                continue
            if isinstance(val, torch.Tensor) and val.device.type == "cuda":
                dtype, shape = _np_dtype(val.dtype), tuple(val.shape)
                out.begin(key, dtype, shape)
                u8 = rows_view(val.detach())
                crc = _stream_cuda(out, u8) if u8.numel() else 0
                streamed += u8.numel()
            else:
                if isinstance(val, torch.Tensor):
                    with _obs_span("checkpoint.copy", bytes=val.numel() * val.element_size()):
                        arr = val.detach().contiguous().numpy()
                else:
                    arr = np.asarray(val)
                    if not arr.flags.c_contiguous:
                        arr = np.ascontiguousarray(arr)
                if arr.dtype.hasobject:
                    raise TypeError(f"checkpoint leaf {key!r}: an object array has no bytes to save")
                dtype, shape = arr.dtype, arr.shape
                out.begin(key, dtype, shape)
                out.write(arr)
                crc = zlib.crc32(arr)
            out.end(crc)
            written += int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            manifest["arrays"][key] = {"shape": list(shape), "dtype": str(dtype), "crc32": crc}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return Saved(written, streamed, "cuda" if streamed else "host")


def _unflatten(flat_arrays: dict, flat_scalars: dict):
    tree: dict = {}
    types = {k[: -len("#type")]: v for k, v in flat_scalars.items() if k.endswith("#type")}
    items = {**flat_arrays, **{k: v for k, v in flat_scalars.items() if not k.endswith("#type")}}
    for key, val in items.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node, prefix=""):
        if isinstance(node, dict):
            keys = list(node.keys())
            fixed = {k: fix(node[k], f"{prefix}.{k}" if prefix else k) for k in keys}
            t = types.get(prefix)
            if t in ("list", "tuple"):
                seq = [fixed[str(i)] for i in range(len(fixed))]
                return seq if t == "list" else tuple(seq)
            return fixed
        return node

    return fix(tree)


def load_pytree(path: str, verify: bool = True):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    if verify:
        for k, meta in manifest["arrays"].items():
            arr = arrays[k]
            if list(arr.shape) != meta["shape"] or str(arr.dtype) != meta["dtype"]:
                raise IOError(f"checkpoint corrupt: {k} shape/dtype mismatch")
            if zlib.crc32(np.ascontiguousarray(arr)) != meta["crc32"]:
                raise IOError(f"checkpoint corrupt: {k} CRC mismatch")
    return _unflatten(arrays, manifest["scalars"]), manifest["meta"]


@dataclasses.dataclass
class CheckpointManager:
    """Step/level-indexed checkpoints with retention and async writes."""

    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._pending: threading.Thread | None = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if (
                name.startswith("ckpt_")
                and not name.endswith(".tmp")
                and not name.endswith(".corrupt")
            ):
                if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, meta: dict | None = None, blocking: bool = True) -> None:
        meta = dict(meta or {}, step=step)
        self.wait()
        if blocking:
            # one span over the whole save, through the rename and the prune
            # (attrs ``bytes``: the arrays written; ``streamed``, ``crc``)
            with _obs_span("checkpoint.write", step=step) as sp:
                saved = save_pytree(self._step_dir(step), tree, meta)
                sp.set(bytes=saved.nbytes, streamed=saved.streamed, crc=saved.crc)
                self._prune()
            return
        # copy tensors to the host on the caller's thread, so the async
        # writer never races live (device) buffers
        tree = _to_host(tree)

        def work():
            save_pytree(self._step_dir(step), tree, meta)
            self._prune()

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore(self, step: int | None = None):
        """Load a checkpoint. With an explicit ``step``, corruption raises.
        With ``step=None`` (latest), a corrupt/truncated newest checkpoint is
        quarantined (renamed ``*.corrupt``) and restore falls back to the
        next older intact one — a crash mid-write of a non-atomic filesystem,
        or a torn disk, costs one checkpoint interval, never the run."""
        self.wait()
        if step is not None:
            return load_pytree(self._step_dir(step))
        for s in reversed(self.steps()):
            path = self._step_dir(s)
            try:
                return load_pytree(path)
            except Exception:
                quarantine = path + ".corrupt"
                shutil.rmtree(quarantine, ignore_errors=True)
                try:
                    os.rename(path, quarantine)
                except OSError:
                    shutil.rmtree(path, ignore_errors=True)
        return None, None

    def destroy(self) -> None:
        """Remove the whole checkpoint directory (e.g. a completed mining
        job whose resume states are no longer needed)."""
        self.wait()
        shutil.rmtree(self.directory, ignore_errors=True)

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
