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
tensors and JSON-able leaves, stored as `arrays.npz` + `manifest.json`. A
torch tensor, on the CPU or a CUDA device, is copied to host numpy first, so
the files are exactly those the reference package writes: a checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from ..obs.trace import span as _obs_span

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]


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


def save_pytree(path: str, tree, extra_meta: dict | None = None) -> int:
    """Atomic write of a pytree of arrays/scalars to ``path`` (a directory).
    Returns the bytes of the arrays written."""
    flat: dict = {}
    _flatten("", _to_host(tree), flat)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"arrays": {}, "scalars": {}, "meta": extra_meta or {}, "time": time.time()}
    arrays = {}
    for key, val in flat.items():
        if key.endswith("#type"):
            manifest["scalars"][key] = val
            continue
        if hasattr(val, "shape") and hasattr(val, "dtype"):
            arr = np.asarray(val)
            arrays[key] = arr
            manifest["arrays"][key] = {
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": zlib.crc32(arr.tobytes()),
            }
        else:
            manifest["scalars"][key] = val
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return sum(int(a.nbytes) for a in arrays.values())


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
            if zlib.crc32(arr.tobytes()) != meta["crc32"]:
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
            # one span over the whole save, from the host copy through the
            # rename and the prune (attr ``bytes``: the arrays written)
            with _obs_span("checkpoint.write", step=step) as sp:
                sp.set(bytes=save_pytree(self._step_dir(step), tree, meta))
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
