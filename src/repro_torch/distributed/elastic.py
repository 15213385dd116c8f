"""Elastic re-partitioning: resume work on another mesh than the one it was
checkpointed from.

Checkpoints store logical (full) arrays, as the reference's do, so
elasticity is a redistribution on load: :func:`redistribute` places a
logical tree on ``plan.mesh`` by the plan's specs, and :func:`gather` brings
a placed tree back to full tensors on one device (to save it, or to read it
whole). A placed leaf is a :class:`Sharded`: one tensor per mesh entry, the
slice that the entry's coordinates select. An entry that repeats a device
holds its own tensor, as ``core.sharded``'s entries do.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .sharding import Plan

__all__ = ["Sharded", "place", "gather", "redistribute", "mesh_fingerprint"]


def mesh_fingerprint(mesh) -> dict:
    return {"shape": dict(mesh.shape), "n_devices": int(mesh.devices.size)}


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def _slices(mesh, spec: tuple, shape: tuple, coord: tuple) -> tuple[slice, ...]:
    """The part of a ``shape`` tensor that entry ``coord`` holds under ``spec``:
    along each dim, block ``i`` of ``n``, with ``i`` the entry's row-major
    index over that dim's axes."""
    out = []
    for d, size in enumerate(shape):
        i, n = 0, 1
        for a in _axes(spec[d] if d < len(spec) else None):
            k = mesh.axis_names.index(a)
            i, n = i * mesh.devices.shape[k] + coord[k], n * mesh.devices.shape[k]
        if size % n:
            raise ValueError(f"dim {d} of size {size} does not split {n} ways (spec {spec})")
        step = size // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


class Sharded:
    """A logical tensor of ``shape`` placed on ``mesh`` by ``spec``:
    ``shards[coord]`` is entry ``coord``'s slice, on its device."""

    def __init__(self, mesh, spec: tuple, shape: tuple, shards: np.ndarray):
        self.mesh, self.spec, self.shape, self.shards = mesh, tuple(spec), tuple(shape), shards

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    def coords(self):
        return np.ndindex(*self.shards.shape)

    def slices(self, coord) -> tuple[slice, ...]:
        return _slices(self.mesh, self.spec, self.shape, coord)

    def owners(self) -> list[tuple]:
        """The first entry (row-major) holding each distinct slice: each
        part of the logical tensor once."""
        seen, out = set(), []
        for c in self.coords():
            key = tuple((s.start, s.stop) for s in self.slices(c))
            if key not in seen:
                seen.add(key)
                out.append(c)
        return out

    def map(self, fn) -> "Sharded":
        """``fn`` applied to every entry's tensor (the same spec and shape)."""
        shards = np.empty(self.shards.shape, dtype=object)
        for c in self.coords():
            shards[c] = fn(self.shards[c])
        return Sharded(self.mesh, self.spec, self.shape, shards)

    def gather(self, device, dtype: torch.dtype | None = None) -> torch.Tensor:
        """The full tensor on ``device`` (in ``dtype``), each slice copied once."""
        out = torch.empty(self.shape, dtype=dtype or self.dtype, device=device)
        for c in self.owners():
            out[self.slices(c)].copy_(self.shards[c])
        return out

    def __repr__(self) -> str:
        return f"Sharded(shape={self.shape}, spec={self.spec}, dtype={self.dtype})"


def place(x, mesh, spec: tuple) -> Sharded:
    """Entry-by-entry copies of the slices of ``x`` (a tensor or an array)
    that ``spec`` gives each entry of ``mesh``."""
    x = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else \
        torch.as_tensor(x).detach()
    shards = np.empty(mesh.devices.shape, dtype=object)
    for c in np.ndindex(*mesh.devices.shape):
        part = x[_slices(mesh, spec, tuple(x.shape), c)]
        shards[c] = torch.empty(part.shape, dtype=part.dtype, device=mesh.devices[c]).copy_(part)
    return Sharded(mesh, spec, tuple(x.shape), shards)


def _named(tree) -> dict:
    if isinstance(tree, nn.Module):
        return {n: p.detach() for n, p in tree.named_parameters()}
    return dict(tree)


def redistribute(tree, plan: Plan, kind: str = "params"):
    """Place a logical tree (numpy arrays or tensors) on ``plan.mesh`` with
    the plan's specs. ``kind``: ``params`` (a network or ``{name: leaf}``),
    ``opt`` (``{"m", "v": params, "step"}``, the step replicated), ``batch``
    (``{name: leaf}``) or ``cache`` (the model's cache layout)."""
    mesh = plan.mesh
    if kind == "params":
        tree = _named(tree)
        return {n: place(a, mesh, s) for (n, a), s in
                zip(tree.items(), plan.param_shardings(tree).values())}
    if kind == "opt":
        return {"m": redistribute(tree["m"], plan), "v": redistribute(tree["v"], plan),
                "step": place(tree["step"], mesh, plan.replicated())}
    if kind == "batch":
        return {n: place(a, mesh, plan.batch_spec(n, a.shape)) for n, a in tree.items()}
    if kind == "cache":
        specs = plan.cache_shardings(tree)
        return _zip_map(lambda a, s: place(a, mesh, s), tree, specs)
    raise ValueError(kind)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def gather(tree, device="cpu"):
    """Every :class:`Sharded` leaf of ``tree`` as a full tensor on ``device``
    (dicts and lists keep their structure)."""
    if isinstance(tree, dict):
        return {k: gather(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather(v, device) for v in tree]
    return tree.gather(device) if isinstance(tree, Sharded) else tree
