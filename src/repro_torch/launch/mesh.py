"""Device meshes and multi-process launch plumbing.

A :class:`Mesh` is an ndarray of torch devices with one name per axis. The
miner's is a ``(data, model)`` grid: candidate pairs shard over ``data``,
bitset words over ``model`` (``core.sharded``); the LM's sharding plan
(``distributed.sharding``) reads ``(data, model)`` or ``(pod, data, model)``,
the pipeline a ``(stage,)`` axis and sequence-sharded decode attention a
``(data,)`` one (:func:`mesh_from_shape`). An entry
may repeat a device — ``mesh_from_spec("2x2", devices=["cuda:0"] * 4)`` runs
the whole shard logic (one tensor and one launch per shard) on one card, as
the reference's forced host device count does on the CPU.

``make_production_mesh`` gives the reference's pod shapes, 16x16 over
``(data, model)`` and 2x16x16 over ``(pod, data, model)``; it is a function,
so importing this module touches no device. ``launch.dryrun`` builds them on
``meta`` entries.

A torch mesh never spans processes. Across processes the miner runs as a
lockstep fleet (``core.fleet``): ``distributed_init`` joins a
``torch.distributed.TCPStore`` (process 0 hosts it), over which
``core.collective.FleetCollective`` sums the partial popcounts. A three-part
spec ``DCNxDATAxMODEL`` maps onto that fleet: its first part must equal the
number of processes, and the rest is each process's local mesh.

``is_main`` is the coordinator gate (in ``serve_miner`` only process 0
binds HTTP; the others run the peer loop), and ``launch_env_summary`` is the
launch environment (``launch/env.sh``) that ``serve_miner`` logs at startup
in every process, beside the numbers that process reports.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch

__all__ = [
    "Mesh",
    "make_production_mesh",
    "make_host_mesh",
    "mesh_for_device",
    "mesh_from_shape",
    "mesh_from_spec",
    "distributed_init",
    "fleet_store",
    "is_main",
    "launch_env_summary",
]

_SPEC_ERROR = "--mesh spec must be 'MODEL', 'DATAxMODEL' or 'DCNxDATAxMODEL', got {!r}"


class Mesh:
    """An ndarray of ``torch.device`` entries, one name per axis (by default
    the miner's ``(data, model)`` grid)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...] = ("data", "model")):
        axis_names = tuple(axis_names)
        if devices.size == 0 or devices.ndim != len(axis_names) or \
                len(set(axis_names)) != len(axis_names):
            raise ValueError(f"a mesh is a non-empty grid with one distinct name per axis, got "
                             f"shape {devices.shape} and names {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices, each once, in entry order."""
        seen: list[torch.device] = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _visible_devices(n: int) -> list[torch.device]:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise RuntimeError(
            f"a mesh of {n} entries needs {n} cards and torch sees {count}; pass devices= "
            "(an entry may repeat a device, e.g. ['cuda:0'] * n)"
        )
    return [torch.device("cuda", i) for i in range(n)]


def mesh_from_shape(shape, axis_names, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axis_names``; ``devices`` lists the entries
    in row-major order and may repeat a device (default: the visible cards,
    and too few raise)."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape))
    devs = _visible_devices(n) if devices is None else [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} device entries, "
                         f"got {len(devs)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(grid.reshape(shape), axis_names)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The production mesh: 16x16 over ``(data, model)`` (256 entries), or
    with ``multi_pod`` 2x16x16 over ``(pod, data, model)`` (512). ``devices``
    lists the entries in row-major order and may repeat a device or be
    ``"meta"``; by default the visible cards, and too few raise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return mesh_from_shape(shape, axes, devices)


def mesh_from_spec(spec: str, devices=None, *, num_processes: int = 1) -> Mesh:
    """Parse a ``--mesh`` spec: ``"4x2"`` is 4-way pair sharding x 2-way word
    sharding over axes ``(data, model)``; a bare ``"8"`` is ``(1, 8)``.

    ``devices`` lists the entries in row-major order and may repeat a
    device; by default the visible cards are used, and too few raise. A
    three-part ``"DCNxDATAxMODEL"`` spec is accepted only when
    ``num_processes`` equals its first part: the DCN axis is the fleet of
    processes, and the local mesh is ``DATAxMODEL``."""
    raw = spec.lower().replace("×", "x").split("x")
    if not all(p.isdigit() for p in raw) or not 1 <= len(raw) <= 3:
        raise ValueError(_SPEC_ERROR.format(spec))
    parts = [int(p) for p in raw]
    if any(p <= 0 for p in parts):
        raise ValueError(_SPEC_ERROR.format(spec))
    if len(parts) == 3:
        if parts[0] != num_processes:
            raise ValueError(
                f"--mesh {spec!r}: a torch mesh never spans processes; its DCN part "
                f"({parts[0]}) must equal --num-processes ({num_processes})"
            )
        parts = parts[1:]
    if len(parts) == 1:
        parts = [1, parts[0]]
    return mesh_from_shape(parts, ("data", "model"), devices)


def make_host_mesh(data: int = 4, model: int = 2, *, devices=None) -> Mesh:
    """Small mesh over the devices present (tests, the CLI's ``--sharded``):
    ``devices`` (default: the visible cards) shrinks the shape the way the
    reference shrinks to its device count."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_host_mesh needs a CUDA card, or devices=")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    n = len(devices)
    if data * model > n:
        data, model = max(1, n // 2), min(2, n) if n > 1 else 1
        if data * model > n:
            data, model = n, 1
    return mesh_from_shape((data, model), ("data", "model"), devices[: data * model])


def mesh_for_device(spec: str | None, device, *, num_processes: int = 1) -> Mesh:
    """The launchers' mesh: ``spec`` (``None``: :func:`make_host_mesh`'s
    default shape) over ``device``. A device with an index (``cuda:0``), or
    ``cpu``, names one device that every entry repeats; a bare ``cuda``
    spreads the entries over the visible cards."""
    device = torch.device(device)
    one = device.type == "cpu" or device.index is not None
    if spec is None:
        return make_host_mesh(devices=[device] if one else None)
    raw = spec.lower().replace("×", "x").split("x")
    n = int(np.prod([int(p) for p in raw[-2:]])) if all(p.isdigit() for p in raw) else 0
    return mesh_from_spec(spec, devices=[device] * n if one else None,
                          num_processes=num_processes)


# (TCPStore, process_id, num_processes) of the fleet this process joined
# (``distributed_init``); the launcher hands it to the fleet collective
_FLEET = None


def distributed_init(
    coordinator_address: str | None,
    num_processes: int,
    process_id: int,
    *,
    timeout_s: float = 300.0,
) -> tuple[int, int]:
    """Join the mining fleet's ``TCPStore`` at ``host:port``: process 0
    hosts it, the others connect. A ``num_processes <= 1`` call is a no-op.
    Returns the effective ``(process_id, num_processes)``."""
    global _FLEET
    if num_processes <= 1:
        return 0, 1
    if not coordinator_address:
        raise ValueError("--num-processes > 1 requires --coordinator-address")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id must be in [0, {num_processes}), got {process_id}")
    host, _, port = coordinator_address.rpartition(":")
    from torch.distributed import TCPStore

    store = TCPStore(
        host or "127.0.0.1",
        int(port),
        world_size=num_processes,
        is_master=process_id == 0,
        timeout=timedelta(seconds=timeout_s),
        wait_for_workers=False,
    )
    _FLEET = (store, int(process_id), int(num_processes))
    return process_id, num_processes


def fleet_store():
    """The ``(TCPStore, pid, nproc)`` joined by :func:`distributed_init`."""
    if _FLEET is None:
        raise RuntimeError("no fleet store: call distributed_init() first")
    return _FLEET


def is_main() -> bool:
    """Coordinator gate: exactly one process — index 0 — binds the HTTP
    listener and owns artifact writes; the others run the peer loop."""
    return _FLEET is None or _FLEET[1] == 0


def launch_env_summary() -> dict:
    """The launch environment that shaped this process's performance
    (``launch/env.sh``), recorded beside multi-process numbers."""
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cards": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "process_id": 0 if _FLEET is None else _FLEET[1],
        "process_count": 1 if _FLEET is None else _FLEET[2],
        "ld_preload": os.environ.get("LD_PRELOAD", ""),
        "pytorch_cuda_alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""),
        "tcmalloc_report_threshold": os.environ.get(
            "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", ""
        ),
    }
