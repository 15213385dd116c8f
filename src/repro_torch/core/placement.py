"""Bitset placement: where a level's bitsets live and how a batch executes.

A placement answers, for the level pipeline (``kernels.intersect.ops``) and
the level loop (``core.frontier``):

1. **residency** — how a level's parent bitsets and popcounts become
   resident for the level (:meth:`prepare`), and its id/key tables for the
   frontier ops (:meth:`prepare_frontier`);
2. **padding** — what batch sizes to pad to (:meth:`padded_size`);
3. **dispatch** — how one padded pair batch executes (:meth:`dispatch`) and
   how candidates are generated, masked and partitioned
   (:meth:`frontier_dispatch`, and on a device :meth:`frontier_mask` and
   :meth:`frontier_partition`);
4. **retirement** — dropping what :meth:`prepare` uploaded (:meth:`release`);
5. **coverage** — the item bitsets of a record-risk query made resident once
   (:meth:`prepare_coverage`) and one padded itemset batch accumulated
   (:meth:`coverage_dispatch`, ``kernels.coverage``);
6. **layout** — a long-lived bitset matrix (the service's ``DatasetStore``)
   placed once per version (:meth:`put_bits`), and the word-count multiple
   stored matrices keep (``store_word_tile``).

Device dispatches bind their callables once per bucket through the
process-wide executable cache (``core.exec_cache``; one family per kernel
package), so ``/stats`` can show warm versus cold buckets.

Implementations:

* :class:`HostPlacement` — numpy on the host; no padding, eager dispatch.
  It is the reference path, bit-identical by construction.
* :class:`DevicePlacement` — one torch device: the plain PyTorch versions
  (``engine="torch"``) or the hand-written CUDA kernels (``engine="cuda"``),
  of the indexed kernel family or the gathered one (``indexed``).
  Parent bitsets go to the device once per level as int32 words, their word
  axis padded with zero words to a multiple of 4 (16-byte rows for the
  kernels' 128-bit loads); every batch then ships only its pair list.
* :class:`MeshPlacement` — a ``(data, model)`` mesh of torch devices
  (``launch.mesh``): pairs shard over ``data``, bitset words over ``model``,
  and each pair shard sums its word shards' partial popcounts before it
  classifies (``core.sharded``). An entry may repeat a device.

Every placement also moves rows of its own bitset matrices
(:meth:`take_rows`, :meth:`cat_rows`): the level loop gathers stored
children with them, and the service its resident level 1.

``make_placement`` / ``resolve_placement`` are the one factory the miner,
the service and the launchers go through; :func:`is_device_failure` tells
the service's device retries a device fault from a bug.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ..kernels.coverage import index as _cov_index
from ..kernels.coverage import ops as _cov
from ..kernels.coverage.ref import coverage_accumulate_host
from ..kernels.frontier import frontier as _f
from ..kernels.frontier import ops as _fops
from ..kernels.intersect import ops as _ops
from ..obs import cost as _obs_cost
from ..obs import metrics as _om
from .bitops import device_bits, popcount_rows
from . import sharded as _sh
from .prefix import CandidateBatch, Level, generate_candidates, group_reps
from .support import ItemsetIndex, support_test

__all__ = [
    "HostPlacement",
    "DevicePlacement",
    "MeshPlacement",
    "is_device_failure",
    "make_placement",
    "resolve_placement",
    "set_fault_hook",
]

# -- fault seam --------------------------------------------------------------
#
# Device dispatch paths call ``_guard(site)`` just before executing on the
# device. The hook is the seam a fault-injection harness uses to simulate
# device failures without touching the kernels; production leaves it None.
# Host dispatch is deliberately unguarded: it must stay failure-free.

_fault_hook = None


def set_fault_hook(hook):
    """Install ``hook(site: str)`` ahead of every device dispatch (sites:
    "dispatch", "frontier", "coverage"). Returns the previous hook so
    callers can restore it."""
    global _fault_hook
    prev, _fault_hook = _fault_hook, hook
    return prev


_DISPATCHES = _om.counter(
    "repro_placement_dispatch_total",
    "Placement-layer dispatches by seam and backend kind.",
    ("site", "kind"),
)


def count_dispatch(site: str, kind: str) -> None:
    """One placement-layer dispatch at ``site`` ("dispatch", "coverage",
    "frontier") by a placement of ``kind`` (``repro_placement_dispatch_total``)."""
    _DISPATCHES.inc(site=site, kind=kind)


def _guard(site: str, kind: str = "device") -> None:
    # count first: a dispatch that the fault hook kills still happened
    count_dispatch(site, kind)
    _obs_cost.add(device_dispatches=1)
    if _fault_hook is not None:
        _fault_hook(site)


# Substrings that mark a RuntimeError as a CUDA runtime failure: torch's own
# ("CUDA error: ...", "CUDA out of memory") and the kernel wrappers'
# ("<kernel>: launch failed: <cudaGetErrorString>").
_DEVICE_FAILURE_MARKERS = ("CUDA error", "out of memory", ": launch failed: ")


def is_device_failure(exc: BaseException) -> bool:
    """Is ``exc`` a device/runtime failure worth retrying on the device —
    as opposed to a bug that would fail the same way on every attempt?

    Injected faults mark themselves with an ``is_device_failure`` attribute;
    ``torch.cuda.OutOfMemoryError`` and CUDA runtime errors raised by torch
    or by the kernel wrappers count. A kernel *build* failure
    (``kernels/_build.py``: no ``nvcc``, a compile error) and an
    ``ImportError`` never count: they would fail every retry alike."""
    if getattr(exc, "is_device_failure", False):
        return True
    if isinstance(exc, ImportError):
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    msg = str(exc)
    if msg.startswith(("CUDA kernel build failed", "nvcc not found")):
        return False
    return any(marker in msg for marker in _DEVICE_FAILURE_MARKERS)


class HostPlacement:
    """Bitsets stay in host numpy; dispatch is eager and unpadded."""

    kind = "host"
    store_word_tile = 1

    def prepare(self, bits, parent_counts, tau: int, *, fused_classify: bool):
        return (
            np.asarray(bits),
            np.asarray(parent_counts, dtype=np.int64),
            int(tau),
            fused_classify,
        )

    def padded_size(self, m: int, *, pad_buckets: bool = True) -> int:
        return m  # host gathers have no buckets to reuse

    def put_bits(self, bits: np.ndarray):
        return np.ascontiguousarray(bits)

    def take_rows(self, bits, rows: np.ndarray):
        return np.asarray(bits)[np.asarray(rows, dtype=np.int64)]

    def cat_rows(self, parts):
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def describe(self) -> dict:
        return {"kind": self.kind, "engine": "numpy", "devices": 0}

    def dispatch(self, state, padded_pairs: np.ndarray, write_children: bool):
        _DISPATCHES.inc(site="dispatch", kind="host")
        bits, pc, tau, fused = state
        a = bits[padded_pairs[:, 0]]
        b = bits[padded_pairs[:, 1]]
        child = np.bitwise_and(a, b)
        counts = popcount_rows(child)
        classes = None
        if fused:
            minp = np.minimum(pc[padded_pairs[:, 0]], pc[padded_pairs[:, 1]])
            classes = _ops.classify_counts_host(counts, minp, tau)
        return (child if write_children else None), counts, classes

    # -- coverage -------------------------------------------------------------

    def prepare_coverage(self, bits):
        return np.ascontiguousarray(np.asarray(bits, dtype=np.uint32))

    def coverage_dispatch(self, state, padded_sets, padded_weights):
        _DISPATCHES.inc(site="coverage", kind="host")
        return coverage_accumulate_host(state, padded_sets, padded_weights)

    # -- frontier (the numpy reference path) --------------------------------

    def prepare_frontier(self, itemsets, counts, n_symbols: int):
        return ItemsetIndex(itemsets, counts, n_symbols=n_symbols)

    def frontier_dispatch(self, state, lo: int, hi: int, n_pairs: int):
        """Materialise the span's candidate batch (``repeat``/``cumsum``) and
        run the packed-key support test on the host."""
        _DISPATCHES.inc(site="frontier", kind="host")
        itemsets = state.itemsets[lo:hi].astype(np.int32)
        counts = np.zeros(hi - lo, dtype=np.int64)
        batch = generate_candidates(Level(k=0, itemsets=itemsets, counts=counts, bits=None))
        batch = CandidateBatch(i_idx=batch.i_idx + lo, j_idx=batch.j_idx + lo, itemsets=batch.itemsets)
        return batch, support_test(batch.itemsets, state)

    def release(self, state) -> None:
        pass  # host arrays are the caller's

    def __repr__(self) -> str:
        return "HostPlacement()"


class DevicePlacement:
    """One torch device, running the plain PyTorch versions (``torch``) or
    the CUDA kernels (``cuda``).

    ``indexed=False`` selects the gathered kernel family: each batch gathers
    its operand rows by torch indexing and the kernels read them in order.
    On a CUDA device the gathered fused write path donates the gathered
    operand (``donate``): the child is written over it, so a batch allocates
    no child buffer, as the reference donates on accelerators only.

    A CUDA device must exist when one is asked for: construction raises
    otherwise, and nothing falls back to the CPU.
    """

    kind = "device"
    store_word_tile = 1

    def __init__(self, engine: str = "cuda", *, device="cuda", indexed: bool = True):
        if engine not in ("torch", "cuda"):
            raise ValueError(f"DevicePlacement engine must be torch|cuda, got {engine!r}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"engine={engine!r} on device {device} needs a CUDA card, and torch sees none; "
                "pass device='cpu' (or engine='numpy') to mine on the CPU"
            )
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.engine = engine
        self.device = device
        self.indexed = indexed
        self.donate = device.type == "cuda"

    def prepare(self, bits, parent_counts, tau: int, *, fused_classify: bool):
        # bits chained from the previous level are already resident (int32,
        # word-padded); host bitsets are uploaded here and owned by the state
        owned = not isinstance(bits, torch.Tensor)
        return {
            "bits": device_bits(bits, self.device) if owned else bits,
            "pc": torch.as_tensor(np.asarray(parent_counts, dtype=np.int32), device=self.device),
            "tau": int(tau),
            "fused": fused_classify,
            "owned": owned,
        }

    def padded_size(self, m: int, *, pad_buckets: bool = True) -> int:
        return _ops.next_bucket(m) if pad_buckets else m

    def put_bits(self, bits: np.ndarray) -> torch.Tensor:
        """Place a long-lived (t, W) uint32 bitset matrix on this device:
        int32 words, the word axis padded to a multiple of 4."""
        return device_bits(bits, self.device)

    def take_rows(self, bits: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
        """Rows of a device bitset matrix, gathered on its own device (worker
        threads carry no current-device setting)."""
        return bits[torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(bits.device)]

    def cat_rows(self, parts):
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def describe(self) -> dict:
        return {
            "kind": self.kind,
            "engine": self.engine,
            "devices": 1,
            "backend": self.device.type,
            "device": str(self.device),
            "name": (torch.cuda.get_device_name(self.device)
                     if self.device.type == "cuda" else "cpu"),
            "indexed": self.indexed,
        }

    def _pairs(self, pairs) -> torch.Tensor:
        if isinstance(pairs, torch.Tensor):
            return pairs
        return torch.from_numpy(np.ascontiguousarray(pairs, dtype=np.int32)).to(self.device)

    def dispatch(self, state, padded_pairs, write_children: bool):
        _guard("dispatch")
        fused = state["fused"]
        key = (self.engine, self.indexed, fused, write_children,
               int(state["bits"].shape[1]), int(padded_pairs.shape[0]), self.donate)
        fn = _ops.EXEC_CACHE.get(key, lambda: _ops.build_engine_dispatch(
            self.engine, fused_classify=fused, write_children=write_children,
            indexed=self.indexed, donate=self.donate,
        ))
        return fn(state["bits"], self._pairs(padded_pairs), state["pc"], state["tau"])

    # -- coverage -------------------------------------------------------------

    def prepare_coverage(self, bits):
        """Upload the item bitsets once (int32 words, word axis padded); the
        ``cuda`` engine also builds their index of nonzero words there, for
        the anchored kernel. Returns ``(bits, index or None)``."""
        dbits = device_bits(bits, self.device)
        return dbits, (_cov_index.build_coverage_index(dbits) if self.engine == "cuda" else None)

    def coverage_dispatch(self, state, padded_sets, padded_weights):
        """acc (32, padded W) int32 on the device for one padded batch."""
        _guard("coverage")
        key = ("coverage", self.engine, int(padded_sets.shape[1]), int(state[0].shape[1]),
               int(padded_sets.shape[0]))
        fn = _cov.EXEC_CACHE.get(key, lambda: _cov.build_coverage_dispatch(self.engine))
        return fn(*state, padded_sets, padded_weights)

    # -- frontier -----------------------------------------------------------

    def prepare_frontier(self, itemsets, counts, n_symbols: int):
        itemsets = np.asarray(itemsets, dtype=np.int32)
        ids, keys, t_pad = _fops.make_level_tables(itemsets, n_symbols)
        return {
            "k": int(itemsets.shape[1]),
            "n_symbols": int(n_symbols),
            "t": int(itemsets.shape[0]),
            "t_pad": t_pad,
            "ids": torch.from_numpy(ids).to(self.device),
            "keys": torch.from_numpy(keys).to(self.device),
            "reps": group_reps(itemsets).astype(np.int32),
        }

    def frontier_dispatch(self, state, lo: int, hi: int, n_pairs: int):
        _guard("frontier")
        row_bucket, bucket = _fops.gen_buckets(hi - lo, n_pairs)
        k, n_symbols, t_pad = state["k"], state["n_symbols"], state["t_pad"]

        def build():
            bits, ipw, _ = _f.pack_params(n_symbols, k)
            return functools.partial(
                _f.gen_support_body, k=k, bucket=bucket, t_pad=t_pad, bits=bits, ipw=ipw
            )

        fn = _fops.EXEC_CACHE.get(("gen-support", k, n_symbols, t_pad, row_bucket, bucket), build)
        reps_b = torch.from_numpy(_fops.pad_reps(state["reps"][lo:hi], row_bucket)).to(self.device)
        return fn(state["ids"], state["keys"], reps_b, lo, n_pairs)

    def frontier_mask(self, state, pairs, ok):
        return _f.mask_pruned_body(pairs, ok)

    def frontier_partition(self, classes):
        return _f.partition_body(classes)

    def release(self, state) -> None:
        """Drop the device buffers this placement uploaded itself: a
        frontier state's id/key tables, or a level's bitsets and popcounts
        when :meth:`prepare` uploaded them. Tensors the caller handed in stay
        alive."""
        for name in ("ids", "keys"):
            state.pop(name, None)
        if state.get("owned"):
            state.pop("bits", None)
            state.pop("pc", None)

    def __repr__(self) -> str:
        return (f"DevicePlacement(engine={self.engine!r}, device={str(self.device)!r}, "
                f"indexed={self.indexed!r})")


class MeshPlacement:
    """A ``(data, model)`` mesh of torch devices: pairs shard over ``data``,
    words over ``model`` (``word_axis="model"``; ``None`` keeps whole rows).

    Each mesh entry ``(d, w)`` holds its own tensors and launches its own
    kernels, also where entries repeat a device (one card runs the whole
    shard logic). A level's parent bitsets are word shard ``w`` on every
    entry of column ``w`` (replicated over ``data``); a batch's pair list is
    cut into ``data`` equal blocks (``padded_size``: the bucket, then
    ``core.balance.balanced_blocks``); each pair shard sums its word
    shards' partial counts on its first device and classifies after the sum
    (``core.sharded``). Counts, classes and the device frontier's tables
    gather on entry ``(0, 0)``, the home device. Children stay sharded
    (:class:`~repro_torch.core.sharded.PairShardedBits`) until the level loop
    gathers its stored rows into the next level's
    :class:`~repro_torch.core.sharded.MeshBits`.

    ``use_device_frontier`` is on for a mesh of CUDA devices and off for a
    CPU mesh, as the reference gates its mesh frontier by backend.
    ``shard_launches`` counts the kernel calls of each entry and seam.
    """

    kind = "mesh"

    def __init__(
        self,
        mesh,
        *,
        word_axis: str | None = None,
        engine: str = "cuda",
        indexed: bool = True,
        device_frontier: bool | None = None,
    ):
        if word_axis not in (None, "model"):
            raise ValueError(f"word_axis must be 'model' or None, got {word_axis!r}")
        if engine not in ("torch", "cuda"):
            raise ValueError(f"MeshPlacement engine must be torch|cuda, got {engine!r}")
        self.mesh = mesh
        self.word_axis = word_axis
        self.engine = engine
        self.indexed = indexed
        devices = list(mesh.devices.flat)
        on_cuda = all(d.type == "cuda" for d in devices)
        if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
            raise RuntimeError("a mesh of CUDA devices needs a CUDA card, and torch sees none")
        self.use_device_frontier = on_cuda if device_frontier is None else bool(device_frontier)
        self.donate = on_cuda
        self.pair_shards = int(mesh.devices.shape[0])
        self.word_shards = int(mesh.devices.shape[1]) if word_axis else 1
        self.store_word_tile = self.word_shards
        self.spans_processes = False  # a torch mesh lives in one process
        self.home = mesh.devices[0, 0]
        self.shard_launches = collections.Counter()
        steps = {
            (False, True): _sh.sharded_level_step,
            (False, False): _sh.sharded_level_count_step,
            (True, True): _sh.sharded_level_classify_step,
            (True, False): _sh.sharded_level_classify_count_step,
        }
        self._steps = {
            key: build(mesh, word_axis=word_axis, engine=engine, indexed=indexed,
                       donate=self.donate and not indexed)
            for key, build in steps.items()
        }
        self._coverage = _sh.sharded_coverage_step(mesh, word_axis=word_axis, engine=engine)

    def _entry(self, d: int, w: int) -> torch.device:
        return self.mesh.devices[d, w]

    def _recorder(self, site: str):
        """``record(d, w)``: one kernel call of entry ``(d, w)`` at ``site``."""
        return lambda d, w: self.shard_launches.update([(site, d, w)])

    def _grid(self, bits):
        """Per-entry word shards of a level's parents, replicated over
        ``data``: entry ``(0, w)`` uses a chained :class:`MeshBits` part in
        place; every other entry holds its own copy. Returns ``(grid,
        owned)``, ``owned`` naming the entries this call allocated."""
        if isinstance(bits, _sh.MeshBits):
            cols, owned = bits.parts, set()
        else:
            cols, owned = self.put_bits(bits).parts, {(0, w) for w in range(self.word_shards)}
        grid = [[None] * self.word_shards for _ in range(self.pair_shards)]
        for w in range(self.word_shards):
            grid[0][w] = cols[w]
            for d in range(1, self.pair_shards):
                grid[d][w] = cols[w].to(self._entry(d, w), copy=True)
                owned.add((d, w))
        return grid, owned

    def prepare(self, bits, parent_counts, tau: int, *, fused_classify: bool):
        grid, owned = self._grid(bits)
        pc = np.asarray(parent_counts, dtype=np.int32)
        return {
            "grid": grid,
            "owned": owned,
            "pcs": [torch.from_numpy(pc).to(self._entry(d, 0)) for d in range(self.pair_shards)],
            "tau": int(tau),
            "fused": fused_classify,
            "n_words": int(bits.shape[1]),
        }

    def padded_size(self, m: int, *, pad_buckets: bool = True) -> int:
        from .balance import balanced_blocks

        bucket = _ops.next_bucket(m) if pad_buckets else m
        return balanced_blocks(bucket, self.pair_shards)[0]

    def _blocks(self, pairs) -> list[list[torch.Tensor]]:
        """The pair list cut into ``data`` equal blocks, block ``d`` on every
        entry of row ``d``."""
        if not isinstance(pairs, torch.Tensor):
            pairs = torch.from_numpy(np.ascontiguousarray(pairs, dtype=np.int32))
        block = int(pairs.shape[0]) // self.pair_shards
        out = []
        for d in range(self.pair_shards):
            blk = pairs[d * block : (d + 1) * block]
            out.append([blk.to(self._entry(d, w)) for w in range(self.word_shards)])
        return out

    def dispatch(self, state, padded_pairs, write_children: bool):
        _guard("dispatch", "mesh")
        fused = state["fused"]
        step = self._steps[(fused, write_children)]
        blocks, counts, classes = step(state["grid"], self._blocks(padded_pairs), state["pcs"],
                                       state["tau"], self._recorder("dispatch"))
        cnt = torch.cat([c.to(self.home) for c in counts])
        cls = torch.cat([c.to(self.home) for c in classes]) if classes is not None else None
        child = _sh.PairShardedBits(blocks, state["n_words"]) if blocks is not None else None
        return child, cnt, cls

    def put_bits(self, bits) -> "_sh.MeshBits":
        """Word-shard a long-lived bitset matrix over the mesh's first row
        (``prepare`` replicates it over ``data`` per level)."""
        bits = np.asarray(bits, dtype=np.uint32)
        cols = _sh.split_words(bits, self.word_shards)
        return _sh.MeshBits([torch.from_numpy(c).to(self._entry(0, w)) for w, c in enumerate(cols)],
                            bits.shape[1])

    def take_rows(self, bits, rows: np.ndarray) -> "_sh.MeshBits":
        if isinstance(bits, _sh.PairShardedBits):
            return bits.take(rows, [self._entry(0, w) for w in range(self.word_shards)])
        return bits[np.asarray(rows, dtype=np.int64)]

    def cat_rows(self, parts) -> "_sh.MeshBits":
        if len(parts) == 1:
            return parts[0]
        return _sh.MeshBits(
            [torch.cat([p.parts[w] for p in parts]) for w in range(self.word_shards)],
            parts[0].n_words,
        )

    # -- coverage -------------------------------------------------------------

    def prepare_coverage(self, bits):
        """Word-shard the item bitsets onto every entry; the ``cuda`` engine
        builds each entry's index of nonzero words for the anchored kernel."""
        grid, _ = self._grid(bits)
        indexes = [[(_cov_index.build_coverage_index(b) if self.engine == "cuda" else None)
                    for b in row] for row in grid]
        return grid, indexes

    def coverage_dispatch(self, state, padded_sets, padded_weights):
        """acc (32, word_shards * shard_width) int32 on the home device."""
        _guard("coverage", "mesh")
        grid, indexes = state
        return self._coverage(grid, indexes, np.asarray(padded_sets), np.asarray(padded_weights),
                              self._recorder("coverage"))

    # -- frontier -----------------------------------------------------------

    def prepare_frontier(self, itemsets, counts, n_symbols: int):
        itemsets = np.asarray(itemsets, dtype=np.int32)
        ids, keys, t_pad = _fops.make_level_tables(itemsets, n_symbols)
        # the id/key tables replicate per pair shard (the shared-memory
        # analogue); only the support test's pair axis shards
        return {
            "k": int(itemsets.shape[1]),
            "n_symbols": int(n_symbols),
            "t": int(itemsets.shape[0]),
            "t_pad": t_pad,
            "ids": [torch.from_numpy(ids).to(self._entry(d, 0)) for d in range(self.pair_shards)],
            "keys": [torch.from_numpy(keys).to(self._entry(d, 0)) for d in range(self.pair_shards)],
            "reps": group_reps(itemsets).astype(np.int32),
        }

    def frontier_dispatch(self, state, lo: int, hi: int, n_pairs: int):
        """Candidate pairs generated on the home device, then the support
        test split over the pair shards."""
        _guard("frontier", "mesh")
        row_bucket = _fops.gen_buckets(hi - lo, n_pairs)[0]
        bucket = self.padded_size(n_pairs)
        reps_b = torch.from_numpy(_fops.pad_reps(state["reps"][lo:hi], row_bucket)).to(self.home)
        i, j, valid = _f.gen_pairs_body(reps_b, lo, n_pairs, bucket=bucket)
        pairs = torch.stack([i, j], dim=1)
        if state["k"] < 2:  # candidate width 2: both subsets are stored parents
            return pairs, valid
        k, n_symbols, t_pad = state["k"], state["n_symbols"], state["t_pad"]

        def build():
            bits, ipw, _ = _f.pack_params(n_symbols, k)
            return _sh.sharded_frontier_support_step(self.mesh, k=k, t_pad=t_pad, bits=bits,
                                                     ipw=ipw)

        fn = _fops.EXEC_CACHE.get(("mesh-support", id(self.mesh), k, n_symbols, t_pad, bucket),
                                  build)
        return pairs, fn(state["ids"], state["keys"], pairs, valid)

    def frontier_mask(self, state, pairs, ok):
        return _f.mask_pruned_body(pairs, ok)

    def frontier_partition(self, classes):
        return _f.partition_body(classes)

    def release(self, state) -> None:
        """Drop what this placement allocated: a frontier state's tables, or
        a level's replicated copies and uploads (a chained :class:`MeshBits`
        stays its level's)."""
        for name in ("ids", "keys"):
            state.pop(name, None)
        grid = state.get("grid")
        if grid is not None:
            for d, w in state.get("owned", ()):
                grid[d][w] = None
            state.pop("pcs", None)

    def describe(self) -> dict:
        return {
            "kind": self.kind,
            "engine": self.engine,
            "devices": int(self.mesh.devices.size),
            "distinct_devices": [str(d) for d in self.mesh.distinct_devices],
            "mesh_entries": [str(d) for d in self.mesh.devices.flat],
            "mesh_shape": self.mesh.shape,
            "pair_axes": ["data"],
            "word_axis": self.word_axis,
            "pair_shards": self.pair_shards,
            "word_shards": self.word_shards,
            "spans_processes": self.spans_processes,
            "indexed": self.indexed,
        }

    def __repr__(self) -> str:
        return (f"MeshPlacement(shape={self.mesh.shape}, word_axis={self.word_axis!r}, "
                f"engine={self.engine!r})")


def make_placement(engine: str, *, device="cuda", indexed: bool = True):
    """Placement for an engine name: ``numpy`` -> host, ``torch``/``cuda`` ->
    one torch device with the indexed or the gathered kernel family."""
    if engine == "numpy":
        return HostPlacement()
    if engine in ("torch", "cuda"):
        return DevicePlacement(engine, device=device, indexed=indexed)
    raise ValueError(f"no placement for engine {engine!r} (expected numpy|torch|cuda)")


def resolve_placement(config):
    """``config.placement`` when set (a placement instance, or an engine name
    resolved through :func:`make_placement`); otherwise ``config.engine`` on
    ``config.device``, with ``config.indexed_kernel``'s kernel family."""
    p = config.placement
    if p is not None and not isinstance(p, str):
        return p
    return make_placement(p if isinstance(p, str) else config.engine, device=config.device,
                          indexed=config.indexed_kernel)
