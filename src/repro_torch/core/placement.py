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
   (:meth:`coverage_dispatch`, ``kernels.coverage``).

Implementations:

* :class:`HostPlacement` — numpy on the host; no padding, eager dispatch.
  It is the reference path, bit-identical by construction.
* :class:`DevicePlacement` — one torch device: the plain PyTorch versions
  (``engine="torch"``) or the hand-written CUDA kernels (``engine="cuda"``),
  of the indexed kernel family or the gathered one (``indexed``).
  Parent bitsets go to the device once per level as int32 words, their word
  axis padded with zero words to a multiple of 4 (16-byte rows for the
  kernels' 128-bit loads); every batch then ships only its pair list.

``make_placement`` / ``resolve_placement`` are the one factory the miner
and the launcher go through.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.coverage import index as _cov_index
from ..kernels.coverage import ops as _cov
from ..kernels.coverage.ref import coverage_accumulate_host
from ..kernels.frontier import frontier as _f
from ..kernels.frontier import ops as _fops
from ..kernels.intersect import ops as _ops
from ..obs import metrics as _om
from .bitops import device_bits, popcount_rows
from .prefix import CandidateBatch, Level, generate_candidates, group_reps
from .support import ItemsetIndex, support_test

__all__ = [
    "HostPlacement",
    "DevicePlacement",
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


def _guard(site: str) -> None:
    # count first: a dispatch that the fault hook kills still happened
    _DISPATCHES.inc(site=site, kind="device")
    if _fault_hook is not None:
        _fault_hook(site)


class HostPlacement:
    """Bitsets stay in host numpy; dispatch is eager and unpadded."""

    kind = "host"

    def prepare(self, bits, parent_counts, tau: int, *, fused_classify: bool):
        return (
            np.asarray(bits),
            np.asarray(parent_counts, dtype=np.int64),
            int(tau),
            fused_classify,
        )

    def padded_size(self, m: int) -> int:
        return m

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

    def padded_size(self, m: int) -> int:
        return _ops.next_bucket(m)

    def _pairs(self, pairs) -> torch.Tensor:
        if isinstance(pairs, torch.Tensor):
            return pairs
        return torch.from_numpy(np.ascontiguousarray(pairs, dtype=np.int32)).to(self.device)

    def dispatch(self, state, padded_pairs, write_children: bool):
        _guard("dispatch")
        fn = _ops.build_engine_dispatch(
            self.engine, fused_classify=state["fused"], write_children=write_children,
            indexed=self.indexed, donate=self.donate,
        )
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
        fn = _cov.build_coverage_dispatch(self.engine)
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
        bits, ipw, _ = _f.pack_params(state["n_symbols"], state["k"])
        reps_b = torch.from_numpy(_fops.pad_reps(state["reps"][lo:hi], row_bucket)).to(self.device)
        return _f.gen_support_body(
            state["ids"], state["keys"], reps_b, lo, n_pairs,
            k=state["k"], bucket=bucket, t_pad=state["t_pad"], bits=bits, ipw=ipw,
        )

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
