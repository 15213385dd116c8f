"""Three-term roofline per (arch x shape x mesh) step, in seconds:

  t_compute    = flops_per_device / peak_bf16_flops
  t_memory     = hbm_bytes_per_device / hbm_bw
  t_collective = Σ_op collective_cost(op) ; ring-model per op:
                 all-gather / reduce-scatter move (n-1)/n of the *global*
                 tensor bytes through each device's links; all-reduce costs
                 2x reduce-scatter; all-to-all moves (n-1)/n of the local
                 shard; collective-permute moves the operand once.

The ring model prices every link at ``hw.ici_link_bw * hw.ici_links``
(``roofline.hw``: on the production meshes a lower bound). Collectives come
as a list of :class:`CollectiveOp`: the port's dry run lists the copies its
own step makes (torch emits no HLO, so the reference's HLO parser has no
counterpart here).
"""

from __future__ import annotations

import dataclasses

from .hw import H100, HW

__all__ = ["CollectiveOp", "collective_seconds", "roofline_terms", "RooflineReport"]

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: tuple[int, ...]
    group_size: int
    trip_mult: int = 1  # how many times the step makes this copy

    @property
    def bytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * _DTYPE_BYTES.get(self.dtype, 4)


def collective_seconds(ops: list[CollectiveOp], hw: HW = H100) -> tuple[float, int]:
    """Ring-model serialization time and total wire bytes per device."""
    total_t = 0.0
    total_bytes = 0
    bw = hw.ici_link_bw * hw.ici_links
    for op in ops:
        n = max(op.group_size, 1)
        if n == 1:
            continue
        frac = (n - 1) / n
        if op.kind == "all-gather":
            # output is the gathered (global) tensor per shard
            wire = op.bytes * frac
        elif op.kind == "reduce-scatter":
            # output is the scattered shard; global = bytes * n
            wire = op.bytes * n * frac
        elif op.kind == "all-reduce":
            # reduce-scatter + all-gather over the same (per-shard) tensor
            wire = 2 * op.bytes * frac
        elif op.kind == "all-to-all":
            wire = op.bytes * frac
        else:  # collective-permute
            wire = op.bytes
        wire *= op.trip_mult
        total_t += wire / bw
        total_bytes += int(wire)
    return total_t, total_bytes


@dataclasses.dataclass
class RooflineReport:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    collective_bytes_per_dev: int
    t_compute: float
    t_memory: float
    t_collective: float
    n_collectives: int
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """No-overlap upper bound used as the conservative roof."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "collective_bytes_per_dev": self.collective_bytes_per_dev,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "n_collectives": self.n_collectives,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": (
                self.model_flops / self.flops_per_dev if self.flops_per_dev else 0.0
            ),
        }


def roofline_terms(flops: float, hbm_bytes: float, collectives: list[CollectiveOp],
                   hw: HW = H100, model_flops_per_dev: float = 0.0) -> RooflineReport:
    """Three-term roofline of one entry's ``flops`` and ``hbm_bytes`` and the
    ``collectives`` it takes part in."""
    t_coll, wire_bytes = collective_seconds(collectives, hw)
    return RooflineReport(
        flops_per_dev=flops,
        hbm_bytes_per_dev=hbm_bytes,
        collective_bytes_per_dev=wire_bytes,
        t_compute=flops / hw.peak_bf16_flops,
        t_memory=hbm_bytes / hw.hbm_bw,
        t_collective=t_coll,
        n_collectives=len(collectives),
        model_flops=model_flops_per_dev,
    )
