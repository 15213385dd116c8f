"""Target-hardware model: the NVIDIA H100 SXM's data-sheet constants.

Every number here is a cited fact, not a measurement: HBM3 at 3.35 TB/s and
80 GB, the dense bf16 tensor-core peak of 989 TFLOP/s (NVIDIA H100 Tensor
Core GPU data sheet, SXM5), and NVLink 4's 18 links of 25 GB/s each way
(450 GB/s per direction per GPU). The 32-bit logic and popcount rates are the
CUDA C++ Programming Guide's arithmetic throughput at compute capability 9.0
(64 and 16 per clock per SM) times the card's 132 SMs and its 1,980 MHz
maximum SM clock; ``kernels/probe`` measures both on the card (PERF.md §6).

The ring model of ``roofline.analysis`` prices every collective at one link
rate, ``ici_link_bw * ici_links``. A GPU's NVLink domain is 8 cards; a
16-wide ``model`` axis leaves it, and its traffic crosses InfiniBand, which
is slower. So ``t_collective`` on the production meshes (16x16, 2x16x16) is a
lower bound.
"""

from __future__ import annotations

import dataclasses

__all__ = ["HW", "H100"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_bf16_flops: float  # per chip, FLOP/s
    hbm_bw: float  # bytes/s
    ici_link_bw: float  # bytes/s per link
    ici_links: int  # links per chip participating in a collective
    hbm_bytes: float
    logic_ops_per_s: float = 0.0  # 32-bit logic operations per second
    popc_per_s: float = 0.0  # 32-bit population counts per second


_SMS, _MAX_SM_HZ = 132, 1.98e9

H100 = HW(
    name="h100-sxm",
    peak_bf16_flops=989e12,
    hbm_bw=3.35e12,
    ici_link_bw=25e9,
    ici_links=18,
    hbm_bytes=80e9,
    logic_ops_per_s=64 * _SMS * _MAX_SM_HZ,
    popc_per_s=16 * _SMS * _MAX_SM_HZ,
)
