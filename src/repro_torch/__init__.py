"""PyTorch/CUDA port of the Kyiv minimal infrequent itemset miner.

It mirrors the reference package ``repro`` module for module and imports
nothing of it, nor of JAX. The row-intersection bottleneck runs in
hand-written CUDA kernels for Hopper (``kernels/intersect/csrc``); every
kernel keeps a plain PyTorch version beside it. Entry points run on the CUDA
card by default (``engine="cuda"``, ``device="cuda"``) and raise when there
is none; the CPU is used only when the caller asks for it.
"""

from .core import KyivConfig, MiningResult, MiningState, mine, mine_preprocessed, prepare

__all__ = ["KyivConfig", "MiningResult", "MiningState", "mine", "mine_preprocessed", "prepare"]
