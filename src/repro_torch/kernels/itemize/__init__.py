"""The item table built on a torch device: the CUDA kernels
(``csrc/itemize.cu``), their launchers and the pass around them (``ops``),
and their plain PyTorch versions (``ref``)."""

from .ops import LAUNCHES, itemize_on_device, reset_launches

__all__ = ["LAUNCHES", "itemize_on_device", "reset_launches"]
