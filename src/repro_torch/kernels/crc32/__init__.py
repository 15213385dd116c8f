"""CRC-32 of a tensor's row-major bytes on the card: the CUDA kernels
(``csrc/crc32.cu``), their launchers and the device-to-host row copy
(``ops``). Their plain version is ``zlib.crc32``."""

from .ops import LAUNCHES, copy_rows, crc32, crc32_launch, reset_launches, rows_view

__all__ = ["LAUNCHES", "copy_rows", "crc32", "crc32_launch", "reset_launches", "rows_view"]
