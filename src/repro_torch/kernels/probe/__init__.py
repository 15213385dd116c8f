"""Throughput probes of the card (``csrc/rates.cu``): the measured rates of
32-bit logic, popcount and the binary tensor-core product that price the
AND-popcount kernels' bounds."""

from .rates import KINDS, measure_rate, measure_rates

__all__ = ["KINDS", "measure_rate", "measure_rates"]
