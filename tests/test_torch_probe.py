"""The rate probes' wrapper on the CPU: they run only on a CUDA card, so
here they must refuse, and their source must be built with the others."""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.probe import KINDS, measure_rate, measure_rates


def test_probe_source_is_built_with_the_kernels():
    assert _build.SOURCES["probe"].name == "rates.cu"
    assert _build.SOURCES["probe"].is_file()
    assert set(KINDS) == {"lop3", "popc", "mma_m8n8k128", "mma_m16n8k256"}
    assert sorted(KINDS.values()) == [0, 1, 2, 3]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_probes_refuse_the_cpu(kind):
    with pytest.raises(ValueError):
        measure_rate(kind, torch.device("cpu"))


def test_unknown_probe_and_cpu_sweep_refused():
    with pytest.raises(ValueError):
        measure_rate("fma", "cuda")
    with pytest.raises(ValueError):
        measure_rates("cpu")
