"""Resident mining service: device-resident dataset store, incremental
append mining, and a request-batched quasi-identifier API.

The one-shot ``repro_torch.core.mine`` answers a single question about a
static table. This package turns the miner into a *service* over a growing
table: ``DatasetStore`` keeps the itemized bitsets live and versioned across
row-block appends (resident on the card once per version),
``mine_incremental`` exploits support monotonicity to re-answer after
appends at delta cost, ``ResultCache``/``RequestScheduler`` make repeat and
concurrent traffic cheap, and ``MiningService`` is the facade the HTTP
endpoint (``repro_torch.launch.serve_miner``) exposes.

The durability layer (``wal.DurableStore``) makes the store survive process
death, ``resilience`` retries device failures behind a circuit breaker (a mine the
card keeps failing is refused with ``DeviceUnavailable``, never answered from
the host), and ``faults`` is the chaos-test injection harness.
"""

from ..sampling import SamplingConfig
from .api import (
    DeadlineExceeded,
    DeviceUnavailable,
    MineResponse,
    MiningService,
    NotReadyError,
)
from .cache import CacheEntry, ResultCache, make_approx_key, make_key
from .faults import DeviceFault, FaultInjector, KillPoint, placement_faults
from .incremental import (
    IncrementalConfig,
    ResultBands,
    delta_support,
    mine_incremental,
)
from .resilience import CircuitBreaker, ResilienceConfig
from .scheduler import RequestScheduler
from .store import DatasetStore
from .wal import DurableStore, WriteAheadLog

__all__ = [
    "CacheEntry",
    "CircuitBreaker",
    "DatasetStore",
    "DeadlineExceeded",
    "DeviceFault",
    "DeviceUnavailable",
    "DurableStore",
    "FaultInjector",
    "IncrementalConfig",
    "KillPoint",
    "MineResponse",
    "MiningService",
    "NotReadyError",
    "RequestScheduler",
    "ResilienceConfig",
    "ResultBands",
    "ResultCache",
    "SamplingConfig",
    "WriteAheadLog",
    "delta_support",
    "make_approx_key",
    "make_key",
    "mine_incremental",
    "placement_faults",
]
