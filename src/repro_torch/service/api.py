"""The resident mining service facade.

``MiningService`` glues the subsystem together into the workflow the paper
motivates (a custodian continuously vetting a growing table):

    service = MiningService.from_dataset(D)   # on the card (engine="cuda")
    service.mine(tau=1, kmax=3)          # cold: preprocess + Algorithm 1
    service.mine(tau=1, kmax=3)          # warm: LRU hit on (version, ...)
    service.append(new_rows)             # itemizes only the block
    service.mine(tau=1, kmax=3)          # incremental: recount + boundary
    service.report(tau=1, kmax=3)        # sdc quasi-identifier summary
    service.risk(tau=1, kmax=3)          # per-record risk (coverage kernels)
    service.anonymize_plan(tau=1)        # verified zero-QI masking plan

Request flow for ``mine``: snapshot the store (atomic version + immutable
table) -> result-cache lookup -> request scheduler (concurrent identical
requests coalesce onto one run) -> incremental delta mine against the
newest cached base for the same parameters, falling back to a cold
``mine_preprocessed`` when the delta invariants don't hold. Preprocessed
tables are themselves cached per ``(version, tau, ordering, seed)`` so a
cold run at a warm version skips §4.1 preprocessing, and all runs share the
process-wide dispatch buckets (``core.exec_cache``).

Placement: like every entry point of this package, a service built with no
engine runs on the CUDA card (``KyivConfig``'s ``engine="cuda"``,
``device="cuda"``) and raises without one; ``engine="torch",
device="cpu"`` or ``engine="numpy"`` serve from the CPU. The store uploads
each version once to the placement's device, cold mines gather their level 1
and incremental mines their seed extensions from that resident tensor, and
``/risk`` and ``/report`` run the coverage kernels on the same device.

Durability (``wal_dir``): appends are WAL-logged before itemization, the
store is snapshotted every ``snapshot_every`` appends, cold mines save a
level checkpoint at every ``job_checkpoint_levels``-th level boundary, and
a service rebuilt over the same directory recovers the store and resumes
the interrupted mine from its newest checkpoint. A black-box flight
recorder under ``wal_dir/flight`` narrates each incarnation, and the next
one parses it into a :class:`~repro_torch.obs.flight.LastCrashReport`.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import threading
import time
from collections import OrderedDict
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np

from ..core.items import ItemTable
from ..core.kyiv import KyivConfig, MiningResult, RunControl, mine_preprocessed
from ..core.placement import is_device_failure, resolve_placement
from ..core.preprocess import preprocess
from ..core import exec_cache
from ..obs import cost as _obs_cost
from ..obs import flight as _obs_flight
from ..obs import metrics as _om
from ..obs.trace import TRACER as _obs_tracer
from ..obs.trace import current_trace_id as _obs_current_trace_id
from ..obs.trace import span as _obs_span
from ..obs.trace import start_trace as _obs_start_trace
from ..distributed.checkpoint import CheckpointManager
from ..kernels.coverage import coverage as _cov_kernels
from ..kernels.intersect import LevelPipeline
from ..kernels.intersect import intersect as _intersect_kernels
from ..kernels.intersect import tiled as _tiled_kernel
from ..sampling import SamplingConfig, build_sample, classify_counts
from ..sampling.refine import recount_supports
from ..sdc.quasi import QuasiIdentifierReport, report_as_dict
from .cache import CacheEntry, ResultCache, make_approx_key, make_key
from .faults import NULL_INJECTOR
from .incremental import IncrementalConfig, ResultBands, mine_incremental
from .resilience import CircuitBreaker, ResilienceConfig
from .scheduler import RequestScheduler
from .store import DatasetStore
from .wal import DurableStore, restricted_loads

__all__ = [
    "MineResponse",
    "MiningService",
    "NotReadyError",
    "DeviceUnavailable",
    "DeadlineExceeded",
]

_PREP_CACHE_CAPACITY = 8

_MINE_REQUESTS = _om.counter(
    "repro_service_mine_requests_total",
    "Answered mine requests by answer source.",
    ("source",),
)
_MINE_LATENCY = _om.histogram(
    "repro_service_mine_latency_seconds",
    "End-to-end mine request latency by answer source.",
    ("source",),
)
_APPENDS = _om.counter(
    "repro_service_appends_total", "Dataset append requests served."
)
_APPENDED_ROWS = _om.counter(
    "repro_service_appended_rows_total", "Rows appended to the store."
)
_PREPROCESS_SECONDS = _om.histogram(
    "repro_service_preprocess_seconds",
    "Cold §4.1 preprocessing time (prep-cache misses only).",
)
_SAMPLING_MINES = _om.counter(
    "repro_sampling_mines_total",
    "Approx mine requests answered, by answer source.",
    ("source",),
)
_SAMPLING_SAMPLE_SECONDS = _om.histogram(
    "repro_sampling_sample_mine_seconds",
    "Sample-mine wall time (sampling + preprocess + level mining).",
)
_SAMPLING_SAMPLE_ROWS = _om.histogram(
    "repro_sampling_sample_rows", "Rows drawn per sample mine."
)
_SAMPLING_BOUNDARY = _om.counter(
    "repro_sampling_boundary_itemsets_total",
    "Sample-mined itemsets classified into the undecidable boundary band.",
)
_SAMPLING_REFINEMENTS = _om.counter(
    "repro_sampling_refinements_total",
    "Background exact refinements, by outcome.",
    ("status",),
)
_SAMPLING_REFINE_SECONDS = _om.histogram(
    "repro_sampling_refine_seconds",
    "Background refinement wall time (boundary recount + exact promotion).",
)


class NotReadyError(RuntimeError):
    """The service is still recovering (WAL replay / job resume, or
    constructed with ``defer_recovery`` and :meth:`MiningService.recover`
    not called yet) — liveness is fine, readiness is not; HTTP maps this
    to 503."""


class DeviceUnavailable(NotReadyError):
    """The card failed a mine on every attempt, or the circuit breaker is
    open. A service placed on a device never answers from the host instead:
    it refuses, and HTTP maps this to 503 with the device's error."""


class DeadlineExceeded(TimeoutError):
    """A coalesced waiter's deadline expired before the shared run finished.
    The run itself keeps going for waiters without a deadline; HTTP maps
    this to 499."""


class _LruCache:
    """Tiny thread-safe LRU for derived privacy payloads (risk profiles and
    anonymization plans), keyed beside the mining result cache on
    ``(kind, version, tau, kmax, ordering)`` — cheap to rebuild relative to
    mining, so it stays separate from (and smaller than) the result LRU."""

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple):
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: tuple, value) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
            }


@dataclasses.dataclass
class MineResponse:
    """One answered mining request."""

    version: int
    tau: int
    kmax: int
    ordering: str
    source: str  # "cache" | "incremental" | "cold"
    latency_s: float
    result: MiningResult
    info: dict

    @property
    def n_itemsets(self) -> int:
        return len(self.result.itemsets)

    def to_json(self, max_itemsets: int | None = None) -> dict:
        sets = self.result.as_value_sets()
        truncated = max_itemsets is not None and len(sets) > max_itemsets
        if truncated:
            sets = sets[:max_itemsets]
        return {
            "version": self.version,
            "tau": self.tau,
            "kmax": self.kmax,
            "ordering": self.ordering,
            "source": self.source,
            "latency_s": self.latency_s,
            "n_itemsets": self.n_itemsets,
            "truncated": truncated,
            "itemsets": [
                {"items": [[int(c), int(v)] for c, v in ids], "count": int(cnt)}
                for ids, cnt in sets
            ],
            "info": self.info,
        }


class MiningService:
    """Thread-safe facade over store + cache + scheduler + miners."""

    def __init__(
        self,
        n_cols: int | None = None,
        *,
        config: KyivConfig | None = None,
        incremental: IncrementalConfig | None = None,
        placement=None,
        cache_capacity: int = 64,
        cache_max_bytes: int | None = None,
        max_workers: int = 1,
        word_tile: int = 8,
        compact_threshold: int | None = None,
        keep_versions: int = 8,
        wal_dir: str | None = None,
        snapshot_every: int = 8,
        job_checkpoint_levels: int = 1,
        deadline_grace_s: float = 2.0,
        fault_injector=None,
        resilience: ResilienceConfig | None = None,
        defer_recovery: bool = False,
        profile_dir: str | None = None,
        sampling: SamplingConfig | None = None,
        slow_mine_threshold_s: float = 1.0,
        slow_log_size: int = 64,
        flight_enabled: bool = True,
        flight_fsync_s: float = 0.25,
        flight_max_bytes: int = 1 << 20,
        **config_kw,
    ):
        self.config = config or KyivConfig(**config_kw)
        if placement is not None:
            self.config = dataclasses.replace(self.config, placement=placement)
        # one resolved placement per service: the store tiles its words for
        # it and every mining request's LevelPipeline dispatches through it
        self.placement = resolve_placement(self.config)
        self.config = dataclasses.replace(self.config, placement=self.placement)
        self.incremental = incremental or IncrementalConfig()
        self.word_tile = word_tile
        self._store_kw = dict(
            word_tile=word_tile,
            placement=self.placement,
            compact_threshold=compact_threshold,
            keep_versions=keep_versions,
            # fleet placements carry (pid, nproc): the store keeps only this
            # process's word stripes and global padding stays process-invariant
            shard=getattr(self.placement, "shard", None),
        )
        # sites: ``wal.append`` (the durable store), ``mine.level_end`` (after
        # each level checkpoint of a durable cold mine); device faults go
        # through ``faults.placement_faults`` and the placement's hook
        self.injector = fault_injector or NULL_INJECTOR
        self.resilience = resilience or ResilienceConfig()
        self.breaker = CircuitBreaker(
            self.resilience.failure_threshold, self.resilience.cooldown_s
        )
        self.wal_dir = wal_dir
        self.job_checkpoint_levels = max(1, int(job_checkpoint_levels))
        self.deadline_grace_s = deadline_grace_s
        # forensics: parse the *previous* incarnation's flight ring into a
        # LastCrashReport before opening this incarnation's (which reaps the
        # old segment files), then hook the recorder into the tracer and the
        # breaker. No wal_dir -> no ring (the recorder is crash forensics;
        # an in-memory service has nothing to survive into).
        self.slowlog = _obs_cost.SlowMineLog(slow_mine_threshold_s, slow_log_size)
        self.flight: _obs_flight.FlightRecorder | None = None
        self.last_crash: _obs_flight.LastCrashReport | None = None
        if wal_dir is not None and flight_enabled:
            flight_dir = os.path.join(wal_dir, "flight")
            self.last_crash = _obs_flight.recover(flight_dir)
            self.flight = _obs_flight.FlightRecorder(
                flight_dir,
                fsync_interval_s=flight_fsync_s,
                max_bytes=flight_max_bytes,
            )
            _obs_tracer.add_listener(self.flight.span_listener)
            self.breaker.on_transition = (
                lambda state: self._flight_record("breaker.transition", state=state)
            )
        self._durable: DurableStore | None = (
            DurableStore(
                wal_dir,
                snapshot_every=snapshot_every,
                injector=self.injector,
                recorder=self.flight,
                **self._store_kw,
            )
            if wal_dir is not None
            else None
        )
        self._store: DatasetStore | None = (
            DatasetStore(n_cols, **self._store_kw)
            if n_cols and self._durable is None
            else None
        )
        self.cache = ResultCache(cache_capacity, max_bytes=cache_max_bytes)
        self.scheduler = RequestScheduler(max_workers=max_workers)
        self._preps: "OrderedDict[tuple, object]" = OrderedDict()
        self._privacy = _LruCache()
        self._last_mine_timing: dict | None = None
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._controls: dict[tuple, RunControl] = {}
        self._recovery_info: dict | None = None
        self._drain_info: dict | None = None
        self.served = 0
        self.device_retries = 0
        self.unavailable_mines = 0
        self.resumed_jobs = 0
        self.sampling = sampling or SamplingConfig()
        # plain-int counters + a last-request snapshot dict: written under
        # self._lock, read lock-free by /stats and the scrape collector
        self._sampling_stats = {
            "approx_served": 0,
            "sampled_mines": 0,
            "refinements": 0,
            "refine_failures": 0,
            "last": None,
        }
        self.profile_dir = profile_dir
        # scrape-time mirror of the component stats dicts into the one
        # registry; named, so the newest service instance owns the slot
        self._collector_fn = self._collect_metrics
        _om.REGISTRY.register_collector("service", self._collector_fn)
        exec_cache.publish_metrics()
        if self.flight is not None:
            # first durable event: the resolved config this incarnation runs
            # with — the postmortem's "what was it configured to do"
            self.flight.record("config", config=self._resolved_config())
            if self.last_crash is not None and not self.last_crash.clean_shutdown:
                from ..obs import logs as _obs_logs

                _obs_logs.get_logger("repro_torch.service").warning(
                    "previous incarnation died uncleanly: %d open span(s), "
                    "last checkpointed level %s — GET /debug/lastcrash for "
                    "the full report",
                    len(self.last_crash.open_spans),
                    (self.last_crash.last_checkpoint or {}).get("level"),
                )
        if not defer_recovery:
            self.recover()

    def _flight_record(self, kind: str, **fields) -> None:
        if self.flight is not None:
            self.flight.record(kind, **fields)

    def _account_cost(
        self,
        env: _obs_cost.CostEnvelope,
        source: str,
        version: int,
        tau: int,
        kmax: int,
        latency: float,
    ) -> dict:
        """Finish a request's envelope: stamp the serving path, publish the
        per-path cost histograms (trace_id as exemplar) and offer the entry
        to the slow-mine log. Returns the ``info.cost`` dict."""
        env.note(path=source, version=int(version))
        env.finish()
        env.wall_s = latency
        _obs_cost.publish(env)
        self.slowlog.offer(env, tau=int(tau), kmax=int(kmax))
        return env.to_dict()

    def _resolved_config(self) -> dict:
        """The effective configuration this incarnation serves with — the
        flight ring's startup event and the debug bundle's config section."""
        cfg = {
            f.name: getattr(self.config, f.name)
            for f in dataclasses.fields(self.config)
        }
        cfg["placement"] = self.placement.kind
        return {
            "mining": cfg,
            "wal_dir": self.wal_dir,
            "job_checkpoint_levels": self.job_checkpoint_levels,
            "deadline_grace_s": self.deadline_grace_s,
            "cache": {
                "capacity": self.cache.capacity,
                "max_bytes": self.cache.max_bytes,
            },
            "resilience": {
                "max_retries": self.resilience.max_retries,
                "failure_threshold": self.resilience.failure_threshold,
                "cooldown_s": self.resilience.cooldown_s,
            },
            "sampling": {
                "epsilon": self.sampling.epsilon,
                "delta": self.sampling.delta,
                "seed": self.sampling.seed,
            },
            "slow_mine_threshold_s": self.slowlog.threshold_s,
            "flight": (
                {
                    "fsync_interval_s": self.flight.fsync_interval_s,
                    "max_bytes": self.flight.max_bytes,
                    "incarnation": self.flight.incarnation,
                }
                if self.flight is not None
                else None
            ),
        }

    @classmethod
    def from_dataset(cls, dataset: np.ndarray, **kw) -> "MiningService":
        dataset = np.asarray(dataset)
        service = cls(dataset.shape[1], **kw)
        service.append(dataset)
        return service

    # -- readiness / recovery ------------------------------------------------

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def readiness(self) -> tuple[bool, str]:
        """(ready, reason). Not ready while recovering, and while the
        circuit breaker is open (mines are refused with
        :class:`DeviceUnavailable` until a probe after the cooldown
        succeeds)."""
        if not self._ready.is_set():
            return False, "recovering"
        if self.breaker.state == "open":
            return False, "circuit_breaker_open"
        return True, "ok"

    def _require_ready(self) -> None:
        if not self._ready.is_set():
            raise NotReadyError("service is recovering — retry shortly")

    def recover(self) -> dict | None:
        """Replay durability state (WAL + snapshots), resume interrupted
        mine jobs, then flip ready. Without a ``wal_dir`` this just marks
        the service ready."""
        info = None
        if self._durable is not None:
            info = self._durable.recover()
            with self._lock:
                self._store = self._durable.store
            info["resumed_jobs"] = self._resume_jobs()
            self._recovery_info = info
        self._ready.set()
        return info

    # -- store --------------------------------------------------------------

    @property
    def store(self) -> DatasetStore:
        if self._store is None:
            raise RuntimeError("service has no data yet — append rows first")
        return self._store

    def append(self, rows: np.ndarray) -> dict:
        self._require_ready()
        rows = np.asarray(rows)
        if rows.ndim == 1:
            rows = rows[None, :]
        with _obs_span("service.append", rows=int(rows.shape[0])):
            if self._durable is not None:
                version = self._durable.append(rows)
                with self._lock:
                    self._store = self._durable.store
            else:
                with self._lock:
                    if self._store is None:
                        self._store = DatasetStore(rows.shape[1], **self._store_kw)
                version = self.store.append(rows)
        _APPENDS.inc()
        _APPENDED_ROWS.inc(int(rows.shape[0]))
        return {
            "version": version,
            "appended": int(rows.shape[0]),
            "n_rows": self.store.n_rows,
            "n_items": self.store.n_items,
        }

    # -- mining -------------------------------------------------------------

    def _request_config(self, tau: int, kmax: int, ordering: str) -> KyivConfig:
        return dataclasses.replace(
            self.config, tau=tau, kmax=kmax, ordering=ordering
        )

    def _prep_for(self, version: int, table: ItemTable, config: KyivConfig):
        key = (version, config.tau, config.ordering, config.seed)
        with self._lock:
            prep = self._preps.get(key)
            if prep is not None:
                self._preps.move_to_end(key)
                return prep
        t0 = time.perf_counter()
        with _obs_span("mine.preprocess", version=version, tau=config.tau):
            prep = preprocess(
                table, config.tau, ordering=config.ordering, seed=config.seed
            )
        _PREPROCESS_SECONDS.observe(time.perf_counter() - t0)
        with self._lock:
            self._preps[key] = prep
            while len(self._preps) > _PREP_CACHE_CAPACITY:
                self._preps.popitem(last=False)
        return prep

    def _warm_pipeline_factory(self, version: int, prep, config: KyivConfig):
        """Level-pipeline factory backed by the store's per-version resident
        bitsets: level 1 becomes a device-side gather of the placed tensor
        instead of a fresh host->device transfer per request. Returns None
        (the default pipeline) for the host placement or when appends already
        moved the store past ``version``.

        The gather (``placement.take_rows``) runs where the resident rows
        live, on their own device (the scheduler's worker threads carry no
        current-device setting). Its rows keep the store's padded word axis,
        so every pipeline gets the table's logical ``n_words`` to strip on
        host views."""
        placement = self.placement
        if placement.kind == "host":
            return None
        dev = self.store.device_bits(version)
        if dev is None:
            return None
        l_bits_dev = placement.take_rows(dev, prep.l_items)
        n_words = int(prep.l_bits.shape[1])

        def factory(bits, counts, tau):
            if bits is prep.l_bits:  # level 1: the resident gather, bit-equal
                bits = l_bits_dev
            return LevelPipeline(
                bits,
                counts,
                tau=tau,
                placement=placement,
                fused_classify=config.fused_classify,
                locality_sort=config.locality_sort,
                n_words=n_words,
            )

        return factory

    # -- resumable jobs ------------------------------------------------------

    def _job_manager(self, key: tuple) -> CheckpointManager | None:
        """Per-(version, tau, kmax, ordering) mid-run checkpoint manager —
        only when the service is durable (a crash-only concern)."""
        if self._durable is None:
            return None
        version, tau, kmax, ordering = key
        name = f"v{version}_t{tau}_k{kmax}_{ordering}"
        return CheckpointManager(
            os.path.join(self.wal_dir, "jobs", name), keep=2
        )

    def _resume_jobs(self) -> int:
        """Re-issue mine runs that had level checkpoints when the process
        died. Jobs at a stale store version are dropped (their answer is no
        longer the current-version answer anyone will ask for)."""
        jobs_root = os.path.join(self.wal_dir, "jobs")
        if not os.path.isdir(jobs_root):
            return 0
        resumed = 0
        current = self._store.version if self._store is not None else 0
        for name in sorted(os.listdir(jobs_root)):
            try:
                vs, ts, ks, ordering = name.split("_", 3)
                version, tau, kmax = int(vs[1:]), int(ts[1:]), int(ks[1:])
            except (ValueError, IndexError):
                continue
            mgr = CheckpointManager(os.path.join(jobs_root, name), keep=2)
            if version != current or mgr.latest_step() is None:
                mgr.destroy()
                continue
            snap_version, table = self.store.snapshot()
            if snap_version != version:
                mgr.destroy()
                continue
            key = make_key(version, tau, kmax, ordering)
            self.scheduler.submit(key, lambda k=key, t=table: self._compute(k, t))
            resumed += 1
        self.resumed_jobs += resumed
        return resumed

    @staticmethod
    def _restore_job(mgr: CheckpointManager):
        """The newest level checkpoint's ``MiningState``, or None. A blob
        that does not load (a corrupt step, or one naming another package's
        classes, such as the reference's) drops the job: the mine runs cold
        and never imports what the blob names."""
        try:
            state_tree, _meta = mgr.restore()
            if state_tree is None:
                return None
            return restricted_loads(
                np.asarray(state_tree["state"], dtype=np.uint8).tobytes()
            )
        except Exception:
            mgr.destroy()
            return None

    def _mine_cold(
        self,
        key: tuple,
        table: ItemTable,
        config: KyivConfig,
        control: RunControl | None,
    ) -> tuple[MiningResult, dict]:
        """Cold mine with device retries behind the circuit breaker, and
        (when durable) level checkpoints for resume. Only
        :func:`is_device_failure` errors retry; when the retries run out, or
        the breaker is open, the mine is refused with
        :class:`DeviceUnavailable` (never answered from the host). A kernel
        build failure or any other error propagates."""
        version, tau, kmax, ordering = key
        t0 = time.perf_counter()
        prep = self._prep_for(version, table, config)
        info: dict = {"n_rows": table.n_rows, "n_items": table.n_items,
                      "prepare_s": time.perf_counter() - t0}

        mgr = self._job_manager(key)
        on_level_end = None
        resume_state = None
        if mgr is not None:
            resume_state = self._restore_job(mgr)
            if resume_state is not None:
                info["resumed_from_level"] = int(resume_state.next_k)

            def on_level_end(level, state, _mgr=mgr):
                if level % self.job_checkpoint_levels == 0:
                    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
                    _mgr.save(
                        level,
                        {"state": np.frombuffer(blob, dtype=np.uint8)},
                        blocking=True,
                    )
                    # durable flight event — its inline fsync also carries
                    # every buffered span-open to disk, so a death right
                    # after the checkpoint still yields a ring that names
                    # the in-flight level
                    self._flight_record(
                        "job.checkpoint", level=int(level), key=list(key)
                    )
                # the kill-mid-mine seam fires *after* the save — simulated
                # death leaves the checkpoint the restart resumes from
                self.injector.check("mine.level_end")

        def mine_run(factory):
            return mine_preprocessed(
                prep, config, pipeline_factory=factory, on_level_end=on_level_end,
                resume_state=resume_state, control=control,
            )

        def run(factory):
            if self.profile_dir:
                # opt-in device profiling: a torch.profiler Chrome trace per
                # cold mine lands under profile_dir, and the repro_profile_*
                # gauges record the run
                from ..obs import profile as obs_profile

                device = getattr(self.placement, "device", None)
                with obs_profile.profile(self.profile_dir, device=device) as prof:
                    result = mine_run(factory)
                    prof.set_result(result)
                info["profile_trace"] = prof.trace_path
                info["profile_s"] = {"start": prof.start_s,
                                     "mine": prof.wall_s - prof.start_s,
                                     "export": prof.export_s}
                if prof.error is not None:
                    info["profile_error"] = prof.error
                return result
            return mine_run(factory)

        if self.placement.kind == "host":
            result = run(None)
        else:
            if not self.breaker.allow():
                self._refuse("the circuit breaker is open after repeated device failures")
            delay = self.resilience.backoff_s
            attempt = 0
            while True:
                try:
                    result = run(self._warm_pipeline_factory(version, prep, config))
                    self.breaker.record_success()
                    break
                except Exception as exc:
                    if not is_device_failure(exc):
                        raise
                    self._flight_record(
                        "dispatch.failure",
                        error=f"{type(exc).__name__}: {exc}",
                        attempt=attempt,
                        key=list(key),
                    )
                    self.breaker.record_failure()
                    attempt += 1
                    if attempt > self.resilience.max_retries or not self.breaker.allow():
                        self._refuse(f"the mine failed on the device {attempt} time(s): "
                                     f"{type(exc).__name__}: {exc}", exc)
                    self.device_retries += 1
                    self.resilience.sleep(delay)
                    delay *= 2
        if mgr is not None:
            # run finished (complete or deliberately interrupted) — resume
            # state is only for crashes, which never reach this line
            mgr.destroy()
        return result, info

    def _refuse(self, reason: str, cause: BaseException | None = None) -> None:
        with self._lock:
            self.unavailable_mines += 1
        raise DeviceUnavailable(f"device unavailable: {reason}") from cause

    def _compute(
        self, key: tuple, table: ItemTable, control: RunControl | None = None
    ) -> CacheEntry:
        # a coalesced predecessor may have finished between the caller's
        # cache miss and this run being scheduled
        entry = self.cache.get(key)
        if entry is not None:
            return entry
        version, tau, kmax, ordering = key
        config = self._request_config(tau, kmax, ordering)
        if control is not None:
            with self._lock:
                self._controls[key] = control
        # compile-vs-reuse attribution: the envelope rode the context copy
        # into this worker thread (same object the submitter holds)
        _env = _obs_cost.current()
        _xs0 = exec_cache.stats() if _env is not None else None
        try:
            # the incremental path dispatches through the device placement;
            # with the breaker open it would fail the same way the cold path
            # just did, so go straight to the cold path, which refuses
            base = (
                self.cache.latest_base(tau, kmax, ordering, version)
                if self.placement.kind == "host" or self.breaker.allow()
                else None
            )
            if base is not None:
                try:
                    with _obs_span("mine.incremental", base_version=base.version):
                        inc = mine_incremental(
                            self.store,
                            base.result,
                            base.version,
                            config,
                            self.incremental,
                            table=table,
                            # seed expansion runs through this service's
                            # placement, over the store's resident bitsets
                            # (None -> the host snapshot; bit-identical
                            # either way). Host placements skip the resident
                            # copy entirely.
                            placement=self.placement,
                            resident_bits=(
                                self.store.device_bits(version)
                                if self.placement.kind != "host"
                                and self.incremental.enabled
                                else None
                            ),
                            # count-sorted recount companion persisted with
                            # the base entry: recounting touches only the
                            # near-boundary band, not all cached itemsets
                            bands=base.bands,
                        )
                except Exception as exc:
                    if not is_device_failure(exc):
                        raise
                    self._flight_record(
                        "dispatch.failure",
                        error=f"{type(exc).__name__}: {exc}",
                        site="incremental",
                        key=list(key),
                    )
                    # the cold path retries on the device, then refuses
                    self.breaker.record_failure()
                    inc = None
                if inc is not None:
                    result, info = inc
                    if _env is not None:
                        # the delta path never enters mine_levels, so fold
                        # its own work shape into the envelope: recounts
                        # scan the delta rows, seed expansion the full table
                        _env.add(
                            levels=len(result.stats),
                            rows_scanned=(
                                info["delta_rows"] * info["n_recounted"]
                                + result.prep.table.n_rows
                                * info["n_expanded"]
                            ),
                            candidate_pairs=info["n_seeds"],
                            itemsets_emitted=len(result.itemsets),
                        )
                    entry = CacheEntry(
                        key=key,
                        result=result,
                        source="incremental",
                        info=info,
                        bands=ResultBands.from_result(result.itemsets),
                    )
                    self.cache.put(entry)
                    return entry

            # the request key rides the span's *open* attrs so the flight
            # ring can name the active requests at death
            with _obs_span("mine.cold", version=version, key=list(key)):
                result, info = self._mine_cold(key, table, config, control)
            # per-level host-busy vs device-busy split of the last cold run —
            # the /stats view of what the device frontier buys per level
            self._last_mine_timing = {
                "version": version,
                "tau": tau,
                "kmax": kmax,
                "wall_time": result.wall_time,
                "levels": result.timing_breakdown(),
            }
            if not result.completed:
                # valid-but-incomplete answer: hand it to this run's waiters,
                # never cache it and never let the incremental miner build on it
                info["interrupted"] = result.interrupted
                return CacheEntry(key=key, result=result, source="partial", info=info)
            entry = CacheEntry(
                key=key,
                result=result,
                source="cold",
                info=info,
                bands=ResultBands.from_result(result.itemsets),
            )
            self.cache.put(entry)
            return entry
        finally:
            if _env is not None and _xs0 is not None:
                _xs1 = exec_cache.stats()
                _env.add(
                    executables_compiled=max(
                        0, _xs1.get("misses", 0) - _xs0.get("misses", 0)
                    ),
                    executables_reused=max(
                        0, _xs1.get("hits", 0) - _xs0.get("hits", 0)
                    ),
                )
            if control is not None:
                with self._lock:
                    self._controls.pop(key, None)

    def cancel(self, tau: int, kmax: int, ordering: str = "ascending") -> dict:
        """Cancel in-flight runs matching ``(tau, kmax, ordering)`` at any
        version. The run stops at its next batch boundary and its waiters
        receive the partial result."""
        cancelled = 0
        with self._lock:
            for key, ctrl in self._controls.items():
                if key[1:] == (int(tau), int(kmax), str(ordering)):
                    ctrl.cancel()
                    cancelled += 1
        return {"cancelled": cancelled}

    def mine(
        self,
        tau: int = 1,
        kmax: int = 3,
        ordering: str = "ascending",
        deadline_s: float | None = None,
        mode: str = "exact",
        epsilon: float | None = None,
    ) -> MineResponse:
        if mode not in ("exact", "approx"):
            raise ValueError(f"mode must be 'exact' or 'approx', got {mode!r}")
        if mode == "approx":
            return self._mine_approx(
                tau, kmax, ordering, deadline_s,
                self.sampling.epsilon if epsilon is None else float(epsilon),
            )
        self._require_ready()
        t0 = time.perf_counter()
        # root of the request's span tree when called directly; a child span
        # when the HTTP layer (or a planner re-mine) already opened a trace.
        # The cost envelope binds alongside it: the scheduler's context copy
        # carries the same object into the worker, so the level loop's
        # counters land here no matter which thread mines.
        with _obs_start_trace(
            "service.mine", meta={"tau": int(tau), "kmax": int(kmax)}
        ) as _tsp, _obs_cost.attach() as _cenv:
            _cenv.note(trace_id=_obs_current_trace_id())
            # warm path first: a version read + dict lookup, no snapshot copy
            version = self.store.version
            key = make_key(version, tau, kmax, ordering)
            entry = self.cache.get(key)
            source = "cache"
            if entry is None:
                # miss: take the immutable snapshot the computation will run
                # on (its version may have advanced past the first read)
                version, table = self.store.snapshot()
                key = make_key(version, tau, kmax, ordering)
                control = (
                    RunControl.with_timeout(deadline_s)
                    if deadline_s is not None
                    else RunControl()
                )
                future = self.scheduler.submit(
                    key, lambda: self._compute(key, table, control)
                )
                if deadline_s is None:
                    entry = future.result()
                else:
                    # if this request coalesced onto an earlier run, that
                    # run's control (not ours) governs it — bound the wait:
                    # the run stops within one batch of *its* deadline, and a
                    # deadline-free run releases us with DeadlineExceeded
                    try:
                        entry = future.result(
                            timeout=deadline_s + self.deadline_grace_s
                        )
                    except FutureTimeoutError:
                        _MINE_REQUESTS.inc(source="deadline")
                        raise DeadlineExceeded(
                            f"mine(tau={tau}, kmax={kmax}) exceeded "
                            f"{deadline_s}s"
                        ) from None
                source = entry.source
            self.served += 1
            latency = time.perf_counter() - t0
            _tsp.set(source=source, version=version)
            _MINE_REQUESTS.inc(source=source)
            info = dict(entry.info)
            info["cost"] = self._account_cost(
                _cenv, source, version, tau, kmax, latency
            )
            _MINE_LATENCY.observe(
                latency,
                exemplar=(
                    {"trace_id": _cenv.trace_id} if _cenv.trace_id else None
                ),
                source=source,
            )
            return MineResponse(
                version=version,
                tau=tau,
                kmax=kmax,
                ordering=ordering,
                source=source,
                latency_s=latency,
                result=entry.result,
                info=info,
            )

    # -- sampled (approximate) mining ---------------------------------------

    def _mine_approx(
        self,
        tau: int,
        kmax: int,
        ordering: str,
        deadline_s: float | None,
        epsilon: float,
    ) -> MineResponse:
        """The ε-confident fast path: mine a deterministic uniform sample,
        answer immediately with per-itemset confidence, and schedule a
        background refinement that recounts the boundary band and promotes
        the cache entry to the exact answer."""
        self._require_ready()
        if not (0.0 < epsilon < 1.0):
            raise ValueError(f"epsilon must be in (0, 1), got {epsilon}")
        t0 = time.perf_counter()
        with _obs_start_trace(
            "service.mine",
            meta={"tau": int(tau), "kmax": int(kmax), "mode": "approx"},
        ) as _tsp, _obs_cost.attach() as _cenv:
            _cenv.note(trace_id=_obs_current_trace_id())
            version = self.store.version
            akey = make_approx_key(version, tau, kmax, ordering, epsilon)
            entry = self.cache.get(akey)
            if entry is None:
                # an already-promoted exact answer at this version is
                # strictly better than re-sampling — serve it as-is
                entry = self.cache.get(make_key(version, tau, kmax, ordering))
            source = "cache"
            if entry is None:
                version, table = self.store.snapshot()
                akey = make_approx_key(version, tau, kmax, ordering, epsilon)
                future = self.scheduler.submit(
                    akey, lambda: self._compute_approx(akey, table)
                )
                if deadline_s is None:
                    entry = future.result()
                else:
                    try:
                        entry = future.result(
                            timeout=deadline_s + self.deadline_grace_s
                        )
                    except FutureTimeoutError:
                        _SAMPLING_MINES.inc(source="deadline")
                        raise DeadlineExceeded(
                            f"mine(tau={tau}, kmax={kmax}, mode=approx) "
                            f"exceeded {deadline_s}s"
                        ) from None
                source = entry.source
            self.served += 1
            with self._lock:
                self._sampling_stats["approx_served"] += 1
            latency = time.perf_counter() - t0
            _tsp.set(source=source, version=version, mode="approx")
            _MINE_REQUESTS.inc(source="approx")
            _SAMPLING_MINES.inc(source=source)
            _MINE_LATENCY.observe(
                latency,
                exemplar=(
                    {"trace_id": _cenv.trace_id} if _cenv.trace_id else None
                ),
                source="approx",
            )
            info = dict(entry.info)
            info["cost"] = self._account_cost(
                _cenv,
                "approx" if source not in ("cache", "refined") else source,
                version, tau, kmax, latency,
            )
            if "mode" not in info:
                # exact entry answering an approx request: full confidence
                info.update(
                    mode="approx", epsilon=float(epsilon), confidence=1.0,
                    boundary_count=0, refined=True,
                )
            return MineResponse(
                version=version,
                tau=tau,
                kmax=kmax,
                ordering=ordering,
                source=source,
                latency_s=latency,
                result=entry.result,
                info=info,
            )

    def _compute_approx(self, key: tuple, table: ItemTable) -> CacheEntry:
        """Sample-mine one snapshot (scheduler-side of an approx request).

        Mines the ε-sized sample with the standard level pipeline (same
        placement/engine as exact requests — the sampled table's word axis
        is padded for it), classifies every emitted itemset into certain
        vs boundary, caches the scaled-estimate answer under the approx
        key, and schedules the background refinement under the *exact* key
        so concurrent exact requests coalesce onto the promotion run."""
        entry = self.cache.get(key)
        if entry is not None:
            return entry
        version, tau, kmax, ordering = key[0], key[1], key[2], key[3]
        epsilon = float(key[5])
        t0 = time.perf_counter()
        with _obs_span(
            "mine.sample", version=version, tau=int(tau), epsilon=epsilon
        ):
            plan = build_sample(
                table,
                version=version,
                tau=tau,
                epsilon=epsilon,
                config=self.sampling,
                word_tile=int(getattr(self.placement, "store_word_tile", 1) or 1),
            )
            config = dataclasses.replace(
                self._request_config(tau, kmax, ordering), tau=plan.tau_sample
            )
            prep = preprocess(
                plan.table, plan.tau_sample, ordering=ordering, seed=config.seed
            )
            sample_result = mine_preprocessed(prep, config)
            raw = np.asarray(
                [cnt for _, cnt in sample_result.itemsets], dtype=np.int64
            )
            est, boundary = classify_counts(
                raw,
                tau=int(tau),
                epsilon=epsilon,
                n_rows=plan.n_rows_full,
                n_sample=int(plan.rows.shape[0]),
            )
            itemsets = [
                (ids, int(e))
                for (ids, _), e in zip(sample_result.itemsets, est)
            ]
            boundary_sets = [
                ids
                for (ids, _), b in zip(sample_result.itemsets, boundary)
                if b
            ]
            result = dataclasses.replace(sample_result, itemsets=itemsets)
            n_total = len(itemsets)
            info = {
                "mode": "approx",
                "epsilon": epsilon,
                "confidence": (
                    1.0 if not n_total
                    else (n_total - len(boundary_sets)) / n_total
                ),
                "boundary_count": len(boundary_sets),
                "seed": plan.seed,
                "sample_rows": int(plan.rows.shape[0]),
                "n_rows": plan.n_rows_full,
                "tau_sample": plan.tau_sample,
                "scale": plan.scale,
                "refined": False,
            }
            entry = CacheEntry(key=key, result=result, source="approx", info=info)
            self.cache.put(entry)
        sample_s = time.perf_counter() - t0
        _SAMPLING_SAMPLE_SECONDS.observe(sample_s)
        _SAMPLING_SAMPLE_ROWS.observe(int(plan.rows.shape[0]))
        _SAMPLING_BOUNDARY.inc(len(boundary_sets))
        with self._lock:
            ss = self._sampling_stats
            ss["sampled_mines"] += 1
            ss["last"] = {
                "version": int(version),
                "tau": int(tau),
                "kmax": int(kmax),
                "epsilon": epsilon,
                "seed": plan.seed,
                "sample_rows": int(plan.rows.shape[0]),
                "boundary_count": len(boundary_sets),
                "confidence": info["confidence"],
                "sample_mine_s": sample_s,
            }
        ekey = make_key(version, tau, kmax, ordering)
        self.scheduler.submit(
            ekey, lambda: self._refine(key, ekey, table, boundary_sets)
        )
        return entry

    def _refine(
        self,
        akey: tuple,
        ekey: tuple,
        table: ItemTable,
        boundary_sets: list[tuple[int, ...]],
    ) -> CacheEntry:
        """Background refinement of one approx answer, in two stages.

        Stage 1 recounts the boundary band exactly against the full table
        (``sampling.refine``) and
        re-caches the approx entry with those counts resolved. Stage 2
        promotes to the bit-exact answer through the standard ``_compute``
        path, so job checkpoints, device retries and request coalescing
        all apply — a crash mid-promotion leaves a level checkpoint that
        restart recovery resumes. Runs under the exact
        cache key: concurrent exact requests coalesce onto this run and
        receive the returned exact entry."""
        version, tau, kmax, ordering = ekey
        t0 = time.perf_counter()
        status = "ok"
        try:
            with _obs_span(
                "mine.refine",
                version=int(version),
                tau=int(tau),
                boundary=len(boundary_sets),
            ):
                base = self.cache.get(akey)
                if boundary_sets and base is not None:
                    counts, rinfo = recount_supports(
                        table,
                        boundary_sets,
                        placement=self.placement,
                        tau=int(tau),
                        fused_classify=self.config.fused_classify,
                    )
                    exact_of = dict(
                        zip(boundary_sets, (int(c) for c in counts))
                    )
                    kept = []
                    for ids, est in base.result.itemsets:
                        exact = exact_of.get(ids)
                        if exact is None:
                            kept.append((ids, est))
                        elif exact <= tau:
                            kept.append((ids, exact))
                        # else: boundary itemset proven frequent — drop it
                    result = dataclasses.replace(base.result, itemsets=kept)
                    info = dict(
                        base.info,
                        boundary_count=0,
                        recount=rinfo,
                        refined="recount",
                    )
                    self.cache.put(
                        CacheEntry(
                            key=akey, result=result, source="approx", info=info
                        )
                    )
                entry = self._compute(ekey, table)
                if entry.source != "partial":
                    base = self.cache.get(akey)
                    info = dict(
                        base.info if base is not None else {},
                        confidence=1.0,
                        boundary_count=0,
                        refined=True,
                        promoted=True,
                    )
                    self.cache.put(
                        CacheEntry(
                            key=akey,
                            result=entry.result,
                            source="refined",
                            info=info,
                        )
                    )
                return entry
        except BaseException:
            status = "error"
            raise
        finally:
            _SAMPLING_REFINEMENTS.inc(status=status)
            _SAMPLING_REFINE_SECONDS.observe(time.perf_counter() - t0)
            with self._lock:
                self._sampling_stats["refinements"] += 1
                if status == "error":
                    self._sampling_stats["refine_failures"] += 1

    # -- reports ------------------------------------------------------------

    def _risk_profile_for(self, resp: MineResponse) -> tuple[object, str]:
        """The response's record-risk profile, via the privacy LRU; returns
        ``(profile, source)`` where source is "privacy-cache" on a hit."""
        from ..privacy.risk import risk_profile

        key = ("risk", resp.version, resp.tau, resp.kmax, resp.ordering)
        profile = self._privacy.get(key)
        if profile is not None:
            return profile, "privacy-cache"
        store = self.store
        profile = risk_profile(
            resp.result,
            placement=self.placement,
            # process-sharded store: the coverage accumulator is local-width;
            # the fleet placement scatters it to global rows via this map
            word_map=store.word_map() if store.shard[1] > 1 else None,
        )
        self._privacy.put(key, profile)
        return profile, resp.source

    def report(
        self,
        tau: int = 1,
        kmax: int = 3,
        ordering: str = "ascending",
    ) -> dict:
        """Quasi-identifier report (sdc.quasi) over the current version,
        served from the result cache when warm (the record-risk fields reuse
        the privacy LRU's profile rather than re-running the coverage
        kernels)."""
        resp = self.mine(tau=tau, kmax=kmax, ordering=ordering)
        profile, _ = self._risk_profile_for(resp)
        rep = QuasiIdentifierReport(
            result=resp.result, tau=tau, kmax=kmax, _profile=profile
        )
        out = report_as_dict(rep)
        out.update(version=resp.version, source=resp.source, latency_s=resp.latency_s)
        return out

    # -- privacy risk engine -------------------------------------------------

    def risk(
        self,
        tau: int = 1,
        kmax: int = 3,
        ordering: str = "ascending",
        *,
        top: int = 10,
    ) -> dict:
        """Record-level risk profile of the current version (coverage kernels
        over the resident bitsets), cached per (version, tau, kmax) beside
        the result LRU."""
        t0 = time.perf_counter()
        resp = self.mine(tau=tau, kmax=kmax, ordering=ordering)
        profile, source = self._risk_profile_for(resp)
        out = profile.summary(top=top)
        out.update(
            version=resp.version,
            source=source,
            latency_s=time.perf_counter() - t0,
        )
        return out

    def anonymize_plan(
        self,
        tau: int = 1,
        kmax: int = 3,
        ordering: str = "ascending",
        *,
        max_rounds: int = 12,
        max_suppressions: int | None = 200,
    ) -> dict:
        """Verified masking plan (zero residual quasi-identifiers) for the
        current version. The table is reconstructed from the resident item
        bitsets; the planner's verification re-mines reuse this service's
        placement and warm executable buckets."""
        from ..privacy.planner import plan_anonymization

        t0 = time.perf_counter()
        resp = self.mine(tau=tau, kmax=kmax, ordering=ordering)
        key = ("plan", resp.version, tau, kmax, ordering, max_rounds)
        plan = self._privacy.get(key)
        source = "privacy-cache"
        if plan is None:
            dataset = resp.result.prep.table.to_dataset()
            plan = plan_anonymization(
                dataset,
                tau=tau,
                kmax=kmax,
                config=self._request_config(tau, kmax, ordering),
                max_rounds=max_rounds,
                base_result=resp.result,
            )
            self._privacy.put(key, plan)
            source = resp.source
        out = plan.as_dict(max_suppressions=max_suppressions)
        out.update(
            version=resp.version,
            source=source,
            latency_s=time.perf_counter() - t0,
        )
        return out

    # -- forensics ----------------------------------------------------------

    def last_crash_report(self) -> dict | None:
        """The previous incarnation's parsed flight ring (``None`` on first
        boot or without a flight recorder) — ``GET /debug/lastcrash``."""
        return self.last_crash.to_dict() if self.last_crash is not None else None

    def slowlog_entries(self, n: int | None = None) -> list[dict]:
        """Newest-first slow-mine envelopes — ``GET /debug/slowlog``."""
        return self.slowlog.entries(n)

    def debug_bundle(self) -> dict:
        """One-shot postmortem snapshot — ``GET /debug/bundle`` (gzipped).

        Privacy: carries no row data — itemset ids, counters and timings
        only (same exposure as /metrics + /trace + /stats).
        """
        return {
            "generated_at": time.time(),
            "config": self._resolved_config(),
            "stats": self.stats(),
            "metrics": _om.REGISTRY.render(),
            "traces": [t.to_dict() for t in _obs_tracer.last(16)],
            "slowlog": self.slowlog_entries(),
            "lastcrash": self.last_crash_report(),
            "exec_cache_keys": {
                fam: [list(map(str, k)) for k in exec_cache.SHARED_EXEC_CACHE.keys(fam)]
                for fam in exec_cache.stats()["families"]
            },
            "flight": self.flight.stats() if self.flight is not None else None,
        }

    # -- observability ------------------------------------------------------

    def _collect_metrics(self) -> None:
        """Scrape-time mirror of component-local stats into the registry.

        Runs under the registry lock, so it must only read values whose
        writers never hold their own lock while recording registry metrics
        (lock-ordering: component lock -> registry lock is forbidden for
        anything read here; plain attribute reads are always safe).
        """
        reg = _om.REGISTRY
        g = reg.gauge
        c = reg.counter

        c("repro_service_served_total", "Requests answered.").set_total(self.served)
        c(
            "repro_service_unavailable_mines_total",
            "Mines refused because the device failed or the breaker was open.",
        ).set_total(self.unavailable_mines)
        c(
            "repro_service_device_retries_total", "Device mine retries."
        ).set_total(self.device_retries)
        c(
            "repro_service_resumed_jobs_total", "Mine jobs resumed at recovery."
        ).set_total(self.resumed_jobs)
        g("repro_service_ready", "1 when ready (recovered, breaker closed).").set(
            1.0 if self.readiness()[0] else 0.0
        )

        cache = self.cache.stats()
        g("repro_result_cache_entries", "Cached mining results.").set(cache["entries"])
        g("repro_result_cache_bytes", "Approximate result-cache footprint.").set(
            cache["bytes"]
        )
        c("repro_result_cache_hits_total", "Result-cache hits.").set_total(
            cache["hits"]
        )
        c("repro_result_cache_misses_total", "Result-cache misses.").set_total(
            cache["misses"]
        )

        priv = self._privacy.stats()
        g("repro_privacy_cache_entries", "Cached privacy payloads.").set(
            priv["entries"]
        )
        c("repro_privacy_cache_hits_total", "Privacy-LRU hits.").set_total(
            priv["hits"]
        )
        c("repro_privacy_cache_misses_total", "Privacy-LRU misses.").set_total(
            priv["misses"]
        )

        sched = self.scheduler.stats()
        c("repro_scheduler_scheduled_total", "Runs scheduled.").set_total(
            sched["scheduled"]
        )
        c(
            "repro_scheduler_coalesced_total",
            "Requests coalesced onto an in-flight run.",
        ).set_total(sched["coalesced"])
        c("repro_scheduler_failed_total", "Runs that raised.").set_total(
            sched["failed"]
        )
        g("repro_scheduler_inflight", "Runs currently executing.").set(
            sched["inflight"]
        )

        br = self.breaker.stats()
        g(
            "repro_breaker_open",
            "1 while the circuit breaker rejects the device path.",
        ).set(1.0 if br["state"] == "open" else 0.0)
        g(
            "repro_breaker_consecutive_failures",
            "Consecutive device failures recorded.",
        ).set(br["consecutive_failures"])

        store = self._store
        if store is not None:
            st = store.stats()
            g("repro_store_version", "Current dataset version.").set(st["version"])
            g("repro_store_rows", "Rows in the store.").set(st["n_rows"])
            g("repro_store_items", "Distinct items in the store.").set(
                st["n_items"]
            )
            g("repro_store_bitset_bytes", "Resident bitset bytes.").set(
                st["bitset_bytes"]
            )
            c("repro_store_compactions_total", "Store compactions.").set_total(
                st["compactions"]
            )
        durable = self._durable
        if durable is not None:
            # plain attribute reads only — DurableStore's lock is held while
            # WAL metrics record, so taking it here would invert lock order
            g(
                "repro_store_snapshots_taken", "Snapshots taken (this store)."
            ).set(durable.snapshots_taken)

        ss = self._sampling_stats
        c(
            "repro_sampling_approx_served_total",
            "Approx mine requests answered.",
        ).set_total(ss["approx_served"])
        c(
            "repro_sampling_refine_failures_total",
            "Background refinements that raised.",
        ).set_total(ss["refine_failures"])
        last = ss["last"]
        if last is not None:
            g(
                "repro_sampling_last_confidence",
                "Certain fraction of the most recent sample mine.",
            ).set(last["confidence"])
            g(
                "repro_sampling_last_sample_rows",
                "Rows drawn by the most recent sample mine.",
            ).set(last["sample_rows"])

        ts = _obs_tracer.stats()
        c("repro_traces_started_total", "Traces started.").set_total(ts["started"])
        c(
            "repro_traces_sampled_out_total", "Traces dropped by sampling."
        ).set_total(ts["sampled_out"])
        g("repro_traces_stored", "Traces in the ring buffer.").set(ts["stored"])
        c(
            "repro_trace_dropped_total",
            "Finished traces evicted from the ring by newer arrivals.",
        ).set_total(ts["dropped"])

    def stats(self) -> dict:
        store = self._store
        ready, reason = self.readiness()
        return {
            "ready": ready,
            "ready_reason": reason,
            "served": self.served,
            "durability": (
                dict(
                    self._durable.stats(),
                    last_recovery=self._recovery_info,
                    job_checkpoint_levels=self.job_checkpoint_levels,
                    resumed_jobs=self.resumed_jobs,
                )
                if self._durable is not None
                else None
            ),
            "resilience": dict(
                self.breaker.stats(),
                device_retries=self.device_retries,
                unavailable_mines=self.unavailable_mines,
                max_retries=self.resilience.max_retries,
            ),
            "drain": self._drain_info,
            # one locked read — an in-flight append can't tear this section
            "store": (
                store.stats()
                if store
                else {
                    "version": 0,
                    "n_rows": 0,
                    "n_items": 0,
                    "n_words": 0,
                    "word_tile": self.word_tile,
                    "bitset_bytes": 0,
                    "compactions": 0,
                }
            ),
            "placement": self.placement.describe(),
            # the sampled-mining fast path: request/refinement counters,
            # the reproducibility surface (derived seed, ε, sample size) of
            # the most recent sample mine, and boundary-recount bucket reuse
            "sampling": dict(
                self._sampling_stats,
                config={
                    "epsilon": self.sampling.epsilon,
                    "delta": self.sampling.delta,
                    "oversample": self.sampling.oversample,
                    "min_rows": self.sampling.min_rows,
                    "seed": self.sampling.seed,
                },
            ),
            "cache": self.cache.stats(),
            "privacy": self._privacy.stats(),
            "scheduler": self.scheduler.stats(),
            # one unified section for every kernel family's bound dispatch
            # buckets (intersect / coverage / frontier) — per-family
            # counters under "families", process totals at the top level;
            # a miss is a bucket's first binding, not a compile
            "executables": exec_cache.stats(),
            # per-level timing split of the most recent cold mine (host
            # candidate/classify work vs device dispatch+sync)
            "last_mine": self._last_mine_timing,
            # this process's CUDA kernel launches by wrapper name (each
            # wrapper counts where it launches its kernel): what the
            # requests so far ran on the card
            "launches": {
                "intersect": dict(_intersect_kernels.LAUNCHES),
                "coverage": dict(_cov_kernels.LAUNCHES),
                "tiled": dict(_tiled_kernel.LAUNCHES),
            },
            # registry fold-in: every metric family in one consistent
            # (single-lock) snapshot, plus the tracer's ring-buffer state.
            # The sections above keep their historical shapes; this is the
            # one place new telemetry lands without reshaping them.
            "obs": {
                "metrics": _om.REGISTRY.snapshot(),
                "traces": _obs_tracer.stats(),
            },
            # crash forensics + per-request cost surfaces: the flight ring's
            # write-side counters, the slow-mine log, and whether the
            # previous incarnation died cleanly
            "forensics": {
                "flight": self.flight.stats() if self.flight is not None else None,
                "slowlog": self.slowlog.stats(),
                "last_crash": (
                    {
                        "clean_shutdown": self.last_crash.clean_shutdown,
                        "open_spans": len(self.last_crash.open_spans),
                        "last_checkpoint": self.last_crash.last_checkpoint,
                    }
                    if self.last_crash is not None
                    else None
                ),
            },
        }

    def compact(self, keep_versions: int | None = None) -> dict:
        """Manually coalesce the store's append blocks (see
        :meth:`DatasetStore.compact`). On a durable service the compacted
        state is snapshotted immediately — compaction is not WAL-logged, so
        folding it into a snapshot (which also resets the WAL) is what keeps
        recovery consistent."""
        out = self.store.compact(keep_versions)
        if self._durable is not None:
            self._durable.snapshot()
        return out

    def snapshot_store(self) -> int | None:
        """Force a durable snapshot (graceful shutdown calls this so restart
        recovery is a snapshot load, not a WAL replay)."""
        if self._durable is None:
            return None
        return self._durable.snapshot()

    def drain(self, timeout: float | None = None) -> dict:
        """Graceful-shutdown drain: wait for in-flight runs up to
        ``timeout``, then cancel stragglers (they stop at their next batch
        boundary and their waiters get partial results) and give them a
        short grace to unwind."""
        info = self.scheduler.drain(timeout)
        with self._lock:
            stragglers = list(self._controls.values())
        for ctrl in stragglers:
            ctrl.cancel()
        if info["abandoned"]:
            grace = self.scheduler.drain(min(2.0, timeout if timeout else 2.0))
            info["drained_after_cancel"] = grace["drained"]
        self._drain_info = info
        return info

    def close(self) -> None:
        self.scheduler.shutdown()
        if self._durable is not None:
            self._durable.close()
        if self.flight is not None:
            # orderly shutdown leaves a clean-shutdown marker in the ring —
            # the next incarnation's LastCrashReport reads "nothing to see"
            _obs_tracer.remove_listener(self.flight.span_listener)
            self.flight.close()
        # drop the scrape collector only if this instance still owns the
        # slot (a newer service may have replaced it)
        _om.REGISTRY.unregister_collector("service", self._collector_fn)
