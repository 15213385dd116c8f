"""The Kyiv algorithm (paper Algorithm 1): breadth-first minimal τ-infrequent
itemset mining, driven over a device-resident level frontier.

Per level-transition (k -> k+1), all five steps of Alg. 1 lines 11-41 run
where the placement keeps the level (``repro_torch.core.frontier``):

  1. candidate joins of prefix-sharing stored itemsets     (lines 11-20)
  2. support-itemset test via stored-level lookups         (line 23, §4.4.1)
  3. at k+1 == k_max: Lemma 4.6 + Corollary 4.7 bounds     (lines 25-29)
  4. bulk row intersection (the bottleneck, CUDA kernel)   (line 31)
  5. classify + partition: absent/uniform skip (line 32), emit minimal
     τ-infrequent (lines 34-38 incl. Prop 4.1 mirror expansion), or store
     (line 41)

**What lives where.** With a device placement and the default
``KyivConfig.device_frontier`` / ``fused_classify``, a level transition is
device-to-device: candidate pair indices come from prefix-group run lengths
(``cumsum``/``repeat_interleave``), the support test binary-searches a
packed parent key table, the fused kernels classify in registers, and one
stable compaction pass splits each batch into [skip | emit | store] —
stored child bitsets never visit the host; the next level is a device-side
concat. The
host keeps only the tiny frontier mirrors (itemset ids, counts, group run
lengths) and drains the emitted minimal itemsets. The only host sync points
are three scalars plus the emit/store index blocks per batch, the
``k = k_max`` bound pruning (``use_bounds``), and ``on_level_end``
checkpoint hooks (which copy level bitsets into ``MiningState``). With
``HostPlacement`` (``engine="numpy"``) or ``fused_classify=False``, the same
engine runs the host reference path — bit-identical on results and
per-level stats by construction, and kept as the parity oracle.

Engines: ``cuda`` (the default) runs the hand-written CUDA kernels on
``KyivConfig.device`` (default ``"cuda"``); ``torch`` runs their plain
PyTorch versions on that device; ``numpy`` runs on the host. A CUDA device
that does not exist raises: the CPU is used only when the caller asks for it
(``device="cpu"`` or ``engine="numpy"``).

Vertex bookkeeping follows §5.2.3: type **A** = emitted minimal τ-infrequent,
type **B** = visited without performing a row intersection (support- or
bound-pruned), type **C** = the rest (intersection performed).

Batches are double-buffered: candidate generation, support tests and bound
pruning of batch *n+1* overlap the device intersection of batch *n*. Parent
levels retire eagerly once a transition completes (placement-owned device
buffers are dropped), so peak device memory tracks
``MiningResult.peak_level_bytes`` rather than every level mined so far.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ..kernels.intersect.ops import LegacyIntersectPipeline, LevelPipeline
from ..obs import metrics as _om
from ..obs.trace import span as _obs_span
from ..obs.trace import start_trace as _obs_start_trace
from .frontier import LevelFrontier, mine_levels
from .items import ItemTable, device_dtype, itemize
from .placement import DevicePlacement, resolve_placement
from .preprocess import Preprocessed, preprocess
from .prefix import Level
from .support import ItemsetIndex

__all__ = [
    "KyivConfig",
    "LevelStats",
    "MiningInterrupted",
    "MiningResult",
    "MiningState",
    "RunControl",
    "mine",
    "mine_preprocessed",
    "prepare",
]

_MINE_WALL = _om.histogram(
    "repro_mine_wall_seconds", "End-to-end wall time of one mining run."
)
_MINE_RUNS = _om.counter(
    "repro_mine_runs_total", "Mining runs by terminal status.", ("status",)
)
_MINE_EMITTED = _om.counter(
    "repro_mine_emitted_itemsets_total",
    "Minimal infrequent itemsets emitted across all runs.",
)
_MINE_PEAK = _om.gauge(
    "repro_mine_peak_level_bytes",
    "peak_level_bytes of the most recent mining run.",
)


class MiningInterrupted(RuntimeError):
    """A run stopped early at a batch boundary (deadline or cancellation).

    Raised by :meth:`RunControl.check` inside the level loop; callers that
    want partial-result semantics catch it (``mine_preprocessed`` does, and
    returns the itemsets emitted so far with ``MiningResult.interrupted``
    set to the reason)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclasses.dataclass
class RunControl:
    """Deadline + cancellation for one mining run.

    ``deadline`` is an absolute ``time.monotonic()`` instant (None = no
    deadline). The level loop calls :meth:`check` at every batch boundary —
    the run therefore stops within one batch of the deadline or of
    :meth:`cancel` being called, never mid-kernel. Everything emitted before
    the stop is a valid (but possibly incomplete) set of minimal
    τ-infrequent itemsets.
    """

    deadline: float | None = None
    _cancelled: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False
    )

    @classmethod
    def with_timeout(cls, seconds: float | None) -> "RunControl":
        return cls(
            deadline=None if seconds is None else time.monotonic() + float(seconds)
        )

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def remaining(self) -> float | None:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def check(self) -> None:
        if self._cancelled.is_set():
            raise MiningInterrupted("cancelled")
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise MiningInterrupted("deadline")



@dataclasses.dataclass
class KyivConfig:
    tau: int = 1
    kmax: int = 3
    ordering: str = "ascending"  # Def. 4.5 / §5.2.4 ablations
    use_bounds: bool = True  # Lemma 4.6 / Corollary 4.7 at k = k_max
    engine: str = "cuda"  # numpy | torch | cuda
    device: str = "cuda"  # torch device of the torch and cuda engines
    # Bitset placement override: a placement instance or an engine-name
    # string; None derives one from `engine` and `device`
    # (placement.resolve_placement). All placements are bit-identical.
    placement: Any = None
    expansion: str = "full"  # "full" | "paper" (single-swap, Alg. 1 lines 36-38)
    seed: int = 0  # random-ordering seed
    max_pairs_per_chunk: int = 1 << 22  # level spilling / bucket unit
    fused_classify: bool = True  # classify (Alg. 1 lines 32-41) on the engine
    # indexed kernels read the pairs' parent rows themselves; False selects
    # the gathered family (operand rows gathered by torch indexing first)
    indexed_kernel: bool = True
    locality_sort: bool = True  # locality-aware pair schedule before dispatch
    double_buffer: bool = True  # overlap host candidate gen with device batches
    # run candidate generation, support tests and emit/store partitioning on
    # the placement's device (core.frontier); False pins the host reference
    # path even for device placements
    device_frontier: bool = True


@dataclasses.dataclass
class LevelStats:
    k: int
    candidates: int = 0
    support_pruned: int = 0
    bound_pruned: int = 0
    intersections: int = 0
    emitted: int = 0
    skipped_absent_uniform: int = 0
    stored: int = 0
    time_total: float = 0.0
    time_intersect: float = 0.0  # dispatch + blocking device sync
    time_classify: float = 0.0  # classification / partition consumption
    time_candidates: float = 0.0  # candidate gen + support test + bounds
    level_bytes: int = 0

    @property
    def type_a(self) -> int:
        return self.emitted

    @property
    def type_b(self) -> int:
        return self.support_pruned + self.bound_pruned

    @property
    def type_c(self) -> int:
        return self.intersections - self.emitted

    @property
    def time_host_busy(self) -> float:
        """Host-side frontier work (candidate gen / support / bounds on the
        host path; batch orchestration + emit drain on the device path)."""
        return self.time_candidates + self.time_classify

    @property
    def time_device_busy(self) -> float:
        """Time attributed to device dispatch + blocking sync."""
        return self.time_intersect

    def timing_breakdown(self) -> dict:
        """JSON-friendly per-level host-idle vs device-busy split."""
        return {
            "k": self.k,
            "total": self.time_total,
            "candidates": self.time_candidates,
            "intersect": self.time_intersect,
            "classify": self.time_classify,
            "host_busy": self.time_host_busy,
            "device_busy": self.time_device_busy,
            "idle_other": max(
                0.0, self.time_total - self.time_host_busy - self.time_device_busy
            ),
        }


@dataclasses.dataclass
class MiningResult:
    """All minimal τ-infrequent itemsets up to k_max, as original item ids."""

    itemsets: list[tuple[tuple[int, ...], int]]  # (sorted item ids, |R_I|)
    stats: list[LevelStats]
    prep: Preprocessed
    config: KyivConfig
    wall_time: float
    # "deadline" | "cancelled" when the run stopped early at a batch
    # boundary — the itemsets list is then a valid partial answer and must
    # not be cached or used as an incremental base
    interrupted: str | None = None

    @property
    def completed(self) -> bool:
        return self.interrupted is None

    def as_value_sets(self) -> list[tuple[tuple[tuple[int, int], ...], int]]:
        """Human-readable ((column, value), ...) form, 0-based columns."""
        t = self.prep.table
        out = []
        for ids, cnt in self.itemsets:
            out.append((tuple((int(t.col[i]), int(t.value[i])) for i in ids), cnt))
        return out

    def canonical_set(self) -> set[tuple[int, ...]]:
        return {ids for ids, _ in self.itemsets}

    @property
    def total_intersections(self) -> int:
        return sum(s.intersections for s in self.stats)

    @property
    def total_intersect_time(self) -> float:
        return sum(s.time_intersect for s in self.stats)

    @property
    def total_classify_time(self) -> float:
        return sum(s.time_classify for s in self.stats)

    @property
    def total_candidate_time(self) -> float:
        return sum(s.time_candidates for s in self.stats)

    @property
    def peak_level_bytes(self) -> int:
        return max((s.level_bytes for s in self.stats), default=0)

    def timing_breakdown(self) -> list[dict]:
        return [s.timing_breakdown() for s in self.stats]


@dataclasses.dataclass
class MiningState:
    """Resumable mining state at a level boundary (Alg. 1 outer loop).

    Produced for every ``on_level_end`` callback and accepted back as
    ``resume_state``, to restart a run without redoing earlier levels.
    Mapping-style access (``state["level"]``) works as in the reference.
    ``level.bits`` is host uint32 numpy here, word padding stripped (the
    one deliberate device->host copy of the frontier path), so states stay
    picklable and resumable under any placement;
    ``repro_torch.convert`` carries them to and from the reference package.
    A hook that declares ``device_bits = True`` on itself gets instead the
    level's uint32 words where they lie (a device tensor, or host numpy)
    as a view, padding stripped, with no copy: valid only during the call
    (the next level may overwrite them), so such a hook uses them within
    the call and keeps nothing. The service's job checkpoint and the CLI's
    ``--ckpt-dir`` hook declare it (each saves blocking and keeps nothing);
    a hook that keeps states (tests, ``convert``) does not.
    """

    results: list[tuple[tuple[int, ...], int]]
    stats: list["LevelStats"]
    level: Level
    grandparent_index: ItemsetIndex | None
    next_k: int

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def keys(self):
        return (f.name for f in dataclasses.fields(self))

    @classmethod
    def from_mapping(cls, m: "MiningState | dict[str, Any]") -> "MiningState":
        if isinstance(m, cls):
            return m
        return cls(
            results=list(m["results"]),
            stats=list(m["stats"]),
            level=m["level"],
            grandparent_index=m.get("grandparent_index"),
            next_k=m["next_k"],
        )


def mine_preprocessed(
    prep: Preprocessed,
    config: KyivConfig,
    *,
    intersect_fn: Callable[..., Any] | None = None,
    pipeline_factory: Callable[..., Any] | None = None,
    on_level_end: Callable[[int, "MiningState"], None] | None = None,
    resume_state: "MiningState | dict[str, Any] | None" = None,
    control: RunControl | None = None,
) -> MiningResult:
    """Run Algorithm 1 on a preprocessed item table.

    ``pipeline_factory(bits, parent_counts, tau)`` builds the per-level batch
    pipeline (the resident service supplies one whose level 1 gathers from
    its store's device-resident bitsets); by default each level gets a
    :class:`~repro_torch.kernels.intersect.ops.LevelPipeline` on the
    config's placement. ``intersect_fn(bits, pairs, write_children) ->
    (child | None, counts)`` is the older injection contract
    (``core.sharded.make_sharded_intersect``), adapted by
    :class:`~repro_torch.kernels.intersect.ops.LegacyIntersectPipeline` with
    host classification; a ``pipeline_factory`` takes precedence.
    ``on_level_end`` receives a :class:`MiningState` at every level boundary
    (the checkpoint hook); ``resume_state`` (a ``MiningState`` or the
    equivalent mapping from an old checkpoint) restarts there. ``control``
    carries a per-request deadline/cancellation checked at every batch
    boundary — an interrupted run returns the partial result with
    ``MiningResult.interrupted`` set instead of raising. The level loop
    itself lives in :func:`repro_torch.core.frontier.mine_levels`.

    Every run records into :mod:`repro_torch.obs`: a ``mine`` span (the
    trace root when no trace is active, a child span otherwise) over
    ``mine.seed`` + per-level ``mine.level`` children, plus the
    ``repro_mine_*`` metric families.
    """
    with _obs_start_trace("mine") as _msp:
        try:
            result = _mine_preprocessed_inner(
                prep,
                config,
                intersect_fn=intersect_fn,
                pipeline_factory=pipeline_factory,
                on_level_end=on_level_end,
                resume_state=resume_state,
                control=control,
            )
        except Exception:
            _MINE_RUNS.inc(status="error")
            _msp.set(status="error")
            raise
        status = "interrupted" if result.interrupted else "ok"
        _msp.set(
            status=status,
            emitted=len(result.itemsets),
            levels=len(result.stats),
            peak_level_bytes=result.peak_level_bytes,
        )
        _MINE_WALL.observe(result.wall_time)
        _MINE_RUNS.inc(status=status)
        _MINE_EMITTED.inc(len(result.itemsets))
        _MINE_PEAK.set(result.peak_level_bytes)
    return result


def _mine_preprocessed_inner(
    prep: Preprocessed,
    config: KyivConfig,
    *,
    intersect_fn: Callable[..., Any] | None = None,
    pipeline_factory: Callable[..., Any] | None = None,
    on_level_end: Callable[[int, "MiningState"], None] | None = None,
    resume_state: "MiningState | dict[str, Any] | None" = None,
    control: RunControl | None = None,
) -> MiningResult:
    t_start = time.perf_counter()
    table = prep.table
    n_words = prep.l_bits.shape[1]
    placement = resolve_placement(config)

    def default_pipeline(bits, counts, tau_):
        return LevelPipeline(
            bits,
            counts,
            tau=tau_,
            placement=placement,
            fused_classify=config.fused_classify,
            locality_sort=config.locality_sort,
            n_words=n_words,
        )

    def legacy_pipeline(bits, counts, tau_):
        return LegacyIntersectPipeline(intersect_fn, bits)

    make_pipeline = pipeline_factory or (legacy_pipeline if intersect_fn else default_pipeline)

    results: list[tuple[tuple[int, ...], int]] = []
    stats: list[LevelStats] = []

    with _obs_span("mine.seed"):
        # k = 1: emit τ-infrequent singletons (line 5) with mirror-free
        # expansion (every item, duplicate or not, is kept in the item
        # table, so the infrequent singletons are already complete).
        for it in prep.infrequent_items:
            results.append(((int(it),), int(table.freq[it])))
        s1 = LevelStats(k=1, emitted=len(prep.infrequent_items), stored=prep.n_l)
        s1.level_bytes = prep.l_bits.nbytes
        stats.append(s1)

        # level 1 of the prefix tree over L^< (line 8)
        frontier = LevelFrontier(
            k=1,
            itemsets=np.arange(prep.n_l, dtype=np.int32)[:, None],
            counts=prep.l_freq.copy(),
            bits=prep.l_bits,
        )
        grandparent_index: ItemsetIndex | None = None
        start_k = 2

        if resume_state is not None:
            st = MiningState.from_mapping(resume_state)
            results = list(st.results)
            stats = list(st.stats)
            frontier = LevelFrontier.from_level(st.level)
            grandparent_index = st.grandparent_index
            start_k = st.next_k

    device_bits = bool(getattr(on_level_end, "device_bits", False))

    def make_state(next_k: int, fr: LevelFrontier, gp) -> MiningState:
        if device_bits and isinstance(fr.bits, (torch.Tensor, np.ndarray)):
            bits = fr.bits[:, :n_words]
            bits = bits.view(torch.uint32 if isinstance(bits, torch.Tensor) else np.uint32)
            level = Level(k=fr.k, itemsets=fr.itemsets, counts=fr.counts, bits=bits)
        else:
            # inside the caller's ``mine.checkpoint`` span: the stored
            # level's bitsets to the host, the checkpoint's one copy
            with _obs_span("checkpoint.copy") as sp:
                level = fr.as_level(n_words=n_words)
                sp.set(bytes=int(level.bits.nbytes) if level.bits is not None else 0)
        return MiningState(
            results=results,
            stats=stats,
            level=level,
            grandparent_index=gp,
            next_k=next_k,
        )

    interrupted: str | None = None
    try:
        mine_levels(
            prep,
            config,
            make_pipeline,
            results,
            stats,
            frontier=frontier,
            grandparent_index=grandparent_index,
            start_k=start_k,
            on_level_end=on_level_end,
            make_state=make_state,
            control=control,
        )
    except MiningInterrupted as e:
        interrupted = e.reason

    return MiningResult(
        itemsets=results,
        stats=stats,
        prep=prep,
        config=config,
        wall_time=time.perf_counter() - t_start,
        interrupted=interrupted,
    )


def _itemize_on(dataset: np.ndarray, placement) -> ItemTable:
    if not (isinstance(placement, DevicePlacement) and dataset.ndim == 2 and dataset.size
            and device_dtype(dataset.dtype)):
        return itemize(dataset)
    from ..kernels.itemize.ops import itemize_on_device

    with _obs_span("itemize") as sp:
        table, attrs = itemize_on_device(dataset, placement.device, placement.engine)
        sp.set(**attrs)
    return table


def prepare(dataset_or_table: "np.ndarray | ItemTable", config: KyivConfig) -> Preprocessed:
    """Itemize (if needed) and §4.1-preprocess for a config — the cold half of
    :func:`mine`, split out so callers holding a prebuilt :class:`ItemTable`
    can reuse it across runs.

    A dataset of integers that fit int64 is itemized on the placement's
    device when the placement is one :class:`~repro_torch.core.placement.DevicePlacement`
    (``kernels.itemize``: the CUDA kernels on engine ``cuda``, their plain
    versions on ``torch``); any other dataset, and any other placement
    (``numpy``, a mesh, a fleet), takes the host's :func:`itemize`. The table
    is the same. The ``itemize`` span's ``path`` says which ran (``"cuda"``,
    ``"torch"`` or ``"host"``); the device routes add ``dense_cols``,
    ``sorted_cols`` and ``bytes_up``."""
    if isinstance(dataset_or_table, ItemTable):
        table = dataset_or_table
    else:
        table = _itemize_on(np.asarray(dataset_or_table), resolve_placement(config))
    return preprocess(table, config.tau, ordering=config.ordering, seed=config.seed)


def mine(dataset: np.ndarray, config: KyivConfig | None = None, **kw) -> MiningResult:
    """End-to-end: itemize -> preprocess (§4.1) -> Algorithm 1."""
    if config is None:
        config = KyivConfig(**kw)
    elif kw:
        config = dataclasses.replace(config, **kw)
    return mine_preprocessed(prepare(dataset, config), config)
