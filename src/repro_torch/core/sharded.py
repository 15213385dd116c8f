"""Word-sharded mesh level bodies for the Kyiv miner.

The paper parallelises level k with shared-memory threads (§4.4.4): the
stored level is shared, candidate pairs are divided among threads, and no
inter-thread communication happens during a level. On a torch mesh
(``launch.mesh.Mesh``, axes ``(data, model)``):

* candidate **pairs** shard over ``data`` in exactly-equal padded blocks
  (``core.balance.balanced_blocks``);
* the parent level's **bitset words** optionally shard over ``model``; each
  shard's partial popcounts are summed over the word shards on the pair
  shard's first device — the only reduction of the level body. The parent
  level is replicated over ``data`` (the shared-memory analogue).

A mesh entry may repeat a device: each entry still holds its own tensors and
launches its own kernels, so one card runs the whole shard logic.

Each shard body is a plain function over one shard's tensors, and it calls
the port's hand kernels (or their plain versions on CPU tensors) through
``kernels.intersect.ops.build_engine_dispatch``:

* :func:`_local_intersect` — partial counts (and children) of one word
  shard: the unfused kernels ``intersect_{write,count}_indexed``;
* :func:`_local_intersect_classify` — with one word shard the counts are
  whole, so the fused kernels classify inside the launch;
* :func:`_local_coverage` — one shard's ``(32, W_shard)`` coverage
  accumulator, summed over the pair shards.

The ``sharded_level_*_step(mesh, ...)`` factories return callables over a
placed batch (the per-entry tensors that ``core.placement.MeshPlacement``
keeps), under the reference's names. Partial counts never reach a
classifier: with more than one word shard the unfused kernels count, the sum
follows, and classification runs after it (torch ops on the pair shard's
device, the codes of ``classify_counts_host``; padding self-pairs classify
as SKIP). The reference's ``replicate=`` (a pair-axis all-gather for meshes
that span processes) has no counterpart: a torch mesh lives in one process,
and processes meet through the fleet (``core.fleet``).

``make_sharded_pipeline`` is the pipeline factory for
``mine_preprocessed(pipeline_factory=...)``; ``make_sharded_intersect`` is
the older ``intersect_fn`` contract (host classification).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.coverage import ops as _cov
from ..kernels.frontier import frontier as _f
from ..kernels.intersect import ops as _ops
from ..kernels.intersect.ref import classify_counts_ref, min_parent_ref
from .bitops import padded_words

__all__ = [
    "MeshBits",
    "PairShardedBits",
    "shard_width",
    "split_words",
    "sharded_level_step",
    "sharded_level_count_step",
    "sharded_level_classify_step",
    "sharded_level_classify_count_step",
    "sharded_coverage_step",
    "sharded_frontier_support_step",
    "make_sharded_intersect",
    "make_sharded_pipeline",
    "pad_words",
]


def pad_words(bits: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the word dimension to a multiple (extra words are zero = no rows)."""
    t, w = bits.shape
    rem = (-w) % multiple
    if rem == 0:
        return bits
    return np.concatenate([bits, np.zeros((t, rem), dtype=bits.dtype)], axis=1)


def shard_width(n_words: int, word_shards: int) -> int:
    """Words per word shard: an equal split of the logical width, rounded up
    to a multiple of ``bitops.WORD_ALIGN`` so that each shard's rows keep the
    kernels' 16-byte alignment. The zero words past ``n_words`` hold no rows."""
    return padded_words(-(-max(int(n_words), 1) // word_shards))


def split_words(bits: np.ndarray, word_shards: int) -> list[np.ndarray]:
    """(t, W) uint32 host bitsets -> one (t, shard_width) int32 block per
    word shard, zero-padded."""
    bits = np.asarray(bits, dtype=np.uint32)
    s = shard_width(bits.shape[1], word_shards)
    full = np.zeros((bits.shape[0], s * word_shards), dtype=np.uint32)
    full[:, : bits.shape[1]] = bits
    return [np.ascontiguousarray(full[:, w * s : (w + 1) * s]).view(np.int32)
            for w in range(word_shards)]


class MeshBits:
    """A word-sharded bitset matrix with whole rows: ``parts[w]`` is word
    shard ``w``, a ``(t, shard_width)`` int32 tensor on mesh entry
    ``(0, w)``'s device. ``shape`` is the logical ``(t, n_words)``; the host
    view (:meth:`host_words`) strips the shard padding."""

    def __init__(self, parts: list[torch.Tensor], n_words: int):
        self.parts = list(parts)
        self.n_words = int(n_words)

    @property
    def shape(self) -> tuple[int, int]:
        return (int(self.parts[0].shape[0]), self.n_words)

    def __len__(self) -> int:
        return self.shape[0]

    def host_words(self, n_words: int | None = None) -> np.ndarray:
        full = torch.cat([p.cpu() for p in self.parts], dim=1).numpy().view(np.uint32)
        return np.ascontiguousarray(full[:, : self.n_words if n_words is None else n_words])

    def __array__(self, dtype=None, copy=None):
        """numpy's conversion protocol: the host words (``bitops.host_bits``
        and ``np.asarray`` read a mesh matrix through it)."""
        out = self.host_words()
        return out if dtype is None else out.astype(dtype, copy=False)

    def __getitem__(self, rows):
        """Row selection (a slice or host indices) -> :class:`MeshBits`."""
        idx = np.arange(self.shape[0])[rows]
        return MeshBits([p[torch.from_numpy(idx).to(p.device)] for p in self.parts], self.n_words)


class PairShardedBits:
    """Children of one mesh batch: ``blocks[d][w]`` holds pair block ``d``'s
    rows of word shard ``w`` on entry ``(d, w)``'s device. Rows are in the
    batch's pair order, block after block."""

    def __init__(self, blocks: list[list[torch.Tensor]], n_words: int):
        self.blocks = blocks
        self.n_words = int(n_words)
        self.block = int(blocks[0][0].shape[0])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.block * len(self.blocks), self.n_words)

    def take(self, rows: np.ndarray, devices: list[torch.device]) -> MeshBits:
        """Gather ``rows`` (batch positions) into a :class:`MeshBits` whose
        word shard ``w`` lies on ``devices[w]``: each word column is
        reassembled across the pair shards in the order of ``rows``."""
        rows = np.asarray(rows, dtype=np.int64)
        owner = rows // self.block
        order = np.argsort(owner, kind="stable")
        parts = []
        for w, dev in enumerate(devices):
            pieces = []
            for d in np.unique(owner):
                local = rows[order][owner[order] == d] - d * self.block
                src = self.blocks[d][w]
                pieces.append(src[torch.from_numpy(local).to(src.device)].to(dev))
            col = (pieces[0] if len(pieces) == 1 else torch.cat(pieces)) if pieces else (
                torch.zeros((0, int(self.blocks[0][w].shape[1])), dtype=torch.int32, device=dev))
            if not np.array_equal(order, np.arange(len(rows))):
                inv = np.empty_like(order)
                inv[order] = np.arange(len(order))
                col = col[torch.from_numpy(inv).to(dev)]
            parts.append(col)
        return MeshBits(parts, self.n_words)

    def __getitem__(self, rows):
        """Row slice (``[:m]``, the pipeline's strip) -> :class:`MeshBits` on
        the first pair shard's devices."""
        idx = np.arange(self.shape[0])[rows]
        return self.take(idx, [b.device for b in self.blocks[0]])


# -- shard bodies -------------------------------------------------------------


def _engine_fn(fused, write_children, bits, pairs, *, engine, indexed, donate):
    """The bound single-device dispatch of one shard's batch shape."""
    return _ops.EXEC_CACHE.get(
        ("mesh-local", engine, indexed, fused, write_children, int(bits.shape[1]),
         int(pairs.shape[0]), donate),
        lambda: _ops.build_engine_dispatch(engine, fused_classify=fused,
                                           write_children=write_children,
                                           indexed=indexed, donate=donate),
    )


def _local_intersect(bits, pairs, pc, tau, *, write_children, **kw):
    """One shard's partial popcounts (and children) over its word shard."""
    child, cnt, _ = _engine_fn(False, write_children, bits, pairs, **kw)(bits, pairs, pc, tau)
    return child, cnt


def _local_intersect_classify(bits, pairs, pc, tau, *, write_children, **kw):
    """One pair shard of a mesh with one word shard: whole counts, so the
    fused kernels classify inside the launch."""
    return _engine_fn(True, write_children, bits, pairs, **kw)(bits, pairs, pc, tau)


def _local_coverage(bits, index, sets, weights, *, engine):
    """One shard's ``(32, W_shard)`` coverage accumulator over its sets."""
    return _cov.build_coverage_dispatch(engine)(bits, index, sets, weights)


def _sum_to(parts: list[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """Sum int32 partials onto ``dev`` (exact in any order)."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


def _level_step(mesh, *, word_axis, fused, write_children, engine, indexed, donate):
    n_data = mesh.devices.shape[0]
    n_word = mesh.devices.shape[1] if word_axis else 1
    classify_in_kernel = fused and n_word == 1
    body = _local_intersect_classify if classify_in_kernel else _local_intersect
    kw = dict(engine=engine, indexed=indexed, write_children=write_children, donate=donate)

    def step(grid, pairs, pcs, tau, record=None):
        """``grid[d][w]`` parent bits, ``pairs[d][w]`` the pair block, and
        ``pcs[d]`` parent popcounts on entry ``(d, 0)``; ``record(d, w)``
        (optional) is called once per shard call. Returns
        ``(child blocks | None, counts[d], classes[d] | None)``, the counts
        and classes on entry ``(d, 0)``'s device."""
        child_blocks, counts, classes = [], [], []
        for d in range(n_data):
            dev0 = mesh.devices[d, 0]
            outs = []
            for w in range(n_word):
                # pcs[d] feeds only the in-kernel classifier (entry (d, 0))
                outs.append(body(grid[d][w], pairs[d][w], pcs[d], tau, **kw))
                if record is not None:
                    record(d, w)
            if classify_in_kernel:
                child, cnt, cls = outs[0]
                child_blocks.append([child])
            else:
                child_blocks.append([o[0] for o in outs])
                cnt = _sum_to([o[1] for o in outs], dev0)
                cls = (classify_counts_ref(cnt, min_parent_ref(pcs[d], pairs[d][0]), tau)
                       if fused else None)
            counts.append(cnt)
            classes.append(cls)
        return (child_blocks if write_children else None), counts, (classes if fused else None)

    return step


def sharded_level_step(mesh, *, word_axis="model", engine="cuda", indexed=True,
                       donate=False):
    """Write-variant level body: ``(grid, pairs, pcs, tau) -> (child blocks,
    counts, None)``; counts are summed over the word shards."""
    return _level_step(mesh, word_axis=word_axis, fused=False, write_children=True,
                       engine=engine, indexed=indexed, donate=donate)


def sharded_level_count_step(mesh, *, word_axis="model", engine="cuda", indexed=True,
                             donate=False):
    """Count-only (k = k_max) level body: ``-> (None, counts, None)``."""
    return _level_step(mesh, word_axis=word_axis, fused=False, write_children=False,
                       engine=engine, indexed=indexed, donate=donate)


def sharded_level_classify_step(mesh, *, word_axis="model", engine="cuda", indexed=True,
                                donate=False):
    """Fused write-variant level body: ``-> (child blocks, counts, classes)``,
    classified after the word-shard sum (in the kernel with one word shard)."""
    return _level_step(mesh, word_axis=word_axis, fused=True, write_children=True,
                       engine=engine, indexed=indexed, donate=donate)


def sharded_level_classify_count_step(mesh, *, word_axis="model", engine="cuda",
                                      indexed=True, donate=False):
    """Fused count-only (k = k_max) level body: ``-> (None, counts, classes)``."""
    return _level_step(mesh, word_axis=word_axis, fused=True, write_children=False,
                       engine=engine, indexed=indexed, donate=donate)


def sharded_coverage_step(mesh, *, word_axis="model", engine="cuda"):
    """Record-coverage body: ``(grid, indexes, sets, weights) -> acc (32,
    n_word * shard_width)`` on entry ``(0, 0)``'s device. ``sets``/``weights``
    are host arrays split into the pair shards' equal blocks; each word
    shard's accumulators are summed over the pair shards, then the word
    shards are laid side by side."""
    n_data = mesh.devices.shape[0]
    n_word = mesh.devices.shape[1] if word_axis else 1

    def step(grid, indexes, sets, weights, record=None):
        block = sets.shape[0] // n_data
        cols = []
        for w in range(n_word):
            accs = []
            for d in range(n_data):
                sl = slice(d * block, (d + 1) * block)
                accs.append(_local_coverage(grid[d][w], indexes[d][w], sets[sl], weights[sl],
                                            engine=engine))
                if record is not None:
                    record(d, w)
            dev = mesh.devices[0, w]
            cols.append(_sum_to(accs, dev))
        home = mesh.devices[0, 0]
        return torch.cat([c.to(home) for c in cols], dim=1)

    return step


def sharded_frontier_support_step(mesh, *, k, t_pad, bits, ipw):
    """Frontier support test sharded over the pair shards:
    ``(ids[d], keys[d], pairs, valid) -> ok`` on ``pairs``' device. The
    id/key tables are replicated per pair shard (on entry ``(d, 0)``); each
    pair shard binary-searches its own candidates' subsets — no reduction."""
    n_data = mesh.devices.shape[0]

    def step(ids, keys, pairs, valid):
        block = pairs.shape[0] // n_data
        oks = []
        for d in range(n_data):
            dev = mesh.devices[d, 0]
            sl = slice(d * block, (d + 1) * block)
            oks.append(_f.support_ok_body(ids[d], keys[d], pairs[sl].to(dev), valid[sl].to(dev),
                                          k=k, t_pad=t_pad, bits=bits, ipw=ipw))
        return torch.cat([o.to(pairs.device) for o in oks])

    return step


def make_sharded_pipeline(
    mesh,
    *,
    word_axis: str | None = None,
    locality_sort: bool = True,
    fused_classify: bool = True,
    engine: str = "cuda",
    indexed: bool = True,
    device_frontier: bool | None = None,
):
    """Pipeline factory for ``mine_preprocessed(pipeline_factory=...)``:
    ``factory(bits, parent_counts, tau) -> LevelPipeline`` bound to one
    :class:`~repro_torch.core.placement.MeshPlacement`. Level bitsets stay
    on the mesh between levels (:class:`MeshBits`); ``fused_classify=False``
    classifies on the host. The factory's ``placement`` attribute is the
    mesh placement (its shard launch counts)."""
    from .placement import MeshPlacement

    placement = MeshPlacement(mesh, word_axis=word_axis, engine=engine, indexed=indexed,
                              device_frontier=device_frontier)

    def factory(bits, parent_counts, tau: int):
        return _ops.LevelPipeline(
            bits,
            parent_counts,
            tau=tau,
            placement=placement,
            fused_classify=fused_classify,
            locality_sort=locality_sort,
        )

    factory.placement = placement
    return factory


def make_sharded_intersect(
    mesh,
    *,
    word_axis: str | None = None,
    engine: str = "cuda",
    indexed: bool = True,
):
    """Drop-in ``intersect_fn`` for ``mine_preprocessed`` on a mesh: host
    classification, the bitsets placed per call (one fresh ``LevelPipeline``
    each). Kept for the reference's contract; prefer
    :func:`make_sharded_pipeline`."""
    from .placement import MeshPlacement

    placement = MeshPlacement(mesh, word_axis=word_axis, engine=engine, indexed=indexed)

    def intersect_fn(bits: np.ndarray, pairs: np.ndarray, write_children: bool):
        pipe = _ops.LevelPipeline(
            bits,
            np.zeros(bits.shape[0], dtype=np.int64),
            tau=0,
            placement=placement,
            fused_classify=False,
        )
        try:
            child, counts, _ = pipe.submit(pairs, write_children).result()
        finally:
            pipe.retire()
        return child, counts

    return intersect_fn
