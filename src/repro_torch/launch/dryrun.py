"""Dry run of the port's LM steps on the production meshes: for every
(architecture x input shape x mesh), what the port's step holds on its
busiest entry, its three roofline terms on the H100, and the copies it makes
between entries; and the sharded miner's level step. Nothing is compiled and
nothing is allocated: the parameters are ``Model.abstract_params()`` on the
meta device, the caches ``init_cache(..., device="meta")``, the specs
``make_plan`` over ``make_production_mesh(devices=["meta"] * n)``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both   # all 80 cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mining      # the miner's rows
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list        # show the cells

Records: one JSON per cell under ``build/dryrun/`` (``--out``), with the
reference's keys. They describe the port's own step, not the reference's
(an XLA program that gathers one layer at a time):

* train (``training.train``'s plan step): each data row gathers full float32
  copies of every leaf onto its first entry, computes its slice of the
  batch, and the rows' float32 gradients are summed on the first row's
  entry (``dev0``), which sends every entry its slices. ``memory`` is
  ``dev0``'s: the plan-sharded masters, moments and batch slice
  (``argument_bytes``), plus the gathered copies, the bf16 casts, the
  gradients and one micro-batch's activations (``peak_estimate_bytes``,
  each term in ``detail``). The activations come from a trace of the row's
  loss and backward on meta tensors (``_LiveBytes``: the bytes of every
  storage the step creates and still holds, op by op): at the whole depth,
  or at two depths a period of the layer pattern apart, extended by the
  growth per layer between them (``_extrapolated``).
* prefill and decode: the port has no plan-sharded serving step, so a data
  row runs ``Model.prefill`` / ``decode`` on one device with the whole bf16
  model; ``argument_bytes`` is the entry's slices under the plan (the serve
  plan where ``lower_cell`` picks it, as the reference does) of the weights
  and the batch, and of the cache for decode (a prefill makes its cache).
  The peak adds the rest of the model, the rest of the row's cache and the
  step's traced transients (a prefill's traced at up to
  ``PREFILL_TRACE_LEN`` positions and scaled in proportion).

``roofline`` takes the flops from ``analytic_work`` over the entries that
compute (the data rows: ``compute_entries``), the bytes from the port's own
terms (``roofline.bytes_detail``), and the collectives from the list of
copies the step makes: the rows' gathers, the rows' gradients to ``dev0``
and the slices back (train); nothing per step for serving. ``fits`` holds
the peak against ``H100.hbm_bytes``.

The mining rows price ``core.sharded``'s level step: words over ``model``,
pairs over ``data`` (``pod`` and ``data`` on 2x16x16), partial counts summed
onto each pair shard's first entry.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import ARCHS, SHAPES, ArchConfig, ShapeConfig, act_dtype, cells, input_specs
from ..convert import reference_rank2_names
from ..distributed.elastic import _slices
from ..distributed.sharding import make_plan
from ..models.layers.common import cast_params
from ..models.zoo import build
from ..roofline.analysis import CollectiveOp, RooflineReport, collective_seconds, roofline_terms
from ..roofline.analytic import analytic_work
from ..roofline.hw import H100
from ..training.train import TABLE, _reading, data_rows, row_reads
from .mesh import make_production_mesh

__all__ = ["lower_cell", "lower_mining", "mining_terms", "tiled_terms", "main"]

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _production(multi_pod: bool):
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * (512 if multi_pod else 256))


def _model_flops(arch, shape) -> float:
    n_active = arch.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token per row


# -- shapes and specs ------------------------------------------------------

def _slice_shape(mesh, spec, shape) -> tuple[int, ...]:
    """The shape of one entry's slice (every entry's: the plan splits evenly)."""
    first = (0,) * mesh.devices.ndim
    return tuple(s.stop - s.start for s in _slices(mesh, spec, tuple(shape), first))


def _nbytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _slice_bytes(mesh, tensors, specs) -> int:
    return sum(_nbytes(_slice_shape(mesh, s, tuple(t.shape)), t.dtype)
               for t, s in zip(tensors, specs))


def _meta_batch(cfg, shape: ShapeConfig, rows: int | None = None) -> dict:
    """The step's inputs on the meta device (tokens and labels int64, as the
    port's batches are), the first ``rows`` rows of the batch."""
    out = {}
    for name, (shp, dt) in input_specs(cfg, shape, torch.int64).items():
        shp = (rows if rows is not None else shp[0],) + tuple(shp[1:])
        out[name] = torch.empty(shp, dtype=dt, device="meta")
    return out


# -- the trace -------------------------------------------------------------

class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages created under this mode and still alive,
    after each op, and their peak. A storage that existed before (an input,
    a parameter, a cache) is never counted, nor are the views of it; a
    gradient accumulated into a leaf's ``.grad`` is dropped (``drop``)."""

    def __init__(self):
        super().__init__()
        self.sizes: dict[int, int] = {}
        self.live = self.peak = 0

    def _track(self, st, nbytes: int) -> None:
        key = id(st)
        self.sizes[key] = nbytes
        self.live += nbytes
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key, 0)

    def drop(self, t: torch.Tensor) -> None:
        key = id(t.untyped_storage())
        if key in self.sizes:
            self.live -= self.sizes[key]
            self.sizes[key] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor) and id(t.untyped_storage()) not in self.sizes:
                self._track(t.untyped_storage(), 0)  # from outside: not the step's
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and id(t.untyped_storage()) not in self.sizes:
                self._track(t.untyped_storage(), t.untyped_storage().nbytes())
        self.peak = max(self.peak, self.live)
        return out


def _cut(cfg: ArchConfig, layers: int) -> ArchConfig:
    enc = cfg.enc_layers * layers // cfg.n_layers if cfg.enc_layers else 0
    return dataclasses.replace(cfg, n_layers=layers, enc_layers=enc)


def _extrapolated(cfg: ArchConfig, measure) -> float:
    """``measure(layers)`` at the whole depth. Past an MoE's dense layers,
    the shallower of two depths one pattern period apart holds whole
    periods and at least two layers (at one layer an encoder-decoder's peak
    still sits elsewhere). A model no deeper than the deeper one is traced
    whole; a deeper one at both, and extended by the growth per layer
    between them, as every further layer is one of the pattern's."""
    dense = cfg.moe.first_dense if cfg.moe is not None else 0
    p = len(cfg.pattern)
    a = dense + p * -(-2 // p)
    b = a + p
    if b >= cfg.n_layers:
        return float(measure(cfg.n_layers))
    ma, mb = measure(a), measure(b)
    return mb + (cfg.n_layers - b) * (mb - ma) / p


def _train_trace(cfg, shape, rows: int, partial: bool, ctx, layers: int) -> int:
    """Peak bytes one data row's loss and backward create beyond its leaves,
    their gradients and its bf16 reads (remat's kept layer inputs among
    them), traced on meta tensors at ``layers`` depth."""
    c = _cut(cfg, layers)
    model = build(c)
    net = model.abstract_params()
    names = dict(net.named_parameters())
    full = ((n, torch.empty(p.shape, device="meta")) for n, p in names.items())
    leaves, reads = row_reads(full, set(names) & reference_rank2_names(c), partial,
                              net.embed.lm_head is None)
    batch = _meta_batch(c, shape, rows)
    live = _LiveBytes()
    for t in leaves.values():
        t.register_post_accumulate_grad_hook(lambda t: live.drop(t.grad))
    with _reading(net, reads), live:
        model.train_loss(net, batch, ctx=ctx).backward()
    return live.peak


def _train_activations(cfg, shape, rows: int, partial: bool, ctx) -> float:
    return _extrapolated(cfg, lambda n: _train_trace(cfg, shape, rows, partial, ctx, n))


# prefill is traced at no more positions than this and scaled in proportion
# (an upper estimate where the step holds buffers that do not grow with S)
PREFILL_TRACE_LEN = 4096


def _prefill_trace(cfg, shape, layers: int) -> int:
    """Peak bytes one row's prefill creates, its cache included, traced on
    meta tensors at ``layers`` depth and ``shape.seq_len`` positions."""
    c = _cut(cfg, layers)
    model = build(c)
    net = _serve_net(c, model)
    with _LiveBytes() as live:
        model.prefill(net, _meta_batch(c, shape, 1))
    return live.peak


def _prefill_transients(cfg, shape, rows: int) -> float:
    """A row's prefill traced at up to ``PREFILL_TRACE_LEN`` positions and
    scaled by the rows and the positions."""
    s = min(shape.seq_len, PREFILL_TRACE_LEN)
    short = dataclasses.replace(shape, seq_len=s)
    return _extrapolated(cfg, lambda n: _prefill_trace(cfg, short, n)) * rows * shape.seq_len / s


def _decode_trace(cfg, shape, rows: int, layers: int) -> int:
    """Peak bytes a row's decode step creates (its cache is an input),
    traced on meta tensors at ``layers`` depth."""
    c = _cut(cfg, layers)
    model = build(c)
    net = _serve_net(c, model)
    batch = _meta_batch(c, shape, rows)
    cache = model.init_cache(rows, shape.seq_len, device="meta")
    with _LiveBytes() as live:
        model.decode(net, batch, cache)
    return live.peak


def _decode_transients(cfg, shape, rows: int) -> float:
    return _extrapolated(cfg, lambda n: _decode_trace(cfg, shape, rows, n))


def _serve_net(cfg, model):
    net = model.abstract_params()
    dt = act_dtype(cfg)
    return net if dt == torch.float32 else cast_params(net, dt)


# -- the cells -------------------------------------------------------------

def _resolve(arch, shape) -> tuple[ArchConfig, ShapeConfig]:
    return (ARCHS[arch] if isinstance(arch, str) else arch,
            SHAPES[shape] if isinstance(shape, str) else shape)


def _train_cell(cfg, shape, plan, grad_accum: int) -> dict:
    mesh = plan.mesh
    net = build(cfg).abstract_params()
    params = dict(net.named_parameters())
    specs = plan.param_shardings(params)
    rows = data_rows(mesh, plan.dp)
    n_rows, n_entries = len(rows), int(mesh.devices.size)
    micro = shape.global_batch // grad_accum
    split = micro % n_rows == 0
    partial = split and n_rows > 1
    computing = n_rows if split else 1
    b_row = micro // n_rows if split else micro
    tied = net.embed.lm_head is None
    rank2 = reference_rank2_names(cfg)
    cast = set(params) & rank2
    numel = {n: p.numel() for n, p in params.items()}
    n_all = sum(numel.values())
    n_cast = sum(numel[n] for n in cast)
    table = numel[TABLE] if (partial and tied and TABLE in cast) else 0

    batch = _meta_batch(cfg, shape)
    bspecs = [plan.batch_spec(n, t.shape) for n, t in batch.items()]
    slices = {n: _slice_shape(mesh, specs[n], p.shape) for n, p in params.items()}
    n_slice = sum(int(np.prod(s, dtype=np.int64)) for s in slices.values())
    batch_slice = _slice_bytes(mesh, batch.values(), bspecs)
    resident = 3 * 4 * n_slice + 4 + batch_slice  # masters, m, v, the step count
    activations = _train_activations(cfg, shape, b_row, partial, None if split else plan.ctx())
    casts = 2 * n_cast if not partial else 6 * table  # bf16 reads; the head's own copy
    added = {
        "gathered_f32": 4 * n_all,
        "bf16_casts": casts,
        "row_gradients": 4 * (n_all + table),
        "accum_gradients": 4 * n_all if grad_accum > 1 else 0,
        "activations": activations,
    }

    # HBM bytes on dev0 (the busiest entry), per term: ROW_TERMS are every
    # computing entry's, gradient_sum and norm_and_slices dev0's own, and
    # optimizer every entry's
    read_bytes = sum(numel[n] * (2 if (n in cast and not partial) else 4) for n in params)
    tokens_row = b_row * shape.seq_len
    act = act_dtype(cfg).itemsize
    boundary = cfg.n_layers * tokens_row * cfg.d_model * act * 2
    cast_traffic = n_cast * (6 if not partial else 12) + 14 * table
    others = computing - 1
    nbytes = {
        "gather": 4 * n_all,
        "casts": cast_traffic,
        "weights": 3 * read_bytes * grad_accum,
        "activations": 3 * boundary * grad_accum,
        "gradients": 4 * n_all * grad_accum + (12 * n_cast if partial else 0),
        "gradient_sum": 16 * n_all * others,
        "norm_and_slices": 8 * n_all,
        "optimizer": 28 * n_slice,
    }

    # the copies between entries, seen from dev0
    ops = []
    for n, p in params.items():
        groups = int(np.prod(p.shape, dtype=np.int64) // np.prod(slices[n], dtype=np.int64))
        ops.append(CollectiveOp("all-gather", "f32", tuple(p.shape), groups))
        if others:
            ops.append(CollectiveOp("collective-permute", "f32", tuple(p.shape), 2,
                                    trip_mult=others))
        if n_entries > 1:
            ops.append(CollectiveOp("collective-permute", "f32", slices[n], 2,
                                    trip_mult=n_entries - 1))
    return {
        "compute_entries": computing, "rows": n_rows, "entries": n_entries,
        "row_batch": b_row, "work": analytic_work(cfg, shape, computing),
        "argument_bytes": resident, "added": added, "bytes": nbytes, "ops": ops,
        "activations_from": "trace of one data row's train_loss and backward on meta "
                            "tensors (launch.dryrun._LiveBytes) at the whole depth, or at "
                            "two depths a period of the layer pattern apart and extended per "
                            "layer",
    }


def _serve_cell(cfg, shape, plan) -> dict:
    mesh = plan.mesh
    model = build(cfg)
    net = _serve_net(cfg, model)
    params = dict(net.named_parameters())
    specs = plan.param_shardings(params)
    n_rows = len(data_rows(mesh, plan.dp))
    split = shape.global_batch % n_rows == 0
    computing = n_rows if split else 1
    b_row = shape.global_batch // n_rows if split else shape.global_batch
    whole = sum(_nbytes(p.shape, p.dtype) for p in params.values())
    weight_slices = _slice_bytes(mesh, params.values(), specs.values())
    batch = _meta_batch(cfg, shape)
    bspecs = [plan.batch_spec(n, t.shape) for n, t in batch.items()]
    resident = weight_slices + _slice_bytes(mesh, batch.values(), bspecs)
    row_cache = model.init_cache(b_row, shape.seq_len, device="meta")
    cache_row_bytes = sum(_nbytes(t.shape, t.dtype) for t in _leaves(row_cache))
    added = {"rest_of_model": whole - weight_slices}
    if shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
        cspecs = _leaves(plan.cache_shardings(cache))
        cache_slices = _slice_bytes(mesh, _leaves(cache), cspecs)
        resident += cache_slices
        added["rest_of_row_cache"] = max(cache_row_bytes - cache_slices, 0)
        added["decode_transients"] = _decode_transients(cfg, shape, b_row)
    else:
        added["prefill_cache_and_activations"] = _prefill_transients(cfg, shape, b_row)
    tokens_row = b_row * (shape.seq_len if shape.kind == "prefill" else 1)
    boundary = cfg.n_layers * tokens_row * cfg.d_model * act_dtype(cfg).itemsize * 2
    bytes_row = {"weights": whole, "activations": 2 * boundary, "cache": cache_row_bytes}
    return {
        "compute_entries": computing, "rows": n_rows, "entries": int(mesh.devices.size),
        "row_batch": b_row, "work": analytic_work(cfg, shape, computing),
        "argument_bytes": resident, "added": added, "bytes": bytes_row, "ops": [],
        "activations_from": "trace of one data row's Model.prefill / decode on meta tensors "
                            "(launch.dryrun._LiveBytes) at the whole depth, or at two depths a "
                            "period of the layer pattern apart and extended per layer; prefill at "
                            "up to PREFILL_TRACE_LEN positions, scaled in proportion",
    }


# the bytes terms of a train cell that each computing entry moves (the rest
# are dev0's own, and the optimizer's every entry's)
ROW_TERMS = ("gather", "casts", "weights", "activations", "gradients")


def lower_cell(arch, shape, multi_pod: bool = False, grad_accum: int = 1, *,
               mesh=None) -> dict:
    """The record of one cell. ``arch`` and ``shape`` are names or configs;
    ``mesh`` (default: the production mesh on meta entries) may be any
    ``(pod,) data, model`` mesh."""
    t0 = time.perf_counter()
    cfg, shp = _resolve(arch, shape)
    if mesh is None:
        mesh, tag = _production(multi_pod), _mesh_tag(multi_pod)
    else:
        tag = "x".join(str(n) for n in mesh.devices.shape)
    plan = make_plan(mesh)
    if shp.kind == "train":
        cell = _train_cell(cfg, shp, plan, grad_accum)
    else:
        # serving weights are bf16; the reference drops the FSDP dim when the
        # model fits tp-only, and the port's plan does the same
        serve_tp_only = cfg.param_count() * 2 / mesh.shape["model"] < 8e9
        plan = make_plan(mesh, serve=serve_tp_only)
        cell = _serve_cell(cfg, shp, plan)
    computing = cell["compute_entries"]
    report = roofline_terms(cell["work"].flops, float(sum(cell["bytes"].values())), cell["ops"],
                            H100, _model_flops(cfg, shp) / computing)
    added = cell["added"]
    peak = cell["argument_bytes"] + sum(added.values())
    by_kind: dict[str, int] = {}
    for c in cell["ops"]:
        by_kind[c.kind] = by_kind.get(c.kind, 0) + 1
    return {
        "arch": cfg.name,
        "shape": shp.name,
        "mesh": tag,
        "kind": shp.kind,
        "status": "ok",
        "t_count_s": round(time.perf_counter() - t0, 3),
        "compute_entries": computing,
        "data_rows": cell["rows"],
        "entries": cell["entries"],
        "row_batch": cell["row_batch"],
        "memory": {
            "argument_bytes": cell["argument_bytes"],
            "peak_estimate_bytes": peak,
            "detail": {"argument": cell["argument_bytes"], **added},
            "activations_from": cell["activations_from"],
            "hbm_per_chip": H100.hbm_bytes,
            "fits": peak < H100.hbm_bytes,
        },
        "roofline": dict(report.to_dict(), step_time=report.step_time,
                         bytes_detail=cell["bytes"]),
        "collectives": by_kind,
        "sharding_fallbacks": list(plan.fallbacks),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "grad_accum": grad_accum,
        "hw": H100.name,
    }


# -- the miner -------------------------------------------------------------

def _ops_seconds(logic: float, popcounts: float, hw=H100) -> float:
    """The least time of ``logic`` 32-bit logic operations and ``popcounts``
    population counts at the card's rates (the larger of the two)."""
    return max(logic / hw.logic_ops_per_s, popcounts / hw.popc_per_s)


def mining_terms(t_parents: int, n_words: int, m_pairs: int, pair_shards: int,
                 word_shards: int, *, write: bool) -> dict:
    """One entry's work in ``core.sharded``'s level step: its pair shard's
    pairs over its word shard, through the indexed kernel (rows 3-4 of
    PERF.md §6): the parent rows its pairs reach read once (as many as
    ``2m`` rows drawn uniformly from ``t`` reach, in expectation), the pairs,
    the partial counts (and the children) written; an AND and two carry-save
    operations per pair and word, one popcount per 16 words. The pair
    shard's first entry sums its word shards' int32 partial counts."""
    m = m_pairs // pair_shards
    w = -(-n_words // word_shards)
    rows = round(t_parents * -np.expm1(2 * m * np.log1p(-1.0 / t_parents)))
    nbytes = {"parent_rows": rows * w * 4, "pairs": m * 8, "counts": m * 4,
              "children": m * w * 4 if write else 0,
              "count_sum": 3 * 4 * m * (word_shards - 1)}
    ops = ([CollectiveOp("collective-permute", "s32", (m,), 2, trip_mult=word_shards - 1)]
           if word_shards > 1 else [])
    t_coll, wire = collective_seconds(ops, H100)
    logic, popc = 3.0 * m * w, m * w / 16.0
    rep = RooflineReport(0.0, float(sum(nbytes.values())), wire, _ops_seconds(logic, popc),
                         sum(nbytes.values()) / H100.hbm_bw, t_coll, len(ops))
    resident = t_parents * w * 4 + m * 8
    peak = resident + m * 4 * word_shards + nbytes["children"]
    return {
        "memory": {"argument_bytes": resident, "peak_estimate_bytes": peak,
                   "detail": {"bits_and_pairs": resident, "partial_counts": m * 4 * word_shards,
                              "children": nbytes["children"]},
                   "hbm_per_chip": H100.hbm_bytes, "fits": peak < H100.hbm_bytes},
        "roofline": dict(rep.to_dict(), step_time=rep.step_time, bytes_detail=nbytes,
                         logic_ops_per_dev=logic, popcounts_per_dev=popc),
        "collectives": {"collective-permute": len(ops)} if ops else {},
    }


def tiled_terms(tiles: int, bm: int, n_words: int, n_dev: int = 1) -> dict:
    """The group-tiled count (row 11 of PERF.md §6) over ``tiles`` block
    pairs of ``bm`` rows: the reference's traffic model, both ``bm``-row
    blocks of every tile fetched (2·T·bm·W·4 bytes), and the work priced at
    the H100's logic and popcount rates (an AND and two carry-save
    operations per entry and word, one popcount per 16 words: the rates
    ``chip_smoke.py`` prices rows 1-11 with, from the CUDA C++ Programming
    Guide at compute capability 9.0)."""
    nbytes = 2 * tiles * bm * n_words * 4 / n_dev
    entries = tiles * bm * bm * n_words / n_dev
    t_c = _ops_seconds(3.0 * entries, entries / 16.0)
    return {"flops_per_dev": 0.0, "hbm_bytes_per_dev": nbytes, "collective_bytes_per_dev": 0,
            "t_compute": t_c, "t_memory": nbytes / H100.hbm_bw, "t_collective": 0.0,
            "n_collectives": 0, "dominant": "memory" if nbytes / H100.hbm_bw >= t_c
            else "compute", "model_flops": 0.0, "useful_flops_ratio": 0.0,
            "t_compute_from": f"the ALU route: 3 logic ops per entry and word at "
                              f"{H100.logic_ops_per_s:.4g}/s, 1 popcount per 16 words at "
                              f"{H100.popc_per_s:.4g}/s (H100); the port's kernel takes the "
                              "b1 tensor-core route, which has no data-sheet rate"}


def lower_mining(multi_pod: bool, *, t_parents=32768, n_words=262144, m_pairs_count=1 << 20,
                 m_pairs_write=1 << 16) -> list[dict]:
    """The sharded Kyiv level step on the production mesh: the group-tiled
    count (priced on the H100), then the count and write steps."""
    mesh = _production(multi_pod)
    pair_shards = mesh.shape["data"] * mesh.shape.get("pod", 1)
    word_shards = mesh.shape["model"]
    n_dev = int(mesh.devices.size)
    bm, g = 8, 64  # the reference's block rows and prefix-group size at the level equator
    tiles = (t_parents // g) * (g // bm) * (g // bm + 1) // 2
    tiled = tiled_terms(tiles, bm, n_words, n_dev)
    pairwise = 2 * m_pairs_count * n_words * 4 / n_dev
    tiled.update(baseline_t_memory=pairwise / H100.hbm_bw,
                 traffic_reduction=pairwise / tiled["hbm_bytes_per_dev"])
    out = [{"arch": "kyiv-mining-count-tiled",
            "shape": f"t{t_parents}_W{n_words}_M{m_pairs_count}_bm{bm}",
            "mesh": _mesh_tag(multi_pod), "kind": "mining", "status": "ok",
            "analytic_only": True, "memory": {"fits": True}, "roofline": tiled,
            "collectives": {}, "hw": H100.name}]
    for variant, m in (("count", m_pairs_count), ("write", m_pairs_write)):
        rec = mining_terms(t_parents, n_words, m, pair_shards, word_shards,
                           write=variant == "write")
        out.append({"arch": f"kyiv-mining-{variant}", "shape": f"t{t_parents}_W{n_words}_M{m}",
                    "mesh": _mesh_tag(multi_pod), "kind": "mining", "status": "ok",
                    "pair_shards": pair_shards, "word_shards": word_shards, **rec,
                    "hw": H100.name})
    return out


# -- the CLI ---------------------------------------------------------------

def _write(path: Path, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape id or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--mining", action="store_true", help="run the mining rows only")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--accum", type=int, default=1, help="grad accumulation steps")
    ap.add_argument("--tag", default="", help="suffix for record filenames")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.list:
        for arch, shape, skipped in cells(include_skipped=True):
            mark = "SKIP(long-context n/a)" if skipped else ""
            print(f"{arch.name:25s} x {shape.name:12s} {mark}")
        return
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    if args.mining:
        for mp in meshes:
            for rec in lower_mining(mp):
                _write(out / f"{rec['arch']}__{rec['mesh']}.json", rec)
                r = rec["roofline"]
                print(f"[ok] {rec['arch']:24s} {rec['mesh']:10s} tc={r['t_compute']:.2e} "
                      f"tm={r['t_memory']:.2e} tcoll={r['t_collective']:.2e} "
                      f"dom={r['dominant']}", flush=True)
        return

    failures = 0
    for arch, shape, skipped in cells(include_skipped=True):
        if args.arch not in (None, "all", arch.name) or args.shape not in (None, "all",
                                                                          shape.name):
            continue
        for mp in meshes:
            tag = f"{arch.name}__{shape.name}__{_mesh_tag(mp)}" + (
                f"__{args.tag}" if args.tag else "")
            path = out / f"{tag}.json"
            if skipped:
                _write(path, {"arch": arch.name, "shape": shape.name, "mesh": _mesh_tag(mp),
                              "status": "skipped",
                              "reason": "long_500k n/a for pure full-attention arch"})
                print(f"[skip] {tag}", flush=True)
                continue
            try:
                rec = lower_cell(arch.name, shape.name, mp, grad_accum=args.accum)
                _write(path, rec)
                r, m = rec["roofline"], rec["memory"]
                print(f"[ok] {tag:55s} count={rec['t_count_s']:6.2f}s "
                      f"peak={m['peak_estimate_bytes'] / 1e9:8.2f}GB fits={m['fits']} "
                      f"tc={r['t_compute']:.2e} tm={r['t_memory']:.2e} "
                      f"tcoll={r['t_collective']:.2e} dom={r['dominant']}", flush=True)
            except Exception as e:  # record the failure, keep going
                failures += 1
                _write(path, {"arch": arch.name, "shape": shape.name, "mesh": _mesh_tag(mp),
                              "status": "error", "error": repr(e),
                              "traceback": traceback.format_exc()[-4000:]})
                print(f"[FAIL] {tag}: {e!r}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("dry-run complete")


if __name__ == "__main__":
    main()
