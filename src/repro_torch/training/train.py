"""The train step: the loss and its gradients (with gradient accumulation
over micro-batches), then AdamW on the float32 masters; on one device, over
a sharding plan's mesh, or with int8-compressed data-parallel gradients.

``make_train_step`` returns ``train_step(net, opt_state, batch) ->
(opt_state, metrics)``, which updates ``net``'s parameters in place. With
``cast_bf16`` (the default, as in the reference) the loss runs on bfloat16
copies of the leaves whose reference rank is 2 or more
(``convert.reference_rank2_names``, float32 configs too): the layers read
those values, and the gradient flows back through the cast to the float32
master. The other leaves, and the moments, stay float32. Nothing in the
step waits on the device: ``metrics`` (``loss``, ``lr``, ``grad_norm``) are
device tensors. The data loop and checkpoints live in ``launch/train.py``.

With a plan (``distributed.sharding``) it returns ``(train_step,
shardings_for)``, as the reference does, and ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)`` is a ZeRO-3 step over the mesh's
entries on trees that ``distributed.elastic.redistribute`` placed
(``{name: Sharded}``; the moments likewise, the step count replicated):

  * each data row (the entries that share their data coordinates) gathers
    full float32 copies of the leaves onto its first entry, casts the
    rank >= 2 ones to bfloat16, and computes the loss and gradients of its
    slice of the batch, weighted by its share of the labelled tokens so that
    the rows add up to the reference's global mean. When the data axes do
    not divide the batch, the reference replicates it and still routes an
    MoE's tokens in one group per data entry: then the first row computes
    the whole batch once under ``plan.ctx()``;
  * the rows' float32 gradients are summed in row order, and each entry
    keeps its slice (a reduce-scatter);
  * the clipping norm is the summed gradient's, each leaf counted once,
    and AdamW updates every entry's own slices of the masters and moments
    (replicated slices get the same update and stay bit-identical).

The ``model`` axis splits the storage (parameters, moments and reduced
gradients), not the compute: no layer runs tensor-parallel, and two meshes
with the same data rows give the same bits.

``make_compressed_dp_step`` is the reference's manual data-parallel step:
each data entry computes the gradients of its batch slice on its own
replica, and ``compression.compressed_psum`` reduces them as int8 at a
shared scale.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..convert import reference_rank2_names
from ..distributed.elastic import Sharded, place
from ..models.zoo import Model
from .compression import compressed_psum
from .optimizer import OptConfig, adamw_init, adamw_update, global_norm

__all__ = ["init_train_state", "make_train_step", "make_compressed_dp_step",
           "sharded_adamw_init", "data_rows"]


def init_train_state(model: Model, generator: torch.Generator, opt_cfg: OptConfig,
                     device=None) -> tuple[nn.Module, dict]:
    """(network of float32 masters from ``generator`` on ``device``, AdamW state)."""
    net = model.init(generator, device)
    return net, adamw_init(dict(net.named_parameters()))


@contextlib.contextmanager
def _reading(net: nn.Module, tensors: dict):
    """Let ``net``'s layers read ``tensors`` in place of the parameters of
    those names. Checkpointed layers recompute inside the context, so the
    backward pass runs in it too."""
    saved = []
    try:
        for name, t in tensors.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = net.get_submodule(mod_name)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def make_train_step(model: Model, opt_cfg: OptConfig, plan=None, grad_accum: int = 1,
                    cast_bf16: bool = True):
    """``grad_accum > 1`` splits the leading batch axis into micro-batches
    and sums their float32 gradients (and losses), then divides by
    ``grad_accum``: the reference's scan over micro-batches. With ``plan``:
    ``(train_step, shardings_for)`` (the module note); its gathers and its
    reduce run under the profiler ranges ``plan_step.gather`` and
    ``plan_step.reduce``."""
    rank2 = reference_rank2_names(model.cfg)
    if plan is not None:
        def shardings_for(abstract_net):
            pspec = plan.param_shardings(abstract_net)
            return pspec, {"m": pspec, "v": pspec, "step": plan.replicated()}

        return (_plan_step(model, opt_cfg, plan, grad_accum, cast_bf16, rank2),
                shardings_for)

    def loss_and_grads(net: nn.Module, params: dict, batch: dict) -> torch.Tensor:
        """The loss of ``batch``; its gradients are added into ``.grad``."""
        cast = {}
        if cast_bf16:
            cast = {n: p.to(torch.bfloat16) for n, p in params.items()
                    if n in rank2 and p.dtype == torch.float32}
        with _reading(net, cast):
            loss = model.train_loss(net, batch)
            loss.backward()
        return loss.detach()

    def train_step(net: nn.Module, opt_state: dict, batch: dict):
        params = dict(net.named_parameters())
        for p in params.values():
            p.grad = None
        if grad_accum == 1:
            loss = loss_and_grads(net, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
            for i in range(grad_accum):
                micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])[i]
                         for k, v in batch.items()}
                loss = loss + loss_and_grads(net, params, micro)
            loss = loss / grad_accum
        # a leaf the loss does not read has a zero gradient, as in the reference
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in params.items()}
        if grad_accum > 1:
            for g in grads.values():
                g.div_(grad_accum)
        opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg, rank2)
        for p in params.values():
            p.grad = None
        return opt_state, dict(metrics, loss=loss)

    return train_step


def data_rows(mesh, dp_axes) -> list[list[tuple]]:
    """The mesh's entries by data row: row ``r`` (row-major over
    ``dp_axes``) lists the coordinates that share its data coordinates, in
    row-major order; its first entry computes."""
    dims = [mesh.axis_names.index(a) for a in dp_axes]
    n_rows = int(np.prod([mesh.devices.shape[d] for d in dims])) if dims else 1
    rows: list[list[tuple]] = [[] for _ in range(n_rows)]
    for c in np.ndindex(*mesh.devices.shape):
        r = 0
        for d in dims:
            r = r * mesh.devices.shape[d] + c[d]
        rows[r].append(c)
    return rows


def sharded_adamw_init(params: dict, plan) -> dict:
    """AdamW state for placed parameters: float32 zero moments with each
    parameter's spec, and a replicated int32 step count."""

    def zeros(s: Sharded) -> Sharded:
        return s.map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device))

    return {"m": {n: zeros(s) for n, s in params.items()},
            "v": {n: zeros(s) for n, s in params.items()},
            "step": place(torch.zeros((), dtype=torch.int32), plan.mesh, plan.replicated())}


def _micro(batch: dict, i: int, n: int) -> dict:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}


def _update_entries(params: dict, opt: dict, grads_at, gnorm_at, opt_cfg, rank2) -> dict:
    """AdamW on every entry's own slices; ``grads_at(c)`` gives entry ``c``'s
    gradient slices and ``gnorm_at(c)`` the clipping norm on its device.
    Returns entry (0, ...)'s metrics."""
    first = None
    for c in opt["step"].coords():
        mine = {n: s.shards[c] for n, s in params.items()}
        state = {"m": {n: s.shards[c] for n, s in opt["m"].items()},
                 "v": {n: s.shards[c] for n, s in opt["v"].items()},
                 "step": opt["step"].shards[c]}
        state, met = adamw_update(grads_at(c), state, mine, opt_cfg, rank2, gnorm_at(c))
        opt["step"].shards[c] = state["step"]
        first = met if first is None else first
    return first


TABLE, HEAD = "embed.embedding", "embed.lm_head"


def row_reads(full, cast: set, partial: bool, tied: bool) -> tuple[dict, dict]:
    """``(leaves, reads)`` of one data row: ``full`` yields ``(name, full
    float32 tensor)`` pairs (each is transformed before the next is drawn);
    ``leaves`` are the tensors that take gradients, ``reads`` what the
    layers read in place of the parameters (``row_grads`` below)."""
    leaves = {}
    for n, t in full:
        leaves[n] = (t.to(torch.bfloat16).float() if partial and n in cast else t
                     ).requires_grad_()
    if not partial:
        return leaves, {n: t.to(torch.bfloat16) if n in cast else t for n, t in leaves.items()}
    reads = dict(leaves)
    if tied and TABLE in cast:
        leaves[HEAD] = leaves[TABLE].detach().clone().requires_grad_()
        reads.update({HEAD: leaves[HEAD].T, TABLE: leaves[TABLE].to(torch.bfloat16)})
    return leaves, reads


def _plan_step(model: Model, opt_cfg: OptConfig, plan, grad_accum: int, cast_bf16: bool,
               rank2):
    net = model.abstract_params()  # the layers; every leaf is read through _reading
    tied = net.embed.lm_head is None
    mesh = plan.mesh
    rows = data_rows(mesh, plan.dp)
    row_dev = [mesh.devices[r[0]] for r in rows]
    dev0 = row_dev[0]

    def row_grads(params, cast, partial, mb, dev, weight, ctx):
        """(weighted loss on dev0, float32 gradients by name) of one row's
        micro-batch ``mb`` on ``dev``.

        One row reads bfloat16 copies of the ``cast`` leaves, as one device
        does: each use's gradient is rounded to bfloat16 on its way to the
        float32 copy. Rows that split the batch (``partial``) read float32
        copies holding the bfloat16 values instead, so their gradients stay
        float32 and the caller rounds their sum once, as the whole batch's
        is rounded; a tied table then gives its head its own copy (one
        device rounds the gather's and the head's gradients apart), and its
        gather reads the bfloat16 values, whose per-token rounding happens
        within a row."""
        with record_function("plan_step.gather"):
            leaves, reads = row_reads(((n, s.gather(dev)) for n, s in params.items()), cast,
                                      partial, tied)
        mb = {k: v.to(dev) for k, v in mb.items()}
        with _reading(net, reads):
            loss = model.train_loss(net, mb, ctx=ctx)
            (loss if weight is None else loss * weight).backward()
        loss = loss.detach().to(dev0)
        return (loss if weight is None else loss * weight), {
            n: torch.zeros_like(t) if t.grad is None else t.grad for n, t in leaves.items()}

    def train_step(params: dict, opt: dict, batch: dict):
        B = next(iter(batch.values())).shape[0] // grad_accum
        split = B % len(rows) == 0
        partial = split and len(rows) > 1
        cast = {n for n, s in params.items()
                if cast_bf16 and n in rank2 and s.dtype == torch.float32}
        loss = grads = None
        for i in range(grad_accum):
            mb = _micro(batch, i, grad_accum)
            if split:  # each row its slice, weighted by its share of the labels
                counts = (mb["labels"] >= 0).reshape(len(rows), -1).sum(1).tolist()
                parts = [({k: v.reshape(len(rows), B // len(rows), *v.shape[1:])[r]
                           for k, v in mb.items()}, r,
                          counts[r] / max(sum(counts), 1) if partial else None, None)
                         for r in range(len(rows))]
            else:  # replicated, as the reference does: the first row, G groups
                parts = [(mb, 0, None, plan.ctx())]
            micro_grads = None
            for part, r, weight, ctx in parts:
                l, g = row_grads(params, cast, partial, part, row_dev[r], weight, ctx)
                loss = l if loss is None else loss + l
                with record_function("plan_step.reduce"):
                    if micro_grads is None:
                        micro_grads = {n: t.to(dev0) for n, t in g.items()}
                    else:
                        for n, t in g.items():
                            micro_grads[n] += t.to(dev0)
                del g
            if partial:
                for n in cast:
                    micro_grads[n] = micro_grads[n].to(torch.bfloat16).float()
                if tied and TABLE in cast:
                    micro_grads[TABLE] = (micro_grads[TABLE].to(torch.bfloat16)
                                          + micro_grads.pop(HEAD).to(torch.bfloat16)).float()
            if grads is None:
                grads = micro_grads
            else:
                for n, t in micro_grads.items():
                    grads[n] += t
            del micro_grads
        if grad_accum > 1:
            loss = loss / grad_accum
            for g in grads.values():
                g.div_(grad_accum)
        with record_function("plan_step.reduce"):
            # the clip norm counts each leaf once, in one order whatever the
            # mesh's split, so the `model` axis changes no number
            gnorm = global_norm(grads)
            # the reduce-scatter: each entry keeps its slice of the summed gradients
            mine = {c: {n: grads[n][params[n].slices(c)].to(mesh.devices[c], copy=True)
                        for n in params} for c in opt["step"].coords()}
        del grads
        met = _update_entries(params, opt, lambda c: mine[c],
                              lambda c: gnorm.to(mesh.devices[c]), opt_cfg, rank2)
        return params, opt, dict(met, loss=loss)

    return train_step


def make_compressed_dp_step(model: Model, opt_cfg: OptConfig, mesh, dp_axes):
    """The manual data-parallel step: ``step(params, opt_state, batch,
    generator) -> (params, opt_state, metrics)`` on replicated placed trees
    (``distributed.elastic.place`` with spec ``()``). Each data row's first
    entry computes the loss and gradients of its slice of the batch on its
    own replica (float32, no bfloat16 cast, no sharding context: an MoE
    routes one group per row, as in the reference); the gradients are
    reduced by ``compression.compressed_psum`` (int8 at a shared scale,
    stochastic rounding from ``generator``), the losses averaged, and every
    entry takes the same AdamW update."""
    dp_axes = tuple(dp_axes)
    net = model.abstract_params()
    rank2 = reference_rank2_names(model.cfg)
    rows = data_rows(mesh, dp_axes)
    reduce = compressed_psum(mesh, dp_axes)

    def step(params: dict, opt: dict, batch: dict, generator: torch.Generator):
        B = next(iter(batch.values())).shape[0]
        if B % len(rows):
            raise ValueError(f"batch {B} does not split over {len(rows)} data entries")
        grads, losses = [], []
        for r, row in enumerate(rows):
            dev = mesh.devices[row[0]]
            leaves = {n: s.shards[row[0]].detach().requires_grad_() for n, s in params.items()}
            mb = {k: v.reshape(len(rows), B // len(rows), *v.shape[1:])[r].to(dev)
                  for k, v in batch.items()}
            with _reading(net, leaves):
                loss = model.train_loss(net, mb)
                loss.backward()
            losses.append(loss.detach())
            grads.append({n: torch.zeros_like(t) if t.grad is None else t.grad
                          for n, t in leaves.items()})
            del leaves
        reduced = reduce(grads, generator)
        del grads
        dev0 = mesh.devices[rows[0][0]]
        loss = torch.stack([l.to(dev0) for l in losses]).sum() / len(rows)
        row_of = {c: r for r, row in enumerate(rows) for c in row}
        met = _update_entries(
            params, opt,
            lambda c: {n: g.to(mesh.devices[c]) for n, g in reduced[row_of[c]].items()},
            lambda c: None, opt_cfg, rank2)
        return params, opt, dict(met, loss=loss)

    return step
