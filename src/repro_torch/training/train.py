"""The train step on one device: the loss and its gradients (with gradient
accumulation over micro-batches), then AdamW on the float32 masters.

``make_train_step`` returns ``train_step(net, opt_state, batch) ->
(opt_state, metrics)``, which updates ``net``'s parameters in place. With
``cast_bf16`` (the default, as in the reference) the loss runs on bfloat16
copies of the leaves whose reference rank is 2 or more
(``convert.reference_rank2_names``, float32 configs too): the layers read
those values, and the gradient flows back through the cast to the float32
master. The other leaves, and the moments, stay float32. Nothing in the
step waits on the device: ``metrics`` (``loss``, ``lr``, ``grad_norm``) are
device tensors. The data loop and checkpoints live in ``launch/train.py``.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..convert import reference_rank2_names
from ..models.zoo import Model
from .optimizer import OptConfig, adamw_init, adamw_update

__all__ = ["init_train_state", "make_train_step"]


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


def make_train_step(model: Model, opt_cfg: OptConfig, grad_accum: int = 1,
                    cast_bf16: bool = True):
    """``grad_accum > 1`` splits the leading batch axis into micro-batches
    and sums their float32 gradients (and losses), then divides by
    ``grad_accum``: the reference's scan over micro-batches."""
    rank2 = reference_rank2_names(model.cfg)

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
