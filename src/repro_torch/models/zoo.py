"""Model zoo dispatcher: one step API over all ten architectures.

``build(cfg)`` returns a :class:`Model` whose ``init`` makes the network
(an ``nn.Module``) and whose ``forward`` / ``train_loss`` / ``prefill`` /
``decode`` / ``init_cache`` take it as their first argument, as the reference's take the
parameter pytree. Decoder-only families route to ``models.lm``, the audio
family to ``models.encdec``. A batch is a dict of tensors: ``tokens``
(B, S) and, per frontend, ``frames`` (B, S_enc, D) or ``patches``
(B, n_patches, D); training adds ``labels`` (B, S) (-1: ignored), decode
``positions`` (B,).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import encdec as _encdec
from . import lm as _lm
from .layers.common import cast_params

__all__ = ["Model", "build"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    @property
    def audio(self) -> bool:
        return self.cfg.family == "audio"

    def _new(self, device) -> nn.Module:
        return (_encdec.EncDec if self.audio else _lm.LM)(self.cfg, device)

    def init(self, generator: torch.Generator, device=None, dtype: torch.dtype | None = None
             ) -> nn.Module:
        """Random weights from ``generator`` (float32 masters; with ``dtype``
        the leaves outside ``F32_LEAVES`` are then stored in it)."""
        net = _lm.init_weights(self._new(device), generator)
        return net if dtype in (None, torch.float32) else cast_params(net, dtype)

    def load(self, state: dict) -> nn.Module:
        """The network holding ``state`` (``convert.lm_params_from_numpy``)."""
        net = self._new("meta")
        net.load_state_dict(state, strict=True, assign=True)
        return net

    def abstract_params(self) -> nn.Module:
        """The network on the meta device: shapes and dtypes, no storage."""
        return self._new("meta")

    def context_len(self, batch: dict) -> int:
        """Positions a prefill of ``batch`` fills: its tokens, after the
        vision stub's patches."""
        extra = self._extra(batch)
        return batch["tokens"].shape[1] + (0 if extra is None else extra.shape[1])

    def _extra(self, batch):
        return batch.get("patches") if self.cfg.frontend == "vision_stub" else None

    def forward(self, net: nn.Module, batch: dict, positions: slice | None = None):
        """Train-mode logits (B, S_text, V), or the ``positions`` slice of them."""
        if self.audio:
            return _encdec.encdec_logits(net, batch["frames"], batch["tokens"], positions)
        return _lm.lm_logits(net, batch["tokens"], self._extra(batch), positions)

    def train_loss(self, net: nn.Module, batch: dict, remat: bool = True, ctx=None
                   ) -> torch.Tensor:
        """Mean next-token cross-entropy (a float32 scalar), differentiable;
        under autograd with ``remat`` each layer is recomputed in the
        backward pass. ``ctx`` (a ``ShardCtx``, ``Plan.ctx()``) routes an
        MoE's tokens in one group per data entry, as the reference does."""
        if self.audio:
            return _encdec.encdec_train_loss(net, batch["frames"], batch["tokens"],
                                             batch["labels"], remat, ctx)
        return _lm.lm_train_loss(net, batch["tokens"], batch["labels"], self._extra(batch), remat,
                                 ctx)

    @torch.inference_mode()
    def prefill(self, net: nn.Module, batch: dict):
        """(last-position logits (B, 1, V), cache)."""
        if self.audio:
            return _encdec.encdec_prefill(net, batch["frames"], batch["tokens"])
        return _lm.lm_prefill(net, batch["tokens"], self._extra(batch))

    @torch.inference_mode()
    def decode(self, net: nn.Module, batch: dict, cache):
        """(logits (B, 1, V), cache); the cache is updated in place."""
        if self.audio:
            return _encdec.encdec_decode(net, batch["tokens"], batch["positions"], cache)
        return _lm.lm_decode(net, batch["tokens"], batch["positions"], cache)

    def init_cache(self, batch: int, max_len: int, device=None):
        if self.audio:
            return _encdec.init_encdec_cache(self.cfg, batch, max_len, device)
        return _lm.init_cache(self.cfg, batch, max_len, device)



def build(cfg: ArchConfig) -> Model:
    return Model(cfg)
