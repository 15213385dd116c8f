"""Token embedding and the logits head (serving: decode-sized inputs).

The tied head multiplies by ``embedding`` (V, D) through ``F.linear``, which
reads it in place: no transposed copy per call. The training slice's chunked
cross-entropy is not here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init, param

__all__ = ["Embed", "init_embed", "embed_tokens", "logits_head"]


class Embed(nn.Module):
    """``embedding`` (V, D) and, when untied, ``lm_head`` (D, V)."""

    def __init__(self, vocab: int, d_model: int, tie: bool, device=None):
        super().__init__()
        self.embedding = param(vocab, d_model, device=device)
        self.lm_head = None if tie else param(d_model, vocab, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init(self.embedding, generator, in_axis=1)
        if self.lm_head is not None:
            dense_init(self.lm_head, generator)


def init_embed(generator: torch.Generator, vocab: int, d_model: int, tie: bool,
               device=None) -> Embed:
    e = Embed(vocab, d_model, tie, device)
    e.reset_parameters(generator)
    return e


def embed_tokens(p: Embed, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(tokens, p.embedding).to(dtype)


def logits_head(p: Embed, h: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) logits in h's dtype."""
    if p.lm_head is not None:
        return h @ p.lm_head.to(h.dtype)
    return F.linear(h, p.embedding.to(h.dtype))
