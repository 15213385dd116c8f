"""Token embedding, the logits head and the chunked cross-entropy.

The tied head multiplies by ``embedding`` (V, D) through ``F.linear``, which
reads it in place: no transposed copy per call. At training shapes the full
(B, S, V) logits do not fit: :func:`chunked_xent` computes the loss one
sequence chunk at a time (logits, logsumexp, label logit), each chunk under
a non-reentrant checkpoint, so the backward pass recomputes one chunk's
logits at a time and the full logits never exist.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import dense_init, param

__all__ = ["Embed", "init_embed", "embed_tokens", "logits_head", "chunked_xent"]


class Embed(nn.Module):
    """``embedding`` (V, D) and, when untied, ``lm_head`` (D, V). A tied
    table keeps an empty ``lm_head`` slot, so a caller that reads the
    parameters through substitutes (``training.train._reading``) can give
    the head its own tensor of the same values."""

    def __init__(self, vocab: int, d_model: int, tie: bool, device=None):
        super().__init__()
        self.embedding = param(vocab, d_model, device=device)
        self.register_parameter("lm_head", None if tie else param(d_model, vocab, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init(self.embedding, generator, in_axis=1)
        if self.lm_head is not None:
            dense_init(self.lm_head, generator)


def init_embed(generator: torch.Generator, vocab: int, d_model: int, tie: bool,
               device=None) -> Embed:
    e = Embed(vocab, d_model, tie, device)
    e.reset_parameters(generator)
    return e


class _Gather(torch.autograd.Function):
    """``F.embedding`` whose backward pass sums the rows' gradients in
    float32 and rounds the sum to the table's dtype once, on the CPU as on
    the card (the CPU's native backward of a bfloat16 table rounds after
    every row; the card's sums in float32)."""

    @staticmethod
    def forward(ctx, weight: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(tokens)
        ctx.rows = weight.shape[0]
        return F.embedding(tokens, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (tokens,) = ctx.saved_tensors
        g = torch.ops.aten.embedding_dense_backward(grad.float(), tokens, ctx.rows, -1, False)
        return g.to(grad.dtype), None


def embed_tokens(p: Embed, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return _Gather.apply(p.embedding, tokens).to(dtype)


def logits_head(p: Embed, h: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) logits in h's dtype."""
    if p.lm_head is not None:
        return h @ p.lm_head.to(h.dtype)
    return F.linear(h, p.embedding.to(h.dtype))


def _head_matrix(p: Embed, dtype: torch.dtype) -> torch.Tensor:
    """The head as a (V, D) matrix for ``F.linear``."""
    if p.lm_head is not None:
        return p.lm_head.to(dtype).T
    return p.embedding.to(dtype)


def _chunk_nll(hb: torch.Tensor, lb: torch.Tensor, w: torch.Tensor):
    """(summed NLL over valid labels, valid count) of one chunk."""
    valid = lb >= 0
    logits = F.linear(hb, w).float()  # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    lbl = logits.gather(-1, lb.clamp_min(0)[..., None])[..., 0]
    nll = torch.where(valid, lse - lbl, 0.0)
    return nll.sum(), valid.sum(dtype=torch.int32)


def chunked_xent(p: Embed, h: torch.Tensor, labels: torch.Tensor, chunk: int = 512
                 ) -> torch.Tensor:
    """Mean next-token cross-entropy without the full logits.

    h: (B, S, D) final hidden states; labels: (B, S) int (-1 = ignore). The
    sequence is padded to a multiple of the chunk with ignored labels."""
    b, s, _ = h.shape
    w = _head_matrix(p, h.dtype)
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    remat = torch.is_grad_enabled()
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int32, device=h.device)
    for i in range(0, h.shape[1], c):
        hb, lb = h[:, i:i + c], labels[:, i:i + c]
        if remat:
            nll, n = checkpoint(_chunk_nll, hb, lb, w, use_reentrant=False)
        else:
            nll, n = _chunk_nll(hb, lb, w)
        loss_sum = loss_sum + nll
        count = count + n
    return loss_sum / count.clamp_min(1)
