"""Encoder-decoder transformer (Whisper-style, arXiv:2212.04356).

Encoder: non-causal attention over (stubbed) audio-frame embeddings. Decoder:
causal self-attention + cross-attention into the encoder memory + MLP. The
conv frontend is a stub: the caller supplies frame embeddings already at
``d_model``.

Decode caches: ``{"self": [per layer {"k", "v"}], "cross": [per layer
{"k", "v"}]}``, the self-attention KV cache (axis 1 the sequence) and the
cross-attention K/V projected from the encoder memory once at prefill,
which decoding never changes or grows.

Training (``encdec_train_loss``) runs each encoder and decoder layer through
a non-reentrant checkpoint under autograd, as the reference checkpoints its
encoder and (in train mode) decoder scan bodies.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, act_dtype
from .layers.attention import chunked_attention, decode_attention
from .layers.common import NormScales, param, rms_norm
from .layers.embeddings import Embed, chunked_xent, embed_tokens, logits_head
from .layers.mlp import MLP, apply_mlp
from .layers.rope import apply_rope
from .lm import Attention

__all__ = ["EncDec", "encdec_encode", "encdec_logits", "encdec_train_loss", "encdec_prefill",
           "encdec_decode", "init_encdec_cache"]


class EncLayer(NormScales):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.norm1 = param(cfg.d_model, device=device)
        self.attn = Attention(cfg, False, device)
        self.norm2 = param(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, device)


class DecLayer(NormScales):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.norm1 = param(cfg.d_model, device=device)
        self.self_attn = Attention(cfg, False, device)
        self.norm_x = param(cfg.d_model, device=device)
        self.cross_attn = Attention(cfg, False, device)
        self.norm2 = param(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, device)


class EncDec(NormScales):
    """``embed``, ``enc_layers``, ``dec_layers``, ``enc_norm`` and ``final_norm``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab, cfg.d_model, cfg.tie_embeddings, device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device) for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device) for _ in range(cfg.n_layers))
        self.enc_norm = param(cfg.d_model, device=device)
        self.final_norm = param(cfg.d_model, device=device)


def _qkv_rope(p: Attention, x, cfg, positions):
    q, k, v = p.qkv(x, cfg)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _enc_layer(lp: EncLayer, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv_rope(lp.attn, rms_norm(x, lp.norm1), cfg, positions)
    o = chunked_attention(q, k, v, causal=False)
    x = x + o.reshape(b, s, -1) @ lp.attn.wo.to(x.dtype)
    return x + apply_mlp(lp.mlp, rms_norm(x, lp.norm2), cfg.mlp_act)


def encdec_encode(net: EncDec, frames: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """frames (B, S_enc, D) -> encoder memory (B, S_enc, D); under autograd
    with ``remat`` each layer runs through a checkpoint."""
    x = frames
    remat = remat and torch.is_grad_enabled()
    for lp in net.enc_layers:
        if remat:
            x = checkpoint(_enc_layer, lp, net.cfg, x, use_reentrant=False)
        else:
            x = _enc_layer(lp, net.cfg, x)
    return rms_norm(x, net.enc_norm)


def _dec_layer(lp: DecLayer, cfg, x, memory, mode, state, lengths):
    """memory: the encoder states (train, prefill) or this layer's cross cache."""
    b, s, _ = x.shape
    dt = x.dtype
    h = rms_norm(x, lp.norm1)
    if mode in ("train", "prefill"):
        positions = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = _qkv_rope(lp.self_attn, h, cfg, positions)
        o = chunked_attention(q, k, v, causal=True)
        new_self = {"k": k, "v": v}
    else:  # decode: write slot idx of the self cache in place
        q, k, v = _qkv_rope(lp.self_attn, h, cfg, lengths[:, None])
        L = state["k"].shape[1]
        bi = torch.arange(b, device=x.device)
        idx = lengths.clamp_max(L - 1)
        state["k"][bi, idx] = k[:, 0].to(state["k"].dtype)
        state["v"][bi, idx] = v[:, 0].to(state["v"].dtype)
        o = decode_attention(q, state["k"], state["v"], lengths + 1)
        new_self = state
    x = x + o.reshape(b, s, -1) @ lp.self_attn.wo.to(dt)

    hx = rms_norm(x, lp.norm_x)
    ca = lp.cross_attn
    qx = (hx @ ca.wq.to(dt)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    if isinstance(memory, dict):  # pre-projected cache
        km, vm = memory["k"], memory["v"]
    else:
        mb, ms, _ = memory.shape
        km = (memory @ ca.wk.to(dt)).reshape(mb, ms, cfg.n_kv_heads, cfg.head_dim)
        vm = (memory @ ca.wv.to(dt)).reshape(mb, ms, cfg.n_kv_heads, cfg.head_dim)
    ox = chunked_attention(qx, km, vm, causal=False)
    x = x + ox.reshape(b, s, -1) @ ca.wo.to(dt)
    x = x + apply_mlp(lp.mlp, rms_norm(x, lp.norm2), cfg.mlp_act)
    return x, new_self, {"k": km, "v": vm}


def _embed(net: EncDec, tokens, dt):
    x = embed_tokens(net.embed, tokens, dt)
    return x * torch.tensor(net.cfg.d_model ** 0.5, dtype=dt, device=x.device)


def _run_decoder(net: EncDec, x, memory, mode, cache=None, lengths=None, remat: bool = True):
    if mode == "train" and remat and torch.is_grad_enabled():
        for lp in net.dec_layers:
            x, _, _ = checkpoint(_dec_layer, lp, net.cfg, x, memory, mode, None, None,
                                 use_reentrant=False)
        return rms_norm(x, net.final_norm), None, None
    new_self, new_cross = [], []
    for i, lp in enumerate(net.dec_layers):
        st = None if cache is None else cache["self"][i]
        mem = memory if cache is None else cache["cross"][i]
        x, ns, nc = _dec_layer(lp, net.cfg, x, mem, mode, st, lengths)
        new_self.append(ns)
        new_cross.append(nc)
    return rms_norm(x, net.final_norm), new_self, new_cross


def encdec_logits(net: EncDec, frames, tokens, positions: slice | None = None):
    """Train-mode forward: logits (B, S, V) (``positions`` selects a slice)."""
    memory = encdec_encode(net, frames)
    x, _, _ = _run_decoder(net, _embed(net, tokens, memory.dtype), memory, "train")
    if positions is not None:
        x = x[:, positions]
    return logits_head(net.embed, x)


def encdec_train_loss(net: EncDec, frames, tokens, labels, remat: bool = True, ctx=None):
    """Mean next-token cross-entropy of the decoder over ``labels`` (B, S);
    ``ctx`` has no effect here (no MoE layer)."""
    memory = encdec_encode(net, frames, remat)
    x, _, _ = _run_decoder(net, _embed(net, tokens, memory.dtype), memory, "train", remat=remat)
    return chunked_xent(net.embed, x, labels)


def encdec_prefill(net: EncDec, frames, tokens):
    """Encode + decoder prefill; returns (last logits, cache)."""
    memory = encdec_encode(net, frames)
    x, new_self, new_cross = _run_decoder(net, _embed(net, tokens, memory.dtype), memory,
                                          "prefill")
    return logits_head(net.embed, x[:, -1:]), {"self": new_self, "cross": new_cross}


def encdec_decode(net: EncDec, tokens, positions, cache):
    x = _embed(net, tokens, act_dtype(net.cfg))
    x, new_self, _ = _run_decoder(net, x, None, "decode", cache, positions)
    return logits_head(net.embed, x), {"self": new_self, "cross": cache["cross"]}


def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    dt = act_dtype(cfg)
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    xs = (batch, cfg.cross_attn_len, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "self": [{"k": zeros(kv), "v": zeros(kv)} for _ in range(cfg.n_layers)],
        "cross": [{"k": zeros(xs), "v": zeros(xs)} for _ in range(cfg.n_layers)],
    }
