"""Decoder-only LM covering dense / MoE / MLA / SSM / hybrid / VLM architectures.

The model is an ``nn.ModuleList`` of per-layer blocks in layer order
(``cfg.layer_types()``); the reference stacks the repeats of ``cfg.pattern``
into scanned groups, and ``convert.lm_params_from_numpy`` unstacks them.
Three modes share the block bodies:

  * ``train``   full-sequence causal forward; under autograd each block runs
                through a non-reentrant checkpoint (its activations are
                recomputed in the backward pass), and ``lm_train_loss``
                takes the chunked cross-entropy of its output;
  * ``prefill`` full-sequence causal, emits per-layer caches;
  * ``decode``  one token against the caches (attention KV / ring-buffer KV /
                RG-LRU state / SSD state), which it updates in place.

A cache is a list of per-layer dicts: ``{"k", "v"}`` (B, L, KV, hd) for
attention, ``{"c_kv", "k_rope"}`` (B, L, .) for MLA, ``{"h", "conv"}`` for
RG-LRU and ``{"state", "conv"}`` for SSD. Axis 1 of an attention leaf is
the sequence. A local layer whose prompt is longer than its window keeps a
ring of ``window`` slots: slot ``p % window`` holds position ``p``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, act_dtype
from .layers.attention import chunked_attention, decode_attention, local_attention
from .layers.common import NormScales, dense_init, param, rms_norm
from .layers.embeddings import Embed, chunked_xent, embed_tokens, logits_head
from .layers.mla import MLA, mla_decode, mla_train_prefill
from .layers.mlp import MLP, apply_mlp
from .layers.moe import MoE, apply_moe
from .layers.rglru import RGLRU, init_rglru_state, rglru_decode, rglru_train
from .layers.rope import apply_rope
from .layers.ssd import SSD, init_ssd_state, ssd_decode, ssd_train

__all__ = ["Attention", "Block", "LM", "layout", "init_weights", "init_lm", "lm_forward",
           "lm_logits", "lm_train_loss", "lm_prefill", "lm_decode", "init_cache", "SEQ_LEAVES"]

# cache leaves whose axis 1 is the sequence
SEQ_LEAVES = ("k", "v", "c_kv", "k_rope")


def layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(prefix_len, n_groups, suffix_len) over cfg.n_layers, the reference's
    parameter layout (``convert.lm_params_from_numpy`` reads it)."""
    prefix = cfg.moe.first_dense if cfg.moe else 0
    glen = len(cfg.pattern)
    remaining = cfg.n_layers - prefix
    n_groups = remaining // glen
    return prefix, n_groups, remaining - n_groups * glen


class Attention(nn.Module):
    """GQA projections ``wq`` (D, H*hd), ``wk``/``wv`` (D, KV*hd), ``wo``, and
    with ``bias`` the ``bq``/``bk``/``bv`` biases."""

    def __init__(self, cfg: ArchConfig, bias: bool, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = param(d, h * hd, device=device)
        self.wk = param(d, kv * hd, device=device)
        self.wv = param(d, kv * hd, device=device)
        self.wo = param(h * hd, d, device=device)
        self.bq = param(h * hd, device=device) if bias else None
        self.bk = param(kv * hd, device=device) if bias else None
        self.bv = param(kv * hd, device=device) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init(w, generator)
        with torch.no_grad():
            for b in (self.bq, self.bk, self.bv):
                if b is not None:
                    b.zero_()

    def qkv(self, x: torch.Tensor, cfg: ArchConfig):
        """(B, S, D) -> q (B, S, H, hd), k and v (B, S, KV, hd), before RoPE."""
        b, s, _ = x.shape
        dt = x.dtype
        q, k, v = x @ self.wq.to(dt), x @ self.wk.to(dt), x @ self.wv.to(dt)
        if self.bq is not None:
            q = q + self.bq.to(dt)
            k = k + self.bk.to(dt)
            v = v + self.bv.to(dt)
        return (q.reshape(b, s, cfg.n_heads, cfg.head_dim),
                k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
                v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))


def _attn_apply(p: Attention, cfg: ArchConfig, x, kind, mode, state, lengths):
    b, s, _ = x.shape
    q, k, v = p.qkv(x, cfg)
    local = kind == "local" and bool(cfg.window)
    if mode in ("train", "prefill"):
        positions = torch.arange(s, device=x.device).expand(b, s)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if local:
            out = local_attention(q, k, v, window=cfg.window)
        else:
            out = chunked_attention(q, k, v, causal=True)
        new_state = None
        if mode == "prefill":
            if local and s > cfg.window:
                L = cfg.window
                slot = torch.arange(L, device=x.device)
                pos_of_slot = slot + ((s - 1 - slot) // L) * L  # ring layout p % L
                new_state = {"k": k[:, pos_of_slot], "v": v[:, pos_of_slot]}
            else:
                new_state = {"k": k, "v": v}
    else:  # decode: write slot idx of the caches in place, then attend
        positions = lengths[:, None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        L = state["k"].shape[1]
        is_ring = local and L <= cfg.window
        idx = (lengths % L) if is_ring else lengths.clamp_max(L - 1)
        bi = torch.arange(b, device=x.device)
        state["k"][bi, idx] = k[:, 0].to(state["k"].dtype)
        state["v"][bi, idx] = v[:, 0].to(state["v"].dtype)
        attn_len = (lengths + 1).clamp_max(L) if is_ring else lengths + 1
        win = cfg.window if (local and not is_ring) else 0
        out = decode_attention(q, state["k"], state["v"], attn_len, window=win)
        new_state = state
    return out.reshape(b, s, -1) @ p.wo.to(x.dtype), new_state


class Block(NormScales):
    """Pre-norm residual block: ``norm1`` and a mixer (``attn`` | ``rglru`` |
    ``ssd``), then (not for ``ssd``) ``norm2`` and ``mlp`` | ``moe``."""

    def __init__(self, cfg: ArchConfig, kind: str, layer_idx: int, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg, self.kind = cfg, kind
        self.norm1 = param(d, device=device)
        self.attn = self.rglru = self.ssd = None
        self.norm2 = self.mlp = self.moe = None
        if kind in ("attn", "local"):
            self.attn = (MLA(d, cfg.n_heads, cfg.mla, device) if cfg.mla is not None
                         else Attention(cfg, cfg.qkv_bias, device))
        elif kind == "rglru":
            self.rglru = RGLRU(d, cfg.rglru_dim, device=device)
        elif kind == "ssd":
            self.ssd = SSD(d, cfg.ssm, device)
            return  # mamba2 block: mixer only, no MLP
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        self.norm2 = param(d, device=device)
        if cfg.moe is not None and layer_idx >= cfg.moe.first_dense:
            self.moe = MoE(d, cfg.moe, device)
        else:
            ff = cfg.d_ff
            if cfg.moe is not None:
                ff = cfg.moe.first_dense_ff or cfg.d_ff
            self.mlp = MLP(d, ff, cfg.mlp_act, device)

    def forward(self, x: torch.Tensor, mode: str, state=None, lengths=None, ctx=None):
        cfg = self.cfg
        h = rms_norm(x, self.norm1)
        if self.attn is not None:
            if cfg.mla is None:
                mix, new_state = _attn_apply(self.attn, cfg, h, self.kind, mode, state, lengths)
            elif mode == "decode":
                mix, new_state = mla_decode(self.attn, h, state, lengths, cfg.n_heads, cfg.mla,
                                            cfg.rope_theta)
            else:
                mix, new_state = mla_train_prefill(self.attn, h, cfg.n_heads, cfg.mla,
                                                   cfg.rope_theta, return_cache=True)
        elif self.rglru is not None:
            if mode == "decode":
                mix, new_state = rglru_decode(self.rglru, h, state)
            else:
                mix, new_state = rglru_train(self.rglru, h, return_state=True)
        else:
            if mode == "decode":
                mix, new_state = ssd_decode(self.ssd, h, state, cfg.ssm)
            else:
                mix, new_state = ssd_train(self.ssd, h, cfg.ssm, return_state=True)
        x = x + mix
        if self.moe is not None:
            x = x + apply_moe(self.moe, rms_norm(x, self.norm2), cfg.moe, ctx)
        elif self.mlp is not None:
            x = x + apply_mlp(self.mlp, rms_norm(x, self.norm2), cfg.mlp_act)
        return x, (None if mode == "train" else new_state)


class LM(NormScales):
    """``embed``, ``layers`` (one :class:`Block` per layer) and ``final_norm``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab, cfg.d_model, cfg.tie_embeddings, device)
        self.layers = nn.ModuleList(
            Block(cfg, kind, i, device) for i, kind in enumerate(cfg.layer_types())
        )
        self.final_norm = param(cfg.d_model, device=device)


def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter, module by module in definition order."""
    for m in net.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return net


def init_lm(cfg: ArchConfig, generator: torch.Generator, device=None) -> LM:
    return init_weights(LM(cfg, device), generator)


def _embed_inputs(net: LM, tokens, extra_embeds=None):
    cfg = net.cfg
    dt = act_dtype(cfg)
    tok = embed_tokens(net.embed, tokens, dt)
    if extra_embeds is not None:  # vlm: patch embeddings first
        tok = torch.cat([extra_embeds.to(dt), tok], dim=1)
    return tok * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=tok.device)


def lm_forward(net: LM, x: torch.Tensor, mode: str = "train", cache=None, lengths=None,
               remat: bool = True, ctx=None):
    """Run the block stack on embeddings x. Returns (hidden (B,S,D), new cache | None).

    In train mode under autograd with ``remat``, each block runs through a
    non-reentrant checkpoint (the reference checkpoints each scanned group;
    a checkpoint changes no number). ``ctx`` (a ``ShardCtx``) sets the MoE
    layers' routing groups."""
    if mode == "train" and remat and torch.is_grad_enabled():
        for block in net.layers:
            x, _ = checkpoint(block, x, mode, None, None, ctx, use_reentrant=False)
        return rms_norm(x, net.final_norm), None
    new_cache = []
    for i, block in enumerate(net.layers):
        x, ns = block(x, mode, None if cache is None else cache[i], lengths, ctx)
        new_cache.append(ns)
    return rms_norm(x, net.final_norm), (None if mode == "train" else new_cache)


def lm_logits(net: LM, tokens, extra_embeds=None, positions: slice | None = None):
    """Train-mode forward: logits (B, S_text, V) at the text positions
    (``positions`` selects a slice of them before the head)."""
    h, _ = lm_forward(net, _embed_inputs(net, tokens, extra_embeds), mode="train")
    if extra_embeds is not None:
        h = h[:, extra_embeds.shape[1]:]
    if positions is not None:
        h = h[:, positions]
    return logits_head(net.embed, h)


def lm_train_loss(net: LM, tokens, labels, extra_embeds=None, remat: bool = True, ctx=None):
    """Mean next-token cross-entropy of ``labels`` (B, S_text) (-1: ignored)
    over the text positions (a VLM's patch positions are dropped)."""
    h, _ = lm_forward(net, _embed_inputs(net, tokens, extra_embeds), mode="train", remat=remat,
                      ctx=ctx)
    if extra_embeds is not None:
        h = h[:, extra_embeds.shape[1]:]
    return chunked_xent(net.embed, h, labels)


def lm_prefill(net: LM, tokens, extra_embeds=None):
    h, cache = lm_forward(net, _embed_inputs(net, tokens, extra_embeds), mode="prefill")
    return logits_head(net.embed, h[:, -1:]), cache


def lm_decode(net: LM, tokens, positions, cache):
    h, cache = lm_forward(net, _embed_inputs(net, tokens), mode="decode", cache=cache,
                          lengths=positions)
    return logits_head(net.embed, h), cache


def _block_state_shapes(cfg: ArchConfig, kind: str, batch: int, max_len: int, dt):
    if kind in ("attn", "local"):
        if cfg.mla is not None:
            return {"c_kv": ((batch, max_len, cfg.mla.kv_lora), dt),
                    "k_rope": ((batch, max_len, cfg.mla.rope_head_dim), dt)}
        L = min(cfg.window, max_len) if (kind == "local" and cfg.window) else max_len
        shp = (batch, L, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (shp, dt), "v": (shp, dt)}
    if kind == "rglru":
        st = init_rglru_state(batch, cfg.rglru_dim, dtype=dt, device="meta")
    elif kind == "ssd":
        st = init_ssd_state(batch, cfg.ssm, dtype=dt, device="meta")
    else:
        raise ValueError(kind)
    return {k: (tuple(v.shape), v.dtype) for k, v in st.items()}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> list[dict]:
    """Zero decode caches, one dict per layer (``device="meta"``: shapes only)."""
    dt = act_dtype(cfg)
    return [
        {k: torch.zeros(shape, dtype=d, device=device)
         for k, (shape, d) in _block_state_shapes(cfg, kind, batch, max_len, dt).items()}
        for kind in cfg.layer_types()
    ]
