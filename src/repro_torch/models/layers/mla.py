"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

KV is compressed into a per-token latent ``c_kv`` of rank ``kv_lora`` plus a
decoupled RoPE key of ``rope_head_dim``; that pair is all the KV cache
stores. Keys and values are re-expanded from the latent by up-projections at
attention time. Queries have a decoupled (nope, rope) split matching the
keys. This is the naive (non-absorbed) form, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import chunked_attention, decode_attention
from .common import dense_init, param, rms_norm
from .rope import apply_rope

__all__ = ["MLA", "init_mla", "mla_train_prefill", "mla_decode", "expand_kv"]


class MLA(nn.Module):
    def __init__(self, d_model: int, n_heads: int, mla, device=None):
        super().__init__()
        qd = n_heads * (mla.nope_head_dim + mla.rope_head_dim)
        self.wq = param(d_model, qd, device=device)
        self.w_dkv = param(d_model, mla.kv_lora + mla.rope_head_dim, device=device)
        self.kv_norm = param(mla.kv_lora, device=device)
        self.w_uk = param(mla.kv_lora, n_heads * mla.nope_head_dim, device=device)
        self.w_uv = param(mla.kv_lora, n_heads * mla.v_head_dim, device=device)
        self.wo = param(n_heads * mla.v_head_dim, d_model, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.w_dkv, self.w_uk, self.w_uv, self.wo):
            dense_init(w, generator)
        with torch.no_grad():
            self.kv_norm.zero_()


def init_mla(generator: torch.Generator, d_model: int, n_heads: int, mla, device=None) -> MLA:
    m = MLA(d_model, n_heads, mla, device)
    m.reset_parameters(generator)
    return m


def _project_q(p, x, n_heads, mla, positions, theta):
    b, s, _ = x.shape
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, n_heads, mla.nope_head_dim + mla.rope_head_dim)
    q_nope = q[..., : mla.nope_head_dim]
    q_rope = apply_rope(q[..., mla.nope_head_dim:], positions, theta)
    return q_nope, q_rope


def _compress_kv(p, x, mla, positions, theta):
    ckv_full = x @ p.w_dkv.to(x.dtype)  # (b, s, kv_lora + rope_hd)
    c_kv = rms_norm(ckv_full[..., : mla.kv_lora], p.kv_norm)
    # the decoupled rope key is one head's worth, shared across heads
    k_rope = apply_rope(ckv_full[..., mla.kv_lora:][:, :, None, :], positions, theta)
    return c_kv, k_rope[:, :, 0, :]


def expand_kv(p, c_kv, n_heads, mla):
    """Latent (b, s, kv_lora) -> k_nope, v: (b, s, H, nope/v head dims)."""
    b, s, _ = c_kv.shape
    k_nope = (c_kv @ p.w_uk.to(c_kv.dtype)).reshape(b, s, n_heads, mla.nope_head_dim)
    v = (c_kv @ p.w_uv.to(c_kv.dtype)).reshape(b, s, n_heads, mla.v_head_dim)
    return k_nope, v


def _full_qk(q_nope, q_rope, k_nope, k_rope, n_heads, mla):
    """Concatenate nope and rope parts per head; the rope key broadcasts over heads."""
    b, s = k_rope.shape[:2]
    k_rope_h = k_rope[:, :, None, :].expand(b, s, n_heads, mla.rope_head_dim)
    return torch.cat([q_nope, q_rope], dim=-1), torch.cat([k_nope, k_rope_h], dim=-1)


def mla_train_prefill(p: MLA, x: torch.Tensor, n_heads: int, mla, theta: float,
                      return_cache: bool = False):
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q_nope, q_rope = _project_q(p, x, n_heads, mla, positions, theta)
    c_kv, k_rope = _compress_kv(p, x, mla, positions, theta)
    k_nope, v = expand_kv(p, c_kv, n_heads, mla)
    q_full, k_full = _full_qk(q_nope, q_rope, k_nope, k_rope, n_heads, mla)
    out = chunked_attention(q_full, k_full, v, causal=True)
    out = out.reshape(b, s, n_heads * mla.v_head_dim) @ p.wo.to(x.dtype)
    if return_cache:
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    return out


def mla_decode(p: MLA, x: torch.Tensor, cache: dict, lengths: torch.Tensor, n_heads: int,
               mla, theta: float):
    """One-step decode. cache: c_kv (B, L, kv_lora), k_rope (B, L, rope_hd),
    written in place at slot ``lengths[b]``."""
    b = x.shape[0]
    positions = lengths[:, None]  # (B, 1) current absolute position
    q_nope, q_rope = _project_q(p, x, n_heads, mla, positions, theta)
    c_kv_new, k_rope_new = _compress_kv(p, x, mla, positions, theta)
    bi = torch.arange(b, device=x.device)
    cache["c_kv"][bi, lengths] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][bi, lengths] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    # expand the whole cache (naive MLA): (B, L, H, ...)
    k_nope, v = expand_kv(p, cache["c_kv"], n_heads, mla)
    q_full, k_full = _full_qk(q_nope, q_rope, k_nope, cache["k_rope"], n_heads, mla)
    out = decode_attention(q_full, k_full, v, lengths + 1)
    out = out.reshape(b, 1, n_heads * mla.v_head_dim) @ p.wo.to(x.dtype)
    return out, cache
