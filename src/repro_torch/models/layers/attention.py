"""Memory-efficient attention cores, plain functions on tensors.

Three paths, all GQA-aware (query heads grouped over KV heads), with float32
scores, softmax and accumulation whatever the input dtype:

* :func:`chunked_attention` — online softmax over (q blocks x kv blocks);
  never materialises an (S, S) score matrix. Used for train and prefill of
  *global* layers. Under a causal mask a kv block that lies wholly after a q
  block is skipped: its contribution is exactly zero.

* :func:`local_attention` — sliding-window attention per q block against a
  fixed span of kv positions; O(S * window) time and memory (gemma3 and
  recurrentgemma local layers).

* :func:`decode_attention` — single-query attention against a KV cache with
  explicit length masking (and window masking for local layers).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["chunked_attention", "local_attention", "decode_attention"]

_NEG = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KV, G, hd) with H = KV * G."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _pad_seq(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Zero-pad axis 1 of a (B, S, ...) tensor."""
    if not (left or right):
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (left, right))


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 1024,
    block_k: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention. q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd|hdv)."""
    b, sq, h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    scale = hd ** -0.5
    bq, bk = min(block_q, sq), min(block_k, skv)
    pad_q, pad_k = (-sq) % bq, (-skv) % bk
    qg = _group(_pad_seq(q, 0, pad_q), n_kv).float()  # (B, Sq', KV, G, hd)
    kp = _pad_seq(k, 0, pad_k).float()
    vp = _pad_seq(v, 0, pad_k).float()
    nq, nk = qg.shape[1] // bq, kp.shape[1] // bk
    g = qg.shape[3]
    dev = q.device
    out = []
    for qi in range(nq):
        q_blk = qg[:, qi * bq:(qi + 1) * bq]
        qpos = qi * bq + torch.arange(bq, device=dev)
        acc = torch.zeros((b, bq, n_kv, g, hdv), dtype=torch.float32, device=dev)
        m = torch.full((b, bq, n_kv, g), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, bq, n_kv, g), dtype=torch.float32, device=dev)
        for ki in range(nk):
            if causal and ki * bk > (qi + 1) * bq - 1:
                break  # every later kv block is masked for every row of this q block
            k_blk = kp[:, ki * bk:(ki + 1) * bk]
            v_blk = vp[:, ki * bk:(ki + 1) * bk]
            s = torch.einsum("bqkgd,bckd->bqkgc", q_blk, k_blk) * scale
            kpos = ki * bk + torch.arange(bk, device=dev)
            mask = kpos[None, :] < skv  # kv padding
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            s = s.masked_fill(~mask[None, :, None, None, :], _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, v_blk)
            l = l * alpha + p.sum(dim=-1)
            m = m_new
        out.append(acc / l.clamp_min(1e-37)[..., None])
    o = torch.cat(out, dim=1).reshape(b, nq * bq, h, hdv)
    return o[:, :sq].to(q.dtype)


def local_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    block: int | None = None,
) -> torch.Tensor:
    """Sliding-window causal attention, O(S * window).

    Each q block attends to the span of kv positions covering
    [pos - window + 1, pos] for every pos in the block.
    """
    b, sq, h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    scale = hd ** -0.5
    blk = min(block or min(max(window // 2, 128), 1024), sq)
    pad_q = (-sq) % blk
    qg = _group(_pad_seq(q, 0, pad_q), n_kv).float()
    nq = qg.shape[1] // blk
    # kv span per q block: window + blk rounded up to blocks. Left-pad by the
    # span so the first block's slice is in range, right-pad by pad_q so a
    # padded q block's slice is too
    span = ((window + blk - 1) // blk + 1) * blk
    kp = _pad_seq(k, span, pad_q)
    vp = _pad_seq(v, span, pad_q)
    dev = q.device
    out = []
    for qi in range(nq):
        q_end = (qi + 1) * blk  # one past the last q pos
        # unpadded kv start = q_end - span; +span for the left pad = q_end
        k_span = kp[:, q_end:q_end + span].float()
        v_span = vp[:, q_end:q_end + span].float()
        s = torch.einsum("bqkgd,bckd->bqkgc", qg[:, qi * blk:(qi + 1) * blk], k_span) * scale
        qpos = qi * blk + torch.arange(blk, device=dev)
        kpos = (q_end - span) + torch.arange(span, device=dev)  # <0: left pad
        valid = (
            (kpos[None, :] <= qpos[:, None])
            & (kpos[None, :] > qpos[:, None] - window)
            & (kpos[None, :] >= 0)
            & (kpos[None, :] < skv)
        )
        s = s.masked_fill(~valid[None, :, None, None, :], _NEG)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bqkgc,bckd->bqkgd", p, v_span)
        out.append(o / p.sum(dim=-1).clamp_min(1e-37)[..., None])
    o = torch.cat(out, dim=1).reshape(b, nq * blk, h, hdv)
    return o[:, :sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Single-step attention against a cache.

    q: (B, 1, H, hd); k/v_cache: (B, L, KV, hd|hdv); lengths: (B,) valid
    entries (cache slots < lengths are attended). For windowed layers held
    as a ring buffer of L = window slots the caller passes ``window=0``: all
    L slots are valid once full.
    """
    b, _, h, hd = q.shape
    L, n_kv = k_cache.shape[1], k_cache.shape[2]
    hdv = v_cache.shape[-1]
    scale = hd ** -0.5
    qg = _group(q, n_kv)[:, 0].float()  # (B, KV, G, hd)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k_cache.float()) * scale
    slot = torch.arange(L, device=q.device)[None, :]
    valid = slot < lengths[:, None]
    if window:
        valid = valid & (slot >= lengths[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bkgl,blkd->bkgd", p, v_cache.float())
    o = o / p.sum(dim=-1).clamp_min(1e-37)[..., None]
    return o.reshape(b, 1, h, hdv).to(q.dtype)
