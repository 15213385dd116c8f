"""Sequence-sharded decode attention (flash-decoding on a mesh).

For long-context decode at batch 1 neither the batch nor the KV heads give
enough parallelism, and one device may not hold the cache. The cache's
sequence is split over a mesh axis: every entry attends its own slice with
a local log-sum-exp, and the entries combine exactly:

    m   = max(m_local)
    num = sum(exp(m_local - m) * acc_local)
    den = sum(exp(m_local - m) * l_local)
    out = num / den

Only the (B, KV, G, hd) partials move; the cache never leaves its entry.
"""

from __future__ import annotations

import torch

from ..distributed.elastic import Sharded, place

__all__ = ["seq_sharded_decode_attention"]

_NEG = -1e30


def _local_part(q, k_shard, v_shard, start: int, lengths, window: int):
    """Partial attention over a KV slice that starts at cache position
    ``start``: (acc, l, m), un-normalised, in float32."""
    b, _, h, hd = q.shape
    Ls, n_kv = k_shard.shape[1], k_shard.shape[2]
    qg = q.reshape(b, n_kv, h // n_kv, hd).float()
    s = torch.einsum("bkgd,blkd->bkgl", qg, k_shard.float()) * hd ** -0.5
    pos = start + torch.arange(Ls, device=q.device)[None, :]  # absolute cache positions
    valid = pos < lengths[:, None]
    if window:
        valid = valid & (pos >= lengths[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], _NEG)
    m = s.amax(dim=-1)  # (b, kv, g)
    p = torch.exp(s - m[..., None]).masked_fill(~valid[:, None, None, :], 0.0)
    acc = torch.einsum("bkgl,blkd->bkgd", p, v_shard.float())
    return acc, p.sum(dim=-1), m


def seq_sharded_decode_attention(mesh, *, seq_axis: str = "data", window: int = 0):
    """``f(q, k_cache, v_cache, lengths)`` with the cache's sequence dim split
    over ``seq_axis``. q: (B, 1, H, hd); k/v_cache: (B, L, KV, hd), either
    :class:`~repro_torch.distributed.elastic.Sharded` with spec ``(None,
    seq_axis, None, None)`` or a tensor (placed on the entries first);
    lengths: (B,). Returns (B, 1, H, hd) in q's dtype on the first entry."""
    if mesh.axis_names != (seq_axis,):
        raise ValueError(f"a sequence mesh has the one axis {seq_axis!r}, got {mesh.axis_names}")
    spec = (None, seq_axis, None, None)

    def fn(q, k_cache, v_cache, lengths):
        k, v = (c if isinstance(c, Sharded) else place(c, mesh, spec) for c in (k_cache, v_cache))
        b, _, h, hd = q.shape
        dev0 = mesh.devices.flat[0]
        parts = []
        for c in k.coords():
            dev = mesh.devices[c]
            start = k.slices(c)[1].start
            acc, l, m = _local_part(q.to(dev), k.shards[c], v.shards[c], start, lengths.to(dev),
                                    window)
            parts.append((acc.to(dev0), l.to(dev0), m.to(dev0)))
        m_glob = torch.stack([m for _, _, m in parts]).amax(dim=0)
        num = den = 0.0
        for acc, l, m in parts:
            w = torch.exp(m - m_glob)
            num = num + acc * w[..., None]
            den = den + l * w
        out = num / den.clamp_min(1e-37)[..., None]
        return out.reshape(b, 1, h, hd).to(q.dtype)

    return fn
