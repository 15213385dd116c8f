"""Mixture-of-experts channel mixing with grouped capacity-based dispatch.

Routing: softmax router -> top-k experts per token, weights renormalised over
the selected k. Tokens are processed in **groups** (GShard semantics): the
token axis is reshaped to (G, t_g), with G the number of entries of the
data axes of the sharding context (lowered until it divides the tokens; one
group without a context), and each group scatters its tokens into a
per-group capacity buffer ``(G, E, C_g, d)``; an assignment beyond
``C_g = moe_capacity(t_g, E, k, factor)`` is dropped. Assignments take their
slots in the flattened ``(token, k)`` order, so the same ones are dropped as
in the reference. A dropped assignment goes to a spare buffer row, so no
shape depends on the data and nothing waits on the device. Combine is a
gather and a weighted sum of each token's k terms, added in order (the
CPU's ``index_add_`` over tokens, bit for bit; on the card ``index_add_``
adds with atomics in no fixed order, and the step would not repeat).
Shared experts (DeepSeek-V2 style) run densely for every token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ShardCtx, dense_init, param

__all__ = ["MoE", "apply_moe", "moe_capacity"]


def moe_capacity(tokens_per_group: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(tokens_per_group * top_k / n_experts * factor) + 1
    return max(8, -(-c // 8) * 8)  # rounded up to a multiple of 8, as the reference


class MoE(nn.Module):
    def __init__(self, d_model: int, cfg, device=None):
        super().__init__()
        e, f = cfg.n_experts, cfg.d_expert
        self.router = param(d_model, e, device=device)
        self.w_gate = param(e, d_model, f, device=device)
        self.w_up = param(e, d_model, f, device=device)
        self.w_down = param(e, f, d_model, device=device)
        fs = f * cfg.n_shared
        self.sh_gate = param(d_model, fs, device=device) if fs else None
        self.sh_up = param(d_model, fs, device=device) if fs else None
        self.sh_down = param(fs, d_model, device=device) if fs else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init(self.router, generator)
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init(w, generator, in_axis=1)
        for w in (self.sh_gate, self.sh_up, self.sh_down):
            if w is not None:
                dense_init(w, generator)


def _n_groups(t: int, ctx: ShardCtx | None) -> int:
    """The data axes' size, lowered until it divides the ``t`` tokens."""
    g = ctx.axis_size(ctx.dp) if (ctx is not None and ctx.mesh is not None) else 1
    while t % g:
        g -= 1
    return max(g, 1)


def apply_moe(p: MoE, x: torch.Tensor, cfg, ctx: ShardCtx | None = None,
              n_groups: int | None = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). cfg: configs.base.MoECfg."""
    dt = x.dtype
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    G = n_groups or _n_groups(t, ctx)
    tg = t // G
    cap = moe_capacity(tg, e, k, cfg.capacity_factor)
    xg = x.reshape(G, tg, d)

    probs = torch.softmax((xg @ p.router.to(dt)).float(), dim=-1)  # (G, tg, E)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = expert_ids.reshape(G, tg * k)
    # slot of each assignment: the number of earlier assignments (in
    # (token, k) order) to the same expert within its group
    onehot_cum = torch.cumsum(F.one_hot(flat_e, e), dim=1)  # (G, tg*k, E)
    pos = onehot_cum.gather(2, flat_e[..., None])[..., 0] - 1
    keep = pos < cap
    tok_idx = torch.arange(tg, device=x.device).repeat_interleave(k)  # (tg*k,)
    g_idx = torch.arange(G, device=x.device)[:, None]
    # a dropped assignment writes to the spare expert row e, cut off below
    scatter_e = torch.where(keep, flat_e, e)
    pos_c = torch.where(keep, pos, 0)
    buf = torch.zeros((G, e + 1, cap, d), dtype=dt, device=x.device)
    buf[g_idx, scatter_e, pos_c] = xg[:, tok_idx]
    buf = buf[:, :e]

    h_gate = torch.einsum("gecd,edf->gecf", buf, p.w_gate.to(dt))
    h_up = torch.einsum("gecd,edf->gecf", buf, p.w_up.to(dt))
    out_buf = torch.einsum("gecf,efd->gecd", F.silu(h_gate) * h_up, p.w_down.to(dt))

    gathered = out_buf[g_idx, scatter_e.clamp_max(e - 1), pos_c]  # (G, tg*k, d)
    gathered = gathered.masked_fill(~keep[..., None], 0.0)
    weighted = (gathered * gate_vals.reshape(G, tg * k).to(dt)[..., None]).reshape(G, tg, k, d)
    # each token's k terms added in order, rounding after each add: what
    # index_add_ over tok_idx computes on the CPU, without the card's atomics
    out = weighted[:, :, 0]
    for j in range(1, k):
        out = out + weighted[:, :, j]
    out = out.reshape(b, s, d)

    if p.sh_gate is not None:
        xt = x.reshape(t, d)
        sh = F.silu(xt @ p.sh_gate.to(dt)) * (xt @ p.sh_up.to(dt))
        out = out + (sh @ p.sh_down.to(dt)).reshape(b, s, d)
    return out
