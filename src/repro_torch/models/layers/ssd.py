"""Mamba-2 SSD (state-space duality, arXiv:2405.21060), chunked dual form.

The sequence is split into chunks of length Q. Within a chunk the output is
the masked quadratic form (C B^T * decay) x; across chunks a recurrent state
(H, P, N) is carried by a loop over chunks. Decode keeps the (B, H, P, N)
state and the last ``d_conv - 1`` conv inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init, param, rms_norm
from .rglru import causal_conv

__all__ = ["SSD", "ssd_scan", "ssd_train", "ssd_decode", "init_ssd_state"]


class SSD(nn.Module):
    def __init__(self, d_model: int, ssm, device=None):
        super().__init__()
        di, g, n, h = ssm.d_inner, ssm.n_groups, ssm.d_state, ssm.n_heads
        conv_dim = di + 2 * g * n
        proj_out = 2 * di + 2 * g * n + h  # z, x, B, C, dt
        self.w_in = param(d_model, proj_out, device=device)
        self.conv_w = param(ssm.d_conv, conv_dim, device=device)
        self.A_log = param(h, device=device)
        self.D = param(h, device=device)
        self.dt_bias = param(h, device=device)
        self.gate_norm = param(di, device=device)
        self.w_out = param(di, d_model, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_in, self.conv_w, self.w_out):
            dense_init(w, generator)
        with torch.no_grad():
            self.A_log.zero_()
            self.D.fill_(1.0)
            self.dt_bias.zero_()
            self.gate_norm.zero_()


def _split_proj(proj, ssm):
    di, g, n = ssm.d_inner, ssm.n_groups, ssm.d_state
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    B = proj[..., 2 * di:2 * di + g * n]
    C = proj[..., 2 * di + g * n:2 * di + 2 * g * n]
    dt = proj[..., 2 * di + 2 * g * n:]
    return z, x, B, C, dt


def ssd_scan(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD. x: (b,s,h,p); dt: (b,s,h) (post-softplus); A: (h,) < 0;
    B, C: (b,s,g,n). Returns (y (b,s,h,p), final_state (b,h,p,n))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    hpg = h // g  # heads per B/C group

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, g, n)
    Cc = C.reshape(b, nc, q, g, n)

    dA = dtc * A  # (b,nc,q,h) log-decay per step
    cs = torch.cumsum(dA, dim=2)  # within-chunk cumulative
    seg_total = cs[:, :, -1, :]  # (b,nc,h)

    # intra-chunk (diagonal block): L[i,j] = exp(cs_i - cs_j) for j <= i
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (b,nc,q,q,h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # exp of the masked difference, not a masked exp: above the diagonal the
    # difference is positive and its exp overflows at long chunks, and the
    # gradient of a masked inf is 0 * inf = NaN
    L = torch.exp(diff.masked_fill(~mask[None, None, :, :, None], float("-inf")))
    CB = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc).repeat_interleave(hpg, dim=-1)
    y_diag = torch.einsum("bcijh,bcjh,bcjhp->bcihp", CB * L, dtc, xc)

    # chunk states: S_c = sum_j exp(seg_total - cs_j) * dt_j * B_j (x) x_j
    decay_states = torch.exp(seg_total[:, :, None, :] - cs)  # (b,nc,q,h)
    Bh = Bc.repeat_interleave(hpg, dim=-2) if g != h else Bc  # (b,nc,q,h,n)
    states = torch.einsum("bcqh,bcqh,bcqhn,bcqhp->bchpn", decay_states, dtc, Bh, xc)

    # inter-chunk recurrence: the state entering each chunk
    state = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state.to(x.dtype))
    prev_states = []
    for c in range(nc):
        prev_states.append(state)
        state = state * torch.exp(seg_total[:, c])[:, :, None, None] + states[:, c]
    prev = torch.stack(prev_states, dim=1)  # (b,nc,h,p,n)

    # inter-chunk contribution: y_off_i = (C_i . prev_state) * exp(cs_i)
    Ch = Cc.repeat_interleave(hpg, dim=-2) if g != h else Cc  # (b,nc,q,h,n)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, prev, torch.exp(cs))
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y, state


def _gated_out(p: SSD, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm (mamba2), then the output projection."""
    return rms_norm(y * F.silu(z), p.gate_norm) @ p.w_out.to(y.dtype)


def ssd_train(p: SSD, x: torch.Tensor, ssm, return_state: bool = False):
    """The mamba2 mixer after the pre-norm: (B,S,D) -> (B,S,D)
    [+ state {"state": (B,H,P,N) float32, "conv": (B, K-1, conv_dim)}]."""
    b, s, _ = x.shape
    dt_ = x.dtype
    z, xi, B, C, dt = _split_proj(x @ p.w_in.to(dt_), ssm)
    conv_in = torch.cat([xi, B, C], dim=-1)
    conv_out = F.silu(causal_conv(conv_in, p.conv_w.to(dt_)))
    di, g, n, h = ssm.d_inner, ssm.n_groups, ssm.d_state, ssm.n_heads
    xi = conv_out[..., :di].reshape(b, s, h, ssm.head_dim)
    B = conv_out[..., di:di + g * n].reshape(b, s, g, n)
    C = conv_out[..., di + g * n:].reshape(b, s, g, n)
    dt_act = F.softplus(dt.float() + p.dt_bias)  # (b,s,h)
    A = -torch.exp(p.A_log)  # (h,) negative
    y, final = ssd_scan(xi.float(), dt_act, A, B.float(), C.float(), ssm.chunk)
    y = y + xi.float() * p.D[None, None, :, None]
    out = _gated_out(p, y.reshape(b, s, di).to(dt_), z)
    if return_state:
        return out, {"state": final, "conv": conv_in[:, -(ssm.d_conv - 1):, :]}
    return out


def init_ssd_state(batch: int, ssm, dtype=torch.float32, device=None) -> dict:
    conv_dim = ssm.d_inner + 2 * ssm.n_groups * ssm.d_state
    return {
        "state": torch.zeros((batch, ssm.n_heads, ssm.head_dim, ssm.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, ssm.d_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def ssd_decode(p: SSD, x: torch.Tensor, cache: dict, ssm):
    """One-step decode: x (B, 1, D) -> (B, 1, D), updated cache."""
    b = x.shape[0]
    dt_ = x.dtype
    z, xi, B, C, dt = _split_proj(x @ p.w_in.to(dt_), ssm)
    window = torch.cat([cache["conv"].to(dt_), torch.cat([xi, B, C], dim=-1)], dim=1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p.conv_w.to(dt_)))
    di, g, n, h = ssm.d_inner, ssm.n_groups, ssm.d_state, ssm.n_heads
    xi = conv_out[..., :di].reshape(b, h, ssm.head_dim)
    hpg = h // g
    Bh = conv_out[..., di:di + g * n].reshape(b, g, n).repeat_interleave(hpg, dim=1)
    Ch = conv_out[..., di + g * n:].reshape(b, g, n).repeat_interleave(hpg, dim=1)
    dt_act = F.softplus(dt[:, 0].float() + p.dt_bias)  # (b,h)
    decay = torch.exp(dt_act * -torch.exp(p.A_log))  # (b,h)
    new_state = cache["state"].float() * decay[:, :, None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt_act, Bh.float(), xi.float()
    )
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), new_state)
    y = y + xi.float() * p.D[None, :, None]
    out = _gated_out(p, y.reshape(b, 1, di).to(dt_), z)
    return out, {"state": new_state, "conv": window[:, 1:, :]}
