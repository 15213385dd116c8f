"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Block structure: gate branch (linear -> GeLU) || recurrent branch (linear ->
causal depthwise conv1d(4) -> RG-LRU) -> elementwise product -> output linear.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a xi_t + b_a)          recurrence gate
    i_t = sigmoid(W_x xi_t + b_x)          input gate
    log a_t = -c * softplus(lambda) * r_t  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

The sequence form runs the linear recurrence h_t = a_t h_{t-1} + b_t in
float32 as a Hillis-Steele scan: log2(S) rounds, each combining every pair
(a, b) with the one ``offset`` steps before it, the same associative
operator as the reference's ``associative_scan``. Decode is the single-step
update on a (B, R) state plus the conv tail of the last ``d_conv - 1``
inputs. GeLU is the tanh form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init, param
from .mlp import gelu

__all__ = ["RGLRU", "rglru_train", "rglru_decode", "init_rglru_state",
           "linear_scan"]

_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, d_model: int, r_dim: int, d_conv: int = 4, device=None):
        super().__init__()
        self.w_gate = param(d_model, r_dim, device=device)
        self.w_in = param(d_model, r_dim, device=device)
        self.conv_w = param(d_conv, r_dim, device=device)
        self.w_a = param(r_dim, r_dim, device=device)
        self.b_a = param(r_dim, device=device)
        self.w_x = param(r_dim, r_dim, device=device)
        self.b_x = param(r_dim, device=device)
        self.lam = param(r_dim, device=device)
        self.w_out = param(r_dim, d_model, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_in, self.conv_w, self.w_a, self.w_x, self.w_out):
            dense_init(w, generator)
        with torch.no_grad():
            self.b_a.zero_()
            self.b_x.zero_()
            # softplus(lambda) at 0.7 gives a in (0.9, 0.999) at r = 1 (paper)
            self.lam.fill_(0.7)


def causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: u (B, S, C), w (K, C); K shifted adds."""
    k, s = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + up[:, i:i + s, :] * w[i]
    return out


def _gates(p: RGLRU, xi: torch.Tensor):
    dt = xi.dtype
    r = torch.sigmoid(xi @ p.w_a.to(dt) + p.b_a.to(dt))
    i = torch.sigmoid(xi @ p.w_x.to(dt) + p.b_x.to(dt))
    log_a = (-_C * F.softplus(p.lam.float())) * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt((1.0 - torch.exp(2.0 * log_a)).clamp_min(1e-12)) * (i.float() * xi.float())
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 from h = 0.

    Returns (cum_a, h): cum_a_t = prod_{s<=t} a_s, so a start state h0 adds
    cum_a_t * h0.
    """
    s = a.shape[1]
    offset = 1
    while offset < s:
        a_prev, b_prev = a[:, :-offset], b[:, :-offset]
        a_cur, b_cur = a[:, offset:], b[:, offset:]
        b = torch.cat([b[:, :offset], b_prev * a_cur + b_cur], dim=1)
        a = torch.cat([a[:, :offset], a_prev * a_cur], dim=1)
        offset *= 2
    return a, b


def rglru_train(p: RGLRU, x: torch.Tensor, initial_state: torch.Tensor | None = None,
                return_state: bool = False):
    """(B, S, D) -> (B, S, D) [+ state {"h": (B, R) float32, "conv": (B, K-1, R)}]."""
    dt = x.dtype
    gate = gelu(x @ p.w_gate.to(dt))
    xi_pre = x @ p.w_in.to(dt)
    xi = causal_conv(xi_pre, p.conv_w.to(dt))
    a, b = _gates(p, xi)
    cum_a, h = linear_scan(a, b)
    if initial_state is not None:
        h = h + cum_a * initial_state[:, None, :].float()
    out = (gate.float() * h).to(dt) @ p.w_out.to(dt)
    if return_state:
        d_conv = p.conv_w.shape[0]
        return out, {"h": h[:, -1, :], "conv": xi_pre[:, -(d_conv - 1):, :]}
    return out


def init_rglru_state(batch: int, r_dim: int, d_conv: int = 4, dtype=torch.float32,
                     device=None) -> dict:
    return {
        "h": torch.zeros((batch, r_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, d_conv - 1, r_dim), dtype=dtype, device=device),
    }


def rglru_decode(p: RGLRU, x: torch.Tensor, cache: dict):
    """One-step decode: x (B, 1, D) -> (B, 1, D), updated cache."""
    dt = x.dtype
    gate = gelu(x @ p.w_gate.to(dt))  # (B, 1, R)
    xi_pre = x @ p.w_in.to(dt)
    window = torch.cat([cache["conv"].to(dt), xi_pre], dim=1)  # (B, K, R)
    xi = torch.einsum("bkr,kr->br", window, p.conv_w.to(dt))[:, None, :]
    a, b = _gates(p, xi)  # (B, 1, R) float32
    h_new = a[:, 0] * cache["h"].float() + b[:, 0]
    out = (gate.float() * h_new[:, None, :]).to(dt) @ p.w_out.to(dt)
    return out, {"h": h_new, "conv": window[:, 1:, :]}
