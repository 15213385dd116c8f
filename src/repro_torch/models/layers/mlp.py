"""Channel-mixing blocks: gated (SwiGLU/GeGLU) and plain (GELU/squared-ReLU) MLPs.

GELU is the tanh approximation everywhere, as ``jax.nn.gelu`` defaults to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init, param

__all__ = ["MLP", "apply_mlp", "gelu", "ACTIVATIONS"]

ACTIVATIONS = ("swiglu", "geglu", "gelu", "squared_relu")


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return gelu(x)
    if name == "squared_relu":  # Primer / Nemotron-4
        r = F.relu(x)
        return r * r
    raise ValueError(name)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, device=None):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        gated = act in ("swiglu", "geglu")
        self.w_gate = param(d_model, d_ff, device=device) if gated else None
        self.w_up = param(d_model, d_ff, device=device)
        self.w_down = param(d_ff, d_model, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            if w is not None:
                dense_init(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self, x, self.act)


def apply_mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    if act in ("swiglu", "geglu"):
        gate = x @ p.w_gate.to(dt)
        up = x @ p.w_up.to(dt)
        h = (F.silu(gate) if act == "swiglu" else gelu(gate)) * up
    else:
        h = _act(act, x @ p.w_up.to(dt))
    return h @ p.w_down.to(dt)
