"""AdamW with a warmup-cosine schedule and global-norm clipping, over dicts
of named tensors (a network's ``named_parameters()``).

The optimizer state is ``{"m": {name: tensor}, "v": {name: tensor},
"step": int32 tensor}``: float32 moments whatever the parameter dtype, on
the parameters' device. The update is the reference's decoupled-weight-decay
Adam, leaf by leaf in float32, and writes the new parameters and moments in
place. Weight decay applies to the leaves named in ``decay``: those of rank
2 or more in the reference's parameter layout, which stacks the layers of a
scanned group along a leading axis (``convert.reference_rank2_names``), so
a grouped layer's norm scale decays there and must decay here.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Collection, Mapping

import torch

__all__ = ["OptConfig", "lr_at", "adamw_init", "global_norm", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac * lr``; float32
    arithmetic on the step's device, as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac
                    + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = next(iter(params.values())).device
    return {
        "m": {k: zeros(p) for k, p in params.items()},
        "v": {k: zeros(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    sq = [x.float().square().sum() for x in tensors.values()]
    return torch.stack(sq).sum().sqrt()


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: dict,
                 params: Mapping[str, torch.Tensor], cfg: OptConfig,
                 decay: Collection[str], gnorm: torch.Tensor | None = None
                 ) -> tuple[dict, dict]:
    """One AdamW step: ``params`` and the moments are updated in place.
    ``gnorm`` is the global gradient norm for clipping (by default that of
    ``grads``; a sharded step passes the norm over every entry's slices).
    Returns (new opt_state, metrics ``{"lr", "grad_norm"}``, device tensors)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-9), max=1.0)
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    m_all, v_all = opt_state["m"], opt_state["v"]
    for name, p in params.items():
        m, v = m_all[name], v_all[name]
        g = grads[name].float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g.square()
        delta = (m_new / bc1) / ((v_new / bc2).sqrt() + cfg.eps)
        wd = cfg.weight_decay if name in decay else 0.0
        pf = p.float()
        p.copy_(pf - lr * (delta + wd * pf))
        m.copy_(m_new)
        v.copy_(v_new)
    return {"m": m_all, "v": v_all, "step": step}, {"lr": lr, "grad_norm": gnorm}
