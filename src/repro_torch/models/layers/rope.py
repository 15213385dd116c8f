"""Rotary position embeddings (RoPE), half-split formulation."""

from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) float32 inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (..., S, H, hd) by position; positions (..., S) int.

    Half-split convention: pairs are (x[..., :hd/2], x[..., hd/2:]); the
    angles and the rotation are float32, the result has x's dtype.
    """
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * inv  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
