"""Gradient compression for the data-parallel reduce: int8 with a per-tensor
scale and stochastic rounding (unbiased: E[q] = g / scale).

``compressed_psum`` reduces the data entries' gradients to their mean with
int8 on the wire. Every entry quantizes at the shared scale, the max of the
entries' scales, taken *before* quantizing. The reference quantizes each
entry at its own scale and dequantizes the int32 sum at the max
(``src/repro/training/compression.py:54-59``): an entry whose largest
gradient is below the max then has its contribution multiplied by the
ratio of the scales, and the mean is biased. As in the reference, every
entry rounds with the same uniforms: one seeded draw per leaf.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum"]


def _scale(g: torch.Tensor) -> torch.Tensor:
    return g.float().abs().max() / 127.0 + 1e-20


def _quantize(g: torch.Tensor, scale: torch.Tensor, rnd: torch.Tensor) -> torch.Tensor:
    x = g.float() / scale
    lo = torch.floor(x)
    q = lo + (rnd < x - lo).float()
    return q.clamp(-127, 127).to(torch.int8)


def quantize_int8(g: torch.Tensor, generator: torch.Generator
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization at ``g``'s own scale:
    ``(q, scale)``; the uniforms come from ``generator`` (on ``g``'s device)."""
    scale = _scale(g)
    rnd = torch.rand(g.shape, generator=generator, device=g.device)
    return _quantize(g, scale, rnd), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(mesh, dp_axes: tuple[str, ...]):
    """``fn(grads, generator) -> reduced``: ``grads`` lists one gradient dict
    per data entry of ``mesh`` over ``dp_axes`` (row-major), each on its
    entry's device; ``reduced`` lists their mean, as int8 quantized at the
    shared scale and summed in int32, on each entry's device."""
    n = 1
    for a in dp_axes:
        n *= mesh.shape[a]

    def fn(grads: list[dict], generator: torch.Generator) -> list[dict]:
        if len(grads) != n:
            raise ValueError(f"{len(grads)} gradient trees for {n} data entries")
        out: list[dict] = [{} for _ in grads]
        for name, g0 in grads[0].items():
            dev0 = g0.device
            scale = torch.stack([_scale(g[name]).to(dev0) for g in grads]).max()
            rnd = torch.rand(g0.shape, generator=generator, device=generator.device)
            q32 = None
            for g in grads:
                t = g[name]
                q = _quantize(t, scale.to(t.device), rnd.to(t.device)).to(torch.int32).to(dev0)
                q32 = q if q32 is None else q32 + q
            mean = (q32.float() * scale / n).to(g0.dtype)
            for o, g in zip(out, grads):
                o[name] = mean.to(g[name].device)
        return out

    return fn
