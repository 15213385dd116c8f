"""Shared layer utilities: the sharding context, the RMS norm, the
initializers and dtype casts.

``ShardCtx`` names the mesh axes that the sharding plan
(``distributed.sharding``) reads: its only numerical effect is the number of
an MoE's routing groups (``moe._n_groups``), one per entry of the data axes,
as in the reference. The port has no ``shard``: a torch tensor is one
entry's, and nothing constrains a layout inside it (the plan stores the
slices, and the train step splits the batch over the data rows).

Parameters are float32 master weights, as in the reference, unless a caller
stores them in bfloat16 (:func:`cast_params`): every layer reads a weight
through ``.to(x.dtype)``, which is free when it already has that dtype.
The leaves that the layers read in float32 (norm scales and the recurrence
constants, ``F32_LEAVES``) stay float32 either way.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

__all__ = ["F32_LEAVES", "ShardCtx", "rms_norm", "dense_init", "param", "NormScales", "cast",
           "cast_params"]

# leaves read in float32 whatever the activation dtype
F32_LEAVES = frozenset(
    {"norm1", "norm2", "norm_x", "final_norm", "enc_norm", "kv_norm", "gate_norm",
     "lam", "A_log", "D", "dt_bias"}
)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Logical axes over a ``launch.mesh.Mesh``: ``dp`` the data-parallel
    axes (``("data",)`` or ``("pod", "data")``), ``tp`` the tensor axis
    (``"model"``) or None."""

    mesh: object = None
    dp: tuple[str, ...] = ()
    tp: str | None = None

    def axis_size(self, logical: str | tuple[str, ...] | None) -> int:
        if self.mesh is None or logical is None:
            return 1
        axes = (logical,) if isinstance(logical, str) else logical
        size = 1
        for a in axes:
            size *= self.mesh.shape[a]
        return size

    def resolve(self, name) -> tuple[str, ...] | str | None:
        if name is None:
            return None
        if name == "dp":
            return self.dp if self.dp else None
        if name == "tp":
            return self.tp
        raise ValueError(f"unknown logical axis {name!r}")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a ``1 + scale`` gain; returns x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


def dense_init(t: torch.Tensor, generator: torch.Generator, in_axis: int = 0) -> torch.Tensor:
    """Fill ``t`` in place from a normal truncated at +-2 sigma, sigma = fan_in ** -0.5."""
    std = t.shape[in_axis] ** -0.5
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def param(*shape: int, device=None) -> nn.Parameter:
    """An uninitialised float32 parameter (``reset_parameters`` fills it)."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class NormScales(nn.Module):
    """A module whose own parameters (not its children's) are all norm
    scales, zero at init (the norm's gain is ``1 + scale``)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in self.parameters(recurse=False):
                p.zero_()


def cast(x: torch.Tensor, dtype_str: str) -> torch.Tensor:
    return x.to(torch.bfloat16 if dtype_str == "bfloat16" else torch.float32)


def cast_params(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every leaf outside ``F32_LEAVES`` in ``dtype``, one leaf at a time.

    The layers read those leaves only through ``.to(activation dtype)``, so at
    ``dtype`` equal to the activation dtype this gives the same numbers as the
    float32 masters at a fraction of the memory.
    """
    for name, p in net.named_parameters():
        if name.rsplit(".", 1)[-1] not in F32_LEAVES:
            p.data = p.data.to(dtype)
    return net
