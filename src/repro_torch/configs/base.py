"""Architecture + shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig`; the four
assigned input shapes are :class:`ShapeConfig` entries in ``SHAPES``.
``input_specs(arch, shape)`` gives the ``(shape, torch.dtype)`` of every
model input of the corresponding step, without allocating.

Reduced configs for CPU smoke tests come from :func:`reduced`, which scales
depth/width/vocab down while preserving the family-defining structure
(pattern, MoE routing, MLA shapes, SSD state, etc.).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "MoECfg",
    "MLACfg",
    "SSMCfg",
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "reduced",
    "act_dtype",
    "input_specs",
    "step_kind",
]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_dense: int = 0  # leading dense layers (DeepSeek-V2 style)
    first_dense_ff: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_inner: int = 2048
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    d_conv: int = 4

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...] = ("attn",)  # cycled block types per layer
    window: int = 0  # local-attention window
    qkv_bias: bool = False
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu | squared_relu
    rope_theta: float = 10000.0
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    rglru_dim: int = 0  # recurrent branch width for "rglru" blocks
    enc_layers: int = 0  # encoder depth for enc-dec (n_layers = decoder depth)
    n_patches: int = 0  # vlm: patch tokens prepended
    frontend: str | None = None  # audio_stub | vision_stub
    cross_attn_len: int = 1500  # enc-dec decode: encoder memory length
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # which shape ids this arch supports (long_500k only for sub-quadratic)
    supports_long_context: bool = False

    @property
    def sub_quadratic(self) -> bool:
        return self.supports_long_context

    def layer_types(self) -> list[str]:
        return [self.pattern[i % len(self.pattern)] for i in range(self.n_layers)]

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embeddings (tied head)
        if not self.tie_embeddings:
            total += v * d
        for t in self.layer_types():
            total += 2 * d  # norms
            if t in ("attn", "local"):
                if self.mla is not None:
                    m = self.mla
                    qd = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                    total += d * qd
                    total += d * (m.kv_lora + m.rope_head_dim)
                    total += m.kv_lora * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.n_heads * self.head_dim  # q
                    total += 2 * d * self.n_kv_heads * self.head_dim  # kv
                    total += self.n_heads * self.head_dim * d  # out
            elif t == "rglru":
                r = self.rglru_dim
                total += 2 * d * r + r * d + 3 * r + r * (self.window and 4 or 4)
            elif t == "ssd":
                s = self.ssm
                proj_in = 2 * s.d_inner + 2 * s.n_groups * s.d_state + s.n_heads
                total += d * proj_in + s.d_inner * d + 3 * s.n_heads
            # channel mixing
            if t == "ssd":
                continue  # mamba2 blocks have no separate MLP
            if self.moe is not None:
                e = self.moe
                total += d * e.n_experts  # router
                total += e.n_experts * 3 * d * e.d_expert
                total += e.n_shared * 3 * d * e.d_expert
            else:
                mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
                total += mult * d * self.d_ff
        if self.enc_layers:
            for _ in range(self.enc_layers):
                total += 2 * self.d_model
                total += 4 * d * self.n_heads * self.head_dim
                mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
                total += mult * d * self.d_ff
            # decoder cross-attention
            total += self.n_layers * 4 * d * self.n_heads * self.head_dim
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        d = self.d_model
        dense_all = self.param_count()
        inactive = (e.n_experts - e.top_k) * 3 * d * e.d_expert * (
            self.n_layers - e.first_dense
        )
        return int(dense_all - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def step_kind(shape: ShapeConfig) -> str:
    return shape.kind


def reduced(cfg: ArchConfig, *, layers: int | None = None) -> ArchConfig:
    """Family-preserving reduced config for CPU smoke tests."""
    pat = len(cfg.pattern)
    n_layers = layers if layers is not None else max(pat, 2 if pat == 1 else pat)
    d_model = 64
    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads, 2))
    head_dim = 16
    kw: dict[str, Any] = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=128,
        vocab=128,
        window=min(cfg.window, 16) if cfg.window else 0,
        enc_layers=min(cfg.enc_layers, 2) if cfg.enc_layers else 0,
        n_patches=min(cfg.n_patches, 4) if cfg.n_patches else 0,
        cross_attn_len=16,
        rglru_dim=64 if cfg.rglru_dim else 0,
        dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_expert=32,
            n_shared=min(cfg.moe.n_shared, 1),
            first_dense=min(cfg.moe.first_dense, 1),
            first_dense_ff=64 if cfg.moe.first_dense else 0,
        )
    if cfg.mla is not None:
        kw["mla"] = MLACfg(kv_lora=32, rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = SSMCfg(d_state=16, d_inner=128, head_dim=32, n_groups=1, chunk=8, d_conv=4)
    return dataclasses.replace(cfg, **kw)


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    """The activation dtype the config names (``bfloat16`` or ``float32``)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def input_specs(
    cfg: ArchConfig, shape: ShapeConfig, dtype: torch.dtype = torch.int32
) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """``(shape, dtype)`` of every input of the step for (cfg, shape).

    Train:    tokens/labels (B, S)   [+ frontend embeddings for audio/vlm]
    Prefill:  tokens (B, S)
    Decode:   tokens (B, 1) + positions (B,); the serving layer builds the caches.
    """
    B, S = shape.global_batch, shape.seq_len
    act = act_dtype(cfg)
    specs: dict[str, tuple[tuple[int, ...], torch.dtype]] = {}
    if shape.kind == "train":
        if cfg.frontend == "audio_stub":
            specs["frames"] = ((B, S, cfg.d_model), act)
            specs["tokens"] = ((B, S), dtype)
            specs["labels"] = ((B, S), dtype)
        elif cfg.frontend == "vision_stub":
            n_text = S - cfg.n_patches
            specs["patches"] = ((B, cfg.n_patches, cfg.d_model), act)
            specs["tokens"] = ((B, n_text), dtype)
            specs["labels"] = ((B, n_text), dtype)
        else:
            specs["tokens"] = ((B, S), dtype)
            specs["labels"] = ((B, S), dtype)
    elif shape.kind == "prefill":
        if cfg.frontend == "audio_stub":
            specs["frames"] = ((B, S, cfg.d_model), act)
            specs["tokens"] = ((B, min(S, 448)), dtype)
        elif cfg.frontend == "vision_stub":
            specs["patches"] = ((B, cfg.n_patches, cfg.d_model), act)
            specs["tokens"] = ((B, S - cfg.n_patches), dtype)
        else:
            specs["tokens"] = ((B, S), dtype)
    else:  # decode
        specs["tokens"] = ((B, 1), dtype)
        specs["positions"] = ((B,), dtype)
    return specs
