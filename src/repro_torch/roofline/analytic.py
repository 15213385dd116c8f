"""Analytic per-device FLOP / HBM-byte model of the LM steps.

The reference's arithmetic, number for number (``tests/test_torch_roofline.py``
holds it equal on every architecture, shape and device count). It counts the
work an implementation performs, overheads included: the full S x S
rectangle of causal attention, the MoE's capacity factor, the remat
recompute, float32 logit chunks. The port's chunked attention skips the kv
blocks that lie wholly after a q block, so for the port the score term
counts up to twice the scores it computes.

Conventions:
  * matmul flops = 2·M·N·K; backward of a matmul = 2× forward; remat (a
    checkpoint per layer) adds ≈ 1× forward recompute → train multiplier 4
    on matmul-type work unless noted.
  * HBM bytes: parameter reads (per step, ZeRO-sharded float32 masters),
    activation writes+reads at layer boundaries, attention KV traffic, cache
    read/write for decode, optimizer state traffic for train. The dry run
    (``launch.dryrun``) prices the port's own bytes; it takes the flops from
    here.
  * Everything is per *device*: ``n_devices`` divides every term.
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeConfig

__all__ = ["WorkModel", "analytic_work"]


@dataclasses.dataclass
class WorkModel:
    flops: float  # per device
    hbm_bytes: float  # per device
    detail: dict

    def to_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes, "detail": self.detail}


def _attn_flops_train(cfg: ArchConfig, tokens: int, seq: int) -> tuple[float, float]:
    """(projection flops, score/value flops) for one full pass over all attn
    layers, forward only. Counts the implementation: chunked attention does
    the full S×S rectangle (causal masking by arithmetic); local attention
    does S × span with span = window rounded up to blocks (+1 block)."""
    proj = 0.0
    score = 0.0
    kinds = cfg.layer_types()
    for kind in kinds:
        if kind in ("attn", "local"):
            if cfg.mla is not None:
                m = cfg.mla
                qd = cfg.n_heads * (m.nope_head_dim + m.rope_head_dim)
                proj += 2 * tokens * cfg.d_model * qd
                proj += 2 * tokens * cfg.d_model * (m.kv_lora + m.rope_head_dim)
                proj += 2 * tokens * m.kv_lora * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
                proj += 2 * tokens * cfg.n_heads * m.v_head_dim * cfg.d_model
                qk_dim = m.nope_head_dim + m.rope_head_dim
                v_dim = m.v_head_dim
            else:
                hd = cfg.head_dim
                proj += 2 * tokens * cfg.d_model * cfg.n_heads * hd * 2  # q, o
                proj += 2 * tokens * cfg.d_model * cfg.n_kv_heads * hd * 2  # k, v
                qk_dim = hd
                v_dim = hd
            n_batch = tokens // seq
            if kind == "local" and cfg.window:
                blk = min(max(cfg.window // 2, 128), 1024)
                span = ((cfg.window + blk - 1) // blk + 1) * blk
                kv_len = min(span, seq)
            else:
                kv_len = seq  # full rectangle (implementation)
            score += 2 * n_batch * seq * kv_len * cfg.n_heads * (qk_dim + v_dim)
    return proj, score


def _mix_flops_other(cfg: ArchConfig, tokens: int) -> float:
    """ssd / rglru temporal-mixing flops, forward, all layers."""
    total = 0.0
    for kind in cfg.layer_types():
        if kind == "ssd":
            s = cfg.ssm
            proj_out = 2 * s.d_inner + 2 * s.n_groups * s.d_state + s.n_heads
            total += 2 * tokens * cfg.d_model * proj_out  # in proj
            total += 2 * tokens * s.d_inner * cfg.d_model  # out proj
            q = s.chunk
            h, p, n = s.n_heads, s.head_dim, s.d_state
            # intra-chunk quadratic: CB (q*q*n per group→heads) + y_diag (q*q*p)
            total += tokens * q * h * (2 * n + 2 * p)
            # states + y_off: q*n*p per chunk-token
            total += tokens * h * n * p * 4
            total += tokens * (s.d_inner + 2 * s.n_groups * s.d_state) * s.d_conv * 2
        elif kind == "rglru":
            r = cfg.rglru_dim
            total += 2 * tokens * cfg.d_model * r * 3  # gate, in, out
            total += 2 * tokens * r * r * 2  # W_a, W_x gates
            total += tokens * r * (4 * 2 + 10)  # conv(4) + scan combine ops
    return total


def _channel_flops(cfg: ArchConfig, tokens: int) -> float:
    """MLP / MoE flops, forward, all layers — counts capacity-factor waste."""
    total = 0.0
    d = cfg.d_model
    for i, kind in enumerate(cfg.layer_types()):
        if kind == "ssd":
            continue
        if cfg.moe is not None and i >= cfg.moe.first_dense:
            e = cfg.moe
            total += 2 * tokens * d * e.n_experts  # router
            # capacity buffers: E * C tokens actually multiplied
            eff_tokens = tokens * e.top_k * e.capacity_factor
            total += 2 * eff_tokens * d * e.d_expert * 3
            total += 2 * tokens * d * e.d_expert * e.n_shared * 3
        else:
            ff = cfg.d_ff
            if cfg.moe is not None and i < cfg.moe.first_dense:
                ff = cfg.moe.first_dense_ff or cfg.d_ff
            mult = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
            total += 2 * tokens * d * ff * mult
    return total


def _enc_flops(cfg: ArchConfig, tokens: int, seq: int) -> float:
    """Whisper encoder forward flops (non-causal full attention + MLP)."""
    if not cfg.enc_layers:
        return 0.0
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    n_batch = tokens // seq
    per_layer = (
        2 * tokens * d * h * hd * 4  # qkvo
        + 2 * n_batch * seq * seq * h * hd * 2  # scores + values
        + 2 * tokens * d * cfg.d_ff * 2  # gelu mlp
    )
    return per_layer * cfg.enc_layers


def _xent_flops(cfg: ArchConfig, tokens: int) -> float:
    return 2 * tokens * cfg.d_model * cfg.vocab


def analytic_work(cfg: ArchConfig, shape: ShapeConfig, n_devices: int) -> WorkModel:
    B, S = shape.global_batch, shape.seq_len
    act_bytes = 2 if cfg.dtype == "bfloat16" else 4
    n_params = cfg.param_count()
    detail: dict = {}

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision_stub":
            tokens = B * S  # patches + text both flow through the stack
        else:
            tokens = B * S
        proj, score = _attn_flops_train(cfg, tokens, S)
        mix = _mix_flops_other(cfg, tokens)
        chan = _channel_flops(cfg, tokens)
        enc = _enc_flops(cfg, tokens, S)
        head = _xent_flops(cfg, tokens) if shape.kind == "train" else 2 * B * cfg.d_model * cfg.vocab
        fwd = proj + score + mix + chan + enc + (head if shape.kind == "train" else 0)
        if shape.kind == "train":
            # bwd 2x + remat recompute ~1x fwd (checkpointed groups); the
            # xent chunk is also checkpointed (recompute once)
            total = 4 * fwd
            total += 20 * n_params  # adamw update elementwise ops
        else:
            total = fwd + head
        detail = {
            "proj": proj, "score": score, "mix": mix, "channel": chan,
            "encoder": enc, "head": head, "fwd_total": fwd,
        }

        # HBM bytes (per pass): params read (sharded) x (fwd+bwd+remat),
        # layer-boundary activations, optimizer state r/w for train.
        param_bytes_dev = 4 * n_params / n_devices  # f32 master, ZeRO-sharded
        act_boundary = cfg.n_layers * tokens * cfg.d_model * act_bytes * 2 / n_devices
        if shape.kind == "train":
            hbm = 3 * param_bytes_dev + 12 * n_params / n_devices * 2  # grads+opt
            hbm += 3 * act_boundary
        else:
            hbm = param_bytes_dev + 2 * act_boundary
    else:  # decode: one token per row
        tokens = B
        proj, _ = _attn_flops_train(cfg, tokens, 1)
        mix = _mix_flops_other(cfg, tokens)
        chan = _channel_flops(cfg, tokens)
        head = _xent_flops(cfg, tokens)
        # attention against the cache: per attn layer, q·K + p·V over L
        score = 0.0
        cache_bytes = 0.0
        for kind in cfg.layer_types():
            if kind == "attn":
                L = S
            elif kind == "local":
                L = min(cfg.window or S, S)
            else:
                if kind == "ssd":
                    s = cfg.ssm
                    cache_bytes += B * s.n_heads * s.head_dim * s.d_state * 4 * 2
                    score += 2 * B * s.n_heads * s.head_dim * s.d_state * 3
                elif kind == "rglru":
                    cache_bytes += B * cfg.rglru_dim * 4 * 2
                continue
            if cfg.mla is not None:
                m = cfg.mla
                # naive MLA: re-expand K,V from latent for the whole cache
                score += 2 * B * L * m.kv_lora * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
                score += 2 * B * L * cfg.n_heads * (m.nope_head_dim + m.rope_head_dim + m.v_head_dim)
                cache_bytes += B * L * (m.kv_lora + m.rope_head_dim) * act_bytes
            else:
                score += 2 * B * L * cfg.n_heads * cfg.head_dim * 2
                cache_bytes += B * L * cfg.n_kv_heads * cfg.head_dim * act_bytes * 2
        if cfg.enc_layers:  # whisper cross-attention reads
            score += 2 * B * cfg.cross_attn_len * cfg.n_heads * cfg.head_dim * 2 * cfg.n_layers
            cache_bytes += B * cfg.cross_attn_len * cfg.n_kv_heads * cfg.head_dim * act_bytes * 2 * cfg.n_layers
        total = proj + mix + chan + head + score
        detail = {"proj": proj, "score": score, "mix": mix, "channel": chan,
                  "head": head, "cache_bytes": cache_bytes}
        # decode HBM: every param read once (bf16 compute copy) + cache traffic
        hbm = 2 * n_params / n_devices + cache_bytes / n_devices
        hbm += B * cfg.d_model * act_bytes * 2 * cfg.n_layers / n_devices

    return WorkModel(
        flops=total / n_devices,
        hbm_bytes=hbm,
        detail={k: v / n_devices for k, v in detail.items()},
    )
