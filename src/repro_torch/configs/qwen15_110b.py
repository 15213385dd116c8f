"""qwen1.5-110b [dense]: GQA kv=8 with QKV bias (hf:Qwen/Qwen1.5 family).
80L d_model=8192 64H d_ff=49152 vocab=152064."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab=152_064,
    pattern=("attn",),
    qkv_bias=True,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
)
