"""glm4-9b [dense]: RoPE + GQA kv=2 (hf:THUDM/glm-4-9b). 40L d_model=4096
32H d_ff=13696 vocab=151552, SwiGLU."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151_552,
    pattern=("attn",),
    mlp_act="swiglu",
    qkv_bias=True,  # GLM uses QKV bias
    rope_theta=10000.0,
)
