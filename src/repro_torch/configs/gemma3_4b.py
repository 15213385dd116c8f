"""gemma3-4b [dense]: 5 local : 1 global attention pattern, 128k context
(hf:google/gemma-3 family). 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, head_dim 256, local window 1024."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262_144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    mlp_act="geglu",
    rope_theta=1_000_000.0,
    supports_long_context=True,  # 5/6 of layers are windowed; global layers
    # use the sequence-sharded decode attention path
)
