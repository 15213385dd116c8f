"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, pattern 1 attn : 2
recurrent (Griffin, arXiv:2402.19427). 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000, local window 2048."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256_000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    mlp_act="geglu",
    rglru_dim=4096,
    rope_theta=10000.0,
    supports_long_context=True,  # RG-LRU state + bounded local window
)
