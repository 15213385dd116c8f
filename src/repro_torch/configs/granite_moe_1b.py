"""granite-moe-1b-a400m [moe]: 32 experts top-8
(hf:ibm-granite/granite-3.0-1b-a400m-base). 24L d_model=1024 16H (GQA kv=8)
expert d_ff=512 vocab=49155."""

from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49_155,
    pattern=("attn",),
    mlp_act="swiglu",
    rope_theta=10000.0,
    moe=MoECfg(n_experts=32, top_k=8, d_expert=512, n_shared=0, first_dense=0),
)
