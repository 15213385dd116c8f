"""internvl2-26b [vlm]: InternViT + InternLM2-20B backbone (arXiv:2404.16821).
Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. The vision
frontend is a STUB: ``input_specs()`` provides precomputed patch embeddings
(B, n_patches, d_model) prepended to the text tokens."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92_553,
    pattern=("attn",),
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    n_patches=256,
    tie_embeddings=False,
)
