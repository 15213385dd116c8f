"""nemotron-4-15b [dense]: GQA kv=8, squared-ReLU MLP (arXiv:2402.16819).
32L d_model=6144 48H d_ff=24576 vocab=256000."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256_000,
    pattern=("attn",),
    mlp_act="squared_relu",
    rope_theta=10000.0,
    tie_embeddings=False,
)
