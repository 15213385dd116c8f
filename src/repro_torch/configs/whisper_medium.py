"""whisper-medium [audio]: encoder-decoder transformer (arXiv:2212.04356).
24L encoder + 24L decoder, d_model=1024 16H (MHA) d_ff=4096 vocab=51865.
The conv frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (B, S_frames, d_model)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,  # decoder depth
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51_865,
    pattern=("attn",),
    mlp_act="gelu",
    rope_theta=10000.0,
    frontend="audio_stub",
    cross_attn_len=1500,
    tie_embeddings=False,
)
