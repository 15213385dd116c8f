"""mamba2-370m [ssm]: SSD / state-space duality (arXiv:2405.21060),
attention-free. 48L d_model=1024, d_inner=2048, headdim=64 (32 heads),
ssm_state=128, vocab=50280."""

from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,  # = d_inner / head_dim
    n_kv_heads=32,
    head_dim=64,
    d_ff=0,  # mamba2 blocks have no separate MLP
    vocab=50_280,
    pattern=("ssd",),
    ssm=SSMCfg(d_state=128, d_inner=2048, head_dim=64, n_groups=1, chunk=256, d_conv=4),
    supports_long_context=True,  # O(1) recurrent state
)
