"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + fine-grained MoE
(arXiv:2405.04434). 27L d_model=2048 16H, 64 routed experts top-6 + 2 shared,
expert d_ff=1408, vocab=102400. First layer dense (d_ff 10944), per the
published config. The assignment line also mentions "160 routed" (that is
the full DeepSeek-V2); we follow the structured field ``MoE 64e top-6``."""

from .base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,  # nope 128 (+64 rope) per MLA config below
    d_ff=1408,
    vocab=102_400,
    pattern=("attn",),
    mlp_act="swiglu",
    rope_theta=10000.0,
    moe=MoECfg(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        first_dense=1,
        first_dense_ff=10944,
    ),
    mla=MLACfg(kv_lora=512, rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
)
