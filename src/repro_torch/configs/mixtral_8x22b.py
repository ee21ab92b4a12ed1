"""Mixtral-8x22B [arXiv:2401.04088]: 8 experts top-2, sliding-window attn.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, SWA window 4096.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    block_pattern=("attn+moe",),
    moe=MoEConfig(n_experts=8, top_k=2),
    sliding_window=4096,
    activation="swiglu",
    rope_theta=1000000.0,
)
