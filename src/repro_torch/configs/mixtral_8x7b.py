"""Mixtral-8x7B [arXiv:2401.04088]: 8 experts top-2, sliding-window attn.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, SWA window 4096.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    block_pattern=("attn+moe",),
    moe=MoEConfig(n_experts=8, top_k=2),
    sliding_window=4096,
    activation="swiglu",
    rope_theta=1000000.0,
)
