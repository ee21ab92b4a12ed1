"""Jamba-1.5-Large [arXiv:2403.19887]: Mamba+attention 1:7, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536. Period-8 pattern:
one attention layer per 7 Mamba layers; MoE MLP every other layer
(Jamba places MoE on alternate layers; dense d_ff elsewhere).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    block_pattern=(
        "mamba+dense", "mamba+moe", "mamba+dense", "mamba+moe",
        "attn+dense", "mamba+moe", "mamba+dense", "mamba+moe",
    ),
    moe=MoEConfig(n_experts=16, top_k=2),
    activation="swiglu",
    ssm_state_dim=16,
    rope_theta=10000.0,
)
