"""Llama-3.1-405B [arXiv:2407.21783]: dense GQA, 128k vocab.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    block_pattern=("attn+dense",),
    activation="swiglu",
    rope_theta=500000.0,
)
