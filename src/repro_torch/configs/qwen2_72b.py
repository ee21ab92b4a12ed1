"""Qwen2-72B [arXiv:2407.10671]: GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    block_pattern=("attn+dense",),
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1000000.0,
)
