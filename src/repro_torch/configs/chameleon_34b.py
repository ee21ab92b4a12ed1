"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM, VQ image tokens.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. The vision
frontend is a STUB per the assignment: images arrive as VQ token ids that
live in the same 65536 vocab, so the backbone is a dense GQA decoder.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    block_pattern=("attn+dense",),
    activation="swiglu",
    frontend="vision_stub",
    rope_theta=10000.0,
)
