"""Nemotron-4-340B [arXiv:2402.16819]: GQA, squared-ReLU MLP.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    block_pattern=("attn+dense",),
    activation="squared_relu",
    rope_theta=10000.0,
)
