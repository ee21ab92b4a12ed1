"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M]: llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152. Tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    block_pattern=("attn+dense",),
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
)
