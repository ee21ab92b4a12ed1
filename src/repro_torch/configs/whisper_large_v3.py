"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder, conv frontend stub.

32L (decoder) d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866; 32
encoder layers over 1500 audio frames. The conv frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, 1500, 1280).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    block_pattern=("attn+dense",),
    activation="gelu",
    enc_dec=True,
    n_enc_layers=32,
    enc_frames=1500,
    frontend="audio_stub",
)
