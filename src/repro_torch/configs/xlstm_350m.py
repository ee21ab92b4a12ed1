"""xLSTM-350M: alternating mLSTM / sLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304. ``d_ff=0``: xLSTM
blocks carry their own up/down projections (mLSTM proj-factor 2) and have
no separate FFN. Pattern alternates matrix-memory (mLSTM, parallelizable)
and scalar-memory (sLSTM, sequential) cells.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    activation="gelu",
    mlstm_proj_factor=2.0,
    tie_embeddings=True,
)
