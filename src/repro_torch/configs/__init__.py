"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the exact published configuration;
``reduced(cfg)`` shrinks it (same family/topology) for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "xlstm_350m",
    "llama3_405b",
    "smollm_360m",
    "nemotron_4_340b",
    "qwen2_72b",
    "jamba_1_5_large_398b",
    "mixtral_8x7b",
    "mixtral_8x22b",
    "chameleon_34b",
    "whisper_large_v3",
]

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


def reduced(cfg: ModelConfig, seq_len: int = 64) -> ModelConfig:
    """Smoke-test shrink: same family, topology, and pattern; tiny dims."""
    period = cfg.pattern_period
    n_heads = min(cfg.n_heads, 4)
    # keep GQA ratio >= 1, kv | heads
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(4, moe.n_experts),
                                  top_k=min(2, moe.top_k))
    return dataclasses.replace(
        cfg,
        n_layers=2 * period,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        moe=moe,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window
        else None,
        n_enc_layers=2 if cfg.enc_dec else 0,
        enc_frames=8 if cfg.enc_dec else cfg.enc_frames,
        ssm_state_dim=4,
        moe_capacity_factor=8.0,  # drop-free so decode == forward exactly
        dtype="float32",
        remat=False,
    )
