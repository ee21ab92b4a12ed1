"""Decoder-only LM in PyTorch: init / forward / cache / decode.

Port of ``repro.models.model`` for ``attn+dense`` block patterns (smollm,
llama3, qwen2, nemotron, chameleon). Parameters keep the reference's
pytree as plain dictionaries: per pattern position, each leaf stacked over
``n_repeats`` along a leading axis. ``jax.lax.scan`` over the stack
becomes a Python loop over the repeats.

Other mixers, MoE MLPs and the encoder-decoder raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings them.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Params,
    attention,
    attention_decode,
    dtype_of,
    init_attention,
    init_mlp,
    init_rmsnorm,
    mlp,
    resolve_device,
    rmsnorm,
)

_NOT_PORTED = {
    "mamba": "ROADMAP.md queue 1 item 8 (recurrent mixers)",
    "mlstm": "ROADMAP.md queue 1 item 8 (recurrent mixers)",
    "slstm": "ROADMAP.md queue 1 item 8 (recurrent mixers)",
    "moe": "ROADMAP.md queue 1 item 7 (MoE)",
    "enc_dec": "ROADMAP.md queue 1 item 9 (encoder-decoder)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every block is ``attn+dense``."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet; "
            f"{_NOT_PORTED['enc_dec']} brings them")
    for entry in cfg.block_pattern:
        mixer, mlp_kind = cfg.mixer_of(entry), cfg.mlp_of(entry)
        for part in (mixer, mlp_kind):
            if part not in ("attn", "dense"):
                where = _NOT_PORTED.get(part, "ROADMAP.md queue 1")
                raise NotImplementedError(
                    f"{cfg.name}: block {entry!r} is not ported yet (only "
                    f"'attn+dense'); {where} brings {part!r}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device
    return {"norm1": init_rmsnorm(cfg, dev), "mixer": init_attention(gen, cfg),
            "norm2": init_rmsnorm(cfg, dev), "mlp": init_mlp(gen, cfg)}


def _stack(trees: list[Params]) -> Params:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: str | torch.device = "cuda") -> Params:
    """Random parameters at the reference's scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = dtype_of(cfg)
    p: Params = {"embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                       device=dev) * 0.02).to(dt)}
    p["blocks"] = [_stack([_init_block(gen, cfg) for _ in range(cfg.n_repeats)])
                   for _ in range(cfg.pattern_period)]
    p["final_norm"] = init_rmsnorm(cfg, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                                    device=dev) * 0.02).to(dt)
    return p


def _layer(block: Params, r: int) -> Params:
    """Repeat ``r`` of a stacked block (views, no copies)."""
    return {k: (_layer(v, r) if isinstance(v, dict) else v[r]) for k, v in block.items()}


def _head(p: Params, cfg: ModelConfig) -> torch.Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["lm_head"]


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _block_fwd(bp: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = x + attention(bp["mixer"], rmsnorm(bp["norm1"], x, cfg.norm_eps), cfg,
                      causal=True)
    return x + mlp(bp["mlp"], rmsnorm(bp["norm2"], x, cfg.norm_eps), cfg)


def forward(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token logits for training / prefill: (B, S) ints -> (B, S, vocab) fp32."""
    x = p["embed"][tokens].to(dtype_of(cfg))
    for r in range(cfg.n_repeats):
        for block in p["blocks"]:
            x = _block_fwd(_layer(block, r), x, cfg)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return (x @ _head(p, cfg)).float()


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device: str | torch.device = "cuda") -> list[dict[str, torch.Tensor]]:
    """Zeroed KV cache: one ``{"k", "v"}`` entry per pattern position, each
    (n_repeats, batch, S, K, hd) with S = min(seq_len, sliding_window)."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_repeats, batch, _attn_cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
             "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev)}
            for _ in cfg.block_pattern]


def decode_step(
    p: Params,
    cfg: ModelConfig,
    cache: list[dict[str, Any]],
    token: torch.Tensor,        # (B,) ints: the newest token
    pos: int,                   # its position
) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """One serving step: append ``token`` at ``pos`` and return next-token
    logits (B, vocab) fp32 and the cache. The cache is updated in place
    (the returned list is ``cache`` itself)."""
    x = p["embed"][token][:, None, :].to(dtype_of(cfg))      # (B, 1, d)
    for r in range(cfg.n_repeats):
        for block, c in zip(p["blocks"], cache):
            bp = _layer(block, r)
            rotating = cfg.sliding_window is not None and \
                c["k"].shape[2] <= cfg.sliding_window
            h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
            y, _, _ = attention_decode(bp["mixer"], h, c["k"][r], c["v"][r], pos,
                                       cfg, rotating=rotating)
            x = x + y
            x = x + mlp(bp["mlp"], rmsnorm(bp["norm2"], x, cfg.norm_eps), cfg)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return (x[:, 0, :] @ _head(p, cfg)).float(), cache
