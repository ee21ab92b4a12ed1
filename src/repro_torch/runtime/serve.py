"""Serving step builder (decode with the KV cache) and its inputs."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device


def build_serve_step(cfg: ModelConfig):
    """(params, cache, batch) -> (logits, cache).

    ``batch`` = {"token": (B,) ints, "pos": int}. One new token per
    sequence; the cache is updated in place (``M.decode_step``).
    """

    def serve_step(params, cache, batch):
        return M.decode_step(params, cfg, cache, batch["token"], batch["pos"])

    return serve_step


def decode_inputs(cfg: ModelConfig, batch: int, seq_len: int, *,
                  device: str | torch.device = "cuda") -> dict[str, Any]:
    return {
        "token": torch.zeros((batch,), dtype=torch.long, device=resolve_device(device)),
        "pos": seq_len - 1,
    }
