"""Configuration fields of DeepSeek-V3's blocks that ``ModelConfig`` lacks.

``models/config.py`` is a copy of the JAX package's and stays one, so the
fields of multi-head latent attention (the ``mla`` mixer, ``models/mla.py``),
its YaRN rotary embedding and DeepSeekMoE's router live in these subclasses.
Code that meets a plain ``ModelConfig`` or ``MoEConfig`` runs as before.

- ``MLAConfig``: queries through a rank-``q_lora_rank`` bottleneck, keys and
  values through one normed latent of ``kv_lora_rank`` shared by every head,
  each head ``qk_nope_dim`` + ``qk_rope_dim`` wide in q·k and ``v_head_dim``
  in v; the rotary part of the key is one ``qk_rope_dim`` vector per token
  shared by every head; ``yarn`` scales the rotary frequencies and the
  softmax (None: plain RoPE at ``rope_theta``, scale (qk width)^-½).
- ``DeepSeekMoEConfig``: sigmoid scores; the choice by score plus a learned
  per-expert correction bias (the ``e_bias`` leaf), among the experts of the
  ``topk_groups`` best of ``n_groups`` groups (a group's score: the sum of its
  two best biased scores); the weights the unbiased scores of the chosen,
  normalised to sum 1, times ``routed_scale``; experts ``d_expert`` wide; and
  ``n_shared`` experts' width of one SwiGLU that every token passes through.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.models.config import ModelConfig, MoEConfig


@dataclasses.dataclass(frozen=True)
class YarnRope:
    """YaRN's context extension of RoPE (arXiv:2309.00071), as DeepSeek-V3's
    ``rope_scaling`` states it."""

    factor: float
    original_max_position: int
    beta_fast: float
    beta_slow: float
    mscale: float = 1.0
    mscale_all_dim: float = 1.0

    def mscale_of(self, m: float) -> float:
        return 1.0 if self.factor <= 1 else 0.1 * m * math.log(self.factor) + 1.0

    @property
    def rope_mscale(self) -> float:
        """The factor on cos and sin: mscale(mscale) / mscale(mscale_all_dim)."""
        return self.mscale_of(self.mscale) / self.mscale_of(self.mscale_all_dim)

    def correction_dim(self, rotations: float, dim: int, theta: float) -> float:
        """The rotary dimension whose wave turns ``rotations`` times over the
        original context."""
        return (dim * math.log(self.original_max_position / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))


@dataclasses.dataclass(frozen=True)
class DeepSeekMoEConfig(MoEConfig):
    n_groups: int = 1
    topk_groups: int = 1
    routed_scale: float = 1.0
    n_shared: int = 0
    d_expert: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    yarn: YarnRope | None = None

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def softmax_scale(self) -> float:
        """(q·k width)^-½, times YaRN's mscale(mscale_all_dim)² with ``yarn``."""
        s = self.qk_dim ** -0.5
        if self.yarn is not None and self.yarn.mscale_all_dim:
            s *= self.yarn.mscale_of(self.yarn.mscale_all_dim) ** 2
        return s
