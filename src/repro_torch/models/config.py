"""Unified model configuration covering all assigned architecture families.

A model is a cycle of block *patterns*. Each pattern entry names a mixer
and an MLP type, e.g. ``"attn+moe"`` (Mixtral), ``"mamba+dense"`` (Jamba),
``"mlstm"`` (xLSTM — no separate FFN). Layers are stacked per pattern
position so ``jax.lax.scan`` can run the repeated super-block with one
lowered copy of the layer HLO (critical for compile time and HLO size at
126 layers).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    block_pattern: tuple[str, ...] = ("attn+dense",)
    head_dim: int | None = None
    moe: MoEConfig | None = None
    sliding_window: int | None = None
    qkv_bias: bool = False
    activation: str = "swiglu"  # swiglu | squared_relu | gelu
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500      # whisper encoder positions (stub frontend)
    frontend: str | None = None  # None | "audio_stub" | "vision_stub"
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # SSM / recurrent dims
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    mlstm_proj_factor: float = 2.0
    moe_capacity_factor: float = 1.25
    moe_group: int = 2048       # tokens per MoE dispatch group
    # training
    remat: bool = True
    scan_layers: bool = True    # False: unroll (exact HLO cost analysis)
    use_pallas: bool = False    # Pallas kernels on TPU; pure-jnp oracle off

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_repeats(self) -> int:
        assert self.n_layers % self.pattern_period == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {self.pattern_period}"
        )
        return self.n_layers // self.pattern_period

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    def mixer_of(self, entry: str) -> str:
        return entry.split("+")[0]

    def mlp_of(self, entry: str) -> str | None:
        parts = entry.split("+")
        return parts[1] if len(parts) > 1 else None

    # ---- parameter counts (for roofline MODEL_FLOPS = 6·N·D) -------------
    def param_counts(self) -> dict[str, float]:
        """Returns {"total": N, "active": N_active} (embeddings included in
        total, excluded from active FLOPs accounting which uses 6·N·D with
        N = non-embedding params, the standard convention)."""
        d, hd = self.d_model, self.hd
        per_pattern_total = 0.0
        per_pattern_active = 0.0
        for entry in self.block_pattern:
            mixer, mlp = self.mixer_of(entry), self.mlp_of(entry)
            p = 0.0
            if mixer == "attn":
                p += d * (self.n_heads * hd)            # q
                p += 2 * d * (self.n_kv_heads * hd)     # k, v
                p += (self.n_heads * hd) * d            # o
                if self.qkv_bias:
                    p += (self.n_heads + 2 * self.n_kv_heads) * hd
            elif mixer == "mamba":
                di, n = self.d_inner, self.ssm_state_dim
                p += d * 2 * di          # in_proj (x, gate)
                p += di * self.ssm_conv_width
                p += di * (2 * n + 1) + di  # B,C,dt projections + dt bias
                p += di * n              # A
                p += di * d              # out_proj
            elif mixer == "mlstm":
                dk = int(self.mlstm_proj_factor * d)
                p += 3 * d * dk + dk * d  # q,k,v,o
                p += 2 * d * self.n_heads  # gates (i, f per head)
            elif mixer == "slstm":
                p += 4 * d * d + 4 * d * d // self.n_heads  # gates (block-diag recurrent)
            p += d  # norm
            mlp_total = mlp_active = 0.0
            if mlp == "dense":
                mult = 3 if self.activation == "swiglu" else 2
                mlp_total = mlp_active = mult * d * self.d_ff + d
            elif mlp == "moe":
                assert self.moe is not None
                mult = 3 if self.activation == "swiglu" else 2
                per_expert = mult * d * self.d_ff
                mlp_total = self.moe.n_experts * per_expert + d * self.moe.n_experts + d
                mlp_active = self.moe.top_k * per_expert + d * self.moe.n_experts + d
            per_pattern_total += p + mlp_total
            per_pattern_active += p + mlp_active
        total = per_pattern_total * self.n_repeats
        active = per_pattern_active * self.n_repeats
        if self.enc_dec:
            # encoder: full-attn + dense mlp, plus decoder cross-attn
            enc_block = (2 * d * (self.n_heads * hd) * 2) / 2  # q,k,v,o approx
            enc_block = d * self.n_heads * hd * 2 + 2 * d * self.n_kv_heads * hd
            mult = 2  # gelu
            enc_block += mult * d * self.d_ff + 2 * d
            total += enc_block * self.n_enc_layers
            active += enc_block * self.n_enc_layers
            cross = 2 * d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + d
            total += cross * self.n_layers
            active += cross * self.n_layers
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return {"total": total + embed, "active": active,
                "embed": float(embed)}

    def model_flops_per_token(self) -> float:
        """6·N_active per token (the §Roofline MODEL_FLOPS convention)."""
        return 6.0 * self.param_counts()["active"]


def human(n: float) -> str:
    for unit in ["", "K", "M", "B", "T"]:
        if abs(n) < 1000:
            return f"{n:.1f}{unit}"
        n /= 1000
    return f"{n:.1f}P"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell from the assignment."""

    name: str               # train_4k | prefill_32k | decode_32k | long_500k
    kind: str               # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def sub_quadratic(cfg: ModelConfig) -> bool:
    """True if the arch can decode at 500k tokens with bounded state:
    SSM/linear-recurrent state, or sliding-window attention, or a hybrid
    with only windowed/sparse attention layers."""
    if cfg.enc_dec:
        return False
    mixers = {cfg.mixer_of(e) for e in cfg.block_pattern}
    if "attn" not in mixers:
        return True
    return cfg.sliding_window is not None or cfg.family in ("hybrid",)


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k"]
    out.append("decode_32k")  # all assigned archs have a decoder step
    if sub_quadratic(cfg):
        out.append("long_500k")
    return out
