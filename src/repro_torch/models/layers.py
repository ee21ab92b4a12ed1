"""Transformer building blocks in PyTorch: RMSNorm, RoPE, GQA attention, MLP.

Port of ``repro.models.layers`` for ``attn+dense`` blocks. Parameters are
plain dictionaries of tensors with the reference's names and layouts:
weights stored ``(in, out)`` and applied as ``x @ W``. ``init_*`` take an
explicit ``torch.Generator`` and device.

Attention runs through the kernel wrappers whatever ``cfg.use_pallas``
says: ``attention`` calls ``ops.flash_attention`` and ``attention_decode``
calls ``ops.decode_attention``, so the device of the tensors picks the
CUDA kernel or its plain version. ``sdpa`` is the plain oracle the tests
hold both against.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available "
                           "(pass device='cpu' to run the plain versions)")
    return dev


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _init(gen: torch.Generator, shape: tuple[int, ...], scale: float,
          dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def init_rmsnorm(cfg: ModelConfig, device: torch.device) -> Params:
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings (split-half)
# --------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    scale = d ** -0.5
    p: Params = {
        "wq": _init(gen, (d, H * hd), scale, dt),
        "wk": _init(gen, (d, K * hd), scale, dt),
        "wv": _init(gen, (d, K * hd), scale, dt),
        "wo": _init(gen, (H * hd, d), (H * hd) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    return p


def _project_qkv(p: Params, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, Sq, H, hd), k.reshape(B, Skv, K, hd),
            v.reshape(B, Skv, K, hd))


def sdpa(
    q: torch.Tensor,                 # (B, Sq, H, hd)
    k: torch.Tensor,                 # (B, Skv, K, hd)
    v: torch.Tensor,                 # (B, Skv, K, hd)
    *,
    causal: bool,
    window: int | None = None,
    q_offset: int = 0,
    kv_len: int | torch.Tensor | None = None,   # valid prefix length (decode)
) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention, the plain oracle.

    Softmax in fp32; probabilities cast to q.dtype before p·v; returns
    q.dtype. ``q_offset`` is the absolute position of q[0]; ``kv_len``
    masks the KV tail of a preallocated cache.
    """
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * (hd ** -0.5)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence self-attention with RoPE (training / prefill) through the
    flash kernel."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, x, cfg)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return out.reshape(B, S, -1) @ p["wo"]


def attention_decode(
    p: Params,
    x: torch.Tensor,                 # (B, 1, d)
    cache_k: torch.Tensor,           # (B, Smax, K, hd), updated in place
    cache_v: torch.Tensor,
    pos: int,                        # index of the new token
    cfg: ModelConfig,
    *,
    rotating: bool = False,          # sliding-window rotating cache
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step with RoPE through the decode kernel.

    Writes the new key and value into ``cache_k``/``cache_v`` in place (slot
    ``pos % Smax`` for a rotating cache, else ``min(pos, Smax - 1)``) and
    returns ``(out, cache_k, cache_v)``.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, x, cfg)
    posv = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    Smax = cache_k.shape[1]
    slot = pos % Smax if rotating else min(pos, Smax - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    n = min(pos + 1, Smax) if rotating else pos + 1
    kv_len = torch.full((B,), n, dtype=torch.int32, device=x.device)
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, kv_len)
    return out.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


# --------------------------------------------------------------------------
# Dense MLP (SwiGLU / squared-ReLU / GELU)
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    p: Params = {}
    if cfg.activation == "swiglu":
        p["w_gate"] = _init(gen, (d, f), d ** -0.5, dt)
    p["w_up"] = _init(gen, (d, f), d ** -0.5, dt)
    p["w_down"] = _init(gen, (f, d), f ** -0.5, dt)
    return p


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(x @ p["w_up"]))
    else:  # gelu, tanh approximation as jax.nn.gelu's default
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
