"""Multi-head latent attention (MLA), DeepSeek-V2/V3's mixer (arXiv:2412.19437).

Leaves (weights stored ``(in, out)`` as everywhere in the port; the norms'
scales fp32, the rest in the model dtype):

- ``wq_a`` (d, q_lora_rank), ``q_norm``, ``wq_b`` (q_lora_rank, H·(nope+rope)):
  the query through its low-rank bottleneck, each head ``nope`` + ``rope``
  wide;
- ``wkv_a`` (d, kv_lora_rank + rope): the latent and one rotary key per
  token, shared by every head; ``kv_norm`` norms the latent;
- ``wkv_b`` (kv_lora_rank, H·(nope+v)): the latent's expansion into each
  head's key (``nope`` wide, ``W_UK``) and value (``v`` wide, ``W_UV``);
- ``wo`` (H·v, d).

The rotary part is split-half RoPE at ``cfg.rope_theta`` with YaRN's
frequencies (``cfg.yarn``); the checkpoint's interleaved pairs are a fixed
permutation of ``wq_b``'s and ``wkv_a``'s rotary columns. The softmax scale
is ``cfg.softmax_scale``.

``mla`` is the full-sequence form: keys and values expanded per head, through
``ops.flash_attention`` at the smallest head dim it takes that holds both
the q·k width and v (v zero-padded; the scale folded into q in fp32 before
its cast, since the kernel scales by hd^-½); the output sliced back to v.

``mla_decode`` is the absorbed form a decode step runs: the cache holds only
the normed latent and the rotary key of each token (``ckv``, ``kpe``), and
``W_UK`` is folded into the query (``q_lat``), ``W_UV`` into the output, so
the core attends over the latent as one kv head of ``kv_lora_rank + rope``
for all H query heads. Every product is a batched cuBLAS call; the scores
are written in fp32 and the softmax runs in fp32, its probabilities cast to
the model dtype before they weigh the latent (as the flash kernels do). Its
shapes are the cache's whatever the position, so a CUDA graph can hold it.

Under a profiler each call is an ``mla`` span on the device, and the
absorbed core of a decode step (scores to ``o_lat``) an ``mla.attend`` span
with ``batch`` and ``pos`` (it attends over ``pos + 1`` slots). On DTensors both forms raise: MLA's placement
is not ported.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.deepseek_config import MLAConfig
from repro_torch.models.layers import EMBED, HEADS, Params, _init, apply_rope, dtype_of, rmsnorm
from repro_torch.runtime import sharding as sh


def init_mla(gen: torch.Generator, cfg: MLAConfig) -> Params:
    d, H, qr, kr = cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    rope, nope, v = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    if cfg.yarn is not None and cfg.yarn.rope_mscale != 1.0:
        raise NotImplementedError(f"{cfg.name}: YaRN's cos/sin scale "
                                  f"{cfg.yarn.rope_mscale} != 1 is not ported")
    dt = dtype_of(cfg)
    dev = gen.device
    return {
        "wq_a": _init(gen, (d, qr), d ** -0.5, dt),
        "q_norm": {"scale": torch.ones((qr,), dtype=torch.float32, device=dev)},
        "wq_b": _init(gen, (qr, H * (nope + rope)), qr ** -0.5, dt),
        "wkv_a": _init(gen, (d, kr + rope), d ** -0.5, dt),
        "kv_norm": {"scale": torch.ones((kr,), dtype=torch.float32, device=dev)},
        "wkv_b": _init(gen, (kr, H * (nope + v)), kr ** -0.5, dt),
        "wo": _init(gen, (H * v, d), (H * v) ** -0.5, dt),
    }


def specs_mla(cfg: MLAConfig) -> Params:
    return {"wq_a": (EMBED, None), "q_norm": {"scale": (None,)}, "wq_b": (None, HEADS),
            "wkv_a": (EMBED, None), "kv_norm": {"scale": (None,)}, "wkv_b": (None, HEADS),
            "wo": (HEADS, EMBED)}


def rope_freqs(cfg: MLAConfig, device: torch.device) -> torch.Tensor:
    """The rotary inverse frequencies (rope/2,) fp32: θ^(−2i/rope), and with
    YaRN those blended with the same over ``factor`` by a linear ramp from
    the dimension that turns ``beta_fast`` times over the original context
    (kept) to the one that turns ``beta_slow`` times (interpolated). Computed
    once per device and kept (a decode step would otherwise spend a dozen
    launches a layer on them)."""
    return _rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, cfg.yarn, torch.device(device))


@functools.lru_cache(maxsize=16)
def _rope_freqs(dim: int, theta: float, y, device: torch.device) -> torch.Tensor:
    extra = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    if y is None:
        return extra
    low = max(math.floor(y.correction_dim(y.beta_fast, dim, theta)), 0)
    high = min(math.ceil(y.correction_dim(y.beta_slow, dim, theta)), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 1e-3)).clamp(0, 1)
    return extra / y.factor * ramp + extra * (1 - ramp)


def _no_dtensor(x: torch.Tensor) -> None:
    if sh.is_dtensor(x):
        raise NotImplementedError("mla: the placement of latent attention on DTensors is "
                                  "not ported")


def _project(p: Params, x: torch.Tensor, cfg: MLAConfig, positions: torch.Tensor):
    """(q_nope (B,S,H,nope), q_pe (B,S,H,rope), ckv (B,S,kv_lora_rank),
    kpe (B,S,1,rope)) of x (B,S,d) at ``positions``: RoPE applied, the latent
    normed, all in the model dtype."""
    B, S, _ = x.shape
    H, nope, rope, kr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    cq = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).view(B, S, H, nope + rope)
    kv_a = x @ p["wkv_a"]
    ckv = rmsnorm(p["kv_norm"], kv_a[..., :kr], cfg.norm_eps)
    # the H query heads' rotary parts and the shared key's, rotated as one tensor
    pe = apply_rope(torch.cat([q[..., nope:], kv_a[..., None, kr:]], dim=-2), positions,
                    cfg.rope_theta, rope_freqs(cfg, x.device))
    return q[..., :nope], pe[..., :H, :], ckv, pe[..., H:, :]


def mla(p: Params, x: torch.Tensor, cfg: MLAConfig) -> torch.Tensor:
    """Causal latent attention over x (B, S, d) -> (B, S, d), keys and values
    expanded per head (training / prefill)."""
    _no_dtensor(x)
    B, S, _ = x.shape
    H, nope, rope, v_dim = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    with tracing.span("mla", device=x.device):
        q_nope, q_pe, ckv, kpe = _project(p, x, cfg, torch.arange(S, device=x.device))
        k_nope, v = (ckv @ p["wkv_b"]).view(B, S, H, nope + v_dim).split([nope, v_dim], -1)
        hd = min(h for h in HEAD_DIMS if h >= max(cfg.qk_dim, v_dim))
        q = torch.cat([q_nope, q_pe], -1).float() * (cfg.softmax_scale * hd ** 0.5)
        k = torch.cat([k_nope, kpe.expand(B, S, H, rope)], -1)
        pad = (0, hd - cfg.qk_dim)
        out = ops.flash_attention(F.pad(q.to(x.dtype), pad), F.pad(k, pad),
                                  F.pad(v, (0, hd - v_dim)), causal=True)
        return out[..., :v_dim].reshape(B, S, H * v_dim) @ p["wo"]


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b written in fp32. On the card cuBLAS accumulates in fp32
    and writes fp32 from operands in the model dtype; the CPU has no such
    kernel, and multiplies fp32 copies: the same products."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def mla_decode(p: Params, x: torch.Tensor, ckv_cache: torch.Tensor, kpe_cache: torch.Tensor,
               pos: int | torch.Tensor, cfg: MLAConfig) -> torch.Tensor:
    """One token (B, 1, d) at ``pos``, absorbed: its normed latent and rotary
    key are written into ``ckv_cache`` (B, S, kv_lora_rank) and ``kpe_cache``
    (B, S, rope) at slot ``pos`` in place, and it attends over slots
    0..pos. Returns (B, 1, d).

    ``pos`` is an int or a 0-d int64 tensor on x's device. Nothing here
    reads it on the host, and every shape is the cache's: the core scores
    all S slots and masks those past ``pos``, so one CUDA graph of a decode
    step serves every position (``runtime.serve.DecodeGraph``). A tensor
    ``pos`` is ``mla.attend``'s counter as it is, read when the spans are."""
    _no_dtensor(x)
    B, S = x.shape[0], ckv_cache.shape[1]
    H, nope, v_dim, kr = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    at = (pos.reshape(1) if isinstance(pos, torch.Tensor)
          else torch.full((1,), pos, device=x.device))
    with tracing.span("mla", device=x.device):
        q_nope, q_pe, ckv, kpe = _project(p, x, cfg, at)
        ckv_cache.index_copy_(1, at, ckv)
        kpe_cache.index_copy_(1, at, kpe[:, :, 0])
        w = p["wkv_b"].view(kr, H, nope + v_dim)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w[..., :nope].permute(1, 2, 0))
        with tracing.span("mla.attend", device=x.device, batch=B, pos=pos):
            s = (_bmm_f32(q_lat.transpose(0, 1), ckv_cache.transpose(1, 2))
                 + _bmm_f32(q_pe[:, 0], kpe_cache.transpose(1, 2)))          # (B, H, S)
            s = s.masked_fill(torch.arange(S, device=x.device) > at, float("-inf"))
            prob = torch.softmax(s * cfg.softmax_scale, dim=-1).to(x.dtype)
            o_lat = torch.bmm(prob, ckv_cache)                                # (B, H, kr)
        o = torch.bmm(o_lat.transpose(0, 1), w[..., nope:].transpose(0, 1))   # (H, B, v)
        return (o.transpose(0, 1).reshape(B, 1, H * v_dim)) @ p["wo"]
