"""Transformer building blocks in PyTorch: RMSNorm, RoPE, GQA attention, MLP, MoE.

Port of ``repro.models.layers`` for ``attn+dense`` and ``attn+moe``
blocks, and the encoder-decoder's cross-attention. Beyond the reference,
the MoE MLP also runs DeepSeekMoE (a ``DeepSeekMoEConfig``): the grouped
sigmoid router ``moe_route_grouped`` and a shared expert. Parameters are plain
dictionaries of tensors with the reference's names and layouts: weights
stored ``(in, out)`` and applied as ``x @ W``.
``init_*`` take an explicit ``torch.Generator`` and device. The reference's
``init_*`` return ``(params, specs)``; here ``specs_*`` beside each
``init_*`` give the specs: the same tree with, at each leaf, a tuple of
*logical axis names* per dimension (the names below), which
``runtime.sharding`` resolves to mesh axes.

Attention runs through the kernel wrappers whatever ``cfg.use_pallas``
says: ``attention`` calls ``ops.flash_attention`` and ``attention_decode``
calls ``ops.decode_attention``, so the device of the tensors picks the
CUDA kernel or its plain version. ``sdpa`` is the plain oracle the tests
hold both against.

On DTensors (a sharded step) the parts the reference leaves to XLA's
partitioner state their own placements: the products are
``runtime.sharding.matmul``; heads split and merge whole per device
(``split_last``, ``merge_last``); the embedding lookup is vocab-parallel
(``embed``); a decode step writes its new key and value only into
the shard of a sequence-sharded cache that holds the slot (``write_slot``);
the MoE MLP dispatches each device's tokens to its own experts or ff slice
(``_moe_sharded``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.deepseek_config import DeepSeekMoEConfig
from repro_torch.runtime import sharding as sh

Params = dict[str, Any]

# Logical axis names (runtime/sharding.py maps them onto a mesh)
VOCAB, EMBED, HEADS, KV, HD, FF, EXPERTS, LAYERS, INNER, STATE = (
    "vocab", "embed", "heads", "kv_heads", "head_dim", "ff", "experts",
    "layers", "inner", "state",
)

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
# Embedding lookup on DTensors
# --------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. For a DTensor table (vocab, d) it is Megatron's
    vocab-parallel lookup: where the vocab is sharded each device looks up
    the tokens of its own rows, zeros the rest, and one all-reduce sums the
    shards' rows; the batch shards as ``tokens``. The result is replicated
    over every non-batch axis. Indexing a sharded table would gather it."""
    if not sh.is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not sh.is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, sh.replicated(mesh), run_check=False)
    tp, tg, kp, outp = [], [], [], []
    vocab_dim = None
    for i, (pt, pk) in enumerate(zip(table.placements, tokens.placements, strict=True)):
        # a mesh axis of one device splits nothing: its lookup is the plain one
        batch, vocab = pk.is_shard(0), pt.is_shard(0) and mesh.shape[i] > 1
        if vocab:
            vocab_dim = i
        tp.append(Shard(0) if vocab else Replicate())
        tg.append(Partial() if batch else tp[-1])
        kp.append(Shard(0) if batch else Replicate())
        outp.append(Shard(0) if batch else Partial() if vocab else Replicate())

    def local(t, ids):
        if vocab_dim is None:
            return t[ids]
        first = mesh.get_local_rank(vocab_dim) * t.shape[0]
        mine = (ids >= first) & (ids < first + t.shape[0])
        rows = t[torch.where(mine, ids - first, 0)]
        return torch.where(mine[..., None], rows, 0)

    out = sh.run_local(local, (table, tokens), (tuple(tp), tuple(kp)), tuple(outp),
                       (tuple(tg), tuple(kp)))
    done = tuple(Replicate() if p.is_partial() else p for p in out.placements)
    return out.redistribute(mesh, done)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def init_rmsnorm(cfg: ModelConfig, device: torch.device) -> Params:
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32, device=device)}


def specs_rmsnorm(cfg: ModelConfig) -> Params:
    return {"scale": (EMBED,)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings (split-half)
# --------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., S, n, hd); positions: broadcastable to (..., S). ``freqs``
    (hd/2,) replaces ``rope_freqs(hd, theta)`` (latent attention's YaRN)."""
    hd = x.shape[-1]
    if freqs is None:
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

def init_attention(gen: torch.Generator, cfg: ModelConfig, cross: bool = False) -> Params:
    """``wq``, ``wk``, ``wv``, ``wo``; with ``cfg.qkv_bias`` and not
    ``cross`` also zero biases ``bq``, ``bk``, ``bv`` (the reference gives
    cross-attention none)."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    scale = d ** -0.5
    p: Params = {
        "wq": _init(gen, (d, H * hd), scale, dt),
        "wk": _init(gen, (d, K * hd), scale, dt),
        "wv": _init(gen, (d, K * hd), scale, dt),
        "wo": _init(gen, (H * hd, d), (H * hd) ** -0.5, dt),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    return p


def specs_attention(cfg: ModelConfig, cross: bool = False) -> Params:
    s: Params = {"wq": (EMBED, HEADS), "wk": (EMBED, KV), "wv": (EMBED, KV),
                 "wo": (HEADS, EMBED)}
    if cfg.qkv_bias and not cross:
        s.update(bq=(HEADS,), bk=(KV,), bv=(KV,))
    return s


def _project_qkv(p: Params, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = sh.matmul(xq, p["wq"])
    k = sh.matmul(xkv, p["wk"])
    v = sh.matmul(xkv, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return sh.split_last(q, (H, hd)), sh.split_last(k, (K, hd)), sh.split_last(v, (K, hd))


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
    xkv: torch.Tensor | None = None,     # cross-attention source (B, Skv, d)
    use_rope: bool = True,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill) through the flash kernel:
    self-attention over ``x``, or with ``xkv`` cross-attention from ``x`` to
    ``xkv``. RoPE, the causal mask and the sliding window apply to
    self-attention only, as in the reference."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, x if xkv is None else xkv, cfg)
    if use_rope and xkv is None:
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal and xkv is None,
                              window=cfg.sliding_window if xkv is None else None)
    return sh.matmul(sh.merge_last(out), p["wo"])


def attention_decode(
    p: Params,
    x: torch.Tensor,                 # (B, 1, d)
    cache_k: torch.Tensor,           # (B, Smax, K, hd), updated in place
    cache_v: torch.Tensor,
    pos: int,                        # index of the new token
    cfg: ModelConfig,
    *,
    use_rope: bool = True,
    rotating: bool = False,          # sliding-window rotating cache
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step through the decode kernel, with RoPE unless
    ``use_rope`` is false.

    Writes the new key and value into ``cache_k``/``cache_v`` in place (slot
    ``pos % Smax`` for a rotating cache, else ``min(pos, Smax - 1)``) and
    returns ``(out, cache_k, cache_v)``.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, x, cfg)
    if use_rope:
        posv = torch.full((1,), pos, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    Smax = cache_k.shape[1]
    slot = pos % Smax if rotating else min(pos, Smax - 1)
    write_slot(cache_k, slot, k[:, 0])
    write_slot(cache_v, slot, v[:, 0])
    n = min(pos + 1, Smax) if rotating else pos + 1
    kv_len = torch.full((B,), n, dtype=torch.int32, device=x.device)
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, kv_len)
    return sh.matmul(sh.merge_last(out[:, None]), p["wo"]), cache_k, cache_v


def write_slot(cache: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``cache[:, slot] = new`` (cache (B,S,K,hd), new (B,K,hd)), cast to the
    cache's dtype. On a DTensor cache whose sequence is sharded only the
    device whose range holds ``slot`` writes, into its own shard: indexing
    the sharded axis would gather the whole cache."""
    if not sh.is_dtensor(cache):
        cache[:, slot] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    seq = [i for i, p in enumerate(cache.placements) if p.is_shard(1)]
    new_p = tuple(Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2) else Replicate()
                  for p in cache.placements)

    def local(c, n):
        at = slot
        if seq:
            at -= mesh.get_local_rank(seq[0]) * c.shape[1]
        if 0 <= at < c.shape[1]:
            c[:, at] = n.to(c.dtype)

    sh.run_local(local, (cache, new), (tuple(cache.placements), new_p), None)


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention's keys and values of the encoder's output
    (B, F, d): ``enc_out @ wk`` and ``enc_out @ wv`` as (B, F, K, hd), what a
    decode step reads from the filled cross cache."""
    B, F, _ = enc_out.shape
    return (sh.split_last(sh.matmul(enc_out, p["wk"]), (cfg.n_kv_heads, cfg.hd)),
            sh.split_last(sh.matmul(enc_out, p["wv"]), (cfg.n_kv_heads, cfg.hd)))


def attention_cross_decode(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One token's cross-attention (B, 1, d) over the filled cross cache
    (B, F, K, hd) through the decode kernel, every one of the F encoder
    frames visible (``kv_len = F``); the cache is only read."""
    B = x.shape[0]
    q = sh.split_last(sh.matmul(x[:, 0], p["wq"]), (cfg.n_heads, cfg.hd))
    kv_len = torch.full((B,), cache_k.shape[1], dtype=torch.int32, device=x.device)
    out = ops.decode_attention(q, cache_k, cache_v, kv_len)
    return sh.matmul(sh.merge_last(out[:, None]), p["wo"])


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


def specs_mlp(cfg: ModelConfig) -> Params:
    s: Params = {"w_gate": (EMBED, FF)} if cfg.activation == "swiglu" else {}
    return {**s, "w_up": (EMBED, FF), "w_down": (FF, EMBED)}


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(sh.matmul(x, p["w_gate"])) * sh.matmul(x, p["w_up"])
    elif cfg.activation == "squared_relu":
        h = torch.square(F.relu(sh.matmul(x, p["w_up"])))
    else:  # gelu, tanh approximation as jax.nn.gelu's default
        h = F.gelu(sh.matmul(x, p["w_up"]), approximate="tanh")
    return sh.matmul(h, p["w_down"])


# --------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-based dispatch)
# --------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The reference's MoE leaves: an fp32 router (d, E) whatever the model
    dtype, and per expert ``w_gate``/``w_up`` (E, d, f) and ``w_down``
    (E, f, d); ``w_gate`` exists for every activation, as in the reference.
    DeepSeekMoE (``DeepSeekMoEConfig``) adds the fp32 correction bias
    ``e_bias`` (E,), zero, after the router, takes f = ``d_expert``, and
    ends with its shared expert ``shared``, a SwiGLU of width
    ``n_shared``·f (``init_mlp``'s leaves)."""
    assert cfg.moe is not None
    grouped = isinstance(cfg.moe, DeepSeekMoEConfig)
    d, E = cfg.d_model, cfg.moe.n_experts
    f = cfg.moe.d_expert if grouped else cfg.d_ff
    dt = dtype_of(cfg)
    p = {"router": _init(gen, (d, E), d ** -0.5, torch.float32)}
    if grouped:
        p["e_bias"] = torch.zeros((E,), dtype=torch.float32, device=gen.device)
    p.update(w_gate=_init(gen, (E, d, f), d ** -0.5, dt), w_up=_init(gen, (E, d, f), d ** -0.5, dt),
             w_down=_init(gen, (E, f, d), f ** -0.5, dt))
    if grouped and cfg.moe.n_shared:
        p["shared"] = init_mlp(gen, dataclasses.replace(cfg, d_ff=cfg.moe.n_shared * f))
    return p


def specs_moe(cfg: ModelConfig) -> Params:
    s = {"router": (EMBED, None), "w_gate": (EXPERTS, EMBED, FF),
         "w_up": (EXPERTS, EMBED, FF), "w_down": (EXPERTS, FF, EMBED)}
    if isinstance(cfg.moe, DeepSeekMoEConfig):
        s = {"router": s.pop("router"), "e_bias": (None,), **s}
        if cfg.moe.n_shared:
            s["shared"] = specs_mlp(cfg)
    return s


class MoeRoute(NamedTuple):
    """Where each (token, slot) assignment goes. Tensors are (G, g, k):
    G groups of g consecutive tokens of one sequence, k chosen experts per
    token, best first."""
    expert: torch.Tensor     # int64 expert index
    slot: torch.Tensor       # int64 place in its expert's queue within the group
    keep: torch.Tensor       # bool: slot < cap
    weights: torch.Tensor    # fp32 combine weights (softmax of the k logits), 0 where dropped
    cap: int                 # queue places per expert and group


def moe_route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> MoeRoute:
    """Top-k routing with capacity, as ``repro.models.layers.moe_mlp``: tokens
    in groups of ``g = min(cfg.moe_group, S)``, fp32 logits ``x @ router``,
    the k largest (ties to the lower expert index, as ``jax.lax.top_k``),
    softmax over those k. An assignment's queue place counts the earlier
    assignments to its expert in the group's token-major (token, slot)
    order; places from ``cap`` on are dropped (weight 0, the kept weights
    not renormalised). Reads nothing back to the host."""
    assert cfg.moe is not None
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    d = x.shape[-1]
    G, g, cap = _groups(x, cfg)
    logits = x.reshape(G, g, d).float() @ router                    # (G, g, E)
    top, expert = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, expert = top[..., :k], expert[..., :k]
    weights = torch.softmax(top, dim=-1)
    return _queued(expert, weights, E, cap)


def _groups(x: torch.Tensor, cfg: ModelConfig) -> tuple[int, int, int]:
    """(G, g, cap): ``moe_route``'s groups of ``x`` (B, S, d) and capacity."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    B, S, _ = x.shape
    g = min(cfg.moe_group, S)
    if S % g:
        raise ValueError(f"moe: sequence length {S} is not a multiple of the group {g}")
    return B * (S // g), g, max(1, int(k * g * cfg.moe_capacity_factor / E))


def _queued(expert: torch.Tensor, weights: torch.Tensor, E: int, cap: int) -> MoeRoute:
    """The route of choices ``expert`` (G, g, k) with ``weights``: each
    assignment's queue place among the earlier ones to its expert in the
    group's token-major (token, slot) order, those from ``cap`` on dropped."""
    G, g, k = expert.shape
    flat = expert.reshape(G, g * k, 1)
    onehot = torch.zeros((G, g * k, E), dtype=torch.int32, device=expert.device)
    onehot.scatter_(-1, flat, 1)
    earlier = onehot.cumsum(dim=1) - onehot                         # exclusive count
    slot = earlier.gather(-1, flat).reshape(G, g, k).long()
    keep = slot < cap
    return MoeRoute(expert, slot, keep, weights * keep, cap)


def moe_route_grouped(router: torch.Tensor, e_bias: torch.Tensor, x: torch.Tensor,
                      cfg: ModelConfig) -> MoeRoute:
    """DeepSeekMoE's routing (``DeepSeekMoEConfig``), in ``moe_route``'s groups
    and capacity: fp32 logits ``x @ router``, sigmoid scores; the choice by
    score + ``e_bias``, among the experts of the ``topk_groups`` groups (of
    ``n_groups`` consecutive experts) whose two best biased scores sum
    highest; the ``top_k`` best biased scores there, best first (``topk``:
    ties, which fp32 scores all but never make, in no set order); weights the
    chosen experts' unbiased scores over their sum, times ``routed_scale``.
    A group of one token (a decode step) queues each of its k distinct
    experts first, so the route keeps them all without ``_queued``'s count."""
    m = cfg.moe
    E, k, n_g = m.n_experts, m.top_k, m.n_groups
    G, g, cap = _groups(x, cfg)
    scores = torch.sigmoid(x.reshape(G, g, -1).float() @ router)   # (G, g, E)
    biased = (scores + e_bias).view(G, g, n_g, E // n_g)
    best = biased.topk(2, dim=-1).values.sum(-1).topk(m.topk_groups, dim=-1).indices
    allowed = torch.zeros((G, g, n_g, 1), dtype=torch.bool, device=x.device).scatter_(
        2, best[..., None], True)
    choice = torch.where(allowed, biased, float("-inf")).view(G, g, E)
    expert = choice.topk(k, dim=-1).indices
    w = scores.gather(-1, expert)
    w = w / w.sum(-1, keepdim=True) * m.routed_scale
    if g == 1:
        return MoeRoute(expert, torch.zeros_like(expert), torch.ones_like(expert, dtype=torch.bool),
                        w, cap)
    return _queued(expert, w, E, cap)


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE MLP with capacity-based dispatch (``moe_route``).

    The dispatch is a gather: each kept assignment writes its own index
    (token·k + slot) into its own entry of an int map of E·G·cap rows
    (expert, then group, then queue place; no two kept assignments share an
    entry, so the map is deterministic: ``moe_maps``), and
    ``ops.moe_dispatch`` gathers the (E, G·cap, d) expert inputs through it,
    empty rows zero. The experts run as one batched matmul over the expert
    axis. ``ops.moe_combine``
    gathers each token's k outputs back and adds them in slot order in
    fp32, weighted by the combine weights rounded to ``x.dtype``, and the
    sum is rounded to ``x.dtype``: the reference's roundings (bf16 expert
    products, SiLU on their bf16 output). On the card both are kernels whose
    backwards are gathers through the same maps; no atomics: two calls give
    the same bits. On DTensors each device runs this on its own shards
    (``_moe_sharded``).

    DeepSeekMoE routes by ``moe_route_grouped`` and adds its shared expert
    (``mlp`` of ``p["shared"]``, every token, once) to the fp32 sum before
    the rounding; its placement on DTensors is not ported."""
    grouped = isinstance(cfg.moe, DeepSeekMoEConfig)
    if sh.is_dtensor(x):
        if grouped:
            raise NotImplementedError("moe: the placement of DeepSeekMoE's router and shared "
                                      "expert on DTensors is not ported")
        return _moe_sharded(p, x, cfg)
    out = _moe_local(p, x, cfg)
    if grouped and "shared" in p:
        out = out + mlp(p["shared"], x, cfg).float()
    return out.to(x.dtype)


def _moe_local(p: Params, x: torch.Tensor, cfg: ModelConfig, first: int = 0) -> torch.Tensor:
    """``moe_mlp`` before its last rounding, in fp32, with the experts
    ``first .. first + E_l - 1`` that ``p``'s expert weights hold (E_l =
    their leading size; all E by default): the routing is over all E, and
    assignments to the other experts add nothing.

    Under a profiler the routing and dispatch are a ``moe.dispatch`` span
    counting the assignments ``kept`` and routed to a held expert (their
    mask, summed when the spans are read) and the E_l·G·cap expert ``rows``
    the batched matmul computes, with ``fused`` 1 where ``ops.moe_dispatch``
    and ``ops.moe_combine`` launch their kernels, 0 where they take the plain
    versions (the CPU)."""
    E_l = p["w_gate"].shape[0]
    B, S, d = x.shape
    with tracing.span("moe.dispatch") as sp:
        if isinstance(cfg.moe, DeepSeekMoEConfig):
            r = moe_route_grouped(p["router"], p["e_bias"], x, cfg)
        else:
            r = moe_route(p["router"], x, cfg)
        slot_row, row_slot, keep, weights = moe_maps(r, cfg.moe.n_experts, E_l, first)
        if sp.recording and tracing.countable(x):
            # kept is summed when the spans are read
            sp.set(kept=keep, rows=row_slot.numel(),
                   fused=int(ops.moe_fused(x, row_slot, slot_row)))
        xe = ops.moe_dispatch(x.reshape(-1, d), row_slot, slot_row).reshape(E_l, -1, d)
    if cfg.activation == "swiglu":
        h = F.silu(xe @ p["w_gate"]) * (xe @ p["w_up"])
    else:  # squared_relu, the reference's only other MoE activation
        h = torch.square(F.relu(xe @ p["w_up"]))
    ye = (h @ p["w_down"]).reshape(-1, d)
    w = weights.to(x.dtype).float().reshape(slot_row.shape)
    return ops.moe_combine(ye, w, row_slot, slot_row).reshape(B, S, d)


def moe_maps(r: MoeRoute, E: int, E_l: int, first: int = 0
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slot_row, row_slot, keep, weights): the dispatch's maps of route
    ``r`` over E experts, of which the E_l ``first .. first + E_l - 1`` are
    held. Expert rows run expert by expert, then group, then queue place
    (E_l·G·cap rows). ``slot_row`` (G·g, k) int64 is the row of each (token,
    slot) assignment, -1 where it is dropped or its expert not held;
    ``row_slot`` (E_l·G·cap,) int64 the assignment (token·k + slot) each row
    holds, -1 where empty. Each kept assignment owns one row and no two
    share one, so both maps are deterministic. ``keep`` and ``weights`` (G,
    g, k) are the route's, assignments to experts not held dropped and
    weighted 0."""
    G, g, k = r.expert.shape
    rows = G * r.cap                                                # per expert
    dev = r.expert.device
    group = torch.arange(G, device=dev).reshape(G, 1, 1)
    expert, keep, weights = r.expert, r.keep, r.weights
    if E_l < E:  # expert parallelism: this device's experts only
        mine = (expert >= first) & (expert < first + E_l)
        expert, keep, weights = expert - first, keep & mine, weights * mine
    dest = (expert * rows + group * r.cap + r.slot).reshape(G * g, k)   # (token, slot)
    kept = keep.reshape(G * g, k)
    R = E_l * rows
    # dropped assignments all write the spare entry past the end, never read
    row_slot = torch.full((R + 1,), -1, dtype=torch.long, device=dev)
    row_slot.scatter_(0, torch.where(kept, dest, R).reshape(-1),
                      torch.arange(G * g * k, device=dev))
    return torch.where(kept, dest, -1), row_slot[:R], keep, weights


def _moe_sharded(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``moe_mlp`` on DTensors. Every device routes its batch shard's tokens
    (the groups are consecutive tokens of one sequence, so a batch shard
    holds whole groups) and dispatches them locally, with no token moving:
    under expert parallelism (experts sharded over the model axis) to its
    own experts, under tensor parallelism (ff sharded) to its ff slice of
    every expert. Each device adds its share of a token's k outputs in
    fp32; the shares are summed by one all-reduce in fp32 and the sum
    rounded to ``x.dtype`` once, as the unsharded ``moe_mlp`` rounds it
    (under expert parallelism and top-2 routing, the same bits: a token's
    two shares are its two weighted outputs, or one of them and zero).
    This is the reference's exchange: its
    compiled step all-reduces the fp32 output of its combine, one buffer of
    the tokens' size, where a token exchange (an all-gather of the expert
    outputs) would move about k·capacity times as much. The drops and the
    slot order are the reference's. Weights sharded elsewhere (FSDP's embed
    dim) are gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    xp, xg, wp, wdp, wg, wdg, rg, outp = ([] for _ in range(8))
    ep_dim = None
    for i, (px, pw) in enumerate(zip(x.placements, p["w_gate"].placements, strict=True)):
        batch, experts, ff = px.is_shard(0), pw.is_shard(0), pw.is_shard(2)
        if experts:
            ep_dim = i
        split = experts or ff
        xp.append(Shard(0) if batch else Replicate())
        xg.append(Shard(0) if batch else Partial() if split else Replicate())
        wp.append(Shard(0) if experts else Shard(2) if ff else Replicate())
        wdp.append(Shard(0) if experts else Shard(1) if ff else Replicate())
        wg.append(Partial() if batch else wp[-1])
        wdg.append(Partial() if batch else wdp[-1])
        rg.append(Partial() if batch or split else Replicate())
        outp.append(Shard(0) if batch else Partial() if split else Replicate())
    xp, xg, wp, wdp, wg, wdg, rg, outp = map(tuple, (xp, xg, wp, wdp, wg, wdg, rg, outp))
    rp = sh.replicated(mesh)

    def local(xl, router, w_gate, w_up, w_down):
        first = 0 if ep_dim is None else mesh.get_local_rank(ep_dim) * w_gate.shape[0]
        lp = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        return _moe_local(lp, xl, cfg, first)

    out = sh.run_local(local, (x, p["router"], p["w_gate"], p["w_up"], p["w_down"]),
                       (xp, rp, wp, wp, wdp), outp, (xg, rg, wg, wg, wdg))
    return sh.settle(out, x).to(x.dtype)
