"""The plain reference of DeepSeek-V3's language model: latent attention and
DeepSeekMoE, its forward and its greedy scores, in plain PyTorch.

It imports nothing of the program. It is written from the model's equations
(arXiv:2412.19437) as the configuration file states them
(``portbench/configs/deepseek_v3.json``, the keys of the model's published
``config.json``): pre-norm blocks of multi-head latent attention, the first
``first_k_dense_replace`` with a SwiGLU MLP, the rest with DeepSeekMoE.

Attention is the textbook form: each head's key and value expanded from the
latent, ``k = [latent·W_UK, RoPE(k_pe)]`` with one rotary key per token
shared by the heads, ``q = [q_nope, RoPE(q_pe)]`` through the query's
low-rank bottleneck, causal softmax at (nope + rope)^-½ times YaRN's
mscale(mscale_all_dim)². RoPE is split-half over the rotary dims, its
inverse frequencies YaRN's: θ^(−2i/rope) blended with the same over
``factor`` by a linear ramp between the dims that turn ``beta_fast`` and
``beta_slow`` times over ``original_max_position_embeddings``.

The router scores by sigmoid; it chooses by score plus the correction bias
``e_bias``, only among the experts of the ``topk_group`` groups (of
``n_group``) whose two best biased scores sum highest, the
``num_experts_per_tok`` best; their unbiased scores, over their sum, times
``routed_scaling_factor``, weigh them. The router is over
``n_routed_experts``; the first ``n_experts`` are the ones given, and a
token's choice of another adds nothing. ``n_shared_experts`` experts' width
of one SwiGLU adds to every token. No assignment is dropped.

Every product runs through ``lm.Precision``, as the other reference's:
float32 with TF32 off (the reference), or its operands rounded to bfloat16
or float8 e4m3 (the controls).
"""
from __future__ import annotations

import math

import torch

from portbench.reference.lm import Precision, at, rmsnorm, swiglu, weight


def softmax_scale(c: dict) -> float:
    s = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    y = c.get("rope_scaling")
    if y and y.get("mscale_all_dim"):
        m = 0.1 * y["mscale_all_dim"] * math.log(y["factor"]) + 1.0
        s *= m * m
    return s


def inv_freq(c: dict, device) -> torch.Tensor:
    dim, theta = c["qk_rope_head_dim"], c["rope_theta"]
    base = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    y = c.get("rope_scaling")
    if not y:
        return base

    def turning(rotations):
        return (dim * math.log(y["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi)) / (2 * math.log(theta)))

    lo = max(math.floor(turning(y["beta_fast"])), 0)
    hi = min(math.ceil(turning(y["beta_slow"])), dim - 1)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
                       / max(hi - lo, 1e-3), 0, 1)
    return base * (1 - ramp) + base / y["factor"] * ramp


def rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Split-half rotary embedding of x (B, S, n, rope) at positions 0..S-1."""
    S, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mla(p, r, x, c, prec):
    B, S, _ = x.shape
    H, nope, rd = c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    vd, kr, eps = c["v_head_dim"], c["kv_lora_rank"], c["rms_norm_eps"]
    freqs = inv_freq(c, x.device)
    cq = rmsnorm(prec.mm(x, at(p["wq_a"], r)), at(p["q_norm"]["scale"], r), eps)
    q = prec.mm(cq, at(p["wq_b"], r)).reshape(B, S, H, nope + rd)
    kv_a = prec.mm(x, at(p["wkv_a"], r))
    latent = rmsnorm(kv_a[..., :kr], at(p["kv_norm"]["scale"], r), eps)
    kv = prec.mm(latent, at(p["wkv_b"], r)).reshape(B, S, H, nope + vd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], freqs)], dim=-1)
    k_pe = rope(kv_a[:, :, None, kr:], freqs).expand(B, S, H, rd)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    v = kv[..., nope:]
    logits = prec.mm(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) * softmax_scale(c)
    pos = torch.arange(S, device=x.device)
    logits = logits.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    out = prec.mm(torch.softmax(logits, dim=-1), v.permute(0, 2, 1, 3))   # (B, H, S, vd)
    return prec.mm(out.permute(0, 2, 1, 3).reshape(B, S, H * vd), at(p["wo"], r))


def route(logits: torch.Tensor, e_bias: torch.Tensor, c: dict):
    """(expert (N, k), weight (N, k)) of N tokens whose router logits are
    ``logits`` (N, E)."""
    N, E = logits.shape
    n_g, k = c["n_group"], c["num_experts_per_tok"]
    scores = torch.sigmoid(logits)
    biased = scores + e_bias
    group = biased.reshape(N, n_g, E // n_g).topk(2, dim=-1).values.sum(-1)
    chosen = torch.zeros_like(group).scatter(1, group.topk(c["topk_group"], dim=-1).indices, 1)
    allowed = chosen.repeat_interleave(E // n_g, dim=-1).bool()
    expert = biased.masked_fill(~allowed, float("-inf")).topk(k, dim=-1).indices
    w = scores.gather(1, expert)
    if c["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    return expert, w * c["routed_scaling_factor"]


def moe(p, r, x, c, prec):
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    expert, w = route(prec.mm(xf, at(p["router"], r)), at(p["e_bias"], r), c)
    out = swiglu(xf, at(p["shared"]["w_gate"], r), at(p["shared"]["w_up"], r),
                 at(p["shared"]["w_down"], r), prec)
    for e in range(p["w_gate"].shape[1]):                          # the experts held
        tok, slot = torch.nonzero(expert == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(xf[tok], weight(p["w_gate"][r, e]), weight(p["w_up"][r, e]),
                   weight(p["w_down"][r, e]), prec)
        out = out.index_add(0, tok, w[tok, slot, None] * y)
    return out.reshape(B, S, d)


def dense(p, r, x, c, prec):
    return swiglu(x, at(p["w_gate"], r), at(p["w_up"], r), at(p["w_down"], r), prec)


def forward(params: dict, c: dict, tokens: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Logits (B, S, vocab) in float32 of ``tokens`` (B, S). Layer ``i`` is
    repeat ``i // len(blocks)`` of block ``i % len(blocks)``."""
    eps = c["rms_norm_eps"]
    x = params["embed"][tokens].float()
    blocks = params["blocks"]
    for i in range(c["num_hidden_layers"]):
        bp, r = blocks[i % len(blocks)], i // len(blocks)
        x = x + mla(bp["mixer"], r, rmsnorm(x, at(bp["norm1"]["scale"], r), eps), c, prec)
        h = rmsnorm(x, at(bp["norm2"]["scale"], r), eps)
        mlp = dense if i < c["first_k_dense_replace"] else moe
        x = x + mlp(bp["mlp"], r, h, c, prec)
    x = rmsnorm(x, weight(params["final_norm"]["scale"]), eps)
    return prec.mm(x, weight(params["lm_head"]))


@torch.no_grad()
def served_gaps(params, c, prompts: torch.Tensor, served: torch.Tensor,
                prec: Precision | None = None, block: int = 32):
    """Teacher-forced over each prompt (B, P) and its served tokens (B, G), in
    blocks of ``block`` sequences: at each position that chose a served token,
    how far its float32 reference logit lies below the reference's best
    (B, G); with ``prec``, also how far below the best lies the reference's
    logit of the token that ``prec`` ranks first (else None)."""
    P, G = prompts.shape[1], served.shape[1]
    got, ctl = [], []
    for i in range(0, prompts.shape[0], block):
        seq = torch.cat([prompts[i:i + block], served[i:i + block, :-1]], dim=1)
        want = forward(params, c, seq, Precision("fp32"))[:, P - 1:P - 1 + G]
        best = want.amax(-1)
        got.append(best - want.gather(-1, served[i:i + block, :, None])[..., 0])
        if prec is not None:
            first = forward(params, c, seq, prec)[:, P - 1:P - 1 + G].argmax(-1, keepdim=True)
            ctl.append(best - want.gather(-1, first)[..., 0])
        del want
    return torch.cat(got), (torch.cat(ctl) if ctl else None)
