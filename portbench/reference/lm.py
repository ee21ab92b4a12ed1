"""The plain reference: the language model of a configuration file, its loss,
its training step and its greedy scores, in plain PyTorch.

It imports nothing of the program. It is written from the model's equations
as the configuration states them (``portbench/configs/<name>.json``): pre-norm
blocks whose mixer is attention (grouped-query, split-half RoPE, causal, the
sliding window) or mamba (the selective scan of Mamba-1, its causal depthwise
conv, ``dt`` through a rank-``d_model/16`` projection and softplus), and whose
MLP is SwiGLU or a top-k mixture of SwiGLU experts. The router is over
``router_experts``; the first ``n_experts`` of them are the ones given, and a
token's choice of another adds nothing. With ``capacity`` (training) the
experts take tokens in groups of ``min(moe_group, S)`` consecutive positions
of one sequence, each expert ``int(top_k · g · moe_capacity_factor / E)``
assignments a group in token-major order, the rest dropped; without it
(serving, one token at a time) none is dropped. The loss is the mean
next-token cross entropy plus ``1e-4 · mean(logsumexp²)``. AdamW clips the
global gradient norm to 1, decays every leaf of two or more dimensions as
stored (stacked per-layer leaves included), and stores each leaf in its
configured dtype.

Every product runs through one ``Precision``: float32 with TF32 off (the
reference), or its operands rounded to bfloat16 or to float8 e4m3 with one
scale per tensor (the controls). ``weight`` takes a stored leaf to float32
where it is used, so a model served in bf16 is read one leaf at a time.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class Precision:
    """Where the products' operands are rounded: ``fp32`` (not at all),
    ``bf16`` or ``fp8`` (e4m3, one scale per tensor: its largest magnitude
    maps to 448). Under autograd the rounded products' gradients are
    rounded alike."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "bf16", "fp8"):
            raise ValueError(name)
        self.name = name

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return t
        if self.name == "bf16":
            return t.to(torch.bfloat16).float()
        amax = t.detach().abs().amax().clamp(min=1e-30)
        s = amax / E4M3_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return a @ b
        return _RoundedMatmul.apply(a, b, self)


def _sum_to(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    while t.dim() > len(shape):
        t = t.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and t.shape[i] != 1:
            t = t.sum(i, keepdim=True)
    return t


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, prec):
        ra, rb = prec.round(a), prec.round(b)
        ctx.save_for_backward(ra, rb)
        ctx.prec = prec
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.prec.round(g)
        da = _sum_to(rg @ rb.transpose(-1, -2), ra.shape)
        db = _sum_to(ra.transpose(-1, -2) @ rg, rb.shape)
        return da, db, None


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def weight(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def at(leaf: torch.Tensor, r: int) -> torch.Tensor:
    """Layer ``r`` of a stacked leaf, in float32."""
    return weight(leaf[r])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """Split-half rotary embedding of x (B, S, n, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, r, x, c, prec):
    B, S, _ = x.shape
    H, K, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    q = prec.mm(x, at(p["wq"], r)).reshape(B, S, H, hd)
    k = prec.mm(x, at(p["wk"], r)).reshape(B, S, K, hd)
    v = prec.mm(x, at(p["wv"], r)).reshape(B, S, K, hd)
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    G = H // K
    qg = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)          # (B, K, G, S, hd)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                          # (B, K, 1, hd, S)
    vg = v.permute(0, 2, 1, 3)[:, :, None]                          # (B, K, 1, S, hd)
    logits = prec.mm(qg, kt) * hd ** -0.5
    pos = torch.arange(S, device=x.device)
    mask = pos[None, :] <= pos[:, None]
    if c.get("sliding_window"):
        mask &= pos[None, :] > pos[:, None] - c["sliding_window"]
    logits = logits.masked_fill(~mask, float("-inf"))
    out = prec.mm(torch.softmax(logits, dim=-1), vg)                # (B, K, G, S, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    return prec.mm(out, at(p["wo"], r))


def mamba(p, r, x, c, prec):
    B, S, d = x.shape
    di = c["ssm_expand"] * d
    n, w = c["ssm_state_dim"], c["ssm_conv_width"]
    rank = c.get("mamba_dt_rank", max(1, d // 16))
    xz = prec.mm(x, at(p["in_proj"], r))
    xin, z = xz[..., :di], xz[..., di:]
    conv_w, conv_b = at(p["conv_w"], r), at(p["conv_b"], r)
    xpad = torch.cat([xin.new_zeros((B, w - 1, di)), xin], dim=1)
    conv = sum(xpad[:, i:i + S] * conv_w[i] for i in range(w)) + conv_b
    u = F.silu(conv)
    proj = prec.mm(u, at(p["x_proj"], r))
    dt_in, Bm, Cm = proj[..., :rank], proj[..., rank:rank + n], proj[..., rank + n:]
    delta = F.softplus(prec.mm(dt_in, at(p["dt_proj"], r)) + at(p["dt_bias"], r))
    A = -torch.exp(at(p["A_log"], r))                               # (di, n)
    h = x.new_zeros((B, di, n))
    ys = []
    for t in range(S):
        h = torch.exp(delta[:, t, :, None] * A) * h + \
            (delta[:, t] * u[:, t])[:, :, None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) + u * at(p["D"], r)
    return prec.mm(y * F.silu(z), at(p["out_proj"], r))


def swiglu(x, w_gate, w_up, w_down, prec):
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def dense(p, r, x, c, prec):
    return swiglu(x, at(p["w_gate"], r), at(p["w_up"], r), at(p["w_down"], r), prec)


def moe_route(logits, c, capacity: bool):
    """(expert (N, k), weight (N, k) with 0 where dropped) of N = B·S tokens
    whose router logits are ``logits`` (B, S, E)."""
    B, S, E = logits.shape
    k = c["top_k"]
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, expert = order.values[..., :k], order.indices[..., :k]
    wts = torch.softmax(top, dim=-1)
    if capacity:
        g = min(c["moe_group"], S)
        cap = max(1, int(k * g * c["moe_capacity_factor"] / E))
        flat = expert.reshape(B * S // g, g * k)                   # token-major in each group
        onehot = F.one_hot(flat, E)
        before = (onehot.cumsum(dim=1) - onehot).gather(-1, flat[..., None])[..., 0]
        wts = wts * (before < cap).reshape(B, S, k)
    return expert.reshape(B * S, k), wts.reshape(B * S, k)


def moe(p, r, x, c, prec, capacity: bool):
    B, S, d = x.shape
    logits = prec.mm(x, at(p["router"], r))
    expert, wts = moe_route(logits, c, capacity)
    xf = x.reshape(B * S, d)
    out = xf.new_zeros((B * S, d))
    for e in range(p["w_gate"].shape[1]):                          # the experts held
        tok, slot = torch.nonzero((expert == e) & (wts != 0), as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(xf[tok], weight(p["w_gate"][r, e]), weight(p["w_up"][r, e]),
                   weight(p["w_down"][r, e]), prec)
        out = out.index_add(0, tok, wts[tok, slot, None] * y)
    return out.reshape(B, S, d)


MIXERS = {"attn": attention, "mamba": mamba}


def forward(params: dict, c: dict, tokens: torch.Tensor, prec: Precision,
            capacity: bool) -> torch.Tensor:
    """Logits (B, S, vocab) in float32 of ``tokens`` (B, S)."""
    eps = c["norm_eps"]
    x = params["embed"][tokens].float()
    R = c["n_layers"] // len(c["block_pattern"])
    for r in range(R):
        for bp, entry in zip(params["blocks"], c["block_pattern"]):
            mixer, _, mlp = entry.partition("+")
            x = x + MIXERS[mixer](bp["mixer"], r, rmsnorm(x, at(bp["norm1"]["scale"], r), eps),
                                  c, prec)
            if mlp:
                h = rmsnorm(x, at(bp["norm2"]["scale"], r), eps)
                x = x + (moe(bp["mlp"], r, h, c, prec, capacity) if mlp == "moe"
                         else dense(bp["mlp"], r, h, c, prec))
    x = rmsnorm(x, weight(params["final_norm"]["scale"]), eps)
    return prec.mm(x, weight(params["lm_head"]))


def loss(params, c, tokens, labels, prec) -> torch.Tensor:
    logits = forward(params, c, tokens, prec, capacity=True)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (logz - gold).mean() + 1e-4 * (logz * logz).mean()


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def rebuild(like: Any, flat: list) -> Any:
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(like)


def lr_scale(count: int, warmup: int, total: int = 10000, min_frac: float = 0.1) -> float:
    """Linear warm-up from (count+1)/warmup, then a cosine to ``min_frac``."""
    if count < warmup:
        return (count + 1.0) / max(1.0, warmup)
    prog = min(max((count - warmup) / max(1.0, total - warmup), 0.0), 1.0)
    return min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * prog))


class Trainer:
    """AdamW training of float32 copies of the given leaves, each stored back
    in its configured dtype after every update. ``step`` takes the step's
    microbatches and returns the loss; ``first_grads`` keeps the first
    step's gradient, before clipping, and ``first_grad_norms`` its leaves'
    norms."""

    def __init__(self, params: Any, c: dict, adamw: dict, prec: Precision):
        self.c, self.prec = c, prec
        self.like = rebuild(params, [None] * len(leaves(params)))    # the tree's shape only
        self.dtypes = [t.dtype for t in leaves(params)]
        self.p = [t.float().clone() for t in leaves(params)]
        self.mu = [torch.zeros_like(t) for t in self.p]
        self.nu = [torch.zeros_like(t) for t in self.p]
        self.count = 0
        self.opt = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
                    "clip_norm": 1.0, "warmup": 200, **adamw}
        self.first_grad_norms: list[float] | None = None
        self.first_grads: list[torch.Tensor] | None = None

    def step(self, micro: list[tuple[torch.Tensor, torch.Tensor]]) -> float:
        o = self.opt
        grads = [torch.zeros_like(t) for t in self.p]
        total = 0.0
        for tokens, labels in micro:
            ps = [t.detach().requires_grad_() for t in self.p]
            lv = loss(rebuild(self.like, ps), self.c, tokens, labels, self.prec)
            gs = torch.autograd.grad(lv, ps)
            grads = [a + b for a, b in zip(grads, gs)]
            total += lv.item()
            del lv, gs, ps
        grads = [g / len(micro) for g in grads]
        if self.first_grad_norms is None:
            self.first_grad_norms = [g.norm().item() for g in grads]
            self.first_grads = [g.clone() for g in grads]
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(o["clip_norm"] / (gnorm + 1e-9), max=1.0)
            lr = o["lr"] * lr_scale(self.count, o["warmup"])
            self.count += 1
            b1c, b2c = 1 - o["b1"] ** self.count, 1 - o["b2"] ** self.count
            for i, g in enumerate(grads):
                g = g * scale
                self.mu[i] = o["b1"] * self.mu[i] + (1 - o["b1"]) * g
                self.nu[i] = o["b2"] * self.nu[i] + (1 - o["b2"]) * g * g
                upd = (self.mu[i] / b1c) / (torch.sqrt(self.nu[i] / b2c) + o["eps"])
                if self.p[i].dim() >= 2:
                    upd = upd + o["weight_decay"] * self.p[i]
                self.p[i] = (self.p[i] - lr * upd).to(self.dtypes[i]).float()
        return total / len(micro)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@torch.no_grad()
def served_gaps(params, c, prompts: torch.Tensor, served: torch.Tensor, prec: Precision,
                ref_logits: torch.Tensor | None = None):
    """Teacher-forced over each prompt (B, P) and its served tokens (B, G):
    the logits (B, G, vocab) at the positions that chose the served tokens.
    With ``ref_logits`` (the float32 reference's), also, at each position,
    how far below the reference's best lies the reference's logit of the
    token this precision ranks first."""
    P, G = prompts.shape[1], served.shape[1]
    seq = torch.cat([prompts, served[:, :-1]], dim=1)
    logits = forward(params, c, seq, prec, capacity=False)[:, P - 1:P - 1 + G]
    if ref_logits is None:
        return logits
    first = logits.argmax(dim=-1, keepdim=True)
    return logits, ref_logits.amax(-1) - ref_logits.gather(-1, first)[..., 0]
