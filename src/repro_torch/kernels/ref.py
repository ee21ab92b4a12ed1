"""Plain PyTorch versions of the kernels (the allclose targets).

Same layouts and arithmetic as ``repro.kernels.ref``: attention logits in
fp32 from the inputs' exact products, masked entries at -1e30; the mLSTM
recurrence in fp32 chunk by chunk. On a CPU tensor the wrappers in
``ops`` run these; on the card ``tests/test_torch_cuda.py`` and the kernel
check (``chip_smoke.py``) hold each CUDA kernel against them. ``flash_attention_bwd_ref`` is autograd of
``flash_attention_ref``: the gradient the backward kernel is held to.
``mlstm_chunk_bwd_ref`` is the backward of ``mlstm_chunk_ref`` written
out in its formulas, chunk by chunk in reverse: the spec of the
``mlstm_chunk`` backward kernel.
``flash_attention_bwd_fp32_ref`` computes the same gradient by its
formulas in fp32 from the forward's output as given, the arithmetic of the
backward kernel, so a bf16 kernel can be held to it elementwise; given the
rows' log-sum-exp (``flash_attention_lse_ref``, or the forward kernel's),
it takes p = exp(s − lse) from it, as the kernels do.
``adamw_update_ref`` is the AdamW step of ``optim.adamw`` written out in
fp32 passes over each leaf, the function ``csrc/adamw.cu`` computes.
``moe_dispatch_ref`` and ``moe_combine_ref`` are the MoE layer's gathers
as PyTorch indexing, differentiated by autograd on the CPU; their forward
arithmetic and the gradients autograd gives them are what
``csrc/moe_dispatch.cu`` computes.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import leaves, map_tree

NEG_INF = -1e30


def _visible(Sq: int, Skv: int, causal: bool, window: int | None,
             device: torch.device) -> torch.Tensor:
    """The (Sq, Skv) mask of the (query, key) pairs attention may see."""
    qpos = torch.arange(Sq, device=device)
    kpos = torch.arange(Skv, device=device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def flash_attention_ref(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Skv, K, hd)
    v: torch.Tensor,            # (B, Skv, K, hd)
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Probabilities are cast to q.dtype before p·v, as in the reference."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * (hd ** -0.5)
    logits = torch.where(_visible(Sq, Skv, causal, window, q.device), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def flash_attention_lse_ref(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Skv, K, hd)
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """(B, H, Sq) fp32: each query row's log-sum-exp ln Σ exp(q·k·hd^-½) over
    its visible keys, what the forward kernels write for the backward."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.float().reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (hd ** -0.5)
    s = torch.where(_visible(Sq, k.shape[1], causal, window, q.device), s, NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_ref(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Skv, K, hd)
    v: torch.Tensor,            # (B, Skv, K, hd)
    dout: torch.Tensor,         # (B, Sq, H, hd): the output's gradient
    *,
    causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_ref`` at (q, k, v) against ``dout``,
    by ``torch.autograd.grad`` (grad mode on whatever the caller's is)."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_ref(q, k, v, causal=causal, window=window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    return dq, dk, dv


def flash_attention_bwd_fp32_ref(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Skv, K, hd)
    v: torch.Tensor,            # (B, Skv, K, hd)
    out: torch.Tensor,          # (B, Sq, H, hd): the forward's output
    dout: torch.Tensor,         # (B, Sq, H, hd): the output's gradient
    *,
    causal: bool = True,
    window: int | None = None,
    lse: torch.Tensor | None = None,  # (B, H, Sq) fp32 rows' log-sum-exp
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in fp32 by the backward's formulas, every input upcast:
    p = softmax(q·kᵀ·scale) (= exp(q·kᵀ·scale − lse) on visible pairs when
    ``lse`` is given), D = Σ_d dO·out, ds = p ⊙ (dO·vᵀ − D),
    dq = ds·k·scale, dk = dsᵀ·q·scale, dv = pᵀ·dO (summed over each kv
    group's query heads). D comes from the ``out`` given, which the forward
    rounded to the inputs' dtype, as in the backward kernel; the kernel
    then rounds only its outputs. ``flash_attention_bwd_ref`` on bf16
    inputs rounds its products to bf16 as well."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qg, og, dog = (t.float().reshape(B, Sq, K, G, hd) for t in (q, out, dout))
    kf, vf = k.float(), v.float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, kf) * scale
    visible = _visible(Sq, Skv, causal, window, q.device)
    if lse is None:
        p = torch.softmax(torch.where(visible, s, NEG_INF), dim=-1)
    else:
        lg = lse.float().reshape(B, K, G, Sq)[..., None]
        p = torch.where(visible, torch.exp(s - lg), 0.0)
    delta = torch.einsum("bskgh,bskgh->bkgs", dog, og)[..., None]
    ds = p * (torch.einsum("bskgh,btkh->bkgst", dog, vf) - delta)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    return dq.reshape(B, Sq, H, hd), dk, dv


def decode_attention_ref(
    q: torch.Tensor,            # (B, H, hd): one new token per sequence
    k_cache: torch.Tensor,      # (B, S, K, hd)
    v_cache: torch.Tensor,      # (B, S, K, hd)
    kv_len: torch.Tensor,       # (B,) int32: valid prefix length
    *,
    with_lse: bool = False,
):
    """Probabilities stay in fp32 through p·v, as in the reference. With
    ``with_lse`` also each row's log-sum-exp of its scaled scores over the
    visible keys, fp32 (B, H): -inf where none is visible (kv_len <= 0),
    the decode kernel's ``lse``."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * (hd ** -0.5)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None].to(q.device)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache.float())
    out = out.reshape(B, H, hd).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1).reshape(B, H)
    empty = (kv_len.to(q.device) <= 0)[:, None]
    return out, torch.where(empty, float("-inf"), lse)


def mlstm_chunk_ref(
    q: torch.Tensor,            # (B, S, H, hd) fp32
    k: torch.Tensor,
    v: torch.Tensor,
    log_f: torch.Tensor,        # (B, S, H) log forget gates (<= 0)
    i_gate: torch.Tensor,       # (B, S, H) input gates in (0, 1]
    chunk: int = 64,
    state: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Chunkwise mLSTM / gated linear attention, ``repro.kernels.ref``'s
    oracle with two generalisations: an initial state ``(C (B,H,hd,hd),
    n (B,H,hd))`` (zeros when None) and the final state as a second output.

    A ragged last chunk is padded with positions that leave the state
    unchanged (log_f = 0, i = 0, q = k = v = 0); their outputs are dropped.
    With zero state and ``S % chunk == 0`` this is exactly the reference.
    """
    B, S, H, hd = q.shape
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_f, i_gate = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (log_f, i_gate))
    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=q.dtype, device=q.device)
        nv = torch.zeros((B, H, hd), dtype=q.dtype, device=q.device)
    else:
        C, nv = state
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    ys = []
    for j in range(n_chunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        qc, kc, vc, fc, ic = q[:, sl], k[:, sl], v[:, sl], log_f[:, sl], i_gate[:, sl]
        fcum = torch.cumsum(fc, dim=1)                       # (B, c, H)
        ftot = fcum[:, -1]                                   # (B, H)
        qd = qc * torch.exp(fcum)[..., None]
        y_inter = torch.einsum("bshk,bhkv->bshv", qd, C)
        n_inter = torch.einsum("bshk,bhk->bsh", qd, nv)
        # D[s,t] = exp(fcum_s - fcum_t) * i_t for t <= s. Above the diagonal
        # rel > 0 can overflow exp, so those entries are -inf before it.
        rel = fcum[:, :, None, :] - fcum[:, None, :, :]      # (B, s, t, H)
        D = torch.exp(rel.masked_fill(~mask[None, :, :, None], float("-inf")))
        D = D * ic[:, None, :, :]
        scores = torch.einsum("bshk,bthk->bsth", qc, kc) * D
        y = y_inter + torch.einsum("bsth,bthv->bshv", scores, vc)
        nrm = n_inter + scores.sum(dim=2)
        ys.append(y / torch.clamp(nrm.abs(), min=1.0)[..., None])
        decay_k = torch.exp(ftot[:, None, :] - fcum)         # (B, c, H)
        kd = kc * (ic * decay_k)[..., None]
        C = torch.exp(ftot)[..., None, None] * C + torch.einsum("bshk,bshv->bhkv", kd, vc)
        nv = torch.exp(ftot)[..., None] * nv + kd.sum(dim=1)
    return torch.cat(ys, dim=1)[:, :S], (C, nv)


def mlstm_chunk_bwd_ref(
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    log_f: torch.Tensor,        # (B, S, H)
    i_gate: torch.Tensor,       # (B, S, H)
    y: torch.Tensor,            # (B, S, H, hd): the forward's output
    dy: torch.Tensor,           # (B, S, H, hd): its gradient
    *,
    chunk: int = 64,
    state: tuple[torch.Tensor, torch.Tensor] | None = None,
    dC: torch.Tensor | None = None,   # (B, H, hd, hd): gradient of the final C, or None
    dn: torch.Tensor | None = None,   # (B, H, hd): gradient of the final n, or None
) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dlog_f, di, dC0, dn0) of ``mlstm_chunk_ref`` at these
    inputs, in their dtype (at least fp32). A final-state gradient that is
    None counts as zeros; dC0 and dn0 are returned whether or not a state
    was given.

    Per chunk, with a_s = e^fcum_s, E[s,t] = e^(fcum_s − fcum_t) (t ≤ s, else
    0), D = E·i_t, P = (q·kᵀ)⊙D, nrm_s = a_s q_s·n + Σ_t P[s,t], m_s =
    max(|nrm_s|, 1), W_t = i_t e^(ftot − fcum_t), and dC', dn' the gradients
    of the state after the chunk:

    - g_s = dy_s / m_s; d nrm_s = −(dy_s·y_s)/m_s · sign(nrm_s) · [|nrm_s| ≥ 1]
      (at |nrm_s| = 1 the gradient passes, as ``torch.clamp(min=1)``'s does;
      JAX's ``jnp.maximum`` would pass half);
    - dP = g·vᵀ + d nrm (per row), dS = dP ⊙ D;
    - dq_s = a_s (C g_s + d nrm_s n) + Σ_t dS[s,t] k_t;
      dk_t = Σ_s dS[s,t] q_s + W_t (dC' v_t + dn');
      dv_t = Σ_s P[s,t] g_s + W_t dC'ᵀ k_t;
    - the gates: d fcum_s = a_s (q_s·C g_s + d nrm_s q_s·n) + Σ_t (dP⊙P)[s,t]
      − Σ_r (dP⊙P)[r,s] − dW_s W_s with dW_t = k_t·(dC' v_t + dn');
      d ftot = e^ftot (Σ C⊙dC' + n·dn') + Σ_t dW_t W_t;
      d log_f_u = Σ_{s ≥ u} d fcum_s + d ftot (a reverse cumulative sum);
      d i_t = Σ_s (dP⊙(q·kᵀ)⊙E)[s,t] + dW_t e^(ftot − fcum_t);
    - the carry: dC ← e^ftot dC' + Σ_s a_s q_s g_sᵀ, dn ← e^ftot dn' +
      Σ_s a_s d nrm_s q_s.

    The padded positions of a ragged last chunk get no gradient.
    """
    B, S, H, hd = q.shape
    dt = torch.promote_types(q.dtype, torch.float32)
    q, k, v, log_f, i_gate, y, dy = (t.to(dt) for t in (q, k, v, log_f, i_gate, y, dy))
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        q, k, v, y, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (q, k, v, y, dy))
        log_f, i_gate = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (log_f, i_gate))
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=q.device)  # noqa: E731
    C, nv = (zeros(B, H, hd, hd), zeros(B, H, hd)) if state is None else (
        state[0].to(dt), state[1].to(dt))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    states = []  # the state entering each chunk
    for j in range(n_chunks):
        states.append((C, nv))
        sl = slice(j * chunk, (j + 1) * chunk)
        kc, vc, fc, ic = k[:, sl], v[:, sl], log_f[:, sl], i_gate[:, sl]
        fcum = torch.cumsum(fc, dim=1)
        ftot = fcum[:, -1]
        kd = kc * (ic * torch.exp(ftot[:, None, :] - fcum))[..., None]
        C = torch.exp(ftot)[..., None, None] * C + torch.einsum("bshk,bshv->bhkv", kd, vc)
        nv = torch.exp(ftot)[..., None] * nv + kd.sum(dim=1)

    dCn = zeros(B, H, hd, hd) if dC is None else dC.to(dt)
    dnn = zeros(B, H, hd) if dn is None else dn.to(dt)
    grads = []
    for j in reversed(range(n_chunks)):
        C, nv = states[j]
        sl = slice(j * chunk, (j + 1) * chunk)
        qc, kc, vc, fc, ic = q[:, sl], k[:, sl], v[:, sl], log_f[:, sl], i_gate[:, sl]
        yc, dyc = y[:, sl], dy[:, sl]
        fcum = torch.cumsum(fc, dim=1)                       # (B, c, H)
        ftot = fcum[:, -1]                                   # (B, H)
        a = torch.exp(fcum)
        rel = fcum[:, :, None, :] - fcum[:, None, :, :]      # (B, s, t, H)
        E = torch.exp(rel.masked_fill(~mask[None, :, :, None], float("-inf")))
        D = E * ic[:, None, :, :]
        Sc = torch.einsum("bshk,bthk->bsth", qc, kc)
        P = Sc * D
        qn = torch.einsum("bshk,bhk->bsh", qc, nv)
        nrm = a * qn + P.sum(dim=2)
        m = torch.clamp(nrm.abs(), min=1.0)
        g = dyc / m[..., None]
        dnrm = (-(dyc * yc).sum(-1) / m) * torch.sign(nrm) * (nrm.abs() >= 1.0)
        # the output and the normaliser
        CG = torch.einsum("bshv,bhkv->bshk", g, C)           # C g_s
        dq = a[..., None] * (CG + dnrm[..., None] * nv[:, None])
        da = (qc * CG).sum(-1) + dnrm * qn
        dP = torch.einsum("bshv,bthv->bsth", g, vc) + dnrm[:, :, None, :]
        dS = dP * D
        dq = dq + torch.einsum("bsth,bthk->bshk", dS, kc)
        dk = torch.einsum("bsth,bshk->bthk", dS, qc)
        dv = torch.einsum("bsth,bshv->bthv", P, g)
        dPP = dP * P
        dfcum = a * da + dPP.sum(dim=2) - dPP.sum(dim=1)
        di = (dP * Sc * E).sum(dim=1)
        # the state update
        decay_k = torch.exp(ftot[:, None, :] - fcum)
        W = ic * decay_k
        DV = torch.einsum("bthv,bhkv->bthk", vc, dCn) + dnn[:, None]   # dC' v_t + dn'
        dk = dk + W[..., None] * DV
        dv = dv + W[..., None] * torch.einsum("bthk,bhkv->bthv", kc, dCn)
        dW = (kc * DV).sum(-1)
        di = di + dW * decay_k
        dfcum = dfcum - dW * W
        dftot = (torch.exp(ftot) * ((C * dCn).sum((-2, -1)) + (nv * dnn).sum(-1))
                 + (dW * W).sum(dim=1))
        dlf = torch.flip(torch.cumsum(torch.flip(dfcum, (1,)), dim=1), (1,)) + dftot[:, None]
        grads.append((dq, dk, dv, dlf, di))
        # the carry to the chunk before
        dCn = (torch.exp(ftot)[..., None, None] * dCn
               + torch.einsum("bshk,bshv->bhkv", a[..., None] * qc, g))
        dnn = torch.exp(ftot)[..., None] * dnn + torch.einsum("bsh,bshk->bhk", a * dnrm, qc)
    out = [torch.cat(parts[::-1], dim=1)[:, :S] for parts in zip(*grads)]
    return (*out, dCn, dnn)


@torch.no_grad()
def adamw_update_ref(
    grads: Any, state: dict[str, Any], params: Any, cfg: Any,
    lr_scale: torch.Tensor | float = 1.0,
) -> tuple[Any, dict[str, Any], dict[str, torch.Tensor]]:
    """(new params, new state, {"grad_norm"}): the clipped, bias-corrected
    AdamW step of ``optim.adamw.adamw_update`` (``cfg`` an ``AdamWConfig``),
    in fp32, each new leaf cast back to its parameter's dtype."""
    if cfg.grad_compress == "bf16":
        grads = map_tree(lambda g: g.to(torch.bfloat16), grads)
    grads = map_tree(lambda g: g.float(), grads)

    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in leaves(grads)))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    grads = map_tree(lambda g: g * scale, grads)

    count = state["count"] + 1
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())
    mu = map_tree(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state["mu"], grads)
    nu = map_tree(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, state["nu"], grads)
    lr = cfg.lr * lr_scale

    def upd(p, m, v):
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:  # no weight decay on norms/bias
            step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = map_tree(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": count}, {"grad_norm": gnorm}


def moe_dispatch_ref(x: torch.Tensor, row_slot: torch.Tensor, k: int) -> torch.Tensor:
    """x (T, d) -> (R, d): expert row r holds the token of assignment
    ``row_slot[r]`` (token·k + slot), zeros where it is -1. Every empty row
    gathers one appended zero row."""
    T, d = x.shape
    src = torch.where(row_slot >= 0, row_slot.div(k, rounding_mode="floor"), T)
    return torch.cat([x, x.new_zeros((1, d))])[src]


def moe_combine_ref(ye: torch.Tensor, w: torch.Tensor, slot_row: torch.Tensor) -> torch.Tensor:
    """ye (R, d), w (T, k) fp32, slot_row (T, k) -> (T, d) fp32: each token's
    k rows ``ye[slot_row]`` weighted by w and added in slot order in fp32.
    A dropped assignment (-1) gathers row 0 at its weight, which the route
    has made 0."""
    y = ye[slot_row.clamp(min=0)]                                   # (T, k, d)
    out = w[:, 0, None] * y[:, 0].float()
    for j in range(1, slot_row.shape[1]):
        out = out + w[:, j, None] * y[:, j].float()
    return out
