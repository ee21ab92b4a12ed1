"""Plain PyTorch versions of the kernels (the allclose targets).

Same layouts and arithmetic as ``repro.kernels.ref``: attention logits in
fp32 from the inputs' exact products, masked entries at -1e30; the mLSTM
recurrence in fp32 chunk by chunk. On a CPU tensor the wrappers in
``ops`` run these; on the card ``chip_smoke.py`` holds each CUDA kernel
against them. ``flash_attention_bwd_ref`` is autograd of
``flash_attention_ref``: the gradient the backward kernel is held to.
``flash_attention_bwd_fp32_ref`` computes the same gradient by its
formulas in fp32 from the forward's output as given, the arithmetic of the
backward kernel, so a bf16 kernel can be held to it elementwise; given the
rows' log-sum-exp (``flash_attention_lse_ref``, or the forward kernel's),
it takes p = exp(s − lse) from it, as the kernels do.
"""
from __future__ import annotations

import torch

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
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, S, K, hd)
    v: torch.Tensor,            # (B, S, K, hd)
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
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, S, K, hd)
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """(B, H, S) fp32: each query row's log-sum-exp ln Σ exp(q·k·hd^-½) over
    its visible keys, what the forward kernels write for the backward."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (hd ** -0.5)
    s = torch.where(_visible(S, k.shape[1], causal, window, q.device), s, NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, S, K, hd)
    v: torch.Tensor,            # (B, S, K, hd)
    dout: torch.Tensor,         # (B, S, H, hd): the output's gradient
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
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, S, K, hd)
    v: torch.Tensor,            # (B, S, K, hd)
    out: torch.Tensor,          # (B, S, H, hd): the forward's output
    dout: torch.Tensor,         # (B, S, H, hd): the output's gradient
    *,
    causal: bool = True,
    window: int | None = None,
    lse: torch.Tensor | None = None,  # (B, H, S) fp32 rows' log-sum-exp
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in fp32 by the backward's formulas, every input upcast:
    p = softmax(q·kᵀ·scale) (= exp(q·kᵀ·scale − lse) on visible pairs when
    ``lse`` is given), D = Σ_d dO·out, ds = p ⊙ (dO·vᵀ − D),
    dq = ds·k·scale, dk = dsᵀ·q·scale, dv = pᵀ·dO (summed over each kv
    group's query heads). D comes from the ``out`` given, which the forward
    rounded to the inputs' dtype, as in the backward kernel; the kernel
    then rounds only its outputs. ``flash_attention_bwd_ref`` on bf16
    inputs rounds its products to bf16 as well."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qg, og, dog = (t.float().reshape(B, S, K, G, hd) for t in (q, out, dout))
    kf, vf = k.float(), v.float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, kf) * scale
    visible = _visible(S, S, causal, window, q.device)
    if lse is None:
        p = torch.softmax(torch.where(visible, s, NEG_INF), dim=-1)
    else:
        lg = lse.float().reshape(B, K, G, S)[..., None]
        p = torch.where(visible, torch.exp(s - lg), 0.0)
    delta = torch.einsum("bskgh,bskgh->bkgs", dog, og)[..., None]
    ds = p * (torch.einsum("bskgh,btkh->bkgst", dog, vf) - delta)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    return dq.reshape(B, S, H, hd), dk, dv


def decode_attention_ref(
    q: torch.Tensor,            # (B, H, hd): one new token per sequence
    k_cache: torch.Tensor,      # (B, S, K, hd)
    v_cache: torch.Tensor,      # (B, S, K, hd)
    kv_len: torch.Tensor,       # (B,) int32: valid prefix length
) -> torch.Tensor:
    """Probabilities stay in fp32 through p·v, as in the reference."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * (hd ** -0.5)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None].to(q.device)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


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
        C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=q.device)
        nv = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
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
