"""Plain PyTorch versions of the attention kernels (the allclose targets).

Same layouts and arithmetic as ``repro.kernels.ref``: logits in fp32 from
the inputs' exact products, masked entries at -1e30. On a CPU tensor the
wrappers in ``ops`` run these; on the card ``chip_smoke.py`` holds each
CUDA kernel against them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, Sq, H, hd)


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
