"""Public wrappers of the attention kernels, named as in ``repro.kernels.ops``.

The device of the input decides what runs: a CPU tensor goes to the plain
PyTorch version in ``ref``; a CUDA tensor launches the hand-written CUDA
kernel, or raises (no fallback). Each wrapper counts its kernel launches in
a plain integer attribute, ``<wrapper>.launches``, so a run can show that
its path went through the kernel.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref

_count_lock = threading.Lock()  # engine tasks may call from several threads


def _on_cpu(*ts: torch.Tensor) -> bool:
    devices = {t.device.type for t in ts}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"tensors on {sorted(devices)}: need all on cpu or all on cuda")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,K,hd) -> (B,S,H,hd) in q.dtype."""
    if _on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    out = _fa.launch(q, k, v, causal=causal, window=window)
    with _count_lock:
        flash_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd), caches (B,S,K,hd), kv_len (B,) int32 -> (B,H,hd) in q.dtype."""
    if _on_cpu(q, k_cache, v_cache, kv_len):
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    out = _dec.launch(q, k_cache, v_cache, kv_len)
    with _count_lock:
        decode_attention.launches += 1
    return out


flash_attention.launches = 0
decode_attention.launches = 0
