"""Public wrappers of the kernels, named as in ``repro.kernels.ops``.

The device of the input decides what runs: a CPU tensor goes to the plain
PyTorch version in ``ref``; a CUDA tensor launches the hand-written CUDA
kernel, or raises (no fallback). Each wrapper counts its kernel launches in
a plain integer attribute, ``<wrapper>.launches``, so a run can show that
its path went through the kernel.

``flash_attention`` is a ``torch.autograd.Function`` whose backward is
``flash_attention_bwd`` (the backward kernels on the card, counted in
``flash_attention.bwd_launches``; autograd of the plain version on the
CPU). When it records a graph, the forward kernel also writes each row's
log-sum-exp, which the backward kernels read. Under ``torch.no_grad()``,
or for inputs that need no grad, it records no graph, allocates no
log-sum-exp and launches the forward alone. The other two kernels
have no backward: on the card they raise under grad rather than return
a tensor that silently carries no gradient.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm_chunk as _ml
from repro_torch.kernels.ref import (
    decode_attention_ref,
    flash_attention_bwd_ref,
    flash_attention_ref,
    mlstm_chunk_ref,
)

_count_lock = threading.Lock()  # engine tasks may call from several threads


def _on_cpu(*ts: torch.Tensor) -> bool:
    if all(t.is_cuda for t in ts):  # the card's path: the cheapest test first
        return False
    devices = {t.device.type for t in ts}
    if devices == {"cpu"}:
        return True
    raise ValueError(f"tensors on {sorted(devices)}: need all on cpu or all on cuda")


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_backward(name: str, roadmap: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} has no backward kernel, so on the card its output would carry "
        f"no gradient; call it under torch.no_grad() ({roadmap})")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, recording):
        lse = None
        if _on_cpu(q, k, v):
            out = flash_attention_ref(q, k, v, causal=causal, window=window)
        else:
            if recording:  # the backward kernels read each row's log-sum-exp
                B, S, H, _ = q.shape
                lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
            out = _fa.launch(q, k, v, causal=causal, window=window, lse=lse)
            with _count_lock:
                flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse=lse,
                                         causal=causal, window=window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,K,hd) -> (B,S,H,hd) in q.dtype; differentiable."""
    # grad mode is off inside Function.forward: whether a graph is recorded
    # is decided here
    return _FlashAttention.apply(q, k, v, causal, window, _needs_grad(q, k, v))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        lse: torch.Tensor | None = None, causal: bool = True,
                        window: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v), whose output was
    ``out``, against the output's gradient ``dout`` (shaped like q). On the
    card ``lse`` (fp32 (B,H,S)) is required: each row's log-sum-exp as the
    forward kernel wrote it (``flash_attention.launch(..., lse=)``); nothing
    recomputes it. On the CPU it is not read."""
    if _on_cpu(q, k, v, out, dout):
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal, window=window)
    if lse is None:
        raise ValueError("flash_attention_bwd: on the card the backward reads each row's "
                         "log-sum-exp from the forward; pass lse=")
    grads = _fa.launch_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
    with _count_lock:
        flash_attention.bwd_launches += 1
    return grads


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd), caches (B,S,K,hd), kv_len (B,) int32 -> (B,H,hd) in q.dtype."""
    if _on_cpu(q, k_cache, v_cache, kv_len):
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    if _needs_grad(q, k_cache, v_cache):
        raise _no_backward("decode_attention", "it serves decoding only, ROADMAP.md "
                           "queue 2; training runs flash_attention")
    out = _dec.launch(q, k_cache, v_cache, kv_len)
    with _count_lock:
        decode_attention.launches += 1
    return out


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                i_gate: torch.Tensor, *, chunk: int = 64,
                state: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """q/k/v (B,S,H,hd) fp32, log_f/i_gate (B,S,H) fp32, state (C (B,H,hd,hd),
    n (B,H,hd)) fp32 or None (zeros) -> (y (B,S,H,hd), final (C, n)).
    The chunk is clamped to S, as in the reference wrapper."""
    chunk = min(chunk, q.shape[1])
    if _on_cpu(q, k, v, log_f, i_gate, *(state or ())):
        return mlstm_chunk_ref(q, k, v, log_f, i_gate, chunk=chunk, state=state)
    if _needs_grad(q, k, v, log_f, i_gate, *(state or ())):
        raise _no_backward("mlstm_chunk", "xLSTM training waits for an mlstm_chunk "
                           "backward, ROADMAP.md queue 1 item 5")
    out = _ml.launch(q, k, v, log_f, i_gate, chunk=chunk, state=state)
    with _count_lock:
        mlstm_chunk.launches += 1
    return out


flash_attention.launches = 0
flash_attention.bwd_launches = 0
decode_attention.launches = 0
mlstm_chunk.launches = 0
