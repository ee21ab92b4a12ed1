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
log-sum-exp and launches the forward alone. Queries and keys of different
lengths (cross-attention) run the same kernels, forward and backward.

``mlstm_chunk`` is likewise a ``torch.autograd.Function``: on the card its
forward, when it records a graph, also saves each chunk's entering state
and each row's normaliser, and its backward is the ``mlstm_chunk``
backward kernel (counted in ``mlstm_chunk.bwd_launches``); on the CPU the
forward is ``mlstm_chunk_ref`` and the backward ``mlstm_chunk_bwd_ref``.
Under ``torch.no_grad()`` the kernel saves nothing. ``decode_attention``
has no backward: on the card it raises under grad rather than return a
tensor that silently carries no gradient.
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
    mlstm_chunk_bwd_ref,
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
    """q (B,Sq,H,hd), k/v (B,Skv,K,hd) -> (B,Sq,H,hd) in q.dtype;
    differentiable. Sq != Skv takes no causal or window mask."""
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
    card ``lse`` (fp32 (B,H,Sq)) is required: each row's log-sum-exp as the
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


class _MlstmChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, log_f, i_gate, C0, n0, chunk, recording):
        ctx.set_materialize_grads(False)  # an unused final state's gradient stays None
        state = None if C0 is None else (C0, n0)
        saved = ()
        if _on_cpu(q, k, v, log_f, i_gate, *(state or ())):
            y, (C, n) = mlstm_chunk_ref(q, k, v, log_f, i_gate, chunk=chunk, state=state)
        else:
            if recording:  # the backward kernel reads the chunks' states and the normalisers
                y, (C, n), saved = _ml.launch(q, k, v, log_f, i_gate, chunk=chunk, state=state,
                                              save=True)
            else:
                y, (C, n) = _ml.launch(q, k, v, log_f, i_gate, chunk=chunk, state=state)
            with _count_lock:
                mlstm_chunk.launches += 1
        ctx.save_for_backward(q, k, v, log_f, i_gate, C0, n0, y, *saved)
        ctx.chunk = chunk
        return y, C, n

    @staticmethod
    def backward(ctx, dy, dC, dn):
        q, k, v, log_f, i_gate, C0, n0, y, *saved = ctx.saved_tensors
        state = None if C0 is None else (C0, n0)
        if dy is None:  # only the final state is used
            dy = torch.zeros_like(y)
        grads = mlstm_chunk_bwd(q, k, v, log_f, i_gate, y, dy.contiguous(), saved=saved,
                                chunk=ctx.chunk, state=state, dC=dC, dn=dn)
        dq, dk, dv, dlf, di, dC0, dn0 = grads
        if state is None:
            dC0 = dn0 = None
        return dq, dk, dv, dlf, di, dC0, dn0, None, None


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                i_gate: torch.Tensor, *, chunk: int = 64,
                state: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """q/k/v (B,S,H,hd) fp32, log_f/i_gate (B,S,H) fp32, state (C (B,H,hd,hd),
    n (B,H,hd)) fp32 or None (zeros) -> (y (B,S,H,hd), final (C, n));
    differentiable in every input. The chunk is clamped to S, as in the
    reference wrapper."""
    chunk = min(chunk, q.shape[1])
    C0, n0 = (None, None) if state is None else state
    # grad mode is off inside Function.forward: whether a graph is recorded is decided here
    recording = _needs_grad(q, k, v, log_f, i_gate, *(state or ()))
    y, C, n = _MlstmChunk.apply(q, k, v, log_f, i_gate, C0, n0, chunk, recording)
    return y, (C, n)


def mlstm_chunk_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                    i_gate: torch.Tensor, y: torch.Tensor, dy: torch.Tensor, *,
                    saved: tuple[torch.Tensor, ...] = (), chunk: int = 64,
                    state: tuple[torch.Tensor, torch.Tensor] | None = None,
                    dC: torch.Tensor | None = None, dn: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dlog_f, di, dC0, dn0) of ``mlstm_chunk`` at these inputs
    (chunk as the forward used it), whose output was ``y``, against the
    output's gradient ``dy`` and the final state's (None: zeros). On the card
    ``saved`` is required: what the forward kernel saved when asked
    (``mlstm_chunk.launch(..., save=True)``); dC0 and dn0 are None without a
    ``state``. On the CPU ``saved`` is not read."""
    if _on_cpu(q, k, v, log_f, i_gate, y, dy):
        return mlstm_chunk_bwd_ref(q, k, v, log_f, i_gate, y, dy, chunk=chunk, state=state,
                                   dC=dC, dn=dn)
    if len(saved) != 3:
        raise ValueError("mlstm_chunk_bwd: on the card the backward reads the chunks' states "
                         "and the rows' normalisers that the forward saved; pass saved=")
    if dC is None and dn is not None:  # one part of the final state is used
        dC = dn.new_zeros((*dn.shape, dn.shape[-1]))
    if dn is None and dC is not None:
        dn = dC.new_zeros(dC.shape[:-1])
    grads = _ml.launch_bwd(q, k, v, log_f, i_gate, y, dy, saved, chunk=chunk,
                           dC=None if dC is None else dC.contiguous(),
                           dn=None if dn is None else dn.contiguous(),
                           state_grads=state is not None)
    with _count_lock:
        mlstm_chunk.bwd_launches += 1
    return grads


flash_attention.launches = 0
flash_attention.bwd_launches = 0
decode_attention.launches = 0
mlstm_chunk.launches = 0
mlstm_chunk.bwd_launches = 0
