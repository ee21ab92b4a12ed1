"""Chunkwise mLSTM as CUDA C++ kernels (``csrc/mlstm_chunk.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.linear_attention.mlstm_chunk``:
gated linear attention over chunks of at most 64 positions, carrying the
matrix state C (hd, hd) and the normaliser n (hd) in fp32. Unlike the TPU
kernel it takes an initial state, returns the final one and masks a
ragged last chunk itself. fp32 only, as the TPU kernel's signature and the
model's casts (``models/ssm.mlstm``). One call runs two kernels: the
scores of each chunk into a workspace, then the state pass over value
tiles of C; every product is 3xTF32 on the tensor cores. Asked to
``save``, the state pass also writes each chunk's entering state and each
row's normaliser, which the backward (``csrc/mlstm_chunk_bwd.cu``,
``launch_bwd``: five kernels, its products 3xTF32 on the tensor cores as
the forward's) reads. Launch through ``ops.mlstm_chunk``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 512)  # reduced xlstm, the 64-wide check, xlstm-350m
MAX_CHUNK = 64  # positions per chunk (csrc/mlstm_chunk.cu, CM)
P_STRIDE = MAX_CHUNK + 4  # row stride of the scores P in the workspace (csrc, PST)


def record_floats(hd: int) -> int:
    """Workspace floats per (b, h, chunk) (csrc, ``record``): P in 64 rows of
    P_STRIDE, then fcum, W and the row sums of P (64 each), then u = Σ_t k_t W_t."""
    return MAX_CHUNK * P_STRIDE + 3 * MAX_CHUNK + hd

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = _build.library("mlstm_chunk").mlstm_chunk_fwd
    fn.argtypes = [_P] * 14 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _bwd():
    lib = _build.library("mlstm_chunk_bwd")
    fn = lib.mlstm_chunk_bwd
    fn.argtypes = [_P] * 20 + [_I] * 5 + [_P]
    fn.restype = _I
    size = lib.mlstm_chunk_bwd_workspace_floats
    size.argtypes = [_I] * 5
    size.restype = ctypes.c_longlong
    return fn, size


def check_layout(named: list[tuple[str, torch.Tensor]]) -> None:
    """Raise unless every tensor is fp32 and contiguous. Reads no memory: a
    dry run's fake kernels check the same (``ops``)."""
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"mlstm_chunk: {name} is {t.dtype}, need torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"mlstm_chunk: {name} is not contiguous")


def _check(named: list[tuple[str, torch.Tensor]], device: torch.device) -> None:
    """``check_layout``, and all on ``device`` (CUDA) and 16-byte aligned."""
    check_layout(named)
    for name, t in named:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"mlstm_chunk: {name} on {t.device}, q on {device}")
        if t.data_ptr() % 16:
            raise ValueError(f"mlstm_chunk: {name} is not 16-byte aligned")


def check_shapes(q, k, v, log_f, i_gate, chunk, state) -> None:
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"mlstm_chunk: head dim {hd} not in {HEAD_DIMS}")
    if (k.shape != q.shape or v.shape != q.shape or log_f.shape != (B, S, H)
            or i_gate.shape != (B, S, H) or 0 in (B, S, H)):
        raise ValueError(f"mlstm_chunk: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, gates {tuple(log_f.shape)}/"
                         f"{tuple(i_gate.shape)}: need q = k = v = (B,S,H,hd), "
                         f"gates (B,S,H), none empty")
    if state is not None and (state[0].shape != (B, H, hd, hd) or state[1].shape != (B, H, hd)):
        raise ValueError(f"mlstm_chunk: state {tuple(state[0].shape)}/"
                         f"{tuple(state[1].shape)}, need ({B},{H},{hd},{hd})/({B},{H},{hd})")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"mlstm_chunk: chunk {chunk} not in [1, {MAX_CHUNK}]")


def saved_shapes(B: int, S: int, H: int, hd: int, chunk: int) -> tuple[tuple[int, ...], ...]:
    """Shapes of what the forward saves for the backward: each chunk's
    entering C (B,H,n_chunks,hd,hd) and n (B,H,n_chunks,hd), and each row's
    normaliser (B,S,H)."""
    n_chunks = -(-S // chunk)
    return (B, H, n_chunks, hd, hd), (B, H, n_chunks, hd), (B, S, H)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
           i_gate: torch.Tensor, *, chunk: int,
           state: tuple[torch.Tensor, torch.Tensor] | None, save: bool = False):
    """q/k/v (B,S,H,hd), gates (B,S,H), state (C (B,H,hd,hd), n (B,H,hd)) or
    None, all fp32 on one CUDA device -> (y (B,S,H,hd), (C, n)), and with
    ``save`` a third item: the tensors of ``saved_shapes`` for ``launch_bwd``.
    Without ``save`` nothing more is allocated or written."""
    B, S, H, hd = q.shape
    named = [("q", q), ("k", k), ("v", v), ("log_f", log_f), ("i_gate", i_gate)]
    if state is not None:
        named += [("C", state[0]), ("n", state[1])]
    _check(named, q.device)
    check_shapes(q, k, v, log_f, i_gate, chunk, state)
    y = torch.empty_like(q)
    C = torch.empty((B, H, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    n_chunks = -(-S // chunk)
    ws = torch.empty(B * H * n_chunks * record_floats(hd), dtype=torch.float32, device=q.device)
    C0, n0 = (None, None) if state is None else (state[0].data_ptr(), state[1].data_ptr())
    saved = tuple(torch.empty(shape, dtype=torch.float32, device=q.device)
                  for shape in saved_shapes(B, S, H, hd, chunk)) if save else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                    i_gate.data_ptr(), C0, n0, y.data_ptr(), C.data_ptr(), n.data_ptr(),
                    ws.data_ptr(), *((t.data_ptr() for t in saved) if save else (None,) * 3),
                    B, S, H, hd, chunk, stream)
    _build.check(err, "mlstm_chunk_fwd")
    return (y, (C, n), saved) if save else (y, (C, n))


def check_bwd_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                   i_gate: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                   saved: tuple[torch.Tensor, ...], *, chunk: int,
                   dC: torch.Tensor | None, dn: torch.Tensor | None
                   ) -> list[tuple[str, torch.Tensor]]:
    """Raise unless ``launch_bwd``'s arguments have the shapes and dtypes it
    takes (``check_layout``, ``check_shapes``); returns them named. Reads no memory: a dry run's fake kernel
    checks the same (``ops``)."""
    B, S, H, hd = q.shape
    named = [("q", q), ("k", k), ("v", v), ("log_f", log_f), ("i_gate", i_gate), ("y", y),
             ("dy", dy), ("C_states", saved[0]), ("n_states", saved[1]), ("nrm", saved[2])]
    if (dC is None) != (dn is None):
        raise ValueError("mlstm_chunk_bwd: pass both final-state gradients or neither")
    if dC is not None:
        named += [("dC", dC), ("dn", dn)]
    check_layout(named)
    check_shapes(q, k, v, log_f, i_gate, chunk, None)
    want = ((q.shape,) * 2 + saved_shapes(B, S, H, hd, chunk)
            + (((B, H, hd, hd), (B, H, hd)) if dC is not None else ()))
    for (name, t), shape in zip(named[5:], want, strict=True):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"mlstm_chunk_bwd: {name} {tuple(t.shape)}, need {tuple(shape)}")
    return named


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
               i_gate: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
               saved: tuple[torch.Tensor, torch.Tensor, torch.Tensor], *, chunk: int,
               dC: torch.Tensor | None, dn: torch.Tensor | None, state_grads: bool):
    """(dq, dk, dv, dlog_f, di, dC0, dn0) of ``launch`` at these inputs, whose
    output was ``y`` and which saved ``saved``, against the output's gradient
    ``dy`` and the final state's (``dC``, ``dn``; None: zeros). dC0 and dn0
    are None unless ``state_grads``. All fp32 on one CUDA device."""
    B, S, H, hd = q.shape
    named = check_bwd_args(q, k, v, log_f, i_gate, y, dy, saved, chunk=chunk, dC=dC, dn=dn)
    _check(named, q.device)
    fn, size = _bwd()
    ws = torch.empty(size(B, S, H, hd, chunk), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dlf, di = (torch.empty_like(log_f) for _ in range(2))
    dC0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=q.device) if state_grads else None
    dn0 = torch.empty((B, H, hd), dtype=torch.float32, device=q.device) if state_grads else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(ptr(t) for t in (q, k, v, log_f, i_gate, y, dy, *saved, dC, dn, dq, dk, dv,
                                    dlf, di, dC0, dn0, ws)),
                 B, S, H, hd, chunk, stream)
    _build.check(err, "mlstm_chunk_bwd")
    return dq, dk, dv, dlf, di, dC0, dn0
