"""Flash attention forward and backward as CUDA C++ kernels.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``. Causal
and sliding-window masks, GQA (query head h reads kv head h // (H/K)), a
ragged length masked in the kernel (no padding), fp32 softmax and
accumulator, output in q's dtype, head dims 16, 32, 64, 128 and 192. The
forward and the backward also take queries and keys of different lengths,
Sq != Skv (cross-attention), without a mask. The dtype and head dim alone
choose the kernels (``route``), both routes on the tensor cores:

- ``"wgmma"``: bf16 at hd 64, 128 or 192, the forward in
  ``csrc/flash_attention_wgmma.cu``, the backward in
  ``csrc/flash_attention_bwd_wgmma.cu`` (wgmma, TMA loads, a
  warp-specialised pipeline);
- ``"3xtf32"``: everything else (f32 at every head dim, bf16 at hd 16 and
  32), ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
  (mma.sync in TF32 at fp32 accuracy: each product as three TF32
  products, fed by cp.async).

``launch`` writes each row's log-sum-exp when given a buffer for it;
``launch_bwd`` needs it. On the ``"3xtf32"`` route a short Sq without a
mask (a few queries against many keys, as whisper's cross-attention from
its decoder) splits the kv axis over more blocks (``split_plan``, from the
shapes alone) and merges their partial results in a second kernel. Launch
through ``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 192)
WGMMA_HEAD_DIMS = (64, 128, 192)  # bf16 head dims of the tensor-core kernels
SPLIT_KEYS = 256  # the 3xTF32 forward's kv split: at most one range per SPLIT_KEYS keys
TARGET_BLOCKS = 2 * 132  # two blocks for each of the H100's SMs

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = [_P] * 6 + [_I] * 11 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


@functools.cache
def _wgmma_fn():
    fn = _build.library("flash_attention_wgmma").flash_attention_wgmma_fwd
    fn.argtypes = [_P] * 5 + [_I] * 8 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.library("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = [_P] * 10 + [_I] * 9 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


@functools.cache
def _bwd_wgmma_fn():
    fn = _build.library("flash_attention_bwd_wgmma").flash_attention_bwd_wgmma
    fn.argtypes = [_P] * 10 + [_I] * 8 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


def route(dtype: torch.dtype, hd: int) -> str:
    """Which kernels ``launch`` and ``launch_bwd`` run for this dtype and
    head dim: ``"wgmma"`` (bf16 at hd 64, 128, 192) or ``"3xtf32"``."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "3xtf32"


def split_plan(B: int, Sq: int, Skv: int, H: int, hd: int, masked: bool) -> tuple[int, int]:
    """(n_split, split_len) of the 3xTF32 forward: the kv axis of Skv keys in
    n_split ranges of split_len keys, whole kv tiles each, where the q tiles
    (``csrc/flash_attention.cu`` ``Tiles``: 64 rows, 128 at hd 192) give
    fewer than ``TARGET_BLOCKS`` blocks and no mask is asked for: enough
    ranges to reach it, at most one per ``SPLIT_KEYS`` keys. Else one
    range."""
    q_rows, tile = (128 if hd > 128 else 64), (32 if hd >= 128 else 64)
    blocks = -(-Sq // q_rows) * B * H
    want = -(-TARGET_BLOCKS // blocks)
    n_split = 1 if masked else max(1, min(-(-Skv // SPLIT_KEYS), want))
    split_len = -(-(-(-Skv // tile)) // n_split) * tile
    return -(-Skv // split_len), split_len


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
               window: int | None, **more: torch.Tensor) -> None:
    """Raise unless q (B,Sq,H,hd), k/v (B,Skv,K,hd) and ``more`` (each shaped
    like q) have the shapes, dtype, head dim, layout and mask the kernels
    take: one dtype, contiguous, no causal or window mask where Sq != Skv
    (the reference masks only self-attention). Reads no memory: a dry run's
    fake kernels check the same (``ops``)."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v), *more.items()):
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {list(DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if k.shape != (B, Skv, K, hd) or v.shape != k.shape or Skv == 0 or K == 0 or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k = v = (B,Skv,K,hd), K | H")
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} != q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if Sq != Skv and (causal or window is not None):
        raise ValueError(f"flash_attention: Sq {Sq} != Skv {Skv} takes no mask "
                         f"(causal={causal}, window={window})")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int | None, **more: torch.Tensor) -> None:
    """``check_args``, and all on q's CUDA device and 16-byte aligned."""
    check_args(q, k, v, causal, window, **more)
    dev = q.get_device()
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")


def _check_lse(q: torch.Tensor, lse: torch.Tensor) -> None:
    B, S, H, _ = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (B, H, S) or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}: need contiguous float32 ({B}, {H}, {S}) on {q.device}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int | None,
           lse: torch.Tensor | None = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,K,hd) on one CUDA device -> (B,Sq,H,hd);
    Sq != Skv without a mask. With ``lse`` (fp32 (B,H,Sq)) the kernel also
    writes each row's log-sum-exp ln Σ exp(q·k·hd^-½) over its visible keys
    into it, for ``launch_bwd``."""
    _check(q, k, v, causal, window)
    if lse is not None:
        _check_lse(q, lse)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    win = -1 if window is None else int(window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route(q.dtype, hd) == "wgmma":
            err = _wgmma_fn()(*ptrs, B, Sq, Skv, H, K, hd, int(causal), win, hd ** -0.5,
                              stream)
        else:
            n_split, split_len = split_plan(B, Sq, Skv, H, hd, causal or window is not None)
            part = (torch.empty(n_split * B * H * Sq * (hd + 1), dtype=torch.float32,
                                device=q.device) if n_split > 1 else None)
            err = _fn()(*ptrs, None if part is None else part.data_ptr(), DTYPES[q.dtype], B,
                        Sq, Skv, H, K, hd, int(causal), win, n_split, split_len, hd ** -0.5,
                        stream)
    _build.check(err, "flash_attention_fwd")
    return o


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
               do: torch.Tensor, lse: torch.Tensor, *, causal: bool, window: int | None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``launch``'s output: q, o (its output), do (the output's
    gradient) (B,Sq,H,hd), k/v (B,Skv,K,hd), lse (fp32 (B,H,Sq), as
    ``launch`` wrote it), on one CUDA device -> (dq, dk, dv) in the inputs'
    dtype; Sq != Skv without a mask, as in ``launch``.

    ``route`` ``"wgmma"``: three kernels on one stream, D = Σ do·o per row
    into fp32 scratch, then dq, then dk and dv. ``"3xtf32"``: two kernels,
    D, then one launch of dk/dv blocks and dq blocks. Neither uses atomics:
    the same inputs give the same bits."""
    _check(q, k, v, causal, window, o=o, do=do)
    _check_lse(q, lse)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    win = -1 if window is None else int(window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route(q.dtype, hd) == "wgmma":
            err = _bwd_wgmma_fn()(*ptrs, B, Sq, Skv, H, K, hd, int(causal), win, hd ** -0.5,
                                  stream)
        else:
            err = _bwd_fn()(*ptrs, DTYPES[q.dtype], B, Sq, Skv, H, K, hd, int(causal), win,
                            hd ** -0.5, stream)
    _build.check(err, "flash_attention_bwd")
    return dq, dk, dv
