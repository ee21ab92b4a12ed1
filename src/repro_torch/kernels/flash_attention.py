"""Flash attention forward as a CUDA C++ kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``. Causal
and sliding-window masks, GQA (query head h reads kv head h // (H/K)), a
ragged S masked in the kernel (no padding), fp32 softmax and accumulator,
output in q's dtype. Launch through ``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _P]
    fn.restype = _I
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int | None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,K,hd) on one CUDA device -> (B,S,H,hd)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not contiguous and 16-byte aligned")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {list(DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if k.shape != (B, S, K, hd) or v.shape != k.shape or K == 0 or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k = v = (B,S,K,hd), K | H")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    DTYPES[q.dtype], B, S, H, K, hd, int(causal),
                    -1 if window is None else int(window), hd ** -0.5, stream)
    _build.check(err, "flash_attention_fwd")
    return o
