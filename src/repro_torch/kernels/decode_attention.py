"""Decode attention as a CUDA C++ kernel (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention``: one
query token per sequence against a (B,S,K,hd) KV cache, per-sequence
``kv_len`` (clamped to S, ragged tail masked in the kernel), the G = H/K
query heads of a kv group sharing each K/V tile read. Launch through
``ops.decode_attention``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_G = 16  # query heads per kv head (csrc/decode_attention.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = _build.library("decode_attention").decode_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    return fn


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           kv_len: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd), caches (B,S,K,hd), kv_len (B,) int32, on one CUDA device."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_len", kv_len)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not contiguous and 16-byte aligned")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: q {q.dtype}, caches {k_cache.dtype}/"
                         f"{v_cache.dtype}: need one dtype of {list(DTYPES)}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"decode_attention: kv_len {kv_len.dtype} {tuple(kv_len.shape)}, "
                         f"need int32 ({B},)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in {HEAD_DIMS}")
    if (k_cache.shape != (B, S, K, hd) or v_cache.shape != k_cache.shape
            or K == 0 or H % K or H // K > MAX_G):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}: need "
                         f"(B,S,K,hd), K | H, H/K <= {MAX_G}")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    kv_len.data_ptr(), o.data_ptr(), DTYPES[q.dtype],
                    B, S, H, K, hd, hd ** -0.5, stream)
    _build.check(err, "decode_attention_fwd")
    return o
