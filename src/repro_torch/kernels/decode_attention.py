"""Decode attention as CUDA C++ kernels (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention``: one
query token per sequence against a (B,S,K,hd) KV cache, per-sequence
``kv_len`` (clamped to S, ragged tail masked in the kernel), the G = H/K
query heads of a kv group sharing each K/V tile read. The kv axis is split
into ranges that blocks take in parallel (``split_plan``, from the shapes
alone); with more than one range a second kernel merges their partial
results. Launch through ``ops.decode_attention``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 192)
MAX_G = 16  # query heads per kv head (csrc/decode_attention.cu)
TILE = 64  # keys per tile (csrc/decode_attention.cu, BK)
SPLIT_KEYS = 256  # fewest keys a split is given
TARGET_BLOCKS = 2 * 132  # two blocks for each of the H100's SMs

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fn():
    fn = _build.library("decode_attention").decode_attention_fwd
    fn.argtypes = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


def split_plan(B: int, K: int, S: int) -> tuple[int, int]:
    """(n_split, split_len): the kv axis of S keys cut into n_split ranges
    of split_len keys, whole tiles each, enough for B·K·n_split to reach
    ``TARGET_BLOCKS`` where S allows ranges of ``SPLIT_KEYS`` keys. Depends
    on the shapes only, never on kv_len, so the host does not wait for the
    card; at S <= ``SPLIT_KEYS`` it is one range (no scratch, no merge)."""
    tiles = -(-S // TILE)
    want = -(-TARGET_BLOCKS // (B * K))
    n_split = max(1, min(-(-S // SPLIT_KEYS), want))
    split_len = -(-tiles // n_split) * TILE
    return -(-S // split_len), split_len


def check_args(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               kv_len: torch.Tensor) -> None:
    """Raise unless q (B,H,hd), caches (B,S,K,hd) and kv_len (B,) int32 have
    the shapes, dtypes, head dim and layout (contiguous) the kernels take.
    Reads no memory: a dry run's fake kernel checks the same (``ops``)."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
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
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} is not contiguous")


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           kv_len: torch.Tensor, lse: torch.Tensor | None = None) -> torch.Tensor:
    """q (B,H,hd), caches (B,S,K,hd), kv_len (B,) int32, on one CUDA device.
    With ``lse`` (fp32 (B,H), contiguous) the kernel also writes each row's
    log-sum-exp of its scaled scores there, -inf where no key is visible."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    dev = q.get_device()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_len", kv_len)):
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte aligned")
    check_args(q, k_cache, v_cache, kv_len)
    if lse is not None and (lse.shape != (B, H) or lse.dtype != torch.float32
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"decode_attention: lse {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}: need contiguous float32 ({B}, {H}) on {q.device}")
    n_split, split_len = split_plan(B, K, S)
    o = torch.empty_like(q)
    part = (torch.empty(B * K * n_split * (H // K) * (hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    kv_len.data_ptr(), o.data_ptr(), None if part is None else part.data_ptr(),
                    None if lse is None else lse.data_ptr(), DTYPES[q.dtype], B, S, H, K, hd,
                    n_split, split_len, hd ** -0.5, stream)
    _build.check(err, "decode_attention_fwd")
    return o
