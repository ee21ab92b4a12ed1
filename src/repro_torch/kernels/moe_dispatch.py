"""The MoE dispatch and combine as CUDA C++ kernels (``csrc/moe_dispatch.cu``).

Replaces no TPU kernel (XLA compiles the JAX package's indexing): the port's
plain versions, ``ref.moe_dispatch_ref`` and ``ref.moe_combine_ref``, are
PyTorch gathers whose autograd backwards sort thousands of duplicate
indices. Here each of the four functions (the dispatch, the combine and
their backwards) is one kernel that writes every output row once. Two maps
drive them: ``row_slot`` (R,) int64, the assignment (token·k + slot) each
expert row holds or -1, and ``slot_row`` (T, k) int64, the row each
assignment went to or -1. The kernels move rows in 16-byte chunks: the
width must be a multiple of 8 and each row array 16-byte aligned (every
configuration's d_model is; a fresh allocation is), or the call raises.
Launch through ``ops.moe_dispatch`` and ``ops.moe_combine``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _fns():
    lib = _build.library("moe_dispatch")
    fwd, bwd, comb, comb_bwd = (lib.moe_dispatch, lib.moe_dispatch_bwd, lib.moe_combine,
                                lib.moe_combine_bwd)
    fwd.argtypes = [_P, _I, _P, _L, _I, _I, _P, _P]
    bwd.argtypes = [_P, _I, _P, _L, _I, _I, _P, _P]
    comb.argtypes = [_P, _I, _P, _P, _L, _I, _I, _P, _P]
    comb_bwd.argtypes = [_P, _I, _P, _P, _P, _P, _L, _L, _I, _I, _P, _P, _P]
    for fn in (fwd, bwd, comb, comb_bwd):
        fn.restype = _I
    return fwd, bwd, comb, comb_bwd


def _check(**named: torch.Tensor) -> None:
    dev = next(iter(named.values())).device
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"moe: {name} is not contiguous")
        if t.device != dev:
            raise ValueError(f"moe: {name} on {t.device}, need {dev}")


def _rows(x: torch.Tensor, name: str) -> None:
    if x.ndim != 2 or x.dtype not in DTYPES:
        raise ValueError(f"moe: {name} {x.dtype} {tuple(x.shape)}: need 2-d {list(DTYPES)}")
    if x.shape[1] % 8:
        raise ValueError(f"moe: {name} {tuple(x.shape)}: the width must be a multiple of 8")


def _aligned(**named: torch.Tensor) -> None:
    """Raise unless each row array starts on 16 bytes (the kernels' chunks)."""
    for name, t in named.items():
        if t.data_ptr() % 16:
            raise ValueError(f"moe: {name} starts at {t.data_ptr():#x}: need 16-byte alignment")


def _ints(t: torch.Tensor, name: str, ndim: int) -> None:
    """Raise unless ``t`` is an int64 map of ``ndim`` dims. Its values are not
    read (that would sync): the caller builds the maps."""
    if t.dtype != torch.int64 or t.ndim != ndim:
        raise ValueError(f"moe: {name} {t.dtype} {tuple(t.shape)}: need {ndim}-d int64")


def check_dispatch(x: torch.Tensor, row_slot: torch.Tensor, k: int) -> None:
    _rows(x, "x")
    _ints(row_slot, "row_slot", 1)
    if k < 1:
        raise ValueError(f"moe: k {k}: need k >= 1")
    _check(x=x, row_slot=row_slot)


def check_dispatch_bwd(dxe: torch.Tensor, slot_row: torch.Tensor) -> None:
    _rows(dxe, "dxe")
    _ints(slot_row, "slot_row", 2)
    _check(dxe=dxe, slot_row=slot_row)


def check_combine(ye: torch.Tensor, w: torch.Tensor, slot_row: torch.Tensor) -> None:
    _rows(ye, "ye")
    _ints(slot_row, "slot_row", 2)
    if w.dtype != torch.float32 or w.shape != slot_row.shape:
        raise ValueError(f"moe: w {w.dtype} {tuple(w.shape)}: need float32 shaped as slot_row "
                         f"{tuple(slot_row.shape)}")
    _check(ye=ye, w=w, slot_row=slot_row)


def check_combine_bwd(ye: torch.Tensor, w: torch.Tensor, dout: torch.Tensor,
                      slot_row: torch.Tensor, row_slot: torch.Tensor) -> None:
    check_combine(ye, w, slot_row)
    _ints(row_slot, "row_slot", 1)
    if row_slot.shape[0] != ye.shape[0]:
        raise ValueError(f"moe: row_slot {tuple(row_slot.shape)} for {ye.shape[0]} rows")
    if dout.dtype != torch.float32 or dout.shape != (slot_row.shape[0], ye.shape[1]):
        raise ValueError(f"moe: dout {dout.dtype} {tuple(dout.shape)}: need float32 "
                         f"({slot_row.shape[0]}, {ye.shape[1]})")
    _check(ye=ye, dout=dout, row_slot=row_slot, slot_row=slot_row)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dispatch(x: torch.Tensor, row_slot: torch.Tensor, k: int) -> torch.Tensor:
    """xe (R, d) in x's type: row r the token of assignment ``row_slot[r]``, zeros where -1."""
    check_dispatch(x, row_slot, k)
    xe = x.new_empty((row_slot.shape[0], x.shape[1]))
    _aligned(x=x)
    with torch.cuda.device(x.device):
        err = _fns()[0](x.data_ptr(), DTYPES[x.dtype], row_slot.data_ptr(), row_slot.shape[0], k,
                        x.shape[1], xe.data_ptr(), _stream(x))
    _build.check(err, "moe_dispatch")
    return xe


def dispatch_bwd(dxe: torch.Tensor, slot_row: torch.Tensor) -> torch.Tensor:
    """dx (T, d) in dxe's type: each token's kept rows of dxe summed in fp32."""
    check_dispatch_bwd(dxe, slot_row)
    T, k = slot_row.shape
    dx = dxe.new_empty((T, dxe.shape[1]))
    _aligned(dxe=dxe)
    with torch.cuda.device(dxe.device):
        err = _fns()[1](dxe.data_ptr(), DTYPES[dxe.dtype], slot_row.data_ptr(), T, k,
                        dxe.shape[1], dx.data_ptr(), _stream(dxe))
    _build.check(err, "moe_dispatch_bwd")
    return dx


def combine(ye: torch.Tensor, w: torch.Tensor, slot_row: torch.Tensor) -> torch.Tensor:
    """out (T, d) fp32: each token's kept rows of ye weighted by w, summed in slot order."""
    check_combine(ye, w, slot_row)
    T, k = slot_row.shape
    out = torch.empty((T, ye.shape[1]), dtype=torch.float32, device=ye.device)
    _aligned(ye=ye)
    with torch.cuda.device(ye.device):
        err = _fns()[2](ye.data_ptr(), DTYPES[ye.dtype], w.data_ptr(), slot_row.data_ptr(), T, k,
                        ye.shape[1], out.data_ptr(), _stream(ye))
    _build.check(err, "moe_combine")
    return out


def combine_bwd(ye: torch.Tensor, w: torch.Tensor, dout: torch.Tensor, slot_row: torch.Tensor,
                row_slot: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dye (R, d) in ye's type, dw (T, k) fp32) of ``combine`` against dout."""
    check_combine_bwd(ye, w, dout, slot_row, row_slot)
    T, k = slot_row.shape
    dye, dw = torch.empty_like(ye), torch.empty_like(w)
    _aligned(ye=ye, dout=dout)
    with torch.cuda.device(ye.device):
        err = _fns()[3](ye.data_ptr(), DTYPES[ye.dtype], w.data_ptr(), dout.data_ptr(),
                        slot_row.data_ptr(), row_slot.data_ptr(), T, ye.shape[0], k, ye.shape[1],
                        dye.data_ptr(), dw.data_ptr(), _stream(ye))
    _build.check(err, "moe_combine_bwd")
    return dye, dw
