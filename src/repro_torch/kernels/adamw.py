"""AdamW as CUDA C++ kernels (``csrc/adamw.cu``).

Replaces no TPU kernel (XLA fuses the JAX package's update): the port's
plain version, ``ref.adamw_update_ref``, is about 25 unfused fp32 passes.
Here a step is the sum of squares of each gradient leaf into its slots of
one scratch buffer (``SLOTS`` blocks a leaf), one finalize block (the
global norm, the clip scale, count + 1, the bias corrections and the
learning rate, all left on the card), then one pass a leaf that reads p, g,
mu and nu and writes new ones. Launch through ``ops.adamw_update``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SLOTS = 4 * 132  # blocks of a leaf's sum of squares: 4 for each of the H100's SMs
N_COEF = 4       # the finalize's coefficients: clip scale, 1 - b1^t, 1 - b2^t, lr

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.cache
def _fns():
    lib = _build.library("adamw")
    sumsq, total, fin, upd = (lib.adamw_sumsq, lib.adamw_leaf_total, lib.adamw_finalize,
                              lib.adamw_update)
    sumsq.argtypes = [_P, _I, _L, _I, _P, _I, _P]
    total.argtypes = [_P, _I, _P, _P]
    fin.argtypes = [_P, _I, _I, _P, _P, _F, _F, _F, _F, _P, _P, _P, _P]
    upd.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _L, _I, _I] + [_F] * 6 + [_P]
    for fn in (sumsq, total, fin, upd):
        fn.restype = _I
    return sumsq, total, fin, upd


def check_leaf(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> None:
    """Raise unless p and g (bf16 or fp32) and the fp32 moments have one shape
    and are contiguous: what the update kernel takes. Reads no memory."""
    if p.dtype not in DTYPES or g.dtype not in DTYPES:
        raise ValueError(f"adamw: parameter {p.dtype}, gradient {g.dtype}: need "
                         f"{list(DTYPES)}")
    if mu.dtype != torch.float32 or nu.dtype != torch.float32:
        raise ValueError(f"adamw: moments {mu.dtype}/{nu.dtype}: need float32")
    if not p.shape == g.shape == mu.shape == nu.shape:
        raise ValueError(f"adamw: parameter {tuple(p.shape)}, gradient {tuple(g.shape)}, "
                         f"moments {tuple(mu.shape)}/{tuple(nu.shape)}: need one shape")
    check_contiguous(p=p, g=g, mu=mu, nu=nu)


def check_contiguous(**named: torch.Tensor) -> None:
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"adamw: {name} is not contiguous")


def check_finalize(partials: torch.Tensor, n_leaves: int, count: torch.Tensor,
                   lr_scale: torch.Tensor | None) -> None:
    """Raise unless ``partials`` is fp32 with a whole number of slots a leaf,
    count a 0-d int32 and ``lr_scale`` (if given) a 0-d fp32 beside them."""
    if (partials.dtype != torch.float32 or partials.ndim != 1 or n_leaves < 1
            or partials.numel() % n_leaves):
        raise ValueError(f"adamw: partials {partials.dtype} {tuple(partials.shape)} for "
                         f"{n_leaves} leaves: need float32 (n_leaves * slots,)")
    if count.dtype != torch.int32 or count.ndim != 0:
        raise ValueError(f"adamw: count {count.dtype} {tuple(count.shape)}: need 0-d int32")
    if lr_scale is not None and (lr_scale.dtype != torch.float32 or lr_scale.ndim != 0):
        raise ValueError(f"adamw: lr_scale {lr_scale.dtype} {tuple(lr_scale.shape)}: need "
                         f"0-d float32")
    check_contiguous(partials=partials)


def _on_device(dev: torch.device, **named: torch.Tensor | None) -> None:
    for name, t in named.items():
        if t is not None and t.device != dev:
            raise ValueError(f"adamw: {name} on {t.device}, need {dev}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_grad(g: torch.Tensor) -> None:
    """Raise unless g is a contiguous bf16 or fp32 gradient."""
    if g.dtype not in DTYPES:
        raise ValueError(f"adamw: gradient {g.dtype}: need {list(DTYPES)}")
    check_contiguous(g=g)


def check_sumsq(g: torch.Tensor, partials: torch.Tensor, slot: int) -> None:
    """Raise unless g is a gradient the kernel takes and the contiguous fp32
    ``partials`` holds the ``SLOTS`` slots of leaf ``slot``."""
    check_grad(g)
    if partials.dtype != torch.float32 or partials.ndim != 1:
        raise ValueError(f"adamw: partials {partials.dtype} {tuple(partials.shape)}: need "
                         f"1-d float32")
    check_contiguous(partials=partials)
    if not 0 <= slot < partials.numel() // SLOTS:
        raise ValueError(f"adamw: slot {slot} outside partials of {partials.numel()}")


def sumsq(g: torch.Tensor, round_bf16: bool, partials: torch.Tensor, slot: int) -> None:
    """Write g's partial sums of squares (each element first rounded to bf16
    with ``round_bf16``) into ``partials[slot * SLOTS:(slot + 1) * SLOTS]``."""
    check_sumsq(g, partials, slot)
    _on_device(g.device, partials=partials)
    with torch.cuda.device(g.device):
        err = _fns()[0](g.data_ptr(), DTYPES[g.dtype], g.numel(), int(round_bf16),
                        partials.data_ptr() + 4 * slot * SLOTS, SLOTS, _stream(g))
    _build.check(err, "adamw_sumsq")


def leaf_sumsq(g: torch.Tensor, round_bf16: bool) -> torch.Tensor:
    """g's sum of squares as a 0-d fp32, summed as ``finalize`` sums a leaf."""
    partials = torch.empty(SLOTS, dtype=torch.float32, device=g.device)
    sumsq(g, round_bf16, partials, 0)
    out = torch.empty((), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = _fns()[1](partials.data_ptr(), SLOTS, out.data_ptr(), _stream(g))
    _build.check(err, "adamw_leaf_total")
    return out


def finalize(partials: torch.Tensor, n_leaves: int, count: torch.Tensor,
             lr_scale: torch.Tensor | None, lr_mul: float, b1: float, b2: float,
             clip_norm: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad norm 0-d fp32, coefficients fp32 (N_COEF,), count + 1 0-d int32)
    from ``n_leaves`` leaves' partials. The learning rate is lr_scale·lr_mul
    with a 0-d ``lr_scale`` on the card, else ``lr_mul`` itself."""
    check_finalize(partials, n_leaves, count, lr_scale)
    _on_device(partials.device, count=count, lr_scale=lr_scale)
    dev = partials.device
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    coef = torch.empty(N_COEF, dtype=torch.float32, device=dev)
    count_out = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _fns()[2](partials.data_ptr(), n_leaves, partials.numel() // n_leaves,
                        count.data_ptr(), None if lr_scale is None else lr_scale.data_ptr(),
                        lr_mul, b1, b2, clip_norm, gnorm.data_ptr(), coef.data_ptr(),
                        count_out.data_ptr(), _stream(partials))
    _build.check(err, "adamw_finalize")
    return gnorm, coef, count_out


def update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
           coef: torch.Tensor, round_bf16: bool, decay: bool, b1: float, b2: float,
           eps: float, weight_decay: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(new p in p's dtype, new mu, new nu) of one leaf, in fresh tensors."""
    check_leaf(p, g, mu, nu)
    _on_device(p.device, g=g, mu=mu, nu=nu, coef=coef)
    if coef.dtype != torch.float32 or coef.shape != (N_COEF,):
        raise ValueError(f"adamw: coef {coef.dtype} {tuple(coef.shape)}: need float32 "
                         f"({N_COEF},)")
    p_out, mu_out, nu_out = torch.empty_like(p), torch.empty_like(mu), torch.empty_like(nu)
    with torch.cuda.device(p.device):
        err = _fns()[3](p.data_ptr(), DTYPES[p.dtype], g.data_ptr(), DTYPES[g.dtype],
                        mu.data_ptr(), nu.data_ptr(), p_out.data_ptr(), mu_out.data_ptr(),
                        nu_out.data_ptr(), coef.data_ptr(), p.numel(), int(round_bf16),
                        int(decay), b1, 1 - b1, b2, 1 - b2, eps, weight_decay, _stream(p))
    _build.check(err, "adamw_update")
    return p_out, mu_out, nu_out
