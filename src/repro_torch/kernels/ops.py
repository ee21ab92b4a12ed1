"""Public wrappers of the kernels, named as in ``repro.kernels.ops``.

The device of the input decides what runs: a CPU tensor goes to the plain
PyTorch version in ``ref``; a CUDA tensor launches the hand-written CUDA
kernel, or raises (no fallback). Each wrapper counts its kernel launches in
a plain integer attribute, ``<wrapper>.launches``, so a run can show that
its path went through the kernel.

Each of the kernel entry points (flash forward with its log-sum-exp,
flash backward, decode, ``mlstm_chunk`` forward with its saved states, its
backward, AdamW's sum of squares, per-shard sum, finalize and update, and
the MoE dispatch and combine with their backwards) is a ``torch.library``
custom op, ``torch.ops.repro_torch.*``.
On real CUDA tensors the op launches the kernel and counts the launch. On
a ``FakeTensor`` (``FakeTensorMode``) or a meta tensor it runs the op's
fake implementation instead: the kernel's argument checks, then outputs
with the shapes, dtypes and strides the kernel allocates, computing
nothing and counting nothing. That is how a dry run
(``launch/dryrun.py``) traces the card's route without a card. Each attention
and mLSTM op also has a FLOP formula (``torch.utils.flop_counter``), the
operations the kernel check (``chip_smoke.py``) counts for the kernel's
bound (``tests/test_torch_cuda.py`` holds them equal), so
``FlopCounterMode`` counts the kernels on the card and in a trace alike;
AdamW's and the MoE ops are bound by bytes and count none, as their plain
versions' elementwise ops and gathers count none.

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
Under ``torch.no_grad()`` the kernel saves nothing. ``moe_dispatch`` and
``moe_combine`` on the card likewise apply autograd Functions whose
backwards are kernels (counted in ``moe_dispatch.bwd_launches`` and
``moe_combine.bwd_launches``); on the CPU they are their plain versions,
differentiated by autograd. ``decode_attention`` has no backward: on the
card it raises under grad rather than return a tensor that silently
carries no gradient; with ``with_lse`` it also returns each row's
log-sum-exp (-inf for a row that sees no key).

On DTensors (a sharded step: the dry run's trace on a production mesh, or a
real run over a process group) each entry states its placements once, at
the function here, and runs itself on each device's shards through
``runtime.sharding.run_local`` (the port's ``local_map``): flash over the
batch and the query heads, with the kv heads those heads read (sliced by
the device's coordinate where the kv heads do not divide the axis); decode
over the batch and either the heads or, where the cache's sequence is
sharded, a range of the cache whose partial results merge by their
log-sum-exp; ``mlstm_chunk`` over the batch and the heads. The local call
takes the route its shards' device picks, so a real CPU run and a trace
shard alike. ``adamw_update`` sums each gradient's squares on its shards
into a Partial scalar, adds them and reduces them as the plain version's
DTensor norm does, then finalizes and updates each leaf on its shards.
``register_sharding`` on the custom ops was not taken: the
plain route never reaches them and would need the same rule again, and a
sharding rule cannot slice kv heads by a device's coordinate.
"""
from __future__ import annotations

import threading

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import adamw as _aw
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm_chunk as _ml
from repro_torch.kernels import moe_dispatch as _md
from repro_torch.kernels.ref import (
    adamw_update_ref,
    decode_attention_ref,
    flash_attention_bwd_ref,
    flash_attention_ref,
    mlstm_chunk_bwd_ref,
    mlstm_chunk_ref,
    moe_combine_ref,
    moe_dispatch_ref,
)
from repro_torch.runtime import sharding as sh
from repro_torch.tree import leaves, unflatten

_count_lock = threading.Lock()  # engine tasks may call from several threads


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version); False for CUDA tensors, real
    or fake, and for meta tensors (a dry run's trace): the kernel's op."""
    if all(t.is_cuda for t in ts):  # the card's path: the cheapest test first
        return False
    devices = {t.device.type for t in ts}
    if devices == {"cpu"}:
        return True
    if devices == {"meta"}:
        return False
    raise ValueError(f"tensors on {sorted(devices)}: need all on cpu, all on cuda or all "
                     f"on meta")


def _count(wrapper, name: str = "launches") -> None:
    with _count_lock:
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def _op(name: str) -> str:
    """A kernel op's qualified name: ``torch.ops.repro_torch.<name>``."""
    return f"repro_torch::{name}"  # lint: allow(REPRO020) torch.library's separator, no KV key


# ---------------------------------------------------------------------------
# The kernels as custom ops: launch on real CUDA tensors, shapes only on fake ones.
# An output asked for only sometimes is a list, empty when it is not: 0-element
# tensors would share no storage and count as aliases of each other.
# ---------------------------------------------------------------------------

@torch.library.custom_op(_op("flash_attention_fwd"), mutates_args=())
def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int | None,
               with_lse: bool) -> tuple[Tensor, list[Tensor]]:
    """(out (B,Sq,H,hd), [lse fp32 (B,H,Sq)] if ``with_lse`` else [])."""
    lse = _lse_like(q) if with_lse else None
    out = _fa.launch(q, k, v, causal=causal, window=window, lse=lse)
    _count(flash_attention)
    return out, [] if lse is None else [lse]


@_flash_fwd.register_fake
def _(q, k, v, causal, window, with_lse):
    _fa.check_args(q, k, v, causal, window)
    return torch.empty_like(q), [_lse_like(q)] if with_lse else []


def _lse_like(q: Tensor) -> Tensor:
    B, S, H, _ = q.shape
    return torch.empty((B, H, S), dtype=torch.float32, device=q.device)


@torch.library.custom_op(_op("flash_attention_bwd"), mutates_args=())
def _flash_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, dout: Tensor, lse: Tensor,
               causal: bool, window: int | None) -> tuple[Tensor, Tensor, Tensor]:
    grads = _fa.launch_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
    _count(flash_attention, "bwd_launches")
    return grads


@_flash_bwd.register_fake
def _(q, k, v, out, dout, lse, causal, window):
    _fa.check_args(q, k, v, causal, window, o=out, do=dout)
    _fa._check_lse(q, lse)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op(_op("decode_attention"), mutates_args=())
def _decode(q: Tensor, k_cache: Tensor, v_cache: Tensor, kv_len: Tensor,
            with_lse: bool) -> tuple[Tensor, list[Tensor]]:
    """(out (B,H,hd), [lse fp32 (B,H)] if ``with_lse`` else [])."""
    lse = q.new_empty(q.shape[:2], dtype=torch.float32) if with_lse else None
    out = _dec.launch(q, k_cache, v_cache, kv_len, lse=lse)
    _count(decode_attention)
    return out, [] if lse is None else [lse]


@_decode.register_fake
def _(q, k_cache, v_cache, kv_len, with_lse):
    _dec.check_args(q, k_cache, v_cache, kv_len)
    return torch.empty_like(q), [q.new_empty(q.shape[:2], dtype=torch.float32)] if with_lse else []


@torch.library.custom_op(_op("mlstm_chunk_fwd"), mutates_args=())
def _mlstm_fwd(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor, i_gate: Tensor,
               C0: Tensor | None, n0: Tensor | None, chunk: int, save: bool
               ) -> tuple[Tensor, Tensor, Tensor, list[Tensor]]:
    """(y, C, n, [C_states, n_states, nrm] if ``save`` else [])."""
    state = None if C0 is None else (C0, n0)
    if save:
        y, (C, n), saved = _ml.launch(q, k, v, log_f, i_gate, chunk=chunk, state=state,
                                      save=True)
    else:
        (y, (C, n)), saved = _ml.launch(q, k, v, log_f, i_gate, chunk=chunk, state=state), ()
    _count(mlstm_chunk)
    return y, C, n, list(saved)


@_mlstm_fwd.register_fake
def _(q, k, v, log_f, i_gate, C0, n0, chunk, save):
    state = None if C0 is None else (C0, n0)
    named = [("q", q), ("k", k), ("v", v), ("log_f", log_f), ("i_gate", i_gate)]
    _ml.check_layout(named + ([] if state is None else [("C", C0), ("n", n0)]))
    _ml.check_shapes(q, k, v, log_f, i_gate, chunk, state)
    B, S, H, hd = q.shape
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=q.device)  # noqa: E731
    saved = [new(*shape) for shape in _ml.saved_shapes(B, S, H, hd, chunk)] if save else []
    return torch.empty_like(q), new(B, H, hd, hd), new(B, H, hd), saved


@torch.library.custom_op(_op("mlstm_chunk_bwd"), mutates_args=())
def _mlstm_bwd(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor, i_gate: Tensor, y: Tensor,
               dy: Tensor, C_states: Tensor, n_states: Tensor, nrm: Tensor,
               dC: Tensor | None, dn: Tensor | None, chunk: int, state_grads: bool
               ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, list[Tensor]]:
    """(dq, dk, dv, dlog_f, di, [dC0, dn0] if ``state_grads`` else [])."""
    grads = _ml.launch_bwd(q, k, v, log_f, i_gate, y, dy, (C_states, n_states, nrm),
                           chunk=chunk, dC=dC, dn=dn, state_grads=state_grads)
    _count(mlstm_chunk, "bwd_launches")
    return (*grads[:5], list(grads[5:]) if state_grads else [])


@_mlstm_bwd.register_fake
def _(q, k, v, log_f, i_gate, y, dy, C_states, n_states, nrm, dC, dn, chunk, state_grads):
    _ml.check_bwd_args(q, k, v, log_f, i_gate, y, dy, (C_states, n_states, nrm), chunk=chunk,
                       dC=dC, dn=dn)
    B, _, H, hd = q.shape
    state = [q.new_empty((B, H, hd, hd)), q.new_empty((B, H, hd))] if state_grads else []
    return (*(torch.empty_like(t) for t in (q, k, v, log_f, i_gate)), state)


@torch.library.custom_op(_op("adamw_sumsq"), mutates_args=("partials",))
def _adamw_sumsq(g: Tensor, round_bf16: bool, partials: Tensor, slot: int) -> None:
    """g's partial sums of squares into leaf ``slot``'s slots of ``partials``."""
    _aw.sumsq(g, round_bf16, partials, slot)
    _count(adamw_update)


@_adamw_sumsq.register_fake
def _(g, round_bf16, partials, slot):
    _aw.check_sumsq(g, partials, slot)


@torch.library.custom_op(_op("adamw_leaf_sumsq"), mutates_args=())
def _adamw_leaf_sumsq(g: Tensor, round_bf16: bool) -> Tensor:
    """g's sum of squares, 0-d fp32: the sum kernel and a leaf's total."""
    out = _aw.leaf_sumsq(g, round_bf16)
    _count(adamw_update)
    return out


@_adamw_leaf_sumsq.register_fake
def _(g, round_bf16):
    _aw.check_grad(g)
    return g.new_empty((), dtype=torch.float32)


@torch.library.custom_op(_op("adamw_finalize"), mutates_args=())
def _adamw_finalize(partials: Tensor, n_leaves: int, count: Tensor, lr_scale: Tensor | None,
                    lr_mul: float, b1: float, b2: float, clip_norm: float
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """(grad norm, coefficients (clip scale, 1 - b1^t, 1 - b2^t, lr), count + 1)."""
    out = _aw.finalize(partials, n_leaves, count, lr_scale, lr_mul, b1, b2, clip_norm)
    _count(adamw_update)
    return out


@_adamw_finalize.register_fake
def _(partials, n_leaves, count, lr_scale, lr_mul, b1, b2, clip_norm):
    _aw.check_finalize(partials, n_leaves, count, lr_scale)
    new = lambda *shape: partials.new_empty(shape)  # noqa: E731
    return new(), new(_aw.N_COEF), count.new_empty(())


@torch.library.custom_op(_op("adamw_update"), mutates_args=())
def _adamw_update(p: Tensor, g: Tensor, mu: Tensor, nu: Tensor, coef: Tensor, round_bf16: bool,
                  decay: bool, b1: float, b2: float, eps: float, weight_decay: float
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """(new p, new mu, new nu) of one leaf."""
    out = _aw.update(p, g, mu, nu, coef, round_bf16, decay, b1, b2, eps, weight_decay)
    _count(adamw_update)
    return out


@_adamw_update.register_fake
def _(p, g, mu, nu, coef, round_bf16, decay, b1, b2, eps, weight_decay):
    _aw.check_leaf(p, g, mu, nu)
    return torch.empty_like(p), torch.empty_like(mu), torch.empty_like(nu)


@torch.library.custom_op(_op("moe_dispatch"), mutates_args=())
def _moe_dispatch(x: Tensor, row_slot: Tensor, k: int) -> Tensor:
    """xe (R, d): the token of each expert row's assignment, zeros where empty."""
    out = _md.dispatch(x, row_slot, k)
    _count(moe_dispatch)
    return out


@_moe_dispatch.register_fake
def _(x, row_slot, k):
    _md.check_dispatch(x, row_slot, k)
    return x.new_empty((row_slot.shape[0], x.shape[1]))


@torch.library.custom_op(_op("moe_dispatch_bwd"), mutates_args=())
def _moe_dispatch_bwd(dxe: Tensor, slot_row: Tensor) -> Tensor:
    """dx (T, d): each token's kept rows of dxe, summed."""
    out = _md.dispatch_bwd(dxe, slot_row)
    _count(moe_dispatch, "bwd_launches")
    return out


@_moe_dispatch_bwd.register_fake
def _(dxe, slot_row):
    _md.check_dispatch_bwd(dxe, slot_row)
    return dxe.new_empty((slot_row.shape[0], dxe.shape[1]))


@torch.library.custom_op(_op("moe_combine"), mutates_args=())
def _moe_combine(ye: Tensor, w: Tensor, slot_row: Tensor) -> Tensor:
    """out (T, d) fp32: each token's kept rows weighted and summed."""
    out = _md.combine(ye, w, slot_row)
    _count(moe_combine)
    return out


@_moe_combine.register_fake
def _(ye, w, slot_row):
    _md.check_combine(ye, w, slot_row)
    return ye.new_empty((slot_row.shape[0], ye.shape[1]), dtype=torch.float32)


@torch.library.custom_op(_op("moe_combine_bwd"), mutates_args=())
def _moe_combine_bwd(ye: Tensor, w: Tensor, dout: Tensor, slot_row: Tensor,
                     row_slot: Tensor) -> tuple[Tensor, Tensor]:
    """(dye (R, d), dw (T, k) fp32)."""
    out = _md.combine_bwd(ye, w, dout, slot_row, row_slot)
    _count(moe_combine, "bwd_launches")
    return out


@_moe_combine_bwd.register_fake
def _(ye, w, dout, slot_row, row_slot):
    _md.check_combine_bwd(ye, w, dout, slot_row, row_slot)
    return torch.empty_like(ye), torch.empty_like(w)


# ---------------------------------------------------------------------------
# FLOP formulas: the operations the kernel check (chip_smoke.py) counts for
# each kernel's bound
# ---------------------------------------------------------------------------

def attention_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs attention sees: ``ref._visible``'s count."""
    if not causal and window is None:
        return Sq * Skv
    S = Sq  # a mask needs Sq == Skv
    if causal:
        w = S if window is None else min(window, S)
        return w * (w + 1) // 2 + (S - w) * w
    w = min(window, S)  # keys after the query, and w - 1 before it
    return S * S - (S - w) * (S - w + 1) // 2


def mlstm_pairs(S: int, chunk: int) -> int:
    """The causal (t <= s) pairs within each chunk, the last one ragged."""
    rest = S % chunk
    return (S // chunk) * chunk * (chunk + 1) // 2 + rest * (rest + 1) // 2


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_fwd_flops(q, k, v, causal, window, with_lse, *, out_shape=None, **kw) -> int:
    B, Sq, H, hd = q
    return 4 * B * H * hd * attention_pairs(Sq, k[1], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q, k, v, out, dout, lse, causal, window, *, out_shape=None, **kw) -> int:
    B, Sq, H, hd = q
    return 10 * B * H * hd * attention_pairs(Sq, k[1], causal, window)


def decode_keys(kv_len: Tensor, S: int) -> int:
    """The cache keys a decode call reads: Σ_b min(kv_len_b, S). The values of
    a fake or meta ``kv_len`` are unknown, and every slot counts: a dry run's
    decode cells fill their caches (``pos = seq_len - 1``)."""
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(kv_len, FakeTensor) or kv_len.is_meta:
        return kv_len.shape[0] * S
    return int(kv_len.clamp(0, S).sum().item())


@register_flop_formula(torch.ops.repro_torch.decode_attention, get_raw=True)
def _decode_flops(q, k_cache, v_cache, kv_len, with_lse=False, *, out_val=None, **kw) -> int:
    _, H, hd = q.shape
    return 4 * H * hd * decode_keys(kv_len, k_cache.shape[1])


@register_flop_formula(torch.ops.repro_torch.mlstm_chunk_fwd)
def _mlstm_fwd_flops(q, k, v, log_f, i_gate, C0, n0, chunk, save, *, out_shape=None,
                     **kw) -> int:
    B, S, H, hd = q
    return B * H * (4 * hd * mlstm_pairs(S, chunk) + 4 * hd * hd * S)


@register_flop_formula(torch.ops.repro_torch.mlstm_chunk_bwd)
def _mlstm_bwd_flops(q, *rest, out_shape=None, **kw) -> int:
    B, S, H, hd = q
    chunk = rest[-2]
    return B * H * (10 * hd * mlstm_pairs(S, chunk) + 8 * hd * hd * S
                    + 2 * hd * hd * -(-S // chunk))


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_backward(name: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} has no backward kernel, so on the card its output would carry "
        f"no gradient; call it under torch.no_grad() ({why})")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, recording):
        lse = None
        if _on_cpu(q, k, v):
            out = flash_attention_ref(q, k, v, causal=causal, window=window)
        else:  # recording: the backward kernels read each row's log-sum-exp
            out, lse = _flash_fwd(q, k, v, causal, window, recording)
            lse = lse[0] if lse else None
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
    if sh.is_dtensor(q):
        return _flash_sharded(q, k, v, causal, window)
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
    return _flash_bwd(q, k, v, out, dout, lse, causal, window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: torch.Tensor, *, with_lse: bool = False):
    """q (B,H,hd), caches (B,S,K,hd), kv_len (B,) int32 -> (B,H,hd) in q.dtype;
    with ``with_lse`` also each row's log-sum-exp of its scaled scores, fp32
    (B,H), -inf where no key is visible (kv_len 0). DTensor arguments run on
    each device's shards (``_decode_sharded``)."""
    if sh.is_dtensor(q):
        return _decode_sharded(q, k_cache, v_cache, kv_len, with_lse)
    if _on_cpu(q, k_cache, v_cache, kv_len):
        if with_lse:
            return decode_attention_ref(q, k_cache, v_cache, kv_len, with_lse=True)
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    if _needs_grad(q, k_cache, v_cache):
        raise _no_backward("decode_attention", "it serves decoding only; training runs "
                           "flash_attention, whose backward is a kernel")
    out, lse = _decode(q, k_cache, v_cache, kv_len, with_lse)
    return (out, lse[0]) if with_lse else out


class _MlstmChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, log_f, i_gate, C0, n0, chunk, recording):
        ctx.set_materialize_grads(False)  # an unused final state's gradient stays None
        state = None if C0 is None else (C0, n0)
        saved = ()
        if _on_cpu(q, k, v, log_f, i_gate, *(state or ())):
            y, (C, n) = mlstm_chunk_ref(q, k, v, log_f, i_gate, chunk=chunk, state=state)
        else:  # recording: the backward kernel reads the chunks' states and the normalisers
            y, C, n, saved = _mlstm_fwd(q, k, v, log_f, i_gate, C0, n0, chunk, recording)
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
    if sh.is_dtensor(q):
        return _mlstm_sharded(q, k, v, log_f, i_gate, chunk, state)
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
    grads = _mlstm_bwd(q, k, v, log_f, i_gate, y, dy, *saved,
                       None if dC is None else dC.contiguous(),
                       None if dn is None else dn.contiguous(), chunk, state is not None)
    return (*grads[:5], *(grads[5] or (None, None)))


def adamw_update(grads, state: dict, params, cfg, lr_scale: Tensor | float = 1.0):
    """(new params, {"mu", "nu", "count"}, {"grad_norm"}): the AdamW step of
    ``optim.adamw.adamw_update`` (``cfg`` an ``AdamWConfig``). CPU leaves take
    ``adamw_update_ref``; any other tree the kernels, in new tensors: each
    gradient's sum of squares into one scratch buffer, one finalize and one
    update a leaf (a leaf that is not contiguous is copied first: the
    kernels read memory in order). On DTensors ``_adamw_sharded``. Counts
    its ops' calls in ``adamw_update.launches``: 2 a leaf and 1 a step."""
    ps, gs = leaves(params), leaves(grads)
    ms, vs, count = leaves(state["mu"]), leaves(state["nu"]), state["count"]
    if _on_cpu(*ps, *gs, *ms, *vs, count):
        return adamw_update_ref(grads, state, params, cfg, lr_scale)
    route = _adamw_sharded if sh.is_dtensor(ps[0]) else _adamw_fused
    new_p, mu, nu, count, gnorm = route(ps, gs, ms, vs, count, lr_scale, cfg)
    return (unflatten(params, new_p),
            {"mu": unflatten(state["mu"], mu), "nu": unflatten(state["nu"], nu), "count": count},
            {"grad_norm": gnorm})


class _MoeDispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row_slot, slot_row):
        ctx.save_for_backward(slot_row)
        return _moe_dispatch(x, row_slot, slot_row.shape[1])

    @staticmethod
    def backward(ctx, dxe):
        (slot_row,) = ctx.saved_tensors
        return _moe_dispatch_bwd(dxe.contiguous(), slot_row), None, None


def moe_fused(*ts: Tensor) -> bool:
    """True where ``moe_dispatch`` and ``moe_combine`` launch the kernels on
    ``ts`` (CUDA tensors, or meta ones in a dry run's trace), False where they
    take the plain versions (CPU tensors)."""
    return not _on_cpu(*ts)


def moe_dispatch(x: Tensor, row_slot: Tensor, slot_row: Tensor) -> Tensor:
    """x (T, d) -> the expert rows (R, d) in x.dtype: row r the token of
    assignment ``row_slot[r]`` (token·k + slot; int64 (R,)), zeros where it
    is -1. ``slot_row`` (int64 (T, k)) is its transpose, the row of each
    assignment or -1: each kept assignment owns one row and each row holds
    at most one. Differentiable in x: each token's gradient is the sum of
    its kept rows' in fp32, in slot order. CPU tensors take
    ``moe_dispatch_ref``."""
    if not moe_fused(x, row_slot, slot_row):
        return moe_dispatch_ref(x, row_slot, slot_row.shape[1])
    return _MoeDispatch.apply(x.contiguous(), row_slot.contiguous(), slot_row.contiguous())


class _MoeCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ye, w, row_slot, slot_row):
        ctx.save_for_backward(ye, w, row_slot, slot_row)
        return _moe_combine(ye, w, slot_row)

    @staticmethod
    def backward(ctx, dout):
        ye, w, row_slot, slot_row = ctx.saved_tensors
        dye, dw = _moe_combine_bwd(ye, w, dout.contiguous(), slot_row, row_slot)
        return dye, dw, None, None


def moe_combine(ye: Tensor, w: Tensor, row_slot: Tensor, slot_row: Tensor) -> Tensor:
    """ye (R, d), w (T, k) fp32 -> (T, d) fp32: each token's kept rows
    ``ye[slot_row[t, j]]`` times ``w[t, j]``, added in slot order in fp32;
    the maps as ``moe_dispatch``'s, w 0 where an assignment was dropped.
    Differentiable in ye and w. CPU tensors take ``moe_combine_ref``."""
    if not moe_fused(ye, w, row_slot, slot_row):
        return moe_combine_ref(ye, w, slot_row)
    return _MoeCombine.apply(ye.contiguous(), w.contiguous(), row_slot.contiguous(),
                             slot_row.contiguous())


def _lr(lr_scale: Tensor | float, lr: float, dev: torch.device) -> tuple[Tensor | None, float]:
    """The finalize's (lr_scale, lr_mul): a 0-d ``lr_scale`` on ``dev`` is read
    there (lr = lr_scale·lr); a Python number or a CPU tensor gives the
    learning rate itself, its product with ``lr`` taken here as the plain
    version takes it."""
    if isinstance(lr_scale, Tensor) and lr_scale.device == dev:
        return lr_scale, lr
    if isinstance(lr_scale, Tensor) and lr_scale.device.type != "cpu":
        raise ValueError(f"adamw_update: lr_scale on {lr_scale.device}, the leaves on {dev}")
    return None, float(lr * lr_scale)


def _adamw_fused(ps, gs, ms, vs, count, lr_scale, cfg):
    compress = cfg.grad_compress == "bf16"
    ps, gs, ms, vs = ([t.contiguous() for t in ts] for ts in (ps, gs, ms, vs))
    partials = torch.empty(len(gs) * _aw.SLOTS, dtype=torch.float32, device=gs[0].device)
    for i, g in enumerate(gs):
        _adamw_sumsq(g, compress, partials, i)
    gnorm, coef, count = _adamw_finalize(partials, len(gs), count,
                                         *_lr(lr_scale, cfg.lr, partials.device), cfg.b1,
                                         cfg.b2, cfg.clip_norm)
    new = [_adamw_update(p, g, m, v, coef, compress, p.ndim >= 2, cfg.b1, cfg.b2, cfg.eps,
                         cfg.weight_decay) for p, g, m, v in zip(ps, gs, ms, vs, strict=True)]
    return *(list(t) for t in zip(*new)), count, gnorm


def _adamw_sharded(ps, gs, ms, vs, count, lr_scale, cfg):
    """``adamw_update`` on DTensors: each gradient's sum of squares on each
    device's shards, a Partial sum over the mesh axes that shard it; their
    sum over the leaves reduced as the plain version's DTensor norm is (the
    same collectives); the finalize on the replicated total; each leaf's
    update on its shards, placed as its parameter. On a mesh of one device
    the bits are the unsharded route's."""
    from torch.distributed.tensor import Partial, Replicate

    compress = cfg.grad_compress == "bf16"
    rep = sh.replicated(ps[0].device_mesh)

    def shard_sum(g):
        places = tuple(g.placements) if sh.is_dtensor(g) else rep
        return sh.run_local(lambda gl: _adamw_leaf_sumsq(gl.contiguous(), compress), (g,),
                            (places,),
                            tuple(Partial() if p.is_shard() else Replicate() for p in places))

    def finalize(total, c, scale):
        return _adamw_finalize(total.reshape(1), 1, c, *_lr(scale, cfg.lr, total.device), cfg.b1,
                               cfg.b2, cfg.clip_norm)

    total = sum(shard_sum(g) for g in gs)
    gnorm, coef, count = sh.run_local(finalize, (total, count, lr_scale), (rep, rep, rep),
                                      (rep, rep, rep))

    def leaf(p, g, m, v):
        places = tuple(p.placements)
        return sh.run_local(
            lambda *a: _adamw_update(*(t.contiguous() for t in a), compress, p.ndim >= 2,
                                     cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay),
            (p, g, m, v, coef), (places,) * 4 + (rep,), (places,) * 3)

    new = [leaf(p, g, m, v) for p, g, m, v in zip(ps, gs, ms, vs, strict=True)]
    return *(list(t) for t in zip(*new)), count, gnorm


# ---------------------------------------------------------------------------
# The entries on DTensors: each device runs the entry above on its shards
# ---------------------------------------------------------------------------

def _axis_roles(t: torch.Tensor, batch_dim: int, head_dim: int):
    """Per mesh dimension of DTensor ``t``: "batch" where it shards
    ``batch_dim``, "heads" where it shards ``head_dim``, else None (the
    entry replicates ``t`` there; a Partial sum is reduced first)."""
    return tuple("batch" if p.is_shard(batch_dim) else "heads" if p.is_shard(head_dim)
                 else None for p in t.placements)


def _place(roles, dims: dict[str, int]):
    """Placements from roles: ``Shard(dims[role])``, or Replicate for a role
    ``dims`` does not name (and for None)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dims[r]) if r in dims else Replicate() for r in roles)


def _kv_for_heads(t: torch.Tensor, first: int, h: int, G: int, dim: int) -> torch.Tensor:
    """The kv heads (along ``dim``) that query heads ``first .. first + h - 1``
    read, query head j reading kv head j // G: whole groups when ``h`` is a
    multiple of G, the one kv head when G is a multiple of ``h``, else one
    kv head per query head."""
    if h % G == 0:
        sel = t.narrow(dim, first // G, h // G)
    elif G % h == 0:
        sel = t.narrow(dim, first // G, 1)
    else:
        sel = t.index_select(dim, (first + torch.arange(h, device=t.device)) // G)
    return sel.contiguous()


def _grouped_kv(q, k, roles):
    """(kv placements, kv gradient placements, (mesh dim, G) or None): where q
    shards its heads over a mesh axis that does not divide the kv heads, each
    device takes the kv heads whole and slices those its query heads read;
    their gradient is then a Partial sum over that axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    H, K = q.shape[-2], k.shape[-2]
    head_dim = k.ndim - 2
    kv, grad, sliced = [], [], None
    for i, (r, size) in enumerate(zip(roles, q.device_mesh.shape)):
        if r == "batch":
            kv.append(Shard(0))
            grad.append(Shard(0))
        elif r == "heads" and K % size == 0:
            kv.append(Shard(head_dim))
            grad.append(Shard(head_dim))
        elif r == "heads":
            assert sliced is None, "query heads sharded over two mesh axes"
            sliced = (i, H // K)
            kv.append(Replicate())
            grad.append(Partial())
        else:
            kv.append(Replicate())
            grad.append(Replicate())
    return tuple(kv), tuple(grad), sliced


def _flash_sharded(q, k, v, causal, window):
    """``flash_attention`` on DTensors q (B,Sq,H,hd), k/v (B,Skv,K,hd): each
    device runs it on its batch shard and its query heads (q's own
    placements; its sequence and head dim replicated), with the kv heads
    those heads read; the output is placed as q."""
    roles = _axis_roles(q, 0, 2)
    qp = _place(roles, {"batch": 0, "heads": 2})
    kvp, kvg, sliced = _grouped_kv(q, k, roles)
    mesh = q.device_mesh

    def local(ql, kl, vl):
        if sliced is not None:
            first = mesh.get_local_rank(sliced[0]) * ql.shape[2]
            kl, vl = (_kv_for_heads(t, first, ql.shape[2], sliced[1], 2) for t in (kl, vl))
        return flash_attention(ql, kl, vl, causal=causal, window=window)

    return sh.run_local(local, (q, k, v), (qp, kvp, kvp), qp, (qp, kvg, kvg))


def _decode_sharded(q, k_cache, v_cache, kv_len, with_lse):
    """``decode_attention`` on DTensors q (B,H,hd), caches (B,S,K,hd): batch
    shards as the cache's; where the cache's sequence is sharded (``kv_seq``,
    sequence parallelism) every device of that axis takes all the query
    heads, attends over its own range of the cache (its kv_len clamped to
    the range, 0 where the range starts past it) and the ranges' partial
    results merge by their log-sum-exp: one all-reduce of the rows' maxima
    and one of the weighted outputs with their weights. Elsewhere the query
    heads shard as q's, with the kv heads they read."""
    import torch.distributed._functional_collectives as funcol

    mesh = q.device_mesh
    croles = tuple("batch" if p.is_shard(0) else "seq" if p.is_shard(1)
                   else "heads" if p.is_shard(2) else None for p in k_cache.placements)
    qroles = tuple("batch" if c == "batch" else "heads" if c == "heads" or (
        c is None and p.is_shard(1)) else None for c, p in zip(croles, q.placements))
    seq = [i for i, c in enumerate(croles) if c == "seq"]
    assert len(seq) <= 1, "cache sequence sharded over two mesh axes"
    seq_dim = seq[0] if seq else None
    qp = _place(qroles, {"batch": 0, "heads": 1})
    cp = _place(croles, {"batch": 0, "seq": 1, "heads": 2})
    kvp, _, sliced = _grouped_kv(q, k_cache, qroles)
    cp = tuple(kv if r == "heads" else c for c, kv, r in zip(cp, kvp, qroles))
    lp = _place(croles, {"batch": 0})
    lse_p = _place(qroles, {"batch": 0, "heads": 1})
    merge = seq_dim is not None and mesh.shape[seq_dim] > 1

    def local(ql, kl, vl, nl):
        if sliced is not None:
            first = mesh.get_local_rank(sliced[0]) * ql.shape[1]
            kl, vl = (_kv_for_heads(t, first, ql.shape[1], sliced[1], 2) for t in (kl, vl))
        if seq_dim is not None:
            S = kl.shape[1]
            nl = (nl - mesh.get_local_rank(seq_dim) * S).clamp(0, S).to(torch.int32)
        if not merge:
            return decode_attention(ql, kl, vl, nl, with_lse=with_lse)
        out, lse = decode_attention(ql, kl, vl, nl, with_lse=True)
        group = (mesh, seq_dim)
        top = funcol.all_reduce(lse, "max", group)
        w = torch.exp(lse - torch.where(torch.isfinite(top), top, 0.0))
        acc = funcol.all_reduce(torch.cat([out.float() * w[..., None], w[..., None]], -1),
                                "sum", group)
        den = acc[..., -1]
        out = (acc[..., :-1] / den[..., None]).to(ql.dtype)
        return (out, top + torch.log(den)) if with_lse else out

    outs = (qp, lse_p) if with_lse else qp
    return sh.run_local(local, (q, k_cache, v_cache, kv_len), (qp, cp, cp, lp), outs)


def _mlstm_sharded(q, k, v, log_f, i_gate, chunk, state):
    """``mlstm_chunk`` on DTensors: each device runs it on its batch shard
    and, where q shards its heads, on its heads; the rest replicated."""
    roles = _axis_roles(q, 0, 2)
    tp = _place(roles, {"batch": 0, "heads": 2})   # q, k, v and the gates alike
    sp = _place(roles, {"batch": 0, "heads": 1})

    def local(ql, kl, vl, lf, ig, C0, n0):
        y, (C, n) = mlstm_chunk(ql, kl, vl, lf, ig, chunk=chunk,
                                state=None if C0 is None else (C0, n0))
        return y, C, n

    C0, n0 = (None, None) if state is None else state
    sp_in = None if state is None else sp
    y, C, n = sh.run_local(local, (q, k, v, log_f, i_gate, C0, n0),
                           (tp, tp, tp, tp, tp, sp_in, sp_in), (tp, sp, sp))
    return y, (C, n)


flash_attention.launches = 0
flash_attention.bwd_launches = 0
decode_attention.launches = 0
mlstm_chunk.launches = 0
mlstm_chunk.bwd_launches = 0
adamw_update.launches = 0
moe_dispatch.launches = 0
moe_dispatch.bwd_launches = 0
moe_combine.launches = 0
moe_combine.bwd_launches = 0
