"""Recurrent mixers in PyTorch: Mamba (Jamba's SSM), mLSTM and sLSTM (xLSTM).

Port of ``repro.models.ssm``. Parameters keep the reference's names,
layouts, scales and dtypes (mamba's ``dt_bias``, ``A_log`` and ``D`` and
the xLSTM gate weights ``wi``, ``wf`` and ``r_gates`` in fp32);
``init_*`` take an explicit ``torch.Generator``; ``specs_*`` give the
reference's logical-axis specs of their trees (``layers``). Every function carries
explicit recurrent state, so the same code serves the forward (state
zeros, full sequence) and decode (state threaded through steps).

- ``mamba`` is the reference's selective SSM in plain PyTorch, which
  trains through autograd. The JAX package computes it in jnp (no Pallas
  kernel), and so does the port: the causal conv as the reference's sum of
  ``w`` products in the model dtype, the recurrence h_t = a_t·h_{t-1} + b_t
  in fp32 by ``_mamba_scan_chunked``, a Python loop over chunks of 256 with
  a log-depth (Hillis–Steele) doubling scan inside each, 8 steps at 256 and
  none at a decode step's chunk of 1: no loop over time, no host sync.
  Kernel launches per mamba layer, read once from a ``torch.profiler``
  trace on an H100 (jamba-1.5-large's width, bf16; no test holds the
  count): 104 in the forward at
  B=2 S=512, 67 of them the scan's (per chunk 8 doubling steps of a
  product, an ``addcmul`` and two ``cat`` copies, and the ``addcmul`` that
  applies the carried state; one ``cat`` of the two chunks); 34 in one
  decode step.
- ``mlstm`` computes the reference's projections and gates and runs the
  chunkwise recurrence through ``ops.mlstm_chunk``: the hand-written CUDA
  kernels (forward and backward) on the card, their plain versions on the
  CPU.
- ``slstm`` is a Python loop over time in plain PyTorch, which trains
  through autograd: its recurrence is sequential and the JAX package has no
  kernel for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import EMBED, HEADS, INNER, STATE, Params, _init, dtype_of
from repro_torch.runtime import sharding as sh

MAMBA_CHUNK = 256
MLSTM_CHUNK = 256  # the reference's chunk, kept for its S % chunk assertion


# ---------------------------------------------------------------------------
# Mamba (selective SSM), Jamba's mixer
# ---------------------------------------------------------------------------

def mamba_dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
    dt_rank = mamba_dt_rank(cfg)
    w = cfg.ssm_conv_width
    dt = dtype_of(cfg)
    dev = gen.device
    return {
        "in_proj": _init(gen, (d, 2 * di), d ** -0.5, dt),
        "conv_w": _init(gen, (w, di), w ** -0.5, dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": _init(gen, (di, dt_rank + 2 * n), di ** -0.5, dt),
        "dt_proj": _init(gen, (dt_rank, di), dt_rank ** -0.5, dt),
        "dt_bias": torch.full((di,), -4.6, dtype=torch.float32, device=dev),  # softplus≈0.01
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)).repeat(di, 1),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _init(gen, (di, d), di ** -0.5, dt),
    }


def specs_mamba(cfg: ModelConfig) -> Params:
    return {"in_proj": (EMBED, INNER), "conv_w": (None, INNER), "conv_b": (INNER,),
            "x_proj": (INNER, None), "dt_proj": (None, INNER), "dt_bias": (INNER,),
            "A_log": (INNER, STATE), "D": (INNER,), "out_proj": (INNER, EMBED)}


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 under (a_l, b_l)∘(a_r, b_r) = (a_l·a_r,
    b_l·a_r + b_r): after step s each position holds the composition of the
    2^s positions ending at it (Hillis–Steele), ⌈log₂ n⌉ steps of four
    launches each."""
    n, s = a.shape[1], 1
    while s < n:
        a, b = (torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1),
                torch.cat([b[:, :s], torch.addcmul(b[:, s:], b[:, :-s], a[:, s:])], dim=1))
        s *= 2
    return a, b


def _mamba_scan_chunked(deltaA: torch.Tensor, deltaBu: torch.Tensor,
                        h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = deltaA_t * h_{t-1} + deltaBu_t, scanned over axis 1 (seq).

    deltaA, deltaBu: (B, S, di, N); h0: (B, di, N). Returns (hs, h_last).
    A Python loop over chunks of ``min(MAMBA_CHUNK, S)`` carries h; inside a
    chunk ``_doubling_scan`` composes the steps. Raises ``ValueError`` unless
    the chunk divides S (the reference asserts it)."""
    S = deltaA.shape[1]
    chunk = min(MAMBA_CHUNK, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the scan's chunk {chunk}")
    h, hs = h0, []
    for c0 in range(0, S, chunk):
        a, b = _doubling_scan(deltaA[:, c0:c0 + chunk], deltaBu[:, c0:c0 + chunk])
        hc = torch.addcmul(b, a, h[:, None])                 # (B, chunk, di, N)
        hs.append(hc)
        h = hc[:, -1]
    return (hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)), h


def mamba(
    p: Params,
    x: torch.Tensor,                   # (B, S, d)
    cfg: ModelConfig,
    state: tuple[torch.Tensor, torch.Tensor] | None = None,
    # state = (conv_state (B, w-1, di) model dtype, ssm_state (B, di, N) fp32)
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    B = x.shape[0]
    di, n = cfg.d_inner, cfg.ssm_state_dim
    w = cfg.ssm_conv_width
    dt_rank = mamba_dt_rank(cfg)

    xz = sh.matmul(x, p["in_proj"])
    if sh.is_dtensor(xz):
        return _mamba_sharded(p, xz, cfg, state)
    xin, z = xz.chunk(2, dim=-1)                         # (B, S, di) each
    if state is None:
        conv_state = torch.zeros((B, w - 1, di), dtype=xin.dtype, device=x.device)
        ssm_state = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    else:
        conv_state, ssm_state = state

    u, new_conv_state = _conv(xin, conv_state, p["conv_w"], p["conv_b"])
    dt_in, Bm, Cm = (u @ p["x_proj"]).split([dt_rank, n, n], dim=-1)
    y, h_last = _scan(u, z, dt_in, Bm, Cm, p["dt_proj"], p["dt_bias"], p["A_log"], p["D"],
                      ssm_state)
    return y @ p["out_proj"], (new_conv_state, h_last)


def _conv(xin: torch.Tensor, conv_state: torch.Tensor, conv_w: torch.Tensor,
          conv_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``mamba``'s causal depthwise conv of width w over the inner channels it
    is given: the reference's sum of w products in the model dtype, in its
    order. Returns (its silu (B, S, di), the last w-1 rows)."""
    S, w = xin.shape[1], conv_w.shape[0]
    xpad = torch.cat([conv_state, xin], dim=1)           # (B, S+w-1, di)
    conv = xpad[:, :S] * conv_w[0]
    for i in range(1, w):
        conv = conv + xpad[:, i:i + S] * conv_w[i]
    conv = conv + conv_b
    return F.silu(conv), xpad[:, S:]


def _scan(u, z, dt_in, Bm, Cm, dt_proj, dt_bias, A_log, D, ssm_state
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mamba``'s selective scan over the inner channels it is given, from the
    conv's output ``u`` (B, S, di) and x_proj's parts (dt_in, B, C) to the
    gated output (B, S, di) in ``z``'s dtype and the last state (B, di, N)."""
    delta = F.softplus((dt_in @ dt_proj).float() + dt_bias)
    A = -torch.exp(A_log)                                # (di, N)
    uf = u.float()
    deltaA = torch.exp(delta[..., None] * A)             # (B, S, di, N)
    deltaBu = (delta * uf)[..., None] * Bm.float()[:, :, None, :]
    hs, h_last = _mamba_scan_chunked(deltaA, deltaBu, ssm_state)
    del deltaA, deltaBu                                  # 2 x 4·B·S·di·N bytes
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm.float())    # (B, S, di)
    y = y + uf * D
    return y.to(z.dtype) * F.silu(z), h_last


def _mamba_sharded(p: Params, xz: torch.Tensor, cfg: ModelConfig,
                   state: tuple[torch.Tensor, torch.Tensor] | None):
    """``mamba`` on DTensors from in_proj's output ``xz`` (B, S, 2·di), its
    inner channels split over the axis that shards them (``conv_b``'s): the
    halves are gathered and cut apart (in_proj's column shards straddle
    them), each device convolves and scans its own channels and batch
    shard (``_conv``, ``_scan``, as the plain path does), and x_proj's
    row-parallel product is reduced between the two. Each parameter's
    gradient adds up over the batch axes; the inputs' over the channels'
    axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = xz.device_mesh
    n, w = cfg.ssm_state_dim, cfg.ssm_conv_width
    roles = tuple("batch" if px.is_shard(0) else "inner" if pb.is_shard(0) else None
                  for px, pb in zip(xz.placements, p["conv_b"].placements, strict=True))

    def place(batch, inner, grad_batch=None, grad_inner=None):
        return tuple(batch if r == "batch" else inner if r == "inner" else Replicate()
                     for r in roles), tuple(
            (grad_batch or batch) if r == "batch" else (grad_inner or inner)
            if r == "inner" else Replicate() for r in roles)

    act, _ = place(Shard(0), Shard(2))                   # (B, S, di) activations
    rows, rows_g = place(Shard(0), Replicate(), grad_inner=Partial())   # x_proj's parts
    state_p, _ = place(Shard(0), Shard(1))               # ssm state (B, di, N)
    vec, vec_g = place(Replicate(), Shard(0), grad_batch=Partial())     # (di, ...) params
    cols, cols_g = place(Replicate(), Shard(1), grad_batch=Partial())   # (., di) params
    whole = tuple(Replicate() if p.is_shard(2) else p for p in xz.placements)
    xin, z = (h.redistribute(mesh, act) for h in xz.redistribute(mesh, whole).chunk(2, -1))
    conv_state, ssm_state = (None, None) if state is None else state

    def conv(x, cs, cw, cb):
        if cs is None:
            cs = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype, device=x.device)
        return _conv(x, cs, cw, cb)

    u, new_conv_state = sh.run_local(
        conv, (xin, conv_state, p["conv_w"], p["conv_b"]),
        (act, None if state is None else act, cols, vec), (act, act),
        (act, None if state is None else act, cols_g, vec_g))
    parts = sh.matmul(u, p["x_proj"]).redistribute(mesh, rows)
    dt_in, Bm, Cm = parts.split([mamba_dt_rank(cfg), n, n], dim=-1)

    def scan(u, z, dt_in, Bm, Cm, dt_proj, dt_bias, A_log, D, h0):
        if h0 is None:
            h0 = torch.zeros((u.shape[0], u.shape[2], n), dtype=torch.float32, device=u.device)
        return _scan(u, z, dt_in, Bm, Cm, dt_proj, dt_bias, A_log, D, h0)

    h0_p = None if state is None else state_p
    y, h_last = sh.run_local(
        scan, (u, z, dt_in, Bm, Cm, p["dt_proj"], p["dt_bias"], p["A_log"], p["D"], ssm_state),
        (act, act, rows, rows, rows, cols, vec, vec, vec, h0_p), (act, state_p),
        (act, act, rows_g, rows_g, rows_g, cols_g, vec_g, vec_g, vec_g, h0_p))
    return sh.matmul(y, p["out_proj"]), (new_conv_state, h_last)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell), chunkwise parallel form
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    dk = int(cfg.mlstm_proj_factor * cfg.d_model)
    return dk, cfg.n_heads, dk // cfg.n_heads


def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    dk, H, _ = mlstm_dims(cfg)
    dt = dtype_of(cfg)
    return {
        "wq": _init(gen, (d, dk), d ** -0.5, dt),
        "wk": _init(gen, (d, dk), d ** -0.5, dt),
        "wv": _init(gen, (d, dk), d ** -0.5, dt),
        "wi": _init(gen, (d, H), d ** -0.5, torch.float32),  # input gate
        "wf": _init(gen, (d, H), d ** -0.5, torch.float32),  # forget gate
        "wo": _init(gen, (dk, d), dk ** -0.5, dt),
    }


def specs_mlstm(cfg: ModelConfig) -> Params:
    return {"wq": (EMBED, HEADS), "wk": (EMBED, HEADS), "wv": (EMBED, HEADS),
            "wi": (EMBED, None), "wf": (EMBED, None), "wo": (HEADS, EMBED)}


def mlstm(
    p: Params,
    x: torch.Tensor,                   # (B, S, d)
    cfg: ModelConfig,
    state: tuple[torch.Tensor, torch.Tensor] | None = None,
    # state = (C (B,H,hd,hd) fp32, n (B,H,hd) fp32)
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Chunkwise mLSTM with sigmoid forget gates; returns the output and the
    final state. The recurrence runs in ``ops.mlstm_chunk`` at its own chunk
    (64), which computes the same function as the reference's chunk."""
    B, S, _ = x.shape
    dk, H, hd = mlstm_dims(cfg)
    chunk = min(MLSTM_CHUNK, S)
    assert S % chunk == 0, (S, chunk)
    q = sh.split_last(sh.matmul(x, p["wq"]), (H, hd)).float() * (hd ** -0.5)
    k = sh.split_last(sh.matmul(x, p["wk"]), (H, hd)).float()
    v = sh.split_last(sh.matmul(x, p["wv"]), (H, hd)).float()
    xf = x.float()
    log_f = sh.pointwise(F.logsigmoid, sh.matmul(xf, p["wf"]))   # (B, S, H)
    i_gate = torch.exp(sh.pointwise(F.logsigmoid, sh.matmul(xf, p["wi"])))
    y, new_state = ops.mlstm_chunk(q, k, v, log_f, i_gate, state=state)
    return sh.matmul(sh.merge_last(y).to(x.dtype), p["wo"]), new_state


def mlstm_decode_step(
    p: Params, x: torch.Tensor, cfg: ModelConfig,
    state: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Single-token mLSTM recurrence (decode); returns new state tensors."""
    B, S, _ = x.shape
    assert S == 1
    dk, H, hd = mlstm_dims(cfg)
    C, n = state
    q = sh.split_last(sh.matmul(x[:, 0], p["wq"]), (H, hd)).float() * (hd ** -0.5)
    k = sh.split_last(sh.matmul(x[:, 0], p["wk"]), (H, hd)).float()
    v = sh.split_last(sh.matmul(x[:, 0], p["wv"]), (H, hd)).float()
    xf = x[:, 0].float()
    f = torch.exp(sh.pointwise(F.logsigmoid, sh.matmul(xf, p["wf"])))   # (B, H)
    i = torch.exp(sh.pointwise(F.logsigmoid, sh.matmul(xf, p["wi"])))
    C = f[..., None, None] * C + i[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n = f[..., None] * n + i[..., None] * k
    y = torch.einsum("bhk,bhkv->bhv", q, C)
    nrm = torch.einsum("bhk,bhk->bh", q, n)
    y = y / torch.clamp(nrm.abs(), min=1.0)[..., None]
    return sh.matmul(sh.merge_last(y[:, None]).to(x.dtype), p["wo"]), (C, n)


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory cell), sequential loop over time
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    dt = dtype_of(cfg)
    return {
        # gates i, f, z, o stacked: input weights (d, 4d)
        "w_gates": _init(gen, (d, 4 * d), d ** -0.5, dt),
        # block-diagonal recurrent weights per head: (H, hd, 4·hd)
        "r_gates": _init(gen, (H, hd, 4 * hd), hd ** -0.5, torch.float32),
        "b_gates": torch.zeros((4 * d,), dtype=torch.float32, device=gen.device),
        "w_out": _init(gen, (d, d), d ** -0.5, dt),
    }


def specs_slstm(cfg: ModelConfig) -> Params:
    return {"w_gates": (EMBED, None), "r_gates": (HEADS, None, None), "b_gates": (None,),
            "w_out": (EMBED, EMBED)}


def slstm(
    p: Params,
    x: torch.Tensor,                   # (B, S, d)
    cfg: ModelConfig,
    state: tuple[torch.Tensor, torch.Tensor] | None = None,
    # state = (c (B,d), h (B,d)) fp32
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    pre = sh.matmul(x, p["w_gates"]).float() + p["b_gates"]      # (B, S, 4d)
    if state is None:
        c = sh.zeros_batched((B, d), pre)
        h = sh.zeros_batched((B, d), pre)
    else:
        c, h = state
    hs = []
    for t in range(S):
        rec = torch.einsum("bhk,hkg->bhg", h.reshape(B, H, hd), p["r_gates"])
        i, f, z, o = (pre[:, t] + rec.reshape(B, 4 * d)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.exp(sh.pointwise(F.logsigmoid, i)) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)               # (B, S, d)
    return sh.matmul(y, p["w_out"]), (c, h)
