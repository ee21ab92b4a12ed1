"""Recurrent mixers in PyTorch: mLSTM and sLSTM (xLSTM).

Port of ``repro.models.ssm`` for the xLSTM blocks. Parameters keep the
reference's names, layouts, scales and dtypes (gate weights ``wi``,
``wf`` and ``r_gates`` in fp32); ``init_*`` take an explicit
``torch.Generator``. Every function carries explicit recurrent state, so
the same code serves the forward (state zeros, full sequence) and decode
(state threaded through steps).

- ``mlstm`` computes the reference's projections and gates and runs the
  chunkwise recurrence through ``ops.mlstm_chunk``: the hand-written CUDA
  kernels (forward and backward) on the card, their plain versions on the
  CPU.
- ``slstm`` is a Python loop over time in plain PyTorch, which trains
  through autograd: its recurrence is sequential and the JAX package has no
  kernel for it.
- Mamba (Jamba's mixer) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _init, dtype_of

MLSTM_CHUNK = 256  # the reference's chunk, kept for its S % chunk assertion

_MAMBA = "ROADMAP.md queue 1 item 7 (recurrent mixers: mamba)"


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Params:
    raise NotImplementedError(f"{cfg.name}: mamba is not ported yet; {_MAMBA} brings it")


def mamba(p: Params, x: torch.Tensor, cfg: ModelConfig, state=None):
    raise NotImplementedError(f"{cfg.name}: mamba is not ported yet; {_MAMBA} brings it")


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
    q = (x @ p["wq"]).reshape(B, S, H, hd).float() * (hd ** -0.5)
    k = (x @ p["wk"]).reshape(B, S, H, hd).float()
    v = (x @ p["wv"]).reshape(B, S, H, hd).float()
    xf = x.float()
    log_f = F.logsigmoid(xf @ p["wf"])                   # (B, S, H)
    i_gate = torch.exp(F.logsigmoid(xf @ p["wi"]))
    y, new_state = ops.mlstm_chunk(q, k, v, log_f, i_gate, state=state)
    return y.reshape(B, S, dk).to(x.dtype) @ p["wo"], new_state


def mlstm_decode_step(
    p: Params, x: torch.Tensor, cfg: ModelConfig,
    state: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Single-token mLSTM recurrence (decode); returns new state tensors."""
    B, S, _ = x.shape
    assert S == 1
    dk, H, hd = mlstm_dims(cfg)
    C, n = state
    q = (x @ p["wq"]).reshape(B, H, hd).float() * (hd ** -0.5)
    k = (x @ p["wk"]).reshape(B, H, hd).float()
    v = (x @ p["wv"]).reshape(B, H, hd).float()
    xf = x[:, 0].float()
    f = torch.exp(F.logsigmoid(xf @ p["wf"]))            # (B, H)
    i = torch.exp(F.logsigmoid(xf @ p["wi"]))
    C = f[..., None, None] * C + i[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n = f[..., None] * n + i[..., None] * k
    y = torch.einsum("bhk,bhkv->bhv", q, C)
    nrm = torch.einsum("bhk,bhk->bh", q, n)
    y = y / torch.clamp(nrm.abs(), min=1.0)[..., None]
    return y.reshape(B, 1, dk).to(x.dtype) @ p["wo"], (C, n)


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
    pre = (x @ p["w_gates"]).float() + p["b_gates"]      # (B, S, 4d)
    if state is None:
        c = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        h = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    else:
        c, h = state
    hs = []
    for t in range(S):
        rec = torch.einsum("bhk,hkg->bhg", h.reshape(B, H, hd), p["r_gates"])
        i, f, z, o = (pre[:, t] + rec.reshape(B, 4 * d)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.exp(F.logsigmoid(i)) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)               # (B, S, d)
    return y @ p["w_out"], (c, h)
