"""The serving step (decode with the KV cache), its inputs, and the
decode step of a latent-attention model as CUDA graphs."""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Any

import torch

from repro_torch import tracing
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.tree import leaves


def build_serve_step(cfg: ModelConfig):
    """(params, cache, batch) -> (logits, cache).

    ``batch`` = {"token": (B,) ints, "pos": int}. One new token per
    sequence; the cache is updated in place (``M.decode_step``).
    """

    def serve_step(params, cache, batch):
        return M.decode_step(params, cfg, cache, batch["token"], batch["pos"])

    return serve_step


def decode_inputs(cfg: ModelConfig, batch: int, seq_len: int, *,
                  device: str | torch.device = "cuda") -> dict[str, Any]:
    return {
        "token": torch.zeros((batch,), dtype=torch.long, device=resolve_device(device)),
        "pos": seq_len - 1,
    }


def graphable(cfg: ModelConfig) -> bool:
    """Whether ``DecodeGraph`` can hold ``cfg``'s decode step: every mixer
    latent attention (``models/mla.py``), whose decode step reads its
    position on the device only and keeps the cache's shapes."""
    return not cfg.enc_dec and all(cfg.mixer_of(e) == "mla" for e in cfg.block_pattern)


class DecodeGraph:
    """The decode step of a latent-attention model (``graphable``) over one
    ``(batch, max_len)`` cache, captured as CUDA graphs and replayed at
    every position of every request it serves (``decode_graph`` keeps one
    per model, batch and length).

    Eagerly, DeepSeek-V3's step at 32 layers launches some 4,100 kernels, and
    an H100's host, at about 20 µs a launch, takes two to four times the
    card's 36 ms for them (``PERF.md`` §6); a replay hands them to the card
    at once. It owns the graphs' inputs (the token, the position as a 0-d
    int64 tensor), their output logits and their cache, all at fixed
    addresses: ``begin`` zeroes the cache for a new request, ``step`` copies
    the inputs in, replays and returns the logits. ``lock`` serialises the
    requests that share it. The parameters are read where they lie: keep
    them as they are while the graph lives.

    The step is captured twice, and ``step`` replays the two graphs in turn.
    With one graph, DeepSeek-V3's jobs ran up to 3.9 % slower in stretches
    (the card's gap between kernels doubled, 0.27 to 0.58 µs) in 5 of 6
    runs, whose tokens/s and p95 spread 3.5 % and 1.6 %; with two, 12 of 12
    runs held within 0.21 % (``PERF.md`` §6). Capture first runs the step once eagerly
    on a side stream (cuBLAS sets up its workspaces there) and runs nothing
    while capturing; each graph keeps its own memory pool and output.

    ``capture_traced`` adds a second pair, captured with the step's spans
    (``tracing.capture``: their events are nodes of the graph, about 3 µs
    of the card's time each), which ``step`` replays instead while a
    profiler records, recording those spans at each replay; so a traced
    request runs the graphed step, and not an eager one. It is captured
    only when asked for: with it captured beside the first pair from the
    start, 3 of 12 untraced DeepSeek-V3 runs read 1.2–3.4 % slow, for a
    cause not found (``PERF.md`` §6)."""

    def __init__(self, cfg: ModelConfig, params: Any, batch: int, max_len: int,
                 device: str | torch.device = "cuda"):
        if not graphable(cfg):
            raise ValueError(f"{cfg.name}: a decode step with other mixers than latent "
                             "attention reads its position on the host")
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"DecodeGraph: CUDA graphs need a CUDA device, not {dev}")
        self.cfg, self.device = cfg, dev
        self.batch, self.max_len = batch, max_len
        self.lock = threading.Lock()
        self.cache = M.init_cache(cfg, batch, max_len, device=dev)
        self.token = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        self.plain = self._capture(params, traced=False)
        self.traced = None
        self.turn = 0

    def _capture(self, params: Any, traced: bool) -> list[tuple]:
        """Two captures of the step: (graph, logits, ``tracing.Capture`` or None)."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            M.decode_step(params, self.cfg, self.cache, self.token, self.pos)
        torch.cuda.current_stream(dev).wait_stream(side)
        pair = []
        for _ in range(2):
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(graph), \
                    (tracing.capture() if traced else contextlib.nullcontext()) as cap:
                logits, _ = M.decode_step(params, self.cfg, self.cache, self.token, self.pos)
            pair.append((graph, logits, cap))
        return pair

    def capture_traced(self, params: Any) -> None:
        """Capture the traced pair, once (``params`` as at construction), and
        launch each graph once, which uploads it to the card. Called before a
        profiler starts, it keeps all of this out of the trace."""
        if self.traced is None:
            self.traced = self._capture(params, traced=True)
            for graph, _, _ in self.traced:
                graph.replay()

    def begin(self) -> list[dict[str, torch.Tensor]]:
        """Zero the cache for a new request; returns it."""
        for c in self.cache:
            for t in c.values():
                t.zero_()
        return self.cache

    def step(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        """Next-token logits (batch, vocab) fp32 of ``token`` (batch,) at ``pos``,
        the cache updated in place: the output buffer of the graph replayed,
        which its next replay, two steps on, overwrites. While a profiler
        records, the traced pair replays, if captured."""
        self.token.copy_(token)
        self.pos.fill_(pos)
        pair = (self.traced if self.traced is not None and torch.autograd._profiler_enabled()
                else self.plain)
        graph, logits, cap = pair[self.turn]
        self.turn = 1 - self.turn
        if cap is not None:
            cap.settle()
            t0 = time.time_ns()  # lint: allow(REPRO001) — the profiler's clock
        graph.replay()
        if cap is not None:
            cap.replayed(t0, time.time_ns())  # lint: allow(REPRO001)
        return logits


_GRAPHS: dict[tuple, DecodeGraph] = {}
_GRAPHS_LOCK = threading.Lock()


def decode_graph(cfg: ModelConfig, params: Any, batch: int, max_len: int,
                 device: torch.device) -> DecodeGraph | None:
    """The ``DecodeGraph`` that serves ``cfg`` with ``params`` at ``batch`` and
    ``max_len`` on ``device``, captured at its first request and kept while
    the parameters live; None where the step cannot be graphed (not on a
    CUDA device, or not ``graphable``)."""
    if device.type != "cuda" or not graphable(cfg):
        return None
    leaf = next(t for t in leaves(params) if isinstance(t, torch.Tensor))
    key = (id(leaf), cfg, batch, max_len, device)
    with _GRAPHS_LOCK:
        graph = _GRAPHS.get(key)
        if graph is None:
            graph = _GRAPHS[key] = DecodeGraph(cfg, params, batch, max_len, device)
            weakref.finalize(leaf, _GRAPHS.pop, key, None)
    return graph


def clear_decode_graphs() -> None:
    """Drop every ``DecodeGraph`` kept, and with them their memory."""
    with _GRAPHS_LOCK:
        _GRAPHS.clear()
