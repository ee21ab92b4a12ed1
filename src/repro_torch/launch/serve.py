"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

Batched greedy decode with the KV cache; each request batch is one task of
the WUKONG engine (``repro_torch.core``), which supplies retry and
concurrency. For the encoder-decoder (whisper) a request also carries
audio frame embeddings (the frontend is a stub: ``request_frames``), which
the task encodes once into the cross cache before it decodes. The
counterpart of ``repro.launch.serve``, with the same flags plus
``--device`` (default ``cuda``) and ``--seed``. Tasks return
host values only (numpy tokens, floats): the engine's data plane sizes
what it stores and must never hold a CUDA tensor.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Any

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs import get_config, reduced
from repro_torch.core import EngineConfig, FaultConfig, GraphBuilder, WukongEngine
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, resolve_device
from repro_torch.runtime.serve import build_serve_step, decode_graph


def request_prompts(seed: int, rid: int, batch: int, prompt_len: int,
                    vocab: int) -> np.ndarray:
    """The (batch, prompt_len) prompt of request ``rid``: a numpy RNG seeded
    from (seed, rid), so a retried task sees the same prompt."""
    rng = np.random.default_rng([seed, rid])
    return rng.integers(0, vocab, size=(batch, prompt_len), dtype=np.int64)


def request_frames(seed: int, rid: int, batch: int, enc_frames: int,
                   d_model: int) -> np.ndarray:
    """The (batch, enc_frames, d_model) float32 frame embeddings of request
    ``rid`` for the encoder-decoder: standard normal from a numpy RNG seeded
    from (seed, rid, 1), so a retried task sees the same audio and the
    stream is not ``request_prompts``'."""
    rng = np.random.default_rng([seed, rid, 1])
    return rng.standard_normal((batch, enc_frames, d_model), dtype=np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def handle_request(cfg: ModelConfig, params: Params, rid: int, *, batch: int,
                   prompt_len: int, gen_len: int, seed: int,
                   device: torch.device) -> dict[str, Any]:
    """One batched request: for the encoder-decoder the frames encoded into
    the cross cache (``prefill_s``), then prompt ingestion on the decode
    path and greedy decode. Returns the generated tokens (batch, gen), the
    decode rate and the latency of the decode loop, and ``prefill_s`` (0.0
    without an encoder).

    Under a profiler it records ``tracing`` spans: ``serve.request`` around it,
    ``serve.cache_init``, ``serve.prompt`` (the ``prompt_len - 1`` steps whose
    logits are discarded) and ``serve.generate`` (the ``gen_len`` steps that
    give tokens), these two also on the device's timeline, and
    ``serve.readback``.

    Where the step can be graphed (``runtime.serve.decode_graph``: a
    latent-attention model on a CUDA device) every step replays the graph
    kept for this model, ``batch`` and ``prompt_len + gen_len``, on its
    cache, which the request holds alone (under a profiler, the pair that
    records the model's spans); the tokens are the eager steps'."""
    with tracing.span("serve.request", rid=rid), contextlib.ExitStack() as held:
        max_len = prompt_len + gen_len
        graph = decode_graph(cfg, params, batch, max_len, device)
        if graph is None:
            serve_step = build_serve_step(cfg)
        else:
            held.enter_context(graph.lock)
            if torch.autograd._profiler_enabled():
                graph.capture_traced(params)

            def serve_step(params, cache, inputs):
                return graph.step(inputs["token"], inputs["pos"]), cache
        prompt = torch.as_tensor(request_prompts(seed, rid, batch, prompt_len, cfg.vocab),
                                 device=device)
        with tracing.span("serve.cache_init"):
            cache = (M.init_cache(cfg, batch, max_len, device=device) if graph is None
                     else graph.begin())
        prefill_s = 0.0
        if cfg.enc_dec:
            frames = torch.as_tensor(
                request_frames(seed, rid, batch, cfg.enc_frames, cfg.d_model), device=device)
            _sync(device)
            t0 = time.perf_counter()  # lint: allow(REPRO001)
            M.prefill_cross(params, cfg, cache, frames)
            _sync(device)
            prefill_s = time.perf_counter() - t0  # lint: allow(REPRO001)
        tok = prompt[:, 0]
        generated = []
        _sync(device)
        t0 = time.perf_counter()  # lint: allow(REPRO001)
        with tracing.span("serve.prompt", device=device):
            for pos in range(prompt_len - 1):
                logits, cache = serve_step(params, cache, {"token": tok, "pos": pos})
                tok = prompt[:, pos + 1]
        with tracing.span("serve.generate", device=device):
            for pos in range(prompt_len - 1, max_len - 1):
                logits, cache = serve_step(params, cache, {"token": tok, "pos": pos})
                tok = logits.argmax(dim=-1)
                generated.append(tok)
        with tracing.span("serve.readback"):
            tokens = torch.stack(generated, dim=1).cpu().numpy()
        _sync(device)
        dt = time.perf_counter() - t0  # lint: allow(REPRO001)
    return {"rid": rid, "tokens": tokens, "decode_tps": batch * tokens.shape[1] / dt,
            "latency_s": dt, "prefill_s": prefill_s}


NO_FAULTS = FaultConfig(task_failure_prob=0.0, max_retries=2)


def serve(cfg: ModelConfig, params: Params, *, requests: int, batch: int,
          prompt_len: int, gen_len: int, seed: int,
          device: str | torch.device = "cuda", faults: FaultConfig = NO_FAULTS):
    """Run ``requests`` request batches as one WUKONG DAG (fan-out of request
    tasks into a summary task) under the engine's fault injection
    ``faults``; returns the engine's ``JobReport``, whose
    ``results["summary"]`` holds the mean decode rate, the p99 latency, the
    mean prefill seconds and each request's generated tokens."""
    dev = resolve_device(device)
    g = GraphBuilder()
    reqs = [g.add(handle_request, cfg, params, r, batch=batch, prompt_len=prompt_len,
                  gen_len=gen_len, seed=seed, device=dev, name=f"request-{r}")
            for r in range(requests)]
    g.add(lambda *rs: {
        "n": len(rs),
        "mean_tps": float(np.mean([r["decode_tps"] for r in rs])),
        "p99_latency_s": float(np.percentile([r["latency_s"] for r in rs], 99)),
        "mean_prefill_s": float(np.mean([r["prefill_s"] for r in rs])),
        "tokens": [r["tokens"] for r in rs],   # per request, in request order
    }, *reqs, name="summary")
    return WukongEngine(EngineConfig(faults=faults, job_timeout_s=3600.0)).compute(g.build())


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    params = M.init_model(cfg, seed=args.seed, device=args.device)
    rep = serve(cfg, params, requests=args.requests, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len, seed=args.seed,
                device=args.device)
    summary = rep.results["summary"]
    print(f"arch={cfg.name} device={args.device} requests={args.requests} "
          f"batch={args.batch} mean decode throughput {summary['mean_tps']:.1f} tok/s "
          f"p99 latency {summary['p99_latency_s']:.3f}s")
    if cfg.enc_dec:
        print(f"mean encoder prefill {summary['mean_prefill_s']:.3f}s")
    return rep


if __name__ == "__main__":
    main()
