"""End-to-end serving entry point: ``python -m repro_torch.launch.serve_lm``

The counterpart of ``examples/serve_lm.py``, with its flags and defaults
(mixtral-8x7b reduced, 4 request batches of 2 sequences, prompt 16, gen 16)
plus ``--device`` (default ``cuda``) and ``--seed``. Each request batch is a
task of the WUKONG engine (``launch.serve.serve``): prompt ingestion on the
decode path, then greedy decode, with the example's injected task failures
(the engine retries them). Prints the example's three lines.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch jamba_1_5_large_398b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch whisper_large_v3 --device cpu

Whisper's requests also carry seeded audio frame embeddings
(``launch.serve.request_frames``), encoded once per request into the
decoder's cross-attention cache.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import FaultConfig
from repro_torch.launch.serve import serve
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params

# examples/serve_lm.py's fault injection
FAULTS = FaultConfig(task_failure_prob=0.05, max_retries=2, seed=3)


def run(cfg: ModelConfig, params: Params, *, requests: int, batch: int, prompt_len: int,
        gen_len: int, seed: int, device: str | torch.device = "cuda"):
    """Serve ``requests`` request batches through the engine with ``FAULTS``;
    returns the engine's ``JobReport`` and the example's three lines."""
    t0 = time.perf_counter()  # lint: allow(REPRO001)
    rep = serve(cfg, params, requests=requests, batch=batch, prompt_len=prompt_len,
                gen_len=gen_len, seed=seed, device=device, faults=FAULTS)
    seconds = time.perf_counter() - t0  # lint: allow(REPRO001)
    summary = rep.results["summary"]  # the job's only root: each request's tokens are here
    lines = [f"arch={cfg.name} requests={requests} batch={batch} gen={gen_len}",
             f"served in {seconds:.1f}s  mean decode throughput {summary['mean_tps']:.1f} "
             f"tok/s  p99 latency {summary['p99_latency_s']:.2f}s",
             "sample continuation (req 0, seq 0): "
             f"{summary['tokens'][0][0][:12].tolist()}"]
    return rep, lines


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral_8x7b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2, help="sequences per request batch")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    params = M.init_model(cfg, seed=args.seed, device=args.device)
    rep, lines = run(cfg, params, requests=args.requests, batch=args.batch,
                     prompt_len=args.prompt_len, gen_len=args.gen_len, seed=args.seed,
                     device=args.device)
    for line in lines:
        print(line)
    return rep


if __name__ == "__main__":
    main()
