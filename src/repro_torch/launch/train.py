"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of ``repro.launch.train``, with the same flags plus ``--device``
(default ``cuda``). It wires the stack together: the token pipeline ->
the train step (attention forward and backward through the flash kernels
on the card) -> a WUKONG-orchestrated workflow (``runtime.orchestrator``)
with injected failures, retries and async checkpoints, resuming from the
checkpoint when one exists. With ``--hosts/--host-id`` each host reads
its disjoint data shard. Without ``--full-width`` it trains the reduced
config. The pipeline's batches carry tokens only, so whisper's
encoder-decoder fails its first step with the ``ValueError`` of its missing
frames, as the reference's ``forward`` fails its assertion there; train it
through ``launch.train_lm``, whose batches carry frames.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import EngineConfig, FaultConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import model as M
from repro_torch.models.layers import resolve_device
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.orchestrator import build_training_workflow, run_training_workflow
from repro_torch.runtime.train import build_train_step


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_launch_ckpt"))
    ap.add_argument("--fail-prob", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, n_layers=args.layers * cfg.pattern_period)
    dev = resolve_device(args.device)

    pipe = TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, batch_per_host=args.batch,
        n_hosts=args.hosts, host_id=args.host_id, seed=13))
    params = M.init_model(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    step = build_train_step(cfg, AdamWConfig(lr=args.lr, warmup=args.warmup))

    os.makedirs(args.ckpt_dir, exist_ok=True)
    path = os.path.join(args.ckpt_dir, f"{cfg.name}.npz")
    losses: list[tuple[int, float]] = []
    writers = []

    def init_fn():
        if os.path.exists(path):
            st, step0 = ckpt.restore(path, {"params": params, "opt": opt})
            print(f"[resume] checkpoint @ step {step0}")
            return (st["params"], st["opt"])
        return (params, opt)

    def data_fn(i: int):
        b = pipe.batch(step=i)  # idempotent under retry
        return {"tokens": torch.as_tensor(b["tokens"], device=dev),
                "labels": torch.as_tensor(b["labels"], device=dev)}

    def step_fn(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        losses.append((int(o["count"]), float(m["loss"])))
        return (p, o), {"loss": float(m["loss"])}

    def checkpoint_fn(state, i):
        p, o = state
        writers.append(ckpt.save(path, {"params": p, "opt": o}, step=i, async_=True))
        return i

    dag, final_key, mk = build_training_workflow(
        n_steps=args.steps, step_fn=step_fn, init_fn=init_fn,
        checkpoint_fn=checkpoint_fn, checkpoint_every=args.ckpt_every,
        data_fn=data_fn)
    t0 = time.perf_counter()  # lint: allow(REPRO001)
    res = run_training_workflow(
        dag, final_key, mk,
        EngineConfig(faults=FaultConfig(task_failure_prob=args.fail_prob, max_retries=2),
                     job_timeout_s=24 * 3600.0))
    dt = time.perf_counter() - t0  # lint: allow(REPRO001)
    for w in writers:
        w.join()
    losses.sort()
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s); "
          f"loss {losses[0][1]:.4f} -> {losses[-1][1]:.4f}")
    return {"report": res.report, "final_state": res.report.results[final_key],
            "losses": losses, "seconds": dt, "checkpoint": path}


if __name__ == "__main__":
    main()
