"""LM training as a WUKONG workflow: ``python -m repro_torch.launch.train_lm``

The counterpart of ``examples/train_lm.py``, with the same flags plus
``--device`` (default ``cuda``). Each train step (loss -> grads -> AdamW,
``runtime.train``) on a ``synthetic_batch`` seeded with the step's index
is a task of the copied engine's training workflow
(``runtime.orchestrator``), with injected Lambda-style failures and
retries and periodic async checkpoints; a run resumes from the checkpoint
when one exists. It trains every ported model: the ``attn+dense``
decoders (smollm-360m by default), xLSTM (``--arch xlstm_350m``), MoE,
jamba and whisper's encoder-decoder (``--arch whisper_large_v3``, whose
batches also carry seeded frames; ``--layers`` cuts its decoder, the
encoder keeps the config's depth), with ``remat`` as the config sets it
(``reduced`` turns it off). Defaults are laptop-sized; ``--full-width``
keeps the arch's real width.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --arch whisper_large_v3 --device cpu \
        --steps 2 --batch 2 --seq 8
    python -m repro_torch.launch.train_lm --arch whisper_large_v3 --full-width --layers 32
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any

from repro_torch.configs import get_config, reduced
from repro_torch.core import EngineConfig, FaultConfig
from repro_torch.models import model as M
from repro_torch.models.layers import resolve_device
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.orchestrator import build_training_workflow, run_training_workflow
from repro_torch.runtime.train import build_train_step, synthetic_batch
from repro_torch.tree import leaves


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-width", action="store_true",
                    help="keep the arch's real width (default: reduced)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--fail-prob", type=float, default=0.02,
                    help="injected Lambda failure probability")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, n_layers=args.layers * cfg.pattern_period)
    dev = resolve_device(args.device)
    params = M.init_model(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")
    opt = adamw_init(params)
    step = build_train_step(cfg, AdamWConfig(lr=args.lr))

    os.makedirs(args.ckpt_dir, exist_ok=True)
    ckpt_path = os.path.join(args.ckpt_dir, f"{cfg.name}.npz")
    writers = []

    def init_fn():
        # elastic resume: pick up the latest checkpoint if one exists
        if os.path.exists(ckpt_path):
            state, step0 = ckpt.restore(ckpt_path, {"params": params, "opt": opt})
            print(f"resumed from checkpoint @ step {step0}")
            return (state["params"], state["opt"])
        return (params, opt)

    losses = []

    def step_fn(state, i):
        p, o = state
        batch = synthetic_batch(cfg, args.batch, args.seq, seed=i, device=dev)
        p, o, m = step(p, o, batch)
        loss = float(m["loss"])
        losses.append((i, loss))
        return (p, o), {"loss": loss}

    def checkpoint_fn(state, i):
        p, o = state
        writers.append(ckpt.save(ckpt_path, {"params": p, "opt": o}, step=i, async_=True))
        return f"ckpt@{i}"

    dag, final_key, metric_keys = build_training_workflow(
        n_steps=args.steps, step_fn=step_fn, init_fn=init_fn,
        checkpoint_fn=checkpoint_fn, checkpoint_every=args.ckpt_every)

    t0 = time.perf_counter()  # lint: allow(REPRO001)
    res = run_training_workflow(
        dag, final_key, metric_keys,
        EngineConfig(faults=FaultConfig(task_failure_prob=args.fail_prob,
                                        max_retries=2, seed=1),
                     job_timeout_s=24 * 3600.0))
    dt = time.perf_counter() - t0  # lint: allow(REPRO001)
    for w in writers:
        w.join()

    losses.sort()
    shown = dict(losses)
    first, last = losses[0][1], losses[-1][1]
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    for i in sorted(shown)[:: max(1, args.steps // 10)]:
        print(f"  step {i:4d}  loss {shown[i]:.4f}")
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    print(f"checkpoint: {ckpt_path} (step {ckpt.latest_step(ckpt_path)})")
    return {"report": res.report, "final_state": res.report.results[final_key],
            "losses": losses, "seconds": dt, "checkpoint": ckpt_path,
            "fault_stats": res.report.fault_stats}


if __name__ == "__main__":
    main()
