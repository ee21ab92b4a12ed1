"""Training cells: the program's training workflow, driven through its engine.

One job is ``runtime.orchestrator.build_training_workflow`` and
``run_training_workflow`` over ``steps_per_job`` steps, each step
``runtime.train.build_train_step(cfg, AdamWConfig(**adamw), microbatches)``
on ``batch`` x ``seq`` rows drawn on the card from the seed and the step's
index. Jobs are chained, one at a time (a closed loop): each job's
``init_fn`` returns the state the previous job ended with, so one training
state is built in set-up and trained through set-up, the window and the
traced stretch alike.

Set-up runs the first ``checked_steps`` steps through the same jobs and
records what the comparison reads: each step's loss, the first step's
gradient as AdamW got it (its first moment over 1 - b1, the clipping undone
by the step's reported gradient norm), kept on the host, and every leaf's
change over those steps. Once the window and the trace are done and the
program's state is freed, the plain reference trains float32 copies of the
same weights on the same rows for those steps, and ``compare``'s numbers
are held to ``limits/<cell>.json``.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Any, Callable

import torch

from portbench import harness as H
from portbench.reference import lm as ref
from portbench.trace import Stretch

FEED_STREAM = 2


def feed(c: dict, tr: dict, seed: int, step: int, device) -> dict:
    """Step ``step``'s rows: tokens and their next tokens, uniform over the
    vocabulary, from a generator on ``device`` seeded by the run's seed and
    the step."""
    gen = torch.Generator(device=device)
    gen.manual_seed(H.derive_seed(seed, FEED_STREAM, step))
    x = torch.randint(0, c["vocab"], (tr["batch"], tr["seq"] + 1), generator=gen,
                      device=device)
    return {"tokens": x[:, :-1].contiguous(), "labels": x[:, 1:].contiguous()}


def norms(ts) -> list[float]:
    return [t.float().norm().item() for t in ts]


class Program:
    """The program's side of a training cell: its one state, its step, and the
    chained jobs that train it. ``make_step`` stands in for
    ``build_train_step`` (a test or a control plants a fault there)."""

    def __init__(self, c: dict, tr: dict, seed: int, device, make_step: Callable | None = None):
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.runtime.train import build_train_step

        self.c, self.tr, self.seed, self.device = c, tr, seed, device
        self.cfg = H.model_config(c)
        params = H.make_params(c, self.cfg, seed, device)
        self.state = (params, adamw_init(params))
        del params
        # The step leaves reference cycles that hold a state's parameters until
        # the collector runs: every job ends in a collection, and what set-up
        # made so far is frozen out of the collector's walk, which is then short.
        gc.collect()
        gc.freeze()
        self.adamw = AdamWConfig(**tr["adamw"])
        self.step = (make_step or build_train_step)(self.cfg, self.adamw,
                                                    n_microbatches=tr["microbatches"])
        self.steps_done = 0
        self.payload_s: list[float] = []
        self.losses: list[float] = []
        self.first_grads: list[torch.Tensor] = []
        self.first_grad_norms: list[float] = []
        self.change_norms: list[float] = []

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, st, i: int):
        from repro_torch.tree import leaves

        batch = feed(self.c, self.tr, self.seed, i, self.device)
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench: train step"):
            p, o, m = self.step(st[0], st[1], batch)
            loss, gnorm = m["loss"].item(), m["grad_norm"].item()
            self.sync()
        self.payload_s.append(time.perf_counter() - t0)
        if i < self.tr["checked_steps"]:
            self.losses.append(loss)
            if i == 0:   # AdamW's first moment is (1 - b1) times the clipped gradient
                scale = (1 - self.adamw.b1) * min(1.0, self.adamw.clip_norm / (gnorm + 1e-9))
                self.first_grads = [(m / scale).cpu() for m in leaves(o["mu"])]
                self.first_grad_norms = [n / scale for n in norms(leaves(o["mu"]))]
            if i == self.tr["checked_steps"] - 1:
                w0 = leaves(H.make_params(self.c, self.cfg, self.seed, self.device))
                self.change_norms = [(a.float() - b.float()).norm().item()
                                     for a, b in zip(leaves(p), w0, strict=True)]
                del w0
        return (p, o), {"loss": loss}

    def job(self) -> None:
        """One workflow job of ``steps_per_job`` steps from the held state."""
        from repro_torch.core import EngineConfig, FaultConfig
        from repro_torch.runtime.orchestrator import (
            build_training_workflow,
            run_training_workflow,
        )

        # the job's graph holds init_fn in reference cycles: the state goes
        # through a holder that is emptied after the job
        held = {"state": self.state}
        self.state = None
        first = self.steps_done
        dag, final_key, metric_keys = build_training_workflow(
            n_steps=self.tr["steps_per_job"], step_fn=lambda st, j: self._step(st, first + j),
            init_fn=lambda: held["state"])
        with torch.profiler.record_function("portbench: training job"):
            res = run_training_workflow(dag, final_key, metric_keys, EngineConfig(
                faults=FaultConfig(task_failure_prob=0.0), job_timeout_s=3600.0))
        held.clear()
        self.state = res.report.results[final_key]
        self.steps_done += self.tr["steps_per_job"]
        del res, dag
        gc.collect()

    def first_steps(self) -> dict:
        """What the comparison reads, from set-up's steps."""
        return {"losses": self.losses, "grad_norms": self.first_grad_norms,
                "change_norms": self.change_norms, "grads": self.first_grads}

    def launches(self) -> dict:
        from repro_torch.kernels import ops

        return {"fwd": ops.flash_attention.launches, "bwd": ops.flash_attention.bwd_launches}


def reference_steps(c: dict, tr: dict, seed: int, device, prec: ref.Precision) -> dict:
    """The plain reference's first ``checked_steps`` steps from the same
    weights and rows: losses, the first gradient's norm per leaf, each
    leaf's change."""
    cfg = H.model_config(c)
    w0 = H.make_params(c, cfg, seed, device)
    trainer = ref.Trainer(w0, c, tr["adamw"], prec)
    w0 = ref.leaves(w0)
    losses = []
    n = tr["microbatches"]
    for i in range(tr["checked_steps"]):
        b = feed(c, tr, seed, i, device)
        micro = list(zip(b["tokens"].chunk(n), b["labels"].chunk(n)))
        losses.append(trainer.step(micro))
    change = [(p - w.float()).norm().item() for p, w in zip(trainer.p, w0, strict=True)]
    return {"losses": losses, "grad_norms": trainer.first_grad_norms, "change_norms": change,
            "grads": trainer.first_grads}


def leaf_gaps(got: dict, want: dict) -> dict[str, list[float]]:
    """Each leaf's gap between the two first-gradient norms and between the two
    changes, against the reference's norm of that leaf or of the median leaf,
    whichever is larger. A leaf whose reference gradient is under a thousandth
    of the median leaf's moves by rounding alone: its change reads 0."""
    g_med = statistics.median(want["grad_norms"])
    grad = [abs(a - b) / max(b, g_med)
            for a, b in zip(got["grad_norms"], want["grad_norms"], strict=True)]
    moving = [g >= 1e-3 * g_med for g in want["grad_norms"]]
    c_med = statistics.median(c for c, m in zip(want["change_norms"], moving) if m)
    change = [abs(a - b) / max(b, c_med) if m else 0.0
              for a, b, m in zip(got["change_norms"], want["change_norms"], moving, strict=True)]
    return {"grad": grad, "change": change}


def grad_diff(got: list[torch.Tensor], want: list[torch.Tensor]) -> float:
    """The norm of the difference of the two first gradients over the norm of
    the reference's, over every leaf together."""
    num = den = 0.0
    for a, b in zip(got, want, strict=True):
        num += (a.to(b.device) - b).float().square().sum().item()
        den += b.float().square().sum().item()
    return (num / den) ** 0.5


def compare(got: dict, want: dict) -> dict[str, float]:
    """The numbers: the largest relative gap of a step's loss, the worst leaf's
    gaps (``leaf_gaps``) of the first gradient and of the change, and the
    first gradients' relative difference (``grad_diff``)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"], strict=True))
    gaps = leaf_gaps(got, want)
    return {"loss": loss, "grad": max(gaps["grad"]), "change": max(gaps["change"]),
            "grad_diff": grad_diff(got["grads"], want["grads"])}


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        make_step: Callable | None = None) -> dict[str, Any]:
    """Set-up, the window, the traced stretch (``trace``), then the comparison.
    Returns the record that the metric readers read."""
    c, tr = cell["config"], cell["traffic"]
    prog = Program(c, tr, seed, device, make_step)
    while prog.steps_done < tr["checked_steps"]:
        prog.job()
    got = prog.first_steps()
    setup_s = time.perf_counter() - t_start

    first, k0 = prog.steps_done, len(prog.payload_s)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        prog.job()
    window_s = time.perf_counter() - t0
    rec = {"kind": "train", "config": c, "traffic": tr, "setup_s": setup_s,
           "window_s": window_s, "steps": prog.steps_done - first,
           "payload_s": sum(prog.payload_s[k0:]), "trace": None}
    rec["tokens"] = rec["steps"] * tr["batch"] * tr["seq"]
    if trace:
        before, s0 = prog.launches(), prog.steps_done
        with Stretch(host=False) as st:
            while prog.steps_done - s0 < tr["trace_steps"]:
                prog.job()
        rec["trace"] = st.read()
        rec["trace_steps"] = prog.steps_done - s0
        after = prog.launches()
        rec["flash_launches"] = {k: after[k] - before[k] for k in after}
        with Stretch(host=True) as st:
            prog.job()
        rec["trace"]["idle_gaps"] = st.read()["idle_gaps"]
    rec["device"] = H.device_record(cell["workload"]["chips"]) if device.type == "cuda" else None
    rec["attempted"], rec["failed"] = rec["steps"], 0
    del prog
    free(device)

    want = reference_steps(c, tr, seed, device, ref.Precision("fp32"))
    rec["numbers"] = compare(got, want)
    free(device)
    return rec
