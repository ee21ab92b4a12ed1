"""Serving cells: the program's serving entry, one engine job a request batch.

Each job is ``launch.serve.serve(cfg, params, requests=1, batch, prompt_len,
gen_len, seed)``: ``batch`` sequences of ``prompt_len`` prompt tokens drawn
from the job's seed, ingested on the decode path, then ``gen_len`` greedy
tokens. Jobs are submitted back to back, one outstanding (a closed loop: an
offline batch queue). A request is one sequence; it is due when its job is
submitted and completes when ``serve`` returns, since a job's results reach
its client only then.

After the window the plain reference runs, teacher-forced, over a sample of
the window's jobs drawn from the seed: each prompt with its served tokens,
in float32 on the same weights. The number compared is the mean, over every
served token of the sample, of how far the token's reference logit lies
below the reference's best at its position (0 where they agree).
"""
from __future__ import annotations

import gc
import random
import time
from typing import Any, Callable

import numpy as np
import torch

from portbench import harness as H
from portbench.reference import lm as ref
from portbench.trace import Stretch

JOB_STREAM = 3
WARM_JOB = -1


def job_seed(seed: int, j: int) -> int:
    return H.derive_seed(seed, JOB_STREAM, j + 1)


def prompts(c: dict, tr: dict, s: int) -> np.ndarray:
    """The prompts the program draws for request 0 of a job seeded ``s``
    (``launch.serve.request_prompts``'s rule, restated here)."""
    rng = np.random.default_rng([s, 0])
    return rng.integers(0, c["vocab"], size=(tr["batch"], tr["prompt_len"]), dtype=np.int64)


class Program:
    """The program's side of a serving cell: the weights, and one job at a
    time through ``serve``, which ``serve_fn`` stands in for (a test or a
    control plants a fault there)."""

    def __init__(self, c: dict, tr: dict, seed: int, device, serve_fn: Callable | None = None):
        from repro_torch.launch.serve import serve

        self.c, self.tr, self.seed, self.device = c, tr, seed, device
        self.cfg = H.model_config(c)
        self.params = H.make_params(c, self.cfg, seed, device)
        self.serve = serve_fn or serve

    def job(self, j: int) -> dict:
        s = job_seed(self.seed, j)
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench: serving job"):
            rep = self.serve(self.cfg, self.params, requests=1, batch=self.tr["batch"],
                             prompt_len=self.tr["prompt_len"], gen_len=self.tr["gen_len"],
                             seed=s, device=self.device)
        t1 = time.perf_counter()
        summary = rep.results["summary"]
        tokens = np.asarray(summary["tokens"][0])
        ok = tokens.shape == (self.tr["batch"], self.tr["gen_len"])
        # one request batch: its p99 over one request is that request's decode-loop span
        return {"j": j, "seed": s, "t0": t0, "t1": t1, "decode_s": summary["p99_latency_s"],
                "tokens": tokens, "ok": ok}


def gaps(c: dict, tr: dict, params, jobs: list[dict], prec: ref.Precision, device) -> dict:
    """Over ``jobs``, every served token's gap: how far its float32 reference
    logit lies below the reference's best at its position (``served``), and
    with a lower precision ``prec`` the same of the token that precision
    ranks first (``control``), each flattened over sequences and positions."""
    served, control = [], []
    for job in jobs:
        p = torch.as_tensor(prompts(c, tr, job["seed"]), device=device)
        toks = torch.as_tensor(job["tokens"], device=device)
        want = ref.served_gaps(params, c, p, toks, ref.Precision("fp32"))
        served.append((want.amax(-1) - want.gather(-1, toks[..., None])[..., 0]).flatten())
        if prec.name != "fp32":
            control.append(ref.served_gaps(params, c, p, toks, prec, want)[1].flatten())
        del want
    out = {"served": torch.cat(served).cpu()}
    if control:
        out["control"] = torch.cat(control).cpu()
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        serve_fn: Callable | None = None) -> dict[str, Any]:
    c, tr = cell["config"], cell["traffic"]
    prog = Program(c, tr, seed, device, serve_fn)
    prog.job(WARM_JOB)
    setup_s = time.perf_counter() - t_start

    jobs, j = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        jobs.append(prog.job(j))
        j += 1
    window_s = time.perf_counter() - t0
    done = [x for x in jobs if x["ok"]]
    B = tr["batch"]
    rec = {"kind": "serve", "config": c, "traffic": tr, "setup_s": setup_s,
           "window_s": window_s, "jobs": len(done),
           "tokens": len(done) * B * tr["gen_len"],
           "latencies_s": [x["t1"] - x["t0"] for x in done for _ in range(B)],
           "decode_s": sum(x["decode_s"] for x in done),
           "steps_per_job": tr["prompt_len"] + tr["gen_len"] - 1, "trace": None,
           "attempted": len(jobs) * B, "failed": (len(jobs) - len(done)) * B}
    if trace:
        from repro_torch.kernels import ops

        before = ops.decode_attention.launches
        with Stretch(host=False) as st:
            for k in range(tr["trace_jobs"]):
                prog.job(j + k)
        rec["trace"] = st.read()
        rec["trace_jobs"] = tr["trace_jobs"]
        rec["decode_launches"] = ops.decode_attention.launches - before
        with Stretch(host=True) as st:
            prog.job(j + tr["trace_jobs"])
        rec["trace"]["idle_gaps"] = st.read()["idle_gaps"]
    rec["device"] = H.device_record(cell["workload"]["chips"]) if device.type == "cuda" else None

    params = prog.params
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = random.Random(H.derive_seed(seed, JOB_STREAM, 0))
    sample = rng.sample(done, min(tr["checked_jobs"], len(done)))
    g = gaps(c, tr, params, sample, ref.Precision("fp32"), device)["served"] if sample else None
    rec["numbers"] = {"mean_gap": g.mean().item() if sample else float("inf")}
    return rec
