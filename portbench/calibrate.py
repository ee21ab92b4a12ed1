"""Readings that set a cell's limits: the program's numbers over many seeds,
the control's, and each planted fault's, at the cell's own size, in one
process on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--out FILE]

The control is the plain reference put in the program's place and run with
its products' operands rounded to float8 e4m3, the precision below the
configuration's bfloat16. The faults, planted in the program's path, are
those the cell can have: for training half of each microbatch left out (its
mean taken over the rest), and one leaf's gradient doubled before AdamW
gets it; for serving a decode step that leaves the cache as it was, half of
the batch served and copied over the other half, and one served token
altered (the last of every sequence). A training step that returns its
state unchanged reads 1 on the first-gradient number by construction; it
is run for what the other numbers read. Each reading is one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness as H  # noqa: E402


# ---------------------------------------------------------------------------
# Faults, each a context in which the program's path is broken
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def half_batch_step(cfg, opt, n_microbatches=1):
    """The program's step over the first half of each microbatch's rows."""
    from repro_torch.runtime.train import build_train_step

    step = build_train_step(cfg, opt, n_microbatches=n_microbatches)

    def train_step(params, opt_state, batch):
        import torch

        half = {k: torch.cat([c[:max(1, c.shape[0] // 2)] for c in v.chunk(n_microbatches)])
                for k, v in batch.items()}
        return step(params, opt_state, half)

    return train_step


def unchanged_step(cfg, opt, n_microbatches=1):
    """The program's step, its new state thrown away: the state as it came."""
    from repro_torch.runtime.train import build_train_step

    step = build_train_step(cfg, opt, n_microbatches=n_microbatches)

    def train_step(params, opt_state, batch):
        _, _, metrics = step(params, opt_state, batch)
        return params, opt_state, metrics

    return train_step


def grad_doubled():
    """AdamW given the last leaf's gradient twice over."""
    from repro_torch.runtime import train as rt
    from repro_torch.tree import leaves, unflatten

    update = rt.adamw_update

    def doubled(grads, *args, **kw):
        g = leaves(grads)
        return update(unflatten(grads, g[:-1] + [2 * g[-1]]), *args, **kw)

    return patched(rt, "adamw_update", doubled)


def cache_unchanged():
    """A decode step run on a copy of the cache: the cache stays as it was."""
    from repro_torch.launch import serve as ls
    from repro_torch.tree import map_tree

    build = ls.build_serve_step

    def build_frozen(cfg):
        step = build(cfg)

        def serve_step(params, cache, batch):
            logits, _ = step(params, map_tree(lambda t: t.clone(), cache), batch)
            return logits, cache

        return serve_step

    return patched(ls, "build_serve_step", build_frozen)


def half_served(serve):
    """``serve`` over half of the batch, its tokens copied over the rest."""
    import numpy as np

    def run(cfg, params, *, batch, **kw):
        rep = serve(cfg, params, batch=batch // 2, **kw)
        toks = rep.results["summary"]["tokens"]
        rep.results["summary"]["tokens"] = [np.concatenate([t, t]) for t in toks]
        return rep

    return run


def token_altered(serve, vocab):
    """``serve`` with the last served token of every sequence changed."""
    def run(cfg, params, **kw):
        rep = serve(cfg, params, **kw)
        t = rep.results["summary"]["tokens"][0]
        t[:, -1] = (t[:, -1] + 1) % vocab
        return rep

    return run


# ---------------------------------------------------------------------------
# Readings
# ---------------------------------------------------------------------------

def train_readings(cell, seeds, control_seeds, device, emit):
    from repro_torch.tree import paths

    from portbench.kinds import train as T
    from portbench.reference import lm as ref

    c, tr = cell["config"], cell["traffic"]
    names = ["".join(p) for p, _ in paths(H.weight_shapes(c, H.model_config(c)))]

    def compare(got, want):
        gaps = T.leaf_gaps(got, want)
        return {"numbers": T.compare(got, want),
                "leaves": {k: dict(zip(names, v)) for k, v in gaps.items()}}

    def program(seed, make_step=None):
        prog = T.Program(c, tr, seed, device, make_step)
        while prog.steps_done < tr["checked_steps"]:
            prog.job()
        got = prog.first_steps()
        del prog
        T.free(device)
        return got

    for seed in seeds:
        t0 = time.perf_counter()
        got = program(seed)
        want = T.reference_steps(c, tr, seed, device, ref.Precision("fp32"))
        T.free(device)
        emit({"seed": seed, "kind": "program", **compare(got, want),
              "losses": got["losses"], "ref_losses": want["losses"],
              "s": time.perf_counter() - t0})
        if seed not in control_seeds:
            continue
        ctl = T.reference_steps(c, tr, seed, device, ref.Precision("fp8"))
        T.free(device)
        emit({"seed": seed, "kind": "control_fp8", **compare(ctl, want), "losses": ctl["losses"],
              "ref_losses": want["losses"]})
        del ctl
        wit = T.reference_steps(c, tr, seed, device, ref.Precision("bf16"))
        T.free(device)
        emit({"seed": seed, "kind": "witness_reference_bf16", **compare(wit, want),
              "losses": wit["losses"]})
        del wit
        emit({"seed": seed, "kind": "fault_half_batch",
              **compare(program(seed, half_batch_step), want)})
        with grad_doubled():
            emit({"seed": seed, "kind": "fault_grad_doubled",
                  **compare(program(seed), want)})
        emit({"seed": seed, "kind": "fault_state_unchanged",
              **compare(program(seed, unchanged_step), want)})


def numbers(t) -> dict:
    return {"mean_gap": t.mean().item()}


def stats(t) -> dict:
    """The spread of every position's gap: its widest, mean, 99th and 90th
    percentiles, and the share of positions off the reference's best."""
    import torch

    q = torch.quantile(t.float(), torch.tensor([0.9, 0.99]))
    return {"max": t.max().item(), "mean": t.mean().item(), "p90": q[0].item(),
            "p99": q[1].item(), "off_best": (t > 1e-6).float().mean().item()}


def serve_readings(cell, seeds, control_seeds, device, emit):
    from repro_torch.launch.serve import serve

    from portbench.kinds import serve as S
    from portbench.kinds import train as T
    from portbench.reference import lm as ref

    c, tr = cell["config"], cell["traffic"]
    for seed in seeds:
        t0 = time.perf_counter()
        prog = S.Program(c, tr, seed, device)
        jobs = [prog.job(j) for j in range(tr["checked_jobs"])]
        control = seed in control_seeds
        g = S.gaps(c, tr, prog.params, jobs, ref.Precision("fp8" if control else "fp32"), device)
        emit({"seed": seed, "kind": "program", "numbers": numbers(g["served"]),
              "gaps": stats(g["served"]), "s": time.perf_counter() - t0})
        if control:
            emit({"seed": seed, "kind": "control_fp8", "numbers": numbers(g["control"]),
                  "gaps": stats(g["control"])})
            w = S.gaps(c, tr, prog.params, jobs, ref.Precision("bf16"), device)
            emit({"seed": seed, "kind": "witness_reference_bf16",
                  "numbers": numbers(w["control"]), "gaps": stats(w["control"])})
            faults = {"fault_cache_unchanged": (cache_unchanged, None),
                      "fault_half_batch": (contextlib.nullcontext, half_served(serve)),
                      "fault_token_altered": (contextlib.nullcontext,
                                              token_altered(serve, c["vocab"]))}
            for name, (ctx, serve_fn) in faults.items():
                with ctx():
                    prog.serve = serve_fn or serve
                    bad = [prog.job(j) for j in range(tr["checked_jobs"])]
                prog.serve = serve
                g = S.gaps(c, tr, prog.params, bad, ref.Precision("fp32"), device)
                emit({"seed": seed, "kind": name, "numbers": numbers(g["served"]),
                      "gaps": stats(g["served"])})
        del prog, jobs
        T.free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    H.cache_dirs()
    H.program_path()
    cell = H.cell(args.workload)
    H.require_cards(cell["workload"]["chips"])
    import torch

    from portbench.reference import lm as ref

    ref.no_tf32()
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = {"workload": args.workload, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    kind = cell["traffic"]["kind"]
    (train_readings if kind == "train" else serve_readings)(cell, seeds, control, device, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
