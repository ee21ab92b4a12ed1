"""Readings that set a latent-attention serving cell's limits, as
``calibrate.py`` takes them for the other serving cells: the program's number
over many seeds, the fp8 control's (the plain reference with every product's
operands rounded to float8 e4m3, the precision below the configuration's
bfloat16), a bf16 witness, and each planted fault's (a decode step that leaves
the cache as it was, half of the batch served and copied over the other half,
the last served token of every sequence altered), in one process on the card.
Every fault is planted in the path the window times: the program's CUDA
graphs of the decode step, captured anew with the fault in them.

    python3 portbench/calibrate_mla.py --workload deepseek_v3.serve_b256 \
        --seeds 1,2,... --control-seeds 1,2,3 [--out FILE]

Each reading is one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import calibrate as K  # noqa: E402
from portbench import harness as H  # noqa: E402


@contextlib.contextmanager
def cache_unchanged():
    """Every decode step, graphed or eager, run on a copy of the cache: the
    cache stays as it was. The program's graphs are captured anew inside."""
    from repro_torch.models import model as M
    from repro_torch.runtime.serve import clear_decode_graphs
    from repro_torch.tree import map_tree

    step = M.decode_step

    def frozen(params, cfg, cache, token, pos):
        logits, _ = step(params, cfg, map_tree(lambda t: t.clone(), cache), token, pos)
        return logits, cache

    clear_decode_graphs()
    try:
        with K.patched(M, "decode_step", frozen):
            yield
    finally:
        clear_decode_graphs()


def readings(cell, seeds, control_seeds, device, emit):
    from repro_torch.launch.serve import serve

    from portbench.kinds import serve_mla as D
    from portbench.kinds import train as T
    from portbench.reference.lm import Precision

    c, tr = cell["config"], cell["traffic"]
    for seed in seeds:
        t0 = time.perf_counter()
        prog = D.Program(c, tr, seed, device)
        jobs = [prog.job(j) for j in range(tr["checked_jobs"])]
        control = seed in control_seeds
        g = D.gaps(c, tr, prog.params, jobs, Precision("fp8" if control else "fp32"), device)
        emit({"seed": seed, "kind": "program", "numbers": K.numbers(g["served"]),
              "gaps": K.stats(g["served"]), "s": time.perf_counter() - t0})
        if control:
            emit({"seed": seed, "kind": "control_fp8", "numbers": K.numbers(g["control"]),
                  "gaps": K.stats(g["control"])})
            w = D.gaps(c, tr, prog.params, jobs, Precision("bf16"), device)
            emit({"seed": seed, "kind": "witness_reference_bf16",
                  "numbers": K.numbers(w["control"]), "gaps": K.stats(w["control"])})
            faults = {"fault_cache_unchanged": (cache_unchanged, None),
                      "fault_half_batch": (contextlib.nullcontext, K.half_served(serve)),
                      "fault_token_altered": (contextlib.nullcontext,
                                              K.token_altered(serve, c["vocab_size"]))}
            timed = prog.serve
            for name, (ctx, serve_fn) in faults.items():
                with ctx():
                    prog.serve = serve_fn or serve
                    bad = [prog.job(j) for j in range(tr["checked_jobs"])]
                prog.serve = timed
                g = D.gaps(c, tr, prog.params, bad, Precision("fp32"), device)
                emit({"seed": seed, "kind": name, "numbers": K.numbers(g["served"]),
                      "gaps": K.stats(g["served"])})
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
        line = json.dumps({"workload": args.workload, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    readings(cell, seeds, control, device, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
