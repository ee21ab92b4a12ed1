"""Run one benchmark cell on the card and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is ``BENCHMARK.json``'s workload ``<name>``; its configuration,
traffic mix, limits and metric readers are found by name under
``portbench/`` (see ``harness.py``). With ``--trace 0`` the line's metrics
are the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, read from a profiled stretch after the window and from the window
itself, and the line adds the device's busy time and a breakdown.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which are also the last lines of standard
error. Without the CUDA devices the cell asks for, or with JAX or the JAX
package loaded once the window has closed, it prints no result and exits
with a code other than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness as H  # noqa: E402


def result(cell: dict, rec: dict, trace: bool) -> dict:
    """The result line of a run's record."""
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = H.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": rec["numbers"][k], "limit": lim["limit"]}
              for k, lim in cell["limits"].items()}
    correct = rec["failed"] == 0 and rec["attempted"] > 0 and all(
        math.isfinite(x["value"]) and x["value"] <= x["limit"] for x in checks.values())
    device = dict(rec["device"])
    out = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if trace:
        t = rec["trace"]
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    H.cache_dirs()
    H.program_path()
    cell = H.cell(args.workload)
    H.require_cards(cell["workload"]["chips"])
    import torch

    from portbench.reference import lm as ref

    ref.no_tf32()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = H.driver(cell["traffic"]["kind"]).run(cell, args.seed, args.seconds,
                                                bool(args.trace), device, T_START)
    found = H.forbidden_modules()
    if found:
        print(f"portbench: loaded once the window closed: {', '.join(found)}", file=sys.stderr)
        return 3
    out = result(cell, rec, bool(args.trace))
    print(json.dumps(out), flush=True)
    print(H.checks_text(out["checks"]), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
