"""A short run of a cell on the card, as the benchmark's command gives it:
one JSON line with the contract's keys, correct, from a CUDA device. Skips
without one."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness as H


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cuda, trace):
    out = subprocess.run([sys.executable, str(H.HERE / "run.py"), "--workload",
                          "mixtral_8x7b.train_b4s512", "--seed", str(2**31 + 3), "--seconds",
                          "2", "--trace", str(trace)], capture_output=True, text=True,
                         check=True, cwd=H.ROOT)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    cell = H.cell("mixtral_8x7b.train_b4s512")
    want = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
