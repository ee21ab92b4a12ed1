"""The control, the plain reference put in the program's place with every
product's operands rounded to float8 e4m3 (the precision below the cells'
bfloat16), comes out not correct against the cells' committed limits; the
program beside it comes out correct. At a size a CPU test can hold: on the
card, at the cells' own sizes, ``portbench/calibrate.py`` reads the same."""
from __future__ import annotations

import pytest
import torch

from portbench.kinds import serve as S
from portbench.kinds import train as T
from portbench.reference import lm as ref
from portbench.tests.conftest import tiny_cell, tiny_config
from portbench.tests.test_portbench_faults import full_spread_logits  # noqa: F401

CPU = torch.device("cpu")


def passes(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= lim["limit"] for k, lim in limits.items())


@pytest.mark.parametrize("workload,micro", [("mixtral_8x7b.train_accum8", 2),
                                            ("mixtral_8x7b.train_b4s512", 1)])
def test_training_control_fails(workload, micro):
    cell = tiny_cell(workload, tiny_config("mixtral_8x7b", d_model=256, n_layers=1, dtype="float32"),
                     batch=8, seq=64, microbatches=micro)
    c, tr = cell["config"], cell["traffic"]
    want = T.reference_steps(c, tr, 23, CPU, ref.Precision("fp32"))
    prog = T.Program(c, tr, 23, CPU)
    while prog.steps_done < tr["checked_steps"]:
        prog.job()
    program = T.compare(prog.first_steps(), want)
    control = T.compare(T.reference_steps(c, tr, 23, CPU, ref.Precision("fp8")), want)
    assert passes(program, cell["limits"]), program
    assert not passes(control, cell["limits"]), control


def test_serving_control_fails(full_spread_logits):  # noqa: F811
    cell = tiny_cell("jamba_1_5_large_398b.serve_b256", batch=8, prompt_len=4, gen_len=4)
    c, tr = cell["config"], cell["traffic"]
    prog = S.Program(c, tr, 29, CPU)
    jobs = [prog.job(j) for j in range(2)]
    g = S.gaps(c, tr, prog.params, jobs, ref.Precision("fp8"), CPU)
    assert passes({"mean_gap": g["served"].mean().item()}, cell["limits"])
    assert not passes({"mean_gap": g["control"].mean().item()}, cell["limits"]), g["control"]
