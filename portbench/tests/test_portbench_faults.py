"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(set-up, the window, the comparison with the reference, the result line) at
a size a CPU test can hold, in the cell's dtype and against the cell's
committed limits, with one fault the cell can have planted in the program's
path; a sound run beside them comes out correct."""
from __future__ import annotations

import contextlib
import time

import pytest
import torch

from portbench import calibrate as K
from portbench.kinds import serve as S
from portbench.kinds import train as T
from portbench.run import result
from portbench.tests.conftest import tiny_cell, tiny_config

CPU = torch.device("cpu")
TRAIN_FAULTS = {
    "sound": (None, contextlib.nullcontext),
    "state_unchanged": (K.unchanged_step, contextlib.nullcontext),
    "half_batch": (K.half_batch_step, contextlib.nullcontext),
    "grad_doubled": (None, K.grad_doubled),
}


def outcome(cell, rec):
    rec["device"] = {"platform": "gpu"}
    return result(cell, rec, trace=False)


@pytest.mark.parametrize("fault", list(TRAIN_FAULTS))
@pytest.mark.parametrize("workload,micro", [("mixtral_8x7b.train_accum8", 2),
                                            ("mixtral_8x7b.train_b4s512", 1)])
def test_training_fault(workload, micro, fault):
    make_step, ctx = TRAIN_FAULTS[fault]
    cell = tiny_cell(workload, tiny_config("mixtral_8x7b", d_model=128, n_layers=1, dtype="float32"),
                     batch=8, seq=32, microbatches=micro)
    with ctx():
        rec = T.run(cell, 2**31 + 17, 0.2, False, CPU, time.perf_counter(), make_step)
    out = outcome(cell, rec)
    assert out["correct"] is (fault == "sound"), out["checks"]


FULL_WIDTH = 8192      # jamba's d_model: the tiny model's head is drawn to give its logits' spread


@pytest.fixture
def full_spread_logits(monkeypatch):
    """The tiny model's head drawn wider, so that its logits spread as the full
    model's do (0.02·√8192) and the cell's limit, set in logits, applies."""
    from portbench import harness as H

    rule = H._init_rule

    def wide_head(path, shape):
        kind, val = rule(path, shape)
        if path[-1] == "['lm_head']":
            val *= (FULL_WIDTH / shape[-2]) ** 0.5
        return kind, val

    monkeypatch.setattr(H, "_init_rule", wide_head)


SERVE_FAULTS = {
    "sound": (contextlib.nullcontext, None),
    "cache_unchanged": (K.cache_unchanged, None),
    "half_batch": (contextlib.nullcontext, K.half_served),
    "token_altered": (contextlib.nullcontext, "altered"),
}


@pytest.mark.parametrize("fault", list(SERVE_FAULTS))
def test_serving_fault(fault, full_spread_logits):
    from repro_torch.launch.serve import serve

    ctx, wrap = SERVE_FAULTS[fault]
    cell = tiny_cell("jamba_1_5_large_398b.serve_b256", batch=8, prompt_len=4, gen_len=4,
                     checked_jobs=2)
    serve_fn = (K.token_altered(serve, cell["config"]["vocab"]) if wrap == "altered"
                else wrap(serve) if wrap else None)
    with ctx():
        rec = S.run(cell, 2**31 + 19, 0.5, False, CPU, time.perf_counter(), serve_fn)
    out = outcome(cell, rec)
    assert out["correct"] is (fault == "sound"), out["checks"]
