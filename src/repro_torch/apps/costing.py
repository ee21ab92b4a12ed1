"""Shared per-task compute costing for the workload DAG builders.

Workloads price a task's compute from its analytic FLOPs (the paper's
task-granularity methodology, Fig. 4): ``ms_per_flop`` charges simulated
ms on the engine clock via ``simulated_compute`` (free wall-clock under
the virtual clock, scaled real sleep in real-time mode);
``sleep_per_flop`` is the seed's real-sleep knob (seconds per flop),
kept for real-time cross-checks.
"""
from __future__ import annotations

import time
from typing import Any, Callable

from repro_torch.core.simclock import simulated_compute


def flop_costed(fn: Callable[..., Any], flops: float,
                sleep_per_flop: float = 0.0,
                ms_per_flop: float = 0.0) -> Callable[..., Any]:
    """Wrap ``fn`` to charge ``flops`` worth of simulated compute (and/or
    legacy real sleep) before running. Returns ``fn`` unwrapped when both
    knobs are off."""
    if sleep_per_flop <= 0 and ms_per_flop <= 0:
        return fn

    def wrapped(*a: Any, **kw: Any) -> Any:
        if ms_per_flop > 0:
            simulated_compute(flops * ms_per_flop)
        if sleep_per_flop > 0:
            time.sleep(flops * sleep_per_flop)  # lint: allow(REPRO001) — opt-in real-sleep knob, off by default
        return fn(*a, **kw)

    wrapped.__name__ = getattr(fn, "__name__", "task")
    return wrapped
