"""Cluster workflow orchestration — the paper's engine driving training.

The training *workflow* (not the inner jitted step) is expressed as a
WUKONG DAG: per-step tasks chain ``data_shard -> train_step -> metrics``,
with periodic checkpoint fan-outs. The DAG engine supplies the paper's
fault-tolerance machinery for free: a failed step task is re-invoked
(Lambda-retry analog), stragglers can be speculatively duplicated, and
idempotent KV writes make both safe. On a real multi-pod deployment each
Task Executor maps to one pod's coordinator process.

This is the TPU adaptation of the paper's decentralized scheduling to the
layer where JAX does *not* already schedule: between jitted regions
(DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core import (
    DAG,
    EngineConfig,
    GraphBuilder,
    JobReport,
    WukongEngine,
)


@dataclasses.dataclass
class TrainRunResult:
    report: JobReport
    final_state_key: str
    metric_keys: list[str]


def build_training_workflow(
    n_steps: int,
    step_fn: Callable[[Any, int], tuple[Any, Any]],
    init_fn: Callable[[], Any],
    checkpoint_fn: Callable[[Any, int], Any] | None = None,
    checkpoint_every: int = 0,
    data_fn: Callable[[int], Any] | None = None,
) -> tuple[DAG, str, list[str]]:
    """Unrolled training chain as a DAG.

    ``step_fn(state, batch_or_step) -> (state, metrics)``. Checkpoint
    tasks fan out of the main chain (they never block the next step —
    async checkpointing expressed as graph structure).
    """
    g = GraphBuilder()
    state = g.add(init_fn, name="train/init")
    metric_keys: list[str] = []

    def make_step(i: int):
        def run_step(st, batch=None):
            new_state, metrics = step_fn(st, batch if batch is not None
                                         else i)
            return {"state": new_state, "metrics": metrics}

        run_step.__name__ = f"train_step_{i}"
        return run_step

    def get_state(d):
        return d["state"]

    def get_metrics(d):
        return d["metrics"]

    for i in range(n_steps):
        args = [state]
        if data_fn is not None:
            batch = g.add(lambda i=i: data_fn(i), name=f"data/shard-{i}")
            args.append(batch)
        out = g.add(make_step(i), *args, name=f"train/step-{i}")
        state = g.add(get_state, out, name=f"train/state-{i}")
        mk = f"train/metrics-{i}"
        g.add(get_metrics, out, name=mk)
        metric_keys.append(mk)
        if (checkpoint_fn is not None and checkpoint_every
                and (i + 1) % checkpoint_every == 0):
            g.add(lambda st, i=i: checkpoint_fn(st, i),
                  state, name=f"ckpt/step-{i}")
    # alias the terminal state so it is a DAG root even when a checkpoint
    # task also consumes it
    g.add(lambda s: s, state, name="train/final")
    return g.build(), "train/final", metric_keys


def run_training_workflow(
    dag: DAG, final_key: str, metric_keys: list[str],
    engine_config: EngineConfig | None = None,
) -> TrainRunResult:
    report = WukongEngine(engine_config or EngineConfig()).compute(dag)
    return TrainRunResult(report=report, final_state_key=final_key,
                          metric_keys=metric_keys)
