"""Dynamic (runtime-expanding) tree reduction.

The paper's DAGs are fully known at submit time; Triggerflow-style
workflows are not — a task may discover its fan-out width only after
looking at its inputs. ``dynamic_tree_reduction_dag`` builds the
smallest such workload: a two-leaf seed graph whose ``reduce`` task,
on execution, *returns* an :class:`~repro_torch.core.dag.Expansion` that
fans out into a full pairwise reduction tree over the data it just
received. The engine installs the subgraph mid-job and carries on.

``static_tree_reduction_equivalent`` builds the graph the expansion
produces, statically, key for key (including the synthetic
``reduce/__base1__`` node) — the control arm of the charge-parity
gate: a dynamic run and its static equivalent must produce
bit-identical results AND bit-identical ``charged_ms`` (run both with
``schedule_ship_mbps=inf``; static-schedule shipping is the one cost
that legitimately differs, since the dynamic arm ships pre-expansion
schedules).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dag import (
    DAG,
    EXPAND_BASE,
    DynamicDAG,
    Expansion,
    Task,
    TaskRef,
    expansion_base_key,
)
from repro_torch.core.simclock import simulated_compute

EXPAND_KEY = "reduce"


def _charge(compute_ms: float) -> None:
    if compute_ms > 0:
        simulated_compute(compute_ms)


def _make_half(values: np.ndarray, compute_ms: float):
    def dyn_half() -> np.ndarray:
        _charge(compute_ms)
        return values

    dyn_half.__name__ = "dyn_half"
    return dyn_half


def _make_leaf(i: int, compute_ms: float, ballast: int):
    def rx_leaf(arr: np.ndarray) -> np.ndarray:
        _charge(compute_ms)
        out = np.empty(1 + ballast)
        out[0] = arr[2 * i] + arr[2 * i + 1]
        return out

    rx_leaf.__name__ = "rx_leaf"
    return rx_leaf


def _make_combine(compute_ms: float):
    def rx_combine(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        _charge(compute_ms)
        out = np.empty_like(x)
        out[0] = x[0] + y[0]
        return out

    rx_combine.__name__ = "rx_combine"
    return rx_combine


def _subgraph(n: int, base_key: str, compute_ms: float,
              payload_bytes: int) -> "tuple[list[Task], str]":
    """The reduction tree over a length-``n`` base array, every task
    reading its inputs through ``base_key`` refs (``EXPAND_BASE`` in
    the dynamic arm, the synthetic base key in the static one).
    Returns ``(tasks, final_key)`` in the deterministic order both
    arms share."""
    ballast = max(0, payload_bytes) // 8
    tasks: "list[Task]" = []
    level: "list[str]" = []
    for i in range(n // 2):
        key = f"rx-leaf-{i}"
        tasks.append(Task(key, _make_leaf(i, compute_ms, ballast),
                          (TaskRef(base_key),)))
        level.append(key)
    depth = 0
    while len(level) > 1:
        nxt: "list[str]" = []
        for j in range(0, len(level), 2):
            key = f"rx-{depth}-{j // 2}"
            tasks.append(Task(key, _make_combine(compute_ms),
                              (TaskRef(level[j]), TaskRef(level[j + 1]))))
            nxt.append(key)
        level = nxt
        depth += 1
    return tasks, level[0]


def _check_n(n: int) -> None:
    if n < 4 or n & (n - 1):
        raise ValueError("n must be a power of two >= 4")


def dynamic_tree_reduction_dag(
    n: int = 16,
    compute_ms: float = 0.0,
    payload_bytes: int = 0,
    max_expansion_depth: int = 8,
) -> DynamicDAG:
    """Two seed halves feeding a ``reduce`` task that expands, at
    runtime, into the n/2-leaf reduction tree."""
    _check_n(n)
    values = np.arange(n, dtype=np.float64)

    def tr_expand(lo: np.ndarray, hi: np.ndarray) -> Expansion:
        _charge(compute_ms)
        tasks, final = _subgraph(n, EXPAND_BASE, compute_ms, payload_bytes)
        return Expansion(value=np.concatenate([lo, hi]),
                         tasks=tasks, final=final)

    tr_expand.__name__ = "tr_expand"
    return DynamicDAG(
        [
            Task("half-lo", _make_half(values[: n // 2], compute_ms)),
            Task("half-hi", _make_half(values[n // 2:], compute_ms)),
            Task(EXPAND_KEY, tr_expand,
                 (TaskRef("half-lo"), TaskRef("half-hi"))),
        ],
        max_expansion_depth=max_expansion_depth,
    )


def static_tree_reduction_equivalent(
    n: int = 16,
    compute_ms: float = 0.0,
    payload_bytes: int = 0,
) -> DAG:
    """The graph ``dynamic_tree_reduction_dag(n)`` becomes after its
    one expansion, built statically: same keys (synthetic base
    included), same fns, same insertion order — so children lists,
    counters, KV traffic and charges line up edge for edge."""
    _check_n(n)
    values = np.arange(n, dtype=np.float64)
    base = expansion_base_key(EXPAND_KEY, 1)

    def tr_expand(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        _charge(compute_ms)
        return np.concatenate([lo, hi])

    tr_expand.__name__ = "tr_expand"
    tasks = [
        Task("half-lo", _make_half(values[: n // 2], compute_ms)),
        Task("half-hi", _make_half(values[n // 2:], compute_ms)),
        Task(base, tr_expand, (TaskRef("half-lo"), TaskRef("half-hi"))),
    ]
    sub, final = _subgraph(n, base, compute_ms, payload_bytes)
    for t in sub:
        if t.key == final:
            t = Task(EXPAND_KEY, t.fn, t.args, t.kwargs)
        tasks.append(t)
    return DAG(tasks)


def dynamic_tree_reduction_expected(n: int) -> float:
    return float(np.arange(n, dtype=np.float64).sum())
