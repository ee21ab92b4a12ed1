"""Tree Reduction (TR) microbenchmark (paper §V, Figs. 4 & 7).

TR sums the elements of an array by repeatedly adding adjacent elements
until one remains. An initial array of n numbers yields n/2 leaf tasks at
the bottom of the DAG (paper Fig. 4 caption). A per-task delay simulates
a compute task with controllable duration — exactly the paper's
methodology for sweeping task granularity. ``compute_ms`` declares the
delay in *simulated* ms charged on the engine clock (free wall-clock
under the virtual clock, scaled real sleep in real-time mode);
``sleep_s`` is the seed's real-sleep knob, kept for cross-checks.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.api import GraphBuilder
from repro_torch.core.dag import DAG
from repro_torch.core.simclock import simulated_compute


def tree_reduction_dag(
    n: int = 1024,
    sleep_s: float = 0.0,
    chunk: np.ndarray | None = None,
    payload_bytes: int = 0,
    compute_ms: float = 0.0,
) -> DAG:
    """Build the TR DAG for an array of ``n`` numbers (n/2 leaf tasks).

    ``compute_ms``    — per-task simulated compute duration in ms, charged
                        on the engine clock (the paper's task-granularity
                        knob).
    ``sleep_s``       — per-task REAL sleep seconds (legacy real-time
                        knob; prefer ``compute_ms``).
    ``payload_bytes`` — optional ballast carried through every edge so the
                        communication-bound regime (paper: "dominated by
                        the communication overhead of transferring the
                        array") can be reproduced at will.
    """
    if n < 2 or n & (n - 1):
        raise ValueError("n must be a power of two >= 2")
    values = chunk if chunk is not None else np.arange(n, dtype=np.float64)
    ballast = max(0, payload_bytes) // 8

    def charge() -> None:
        if compute_ms > 0:
            simulated_compute(compute_ms)
        if sleep_s > 0:
            time.sleep(sleep_s)  # lint: allow(REPRO001) — opt-in real-sleep knob, off by default

    def make_add(a: float, b: float):
        def leaf_add() -> np.ndarray:
            charge()
            out = np.empty(1 + ballast)
            out[0] = a + b
            return out

        leaf_add.__name__ = "tr_leaf"
        return leaf_add

    def combine(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        charge()
        out = np.empty_like(x)
        out[0] = x[0] + y[0]
        return out

    g = GraphBuilder()
    level = [
        g.add(make_add(values[2 * i], values[2 * i + 1]), name=f"tr-leaf-{i}")
        for i in range(n // 2)
    ]
    depth = 0
    while len(level) > 1:
        level = [
            g.add(combine, level[i], level[i + 1],
                  name=f"tr-{depth}-{i // 2}")
            for i in range(0, len(level), 2)
        ]
        depth += 1
    return g.build()


def tree_reduction_expected(n: int) -> float:
    return float(np.arange(n, dtype=np.float64).sum())
