"""User-facing DAG construction API (Dask-delayed style).

WUKONG's front-end parses "user-defined job code" into a DAG (paper
§IV-B: "users submit a Python computing job to WUKONG's DAG generator").
``GraphBuilder`` is that generator: calls record tasks, ``TaskRef``s wire
dependencies, ``build()`` validates and freezes the DAG.

    g = GraphBuilder()
    a = g.add(np.add, x, y, name="a")
    b = g.add(np.sum, a)
    dag = g.build()
    report = WukongEngine().compute(dag)
"""
from __future__ import annotations

import itertools
from typing import Any, Callable

from repro_torch.core.dag import DAG, Task, TaskRef
from repro_torch.core.optimize import CompiledDAG, OptimizeConfig, compile_dag


class GraphBuilder:
    def __init__(self) -> None:
        self._tasks: dict[str, Task] = {}
        self._counter = itertools.count()

    def add(
        self,
        fn: Callable[..., Any],
        *args: Any,
        name: str | None = None,
        **kwargs: Any,
    ) -> TaskRef:
        """Record a task; returns a ``TaskRef`` usable as an argument to
        later tasks."""
        key = name or f"{getattr(fn, '__name__', 'task')}-{next(self._counter)}"
        if key in self._tasks:
            raise ValueError(f"duplicate task name {key!r}")
        self._tasks[key] = Task(key, fn, tuple(args), dict(kwargs))
        return TaskRef(key)

    def literal(self, value: Any, name: str | None = None) -> TaskRef:
        """A leaf task producing a constant (input data block)."""
        key = name or f"literal-{next(self._counter)}"

        def produce() -> Any:
            return value

        produce.__name__ = "literal"
        if key in self._tasks:
            raise ValueError(f"duplicate task name {key!r}")
        self._tasks[key] = Task(key, produce)
        return TaskRef(key)

    def build(
        self, optimize: bool | OptimizeConfig | None = None
    ) -> DAG | CompiledDAG:
        """Validate and freeze the DAG.

        ``optimize`` runs the DAG compiler (``repro_torch.core.optimize``)
        before freezing: ``True`` enables every pass with defaults, an
        ``OptimizeConfig`` selects passes individually, and ``None`` /
        ``False`` returns the graph verbatim. Engines run a compiled
        graph as-is (annotations included), so building optimized here
        is equivalent to setting ``optimize`` on the engine config.
        """
        dag = DAG(self._tasks.values())
        if not optimize:
            return dag
        cfg = optimize if isinstance(optimize, OptimizeConfig) else None
        return compile_dag(dag, cfg)


def delayed_graph(dsk: dict[str, Any]) -> DAG:
    """Build a DAG from a raw Dask-style dict (used by tests and by the
    serverful-baseline comparisons)."""
    return DAG.from_dsk(dsk)
