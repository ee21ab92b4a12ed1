"""Unified DAG / schedule validation (the pre-compile pass).

One home for every graph-integrity rule that used to be scattered
across ``repro_torch.core.dag`` (duplicate keys, missing deps, cycles),
``DynamicDAG.apply_expansion`` (the runtime-expansion rules: collision,
orphan, self-containment, depth cap) and ``repro_torch.core.schedule``
(fan-in counter widths). ``DAG.__init__`` / ``DynamicDAG`` /
``compile_dag`` all route through these functions, and every check is
callable standalone — tests and debugging tools re-validate a live
(possibly runtime-expanded) graph with :func:`verify_dag` without
rebuilding it.

Layering: this module depends on nothing inside ``repro_torch.core`` (it
duck-types tasks via ``.key`` / ``.dependencies()``), which is what
lets ``dag.py`` import it at module load. The exception types and the
``EXPAND_BASE`` placeholder are therefore *defined* here and
re-exported by ``repro_torch.core.dag`` — the import path every caller and
test already uses.

Construction-time checks raise the same exception types with the same
messages as the pre-unification code (:class:`CycleError`,
:class:`ExpansionError`, ``ValueError``); invariant *re*-checks on an
already-built graph raise :class:`ConsistencyError` so a corruption
found after construction is distinguishable from a bad input.
"""
from __future__ import annotations

from typing import Any, Iterable, Mapping

__all__ = [
    "EXPAND_BASE",
    "ConsistencyError",
    "CycleError",
    "ExpansionError",
    "build_graph",
    "check_compiled",
    "check_expansion",
    "check_fan_in_counters",
    "check_schedule_set",
    "fan_in_counter_id",
    "toposort",
    "verify_dag",
]


class CycleError(ValueError):
    pass


class ExpansionError(ValueError):
    """An invalid runtime expansion (bad subgraph, depth exceeded)."""


class ConsistencyError(ValueError):
    """A built graph / schedule set violates a structural invariant."""


# Placeholder dependency key inside an Expansion's subgraph: rewritten
# at apply time to the synthetic base node that holds the expanding
# task's own output value. (Re-exported by repro_torch.core.dag.)
EXPAND_BASE = "__expand_base__"

# Fan-in dependency counters are registered under this prefix (shared
# with repro_torch.core.schedule, which builds the registration batch).
_FANIN_PREFIX = "__fanin__/"


def fan_in_counter_id(key: str) -> str:
    return f"{_FANIN_PREFIX}{key}"


# ---------------------------------------------------------------------------
# Construction-time checks (the DAG.__init__ path)
# ---------------------------------------------------------------------------


def build_graph(tasks: Iterable[Any]) -> tuple[
        dict[str, Any], dict[str, tuple[str, ...]], dict[str, list[str]]]:
    """Validated ``(tasks, deps, children)`` maps from a task iterable.

    Raises ``ValueError`` on a duplicate task key or a dependency on a
    missing key — the two input errors a graph can contain before
    acyclicity is even a question.
    """
    task_map: dict[str, Any] = {}
    for t in tasks:
        if t.key in task_map:
            raise ValueError(f"duplicate task key {t.key!r}")
        task_map[t.key] = t
    deps: dict[str, tuple[str, ...]] = {}
    children: dict[str, list[str]] = {k: [] for k in task_map}
    for k, t in task_map.items():
        d = t.dependencies()
        missing = [x for x in d if x not in task_map]
        if missing:
            raise ValueError(f"task {k!r} depends on missing keys {missing}")
        deps[k] = d
        for x in d:
            children[x].append(k)
    return task_map, deps, children


def toposort(tasks: Mapping[str, Any], deps: Mapping[str, tuple[str, ...]],
             children: Mapping[str, list[str]]) -> tuple[str, ...]:
    """Full topological order; raises :class:`CycleError` if none exists.

    The order doubles as the acyclicity certificate — callers cache it
    so host-side hot paths (compiler passes, schedule generation,
    critical-path metrics) pay O(V+E) once per graph.
    """
    indeg = {k: len(deps[k]) for k in tasks}
    stack = [k for k in tasks if indeg[k] == 0]
    out: list[str] = []
    while stack:
        k = stack.pop()
        out.append(k)
        for c in children[k]:
            indeg[c] -= 1
            if indeg[c] == 0:
                stack.append(c)
    if len(out) != len(tasks):
        raise CycleError("task graph contains a cycle")
    return tuple(out)


# ---------------------------------------------------------------------------
# Runtime-expansion checks (the DynamicDAG.apply_expansion path)
# ---------------------------------------------------------------------------


def check_expansion(tasks: Mapping[str, Any], key: str, expansion: Any,
                    base: str, depth: int, max_depth: int) \
        -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Validate ``expansion`` at ``key`` against the live graph.

    Returns ``(keys, order)``: the subgraph keys in declaration order
    and the local topological order ``[base, ...subgraph...]`` the
    installer and the incremental scheduler consume. Raises
    :class:`ExpansionError` on any violation, in the same order (and
    with the same messages) as the pre-unification inline checks.
    """
    if depth > max_depth:
        raise ExpansionError(
            f"expansion depth {depth} at {key!r} exceeds "
            f"max_expansion_depth={max_depth}")
    sub_tasks = expansion.tasks
    if not sub_tasks:
        raise ExpansionError("empty expansion")
    keys = [t.key for t in sub_tasks]
    if len(set(keys)) != len(keys):
        raise ExpansionError(f"duplicate keys in expansion: {keys}")
    if expansion.final not in set(keys):
        raise ExpansionError(
            f"final {expansion.final!r} not among expansion tasks")
    collisions = [k for k in keys if k in tasks or k == EXPAND_BASE]
    if collisions:
        raise ExpansionError(
            f"expansion keys collide with existing tasks: {collisions}")
    if base in tasks:
        raise ExpansionError(f"base key {base!r} already exists")
    allowed = set(keys) | {EXPAND_BASE}
    sub_deps: dict[str, tuple[str, ...]] = {}
    uses_base = False
    for t in sub_tasks:
        deps = t.dependencies()
        bad = [d for d in deps if d not in allowed]
        if bad:
            raise ExpansionError(
                f"expansion task {t.key!r} depends on {bad}; only "
                f"EXPAND_BASE and sibling expansion tasks are allowed "
                f"(self-contained expansions)")
        if expansion.final in deps:
            raise ExpansionError(
                f"expansion task {t.key!r} depends on the final task "
                f"{expansion.final!r}")
        if not deps:
            raise ExpansionError(
                f"expansion task {t.key!r} has no dependencies and "
                f"would never be triggered")
        if EXPAND_BASE in deps:
            uses_base = True
        sub_deps[t.key] = deps
    if not uses_base:
        raise ExpansionError(
            "no expansion task depends on EXPAND_BASE — the subgraph "
            "has no entry point")
    # Local topological order over {base} + subgraph — also the delta
    # acyclicity check.
    order = [base]
    indeg = {k: sum(1 for d in sub_deps[k] if d != EXPAND_BASE)
             for k in keys}
    stack = [k for k in keys if indeg[k] == 0]
    rchildren: dict[str, list[str]] = {k: [] for k in keys}
    for k in keys:
        for d in sub_deps[k]:
            if d != EXPAND_BASE:
                rchildren[d].append(k)
    while stack:
        k = stack.pop()
        order.append(k)
        for c in rchildren[k]:
            indeg[c] -= 1
            if indeg[c] == 0:
                stack.append(c)
    if len(order) != len(keys) + 1:
        raise ExpansionError("expansion subgraph contains a cycle")
    return tuple(keys), tuple(order)


# ---------------------------------------------------------------------------
# Standalone invariant re-checks (live graphs, schedule sets, compiled DAGs)
# ---------------------------------------------------------------------------


def verify_dag(dag: Any) -> tuple[str, ...]:
    """Re-validate a built (possibly runtime-expanded) DAG's structural
    invariants; returns a fresh topological order.

    Checks: deps match each task's declared dependencies, deps/children
    mirror each other edge-for-edge, ``leaves``/``roots`` are exactly
    the in-degree-0 / out-degree-0 sets, every node is reachable from a
    leaf, and the graph is acyclic. Raises :class:`ConsistencyError`
    (or :class:`CycleError`) on violation — a live graph failing this
    was corrupted *after* construction, e.g. by a concurrent expansion
    bug.
    """
    tasks, deps, children = dag.tasks, dag.deps, dag.children
    for m, name in ((deps, "deps"), (children, "children")):
        extra = set(m) - set(tasks)
        missing = set(tasks) - set(m)
        if extra or missing:
            raise ConsistencyError(
                f"{name} keys diverge from tasks "
                f"(extra={sorted(extra)}, missing={sorted(missing)})")
    edges: set[tuple[str, str]] = set()
    for k, t in tasks.items():
        declared = t.dependencies()
        if tuple(deps[k]) != tuple(declared):
            raise ConsistencyError(
                f"task {k!r} declares deps {list(declared)} but the graph "
                f"records {list(deps[k])}")
        for d in deps[k]:
            edges.add((d, k))
    for d, cs in children.items():
        if len(cs) != len(set(cs)):
            raise ConsistencyError(
                f"task {d!r} lists duplicate children {cs}")
        for c in cs:
            if (d, c) not in edges:
                raise ConsistencyError(
                    f"children edge {d!r}->{c!r} has no matching dep")
            edges.discard((d, c))
    if edges:
        raise ConsistencyError(
            f"dep edges missing from children lists: {sorted(edges)}")
    leaf_set = {k for k in tasks if not deps[k]}
    if set(dag.leaves) != leaf_set:
        raise ConsistencyError(
            f"leaves {sorted(dag.leaves)} != in-degree-0 set "
            f"{sorted(leaf_set)}")
    root_set = {k for k in tasks if not children[k]}
    if set(dag.roots) != root_set:
        raise ConsistencyError(
            f"roots {sorted(dag.roots)} != out-degree-0 set "
            f"{sorted(root_set)}")
    order = toposort(tasks, deps, children)
    # Acyclic + every node topo-sorted implies leaf-reachability; an
    # unreachable node would need an in-edge cycle, caught above.
    return order


def check_fan_in_counters(dag: Any, counters: Mapping[str, int]) -> None:
    """Verify a registered counter map against the graph: exactly one
    counter per true fan-in node (in-degree > 1), each with width equal
    to the node's in-degree. This is the invariant the executor's
    increment-and-check protocol relies on — a stale width deadlocks
    (too wide) or double-fires (too narrow) the fan-in."""
    expected = {fan_in_counter_id(k): len(dag.deps[k])
                for k in dag.tasks if len(dag.deps[k]) > 1}
    for cid, width in expected.items():
        got = counters.get(cid)
        if got is None:
            raise ConsistencyError(
                f"fan-in counter {cid!r} (width {width}) missing from "
                f"the registered set")
        if got != width:
            raise ConsistencyError(
                f"fan-in counter {cid!r} registered with width {got} "
                f"but the task has in-degree {width}")
    extra = [cid for cid in counters
             if cid.startswith(_FANIN_PREFIX) and cid not in expected]
    if extra:
        raise ConsistencyError(
            f"registered fan-in counters for non-fan-in tasks: "
            f"{sorted(extra)}")


def check_schedule_set(schedule_set: Any) -> None:
    """Verify a generated :class:`~repro_torch.core.schedule.ScheduleSet`
    against its DAG: the initial-invocation batches cover every leaf
    exactly once, every batch's schedule covers all its start keys, and
    the fan-in counter registry is consistent (width == in-degree)."""
    dag = schedule_set.dag
    seen: dict[str, int] = {}
    for start_keys, sched in schedule_set.batches:
        for k in start_keys:
            seen[k] = seen.get(k, 0) + 1
            if k not in dag.tasks:
                raise ConsistencyError(
                    f"batch start key {k!r} is not a task")
            if not sched.covers(k):
                raise ConsistencyError(
                    f"batch schedule (leaf {sched.leaf!r}) does not cover "
                    f"its start key {k!r}")
    for leaf in dag.leaves:
        n = seen.get(leaf, 0)
        if n != 1:
            raise ConsistencyError(
                f"leaf {leaf!r} covered by {n} initial batches "
                f"(must be exactly 1)")
    extra = set(seen) - set(dag.leaves)
    if extra:
        raise ConsistencyError(
            f"batches start non-leaf tasks: {sorted(extra)}")
    check_fan_in_counters(dag, schedule_set.fan_in_counters())


def check_compiled(dag: Any) -> None:
    """Verify a :class:`~repro_torch.core.optimize.CompiledDAG`'s annotations
    against its own graph (``compile_dag`` runs this on every result):
    cluster ids map member tasks to member tasks, delayed fan-ins are
    true fan-in nodes, and ``leaf_batches`` partition the leaves."""
    tasks = dag.tasks
    for k, cid in dag.clusters.items():
        if k not in tasks or cid not in tasks:
            raise ConsistencyError(
                f"cluster annotation {k!r}->{cid!r} references a "
                f"non-task key")
    for k in dag.delayed_fanins:
        if k not in tasks:
            raise ConsistencyError(
                f"delayed fan-in {k!r} is not a task")
        if len(dag.deps[k]) <= 1:
            raise ConsistencyError(
                f"delayed fan-in {k!r} has in-degree {len(dag.deps[k])} "
                f"(must be > 1)")
    seen: set[str] = set()
    for batch in dag.leaf_batches:
        for k in batch:
            if k in seen:
                raise ConsistencyError(
                    f"leaf {k!r} appears in multiple leaf batches")
            seen.add(k)
    if seen != set(dag.leaves):
        raise ConsistencyError(
            f"leaf batches cover {sorted(seen)} but the leaves are "
            f"{sorted(dag.leaves)}")
