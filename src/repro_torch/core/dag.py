"""DAG representation for WUKONG.

A DAG maps task keys to ``Task`` objects. Tasks name their dependencies by
key; edges always point dependency -> dependent (data flows along edges).

The graph-construction surface mirrors Dask's: a task graph is a dict
``{key: (callable, arg0, arg1, ...)}`` where string args naming other keys
are dependencies, plus literal leaves ``{key: value}``. The paper's strawman
was "a modification of the Python-written Dask distributed scheduler"; we
keep the same representation so the serverful baseline and WUKONG run the
exact same graphs (paper §V-D notes this is what made their comparison
possible).

Dynamic DAGs (Triggerflow-style reactive workflows): a task of a
:class:`DynamicDAG` may return an :class:`Expansion` instead of a plain
value — a data-dependent subgraph appended to the running job at the
point of the expanding task (fan-outs whose width depends on the data,
iterate-until-converged loops). See :meth:`DynamicDAG.apply_expansion`
for the rewrite rule that keeps an expanded run bit-identical — results,
``charged_ms``, and ``kv_stats`` — to the statically pre-expanded
equivalent graph.
"""
from __future__ import annotations

import dataclasses
import hashlib
import pickle
import threading
from typing import Any, Callable, Iterable, Mapping

# The graph-integrity rules live in the standalone validation pass
# (repro_torch.analysis is a leaf package — no import cycle). CycleError,
# ExpansionError and EXPAND_BASE are defined there and re-exported here,
# the import path every caller and test already uses.
from repro_torch.analysis.dagcheck import (
    EXPAND_BASE,
    CycleError,
    ExpansionError,
    build_graph,
    check_expansion,
    toposort,
)

__all__ = [
    "DAG",
    "DynamicDAG",
    "EXPAND_BASE",
    "CycleError",
    "Expansion",
    "ExpansionDelta",
    "ExpansionError",
    "Task",
    "TaskRef",
    "expansion_base_key",
]


@dataclasses.dataclass(frozen=True)
class Task:
    """A single DAG node.

    ``fn`` is the task code (shipped inside static schedules, like the
    paper's pickled task code). ``args`` may contain ``TaskRef`` objects
    (dependencies) and arbitrary literals.
    """

    key: str
    fn: Callable[..., Any]
    args: tuple[Any, ...] = ()
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def dependencies(self) -> tuple[str, ...]:
        deps = []
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, TaskRef):
                deps.append(a.key)
        return tuple(dict.fromkeys(deps))  # stable-unique


@dataclasses.dataclass(frozen=True)
class TaskRef:
    """Reference to another task's output (an edge in the DAG)."""

    key: str


class DAG:
    """Directed acyclic graph of tasks.

    ``deps[k]``    — keys k reads from (in-edges).
    ``children[k]``— keys that read k (out-edges).
    ``leaves``     — tasks with no dependencies (paper: leaf nodes; one
                     static schedule is generated per leaf).
    ``roots``      — tasks nothing depends on (final outputs).
    """

    def __init__(self, tasks: Iterable[Task]):
        self.tasks, self.deps, self.children = build_graph(tasks)
        self.leaves: tuple[str, ...] = tuple(
            k for k in self.tasks if not self.deps[k]
        )
        self.roots: tuple[str, ...] = tuple(
            k for k in self.tasks if not self.children[k]
        )
        self._check_acyclic()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dsk(cls, dsk: Mapping[str, Any]) -> "DAG":
        """Build from a Dask-style graph dict."""
        tasks = []
        for key, spec in dsk.items():
            if isinstance(spec, tuple) and spec and callable(spec[0]):
                fn = spec[0]
                args = tuple(
                    TaskRef(a) if isinstance(a, str) and a in dsk else a
                    for a in spec[1:]
                )
                tasks.append(Task(key, fn, args))
            else:  # literal leaf
                tasks.append(Task(key, _literal(spec)))
        return cls(tasks)

    # -- utilities ---------------------------------------------------------
    def _check_acyclic(self) -> None:
        # The acyclicity check already computes a full topological order;
        # cache it so the host-side hot paths that re-sort the graph
        # (compiler passes, schedule generation, critical-path metrics)
        # pay O(V+E) once per DAG instead of once per call.
        self._topo_order: tuple[str, ...] = toposort(
            self.tasks, self.deps, self.children)

    def topological_order(self) -> list[str]:
        return list(self._topo_order)

    def reachable_from(self, start: str) -> set[str]:
        """All nodes reachable from ``start`` following out-edges (paper:
        the static schedule for leaf L contains every node reachable from
        L)."""
        seen = {start}
        stack = [start]
        while stack:
            k = stack.pop()
            for c in self.children[k]:
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return seen

    def fan_in_degree(self, key: str) -> int:
        return len(self.deps[key])

    def fan_out_degree(self, key: str) -> int:
        return len(self.children[key])

    def __len__(self) -> int:
        return len(self.tasks)

    def __contains__(self, key: str) -> bool:
        return key in self.tasks

    def critical_path_length(self) -> int:
        depth: dict[str, int] = {}
        for k in self.topological_order():
            depth[k] = 1 + max((depth[d] for d in self.deps[k]), default=0)
        return max(depth.values(), default=0)


# ---------------------------------------------------------------------------
# Dynamic DAGs: runtime graph expansion (Triggerflow-style reactive
# workflows; the ROADMAP streaming open item).
# ---------------------------------------------------------------------------

# EXPAND_BASE — the placeholder dependency key inside an Expansion's
# subgraph, rewritten at apply time to the synthetic base node that
# holds the expanding task's own output value — is defined in
# repro_torch.analysis.dagcheck (imported above) so the standalone validator
# shares it.


def expansion_base_key(key: str, n: int) -> str:
    """The synthetic base node's key for the ``n``-th expansion of
    ``key`` (0-based). Exposed so tests/benchmarks can construct the
    statically pre-expanded equivalent graph with matching names."""
    return f"{key}/__base{n}__"


@dataclasses.dataclass(frozen=True)
class Expansion:
    """Returned by a task of a :class:`DynamicDAG` instead of a plain
    value: append ``tasks`` downstream of this task at runtime.

    ``value``  — the expanding task's own output; the subgraph reads it
                 by depending on :data:`EXPAND_BASE`.
    ``tasks``  — the subgraph. Tasks may only depend on ``EXPAND_BASE``
                 or on sibling tasks of the same expansion
                 (self-contained — the property that makes the expanded
                 run charge-identical to the pre-expanded equivalent).
    ``final``  — the key (within ``tasks``) of the subgraph's sink; its
                 task is re-bound under the expanding task's key, so the
                 original downstream consumers transparently read the
                 converged/aggregated result. ``final`` itself may
                 return another Expansion (iterate-until-converged),
                 bounded by ``DynamicDAG.max_expansion_depth``.
    """

    value: Any
    tasks: tuple[Task, ...]
    final: str

    def __post_init__(self) -> None:
        object.__setattr__(self, "tasks", tuple(self.tasks))


@dataclasses.dataclass(frozen=True)
class ExpansionDelta:
    """What :meth:`DynamicDAG.apply_expansion` changed — everything the
    executor and the incremental scheduler need, O(|subgraph|).

    ``topo`` is the delta in topological order: the base node first, the
    re-bound expanding key last. ``fan_in_widths`` maps every task key
    whose in-degree the expansion (re)defined to its new width > 1; the
    executor registers these host-side (uncharged — the batched
    registration round trip at job start already paid, see
    ``ShardedKVStore.rebind_counter``).

    ``replayed=True`` marks a duplicate application: the expanding task
    ran twice (a resumed run whose crashed predecessor already pushed
    the fan-in counters past their widths, or a speculative duplicate)
    and the graph already holds this exact subgraph. The caller must
    then NOT touch the counters — the first application's subgraph is
    live on them."""

    key: str
    base_key: str
    value: Any
    new_keys: tuple[str, ...]
    topo: tuple[str, ...]
    fan_in_widths: Mapping[str, int]
    replayed: bool = False


def _value_fingerprint(value: Any) -> Any:
    """Stable digest of an expansion's value, part of the replay-dedupe
    signature. Unpicklable values get a unique token — they can never be
    proven to be a duplicate execution, so they never dedupe (a fresh
    install, which then fails on key collisions if it truly was one)."""
    try:
        return hashlib.sha1(pickle.dumps(value, protocol=4)).hexdigest()
    except Exception:
        return object()


def _retarget(task: Task, key: str, base: str) -> Task:
    """``task`` re-keyed to ``key`` with EXPAND_BASE refs bound to
    ``base``."""

    def bind(a: Any) -> Any:
        if isinstance(a, TaskRef) and a.key == EXPAND_BASE:
            return TaskRef(base)
        return a

    return Task(key, task.fn, tuple(bind(a) for a in task.args),
                {k: bind(v) for k, v in task.kwargs.items()})


class DynamicDAG(DAG):
    """A DAG whose tasks may grow the graph at runtime.

    The expansion rewrite (exactly mirrored by a statically pre-expanded
    graph, which is what the parity tests exploit):

    - a synthetic *base* node ``expansion_base_key(key, n)`` is inserted
      where the expanding task ``key`` stood: it inherits ``key``'s
      original args/deps (upstream children lists are retargeted in
      place, preserving positions) and holds the expanding task's output
      value;
    - the subgraph tasks are added with ``EXPAND_BASE`` bound to the
      base node;
    - the ``final`` task is re-bound under ``key`` itself, keeping
      ``key``'s original downstream edges intact.

    Construction order matters for bit-identical fan-out behavior: new
    children lists append in ``Expansion.tasks`` order, so the
    equivalent static graph must list the base task at the expanding
    task's original position and the subgraph tasks (with ``final``
    keyed as ``key``) after it, in the same order.

    ``max_expansion_depth`` bounds chained expansions (a re-bound final
    that expands again), so a non-converging iterate loop fails loudly
    instead of growing forever.
    """

    def __init__(self, tasks: Iterable[Task], max_expansion_depth: int = 8):
        if not isinstance(max_expansion_depth, int) \
                or isinstance(max_expansion_depth, bool) \
                or max_expansion_depth < 1:
            raise ValueError(
                f"max_expansion_depth must be a positive int, got "
                f"{max_expansion_depth!r}")
        super().__init__(tasks)
        self.max_expansion_depth = max_expansion_depth
        self._expand_lock = threading.Lock()
        self._expansion_counts: dict[str, int] = {}
        self._depths: dict[str, int] = {}
        # (key, subgraph keys, final) -> the delta it produced, so a
        # duplicate execution of an expanding task (idempotent-replay
        # crash model) replays the recorded delta instead of colliding.
        self._applied: dict[Any, ExpansionDelta] = {}
        self._topo_dirty = False
        self.expansions_applied = 0

    def topological_order(self) -> list[str]:
        with self._expand_lock:
            if self._topo_dirty:
                # Recompute (and re-verify acyclicity globally) on
                # demand: expansions themselves stay O(|subgraph|).
                self._check_acyclic()
                self._topo_dirty = False
        return list(self._topo_order)

    def apply_expansion(self, key: str, expansion: Expansion) \
            -> ExpansionDelta:
        """Install ``expansion`` at ``key``; returns the delta. Raises
        :class:`ExpansionError` on an invalid subgraph or when the
        chained-expansion depth bound is exceeded."""
        with self._expand_lock:
            return self._apply_locked(key, expansion)

    def _apply_locked(self, key: str, expansion: Expansion) \
            -> ExpansionDelta:
        if key not in self.tasks:
            raise ExpansionError(f"unknown task {key!r}")
        sig = (key, tuple(t.key for t in expansion.tasks), expansion.final,
               _value_fingerprint(expansion.value))
        prior = self._applied.get(sig)
        if prior is not None:
            # The same task produced the same expansion — same subgraph
            # AND same value — again: a duplicate execution (a resumed
            # run whose crashed predecessor already pushed the fan-in
            # counters past their widths re-runs the expanding task with
            # identical inputs). Every KV write below a task is
            # if-absent/idempotent by design, and this makes graph
            # growth match — the duplicate executor relabels onto the
            # already-installed subgraph and falls through the normal
            # (idempotent) write path. A matching subgraph with a NEW
            # value is NOT a replay: that is the next round of an
            # iterate-until-converged loop whose final re-expands under
            # the same key with the same single-task shape.
            return dataclasses.replace(prior, value=expansion.value,
                                       replayed=True)
        depth = self._depths.get(key, 0) + 1
        tasks = expansion.tasks
        n = self._expansion_counts.get(key, 0)
        base = expansion_base_key(key, n)
        # All structural rules — depth cap, collisions, self-containment,
        # orphans, subgraph acyclicity — live in the unified validator
        # (repro_torch.analysis.dagcheck); it returns the subgraph keys plus
        # the local topological order [base, ...subgraph...] the
        # installer below consumes.
        keys, order = check_expansion(
            self.tasks, key, expansion, base, depth,
            self.max_expansion_depth)

        # ---- install (validation done; mutate atomically) -----------------
        self._expansion_counts[key] = n + 1
        orig = self.tasks[key]
        # Base node: the original task, re-keyed. Its fn is never run by
        # the dynamic executor (the expanding task already ran and its
        # value rides the relabel); recording the original fn keeps the
        # graph structurally identical to the static equivalent.
        self.tasks[base] = Task(base, orig.fn, orig.args, orig.kwargs)
        self.deps[base] = self.deps[key]
        self.children[base] = []
        for d in self.deps[base]:
            self.children[d] = [base if c == key else c
                                for c in self.children[d]]
        rebound: dict[str, str] = {expansion.final: key}
        for t in tasks:
            tk = rebound.get(t.key, t.key)
            nt = _retarget(t, tk, base)
            self.tasks[tk] = nt
            self.deps[tk] = nt.dependencies()
            if tk != key:
                self.children[tk] = []
            self._depths[tk] = depth
        # Out-edges: appended in Expansion.tasks order (final contributes
        # at its own position), matching a static graph that lists the
        # subgraph tasks in the same order.
        for t in tasks:
            tk = rebound.get(t.key, t.key)
            for d in self.deps[tk]:
                self.children[d].append(tk)
        self._depths[base] = depth
        if key in self.leaves:
            self.leaves = tuple(base if lf == key else lf
                                for lf in self.leaves)
        new_roots = [k for k in keys
                     if rebound.get(k, k) != key
                     and not self.children[rebound.get(k, k)]]
        if new_roots:
            self.roots = self.roots + tuple(new_roots)
        self._topo_dirty = True
        self.expansions_applied += 1
        new_keys = tuple(k for k in keys if k != expansion.final)
        # [base, ...subgraph in local topo order...], with the final
        # task appearing under its re-bound name (``key``).
        topo = tuple(rebound.get(k, k) for k in order)
        widths = {k: len(self.deps[k])
                  for k in [key, *new_keys]
                  if len(self.deps[k]) > 1}
        delta = ExpansionDelta(
            key=key, base_key=base, value=expansion.value,
            new_keys=new_keys, topo=topo, fan_in_widths=widths,
        )
        self._applied[sig] = delta
        return delta


def _literal(value: Any) -> Callable[[], Any]:
    def produce() -> Any:
        return value

    produce.__name__ = "literal"
    return produce
