"""Static schedule generation (paper §IV-B).

For a DAG with n leaf nodes, n static schedules are generated. The schedule
for leaf L is the subgraph of all nodes reachable from L together with
every edge into and out of those nodes. A static schedule ships the task
*code* for its member nodes plus the KV store keys for task inputs, so a
Task Executor never has to fetch task code at runtime — the
decentralization that §V-B measures as the single largest performance
factor.

The seed implementation ran one DFS *per leaf* (the paper's description,
kept below as :func:`generate_static_schedules_dfs` — the reference
baseline the perf tests compare against). The production path is a single
reverse-topological sweep: each node's reachable set is built once from
its children's sets (O(V+E) set unions, shared by every leaf above it),
the shipped-code size is accumulated incrementally along the same sweep,
and a key -> covering-leaf index is derived in one forward pass so the
speculative monitor resolves a respawn's schedule in O(1) instead of
scanning every schedule.

A static schedule contains three types of operations: task execution,
fan-in and fan-out. We materialize these implicitly: between every
dependent pair (u, v) there is a fan-out at u (width = out-degree of u,
width 1 == the paper's "trivial fan-out") followed by a fan-in at v
(width = in-degree of v). The executor walks the schedule bottom-up from
its leaf, executing tasks along a single path and performing the dynamic
become/invoke (fan-out) and counter (fan-in) protocols at the boundaries.

Schedules only define a valid *partial order*; the time and place tasks
run is decided dynamically (paper: "A static schedule does not map a given
task T to a processor").
"""
from __future__ import annotations

import dataclasses
import pickle
import threading as _threading
from collections.abc import Mapping as _MappingABC
from typing import Iterator, Mapping

from repro_torch.analysis.dagcheck import fan_in_counter_id as _counter_id
from repro_torch.core.dag import DAG


@dataclasses.dataclass(frozen=True)
class StaticSchedule:
    """The reachable subgraph from one leaf, with shipped task code.

    ``nodes`` is the set of tasks whose code this schedule carries. The
    executor may only *execute* tasks in ``nodes``; in-edges arriving from
    other schedules' regions are known by key only (their outputs are read
    from the KV store after the fan-in counter resolves).

    When the DAG was run through the optimizer (``repro_torch.core.optimize``)
    the schedule additionally ships the compiler annotations its executor
    consumes at runtime:

    ``clusters``       — node -> cluster id (head of the node's static
                         become-path; the clustering pass). May be the
                         whole DAG's mapping shared across schedules —
                         ``covers()`` gates membership, so entries for
                         non-member nodes are never consulted.
    ``delayed_fanins`` — fan-in nodes where arrivals use the atomic
                         deposit-and-increment protocol so the completing
                         arriver's locally-held inputs never travel to the
                         KV store (delayed I/O). Shared like ``clusters``.
    """

    leaf: str
    nodes: frozenset[str]
    code_size_bytes: int  # serialized size of shipped task code (cost model)
    clusters: Mapping[str, str] = dataclasses.field(default_factory=dict)
    delayed_fanins: frozenset[str] = frozenset()

    def covers(self, key: str) -> bool:
        return key in self.nodes

    def delayed(self, key: str) -> bool:
        """True if fan-in arrivals at ``key`` delay KV writes (clustering)."""
        return key in self.delayed_fanins


@dataclasses.dataclass(frozen=True)
class ScheduleSet:
    """All static schedules for one DAG + the fan-in counter registry.

    The Storage Manager receives the DAG and the static schedules at the
    start of workflow processing (paper §IV-D); the counter ids created
    here are registered with the KV store (in one batched round trip)
    before any executor launches.

    ``batches`` lists the initial executor invocations: one entry per
    invocation, as ``(start_keys, schedule)``. Without the coalescing
    pass every batch is a single leaf with its own schedule; with it,
    sibling leaves share one invocation and a merged schedule.

    ``covering`` maps every task key to one leaf whose schedule covers it
    (the speculative monitor's respawn index). Empty for schedule sets
    built by the reference DFS generator; ``covering_schedule`` falls
    back to a linear scan in that case.
    """

    dag: DAG
    schedules: Mapping[str, StaticSchedule]  # leaf -> schedule (may be lazy)
    batches: tuple[tuple[tuple[str, ...], StaticSchedule], ...] = ()
    covering: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def fan_in_counters(self) -> dict[str, int]:
        """counter id -> number of in-edges, for every true fan-in node."""
        return {
            _counter_id(k): len(self.dag.deps[k])
            for k in self.dag.tasks
            if len(self.dag.deps[k]) > 1
        }

    def covering_schedule(self, key: str) -> StaticSchedule | None:
        """A schedule covering ``key``: O(1) through the precomputed
        index, linear scan as a fallback for externally-built sets.
        The index hit is re-verified with ``covers`` — on a DynamicDAG a
        key added at runtime may map to a leaf whose (pre-expansion)
        schedule does not actually cover it."""
        leaf = self.covering.get(key)
        if leaf is not None:
            sched = self.schedules.get(leaf)
            if sched is not None and sched.covers(key):
                return sched
        for sched in self.schedules.values():
            if sched.covers(key):
                return sched
        return None

    def expansion_schedule(self, delta) -> StaticSchedule:
        """Incremental re-scheduling after a runtime expansion
        (``DynamicDAG.apply_expansion``): a schedule rooted at the
        expansion's base node, built in O(|subgraph|) by extending the
        O(V+E) sweep's retained reach/size tables over the delta —
        downstream reach of the re-bound key is reused, never re-swept.
        Falls back to a full reachability walk for schedule sets built
        by the reference DFS generator."""
        sched = self.schedules
        if isinstance(sched, _LeafSchedules):
            return sched.extend_for_expansion(self.dag, delta)
        nodes = self.dag.reachable_from(delta.base_key)
        return _make_schedule(
            self.dag, delta.base_key, nodes,
            getattr(self.dag, "clusters", {}),
            getattr(self.dag, "delayed_fanins", frozenset()))


# _counter_id is repro_torch.analysis.dagcheck.fan_in_counter_id (imported
# above): the validator and the schedule generator must agree on the
# "__fanin__/" registration prefix, so there is exactly one definition.


# Shipped-code size estimate: real WUKONG cloudpickles task code into the
# schedule; we estimate per-node (key + function-name payload) sizes so
# the invocation cost model can charge for schedule transfer without
# pickling unpicklable closures. The per-node item sizes are summed
# incrementally along the reverse-topological sweep — no per-schedule
# serialization on the host hot path.
_CODE_BASE_BYTES = 16      # container/framing overhead
_CODE_ITEM_BYTES = 12      # per-item (key + fn-name) tuple/marker overhead

# _new_schedule writes the dataclass fields directly; fail at import time
# (not with a silent stale-field bug later) if StaticSchedule ever grows
# or reorders fields without this fast path being updated. An explicit
# raise, not an assert: the guard must survive python -O.
_SCHEDULE_FIELDS = ("leaf", "nodes", "code_size_bytes", "clusters",
                    "delayed_fanins")
if tuple(f.name for f in dataclasses.fields(StaticSchedule)) != \
        _SCHEDULE_FIELDS:
    raise RuntimeError(
        "update _new_schedule for the new StaticSchedule fields")


def _new_schedule(leaf, nodes, code_size_bytes, clusters, delayed):
    """Construct a StaticSchedule without the frozen-dataclass __init__
    (one ``object.__setattr__`` per field — measurably hot at one object
    per leaf/batch on wide DAGs). Guarded by the _SCHEDULE_FIELDS check
    above."""
    s = StaticSchedule.__new__(StaticSchedule)
    d = s.__dict__
    d["leaf"] = leaf
    d["nodes"] = nodes
    d["code_size_bytes"] = code_size_bytes
    d["clusters"] = clusters
    d["delayed_fanins"] = delayed
    return s


class _LeafSchedules(_MappingABC):
    """leaf -> StaticSchedule, materialized on first access.

    With the coalescing pass on, initial invocations use merged *batch*
    schedules, so most per-leaf schedule objects are only ever needed if
    the speculative monitor respawns into one — building them eagerly is
    pure host-side overhead on the job-start hot path. This view carries
    the sweep's shared reach/size tables and constructs (then caches) a
    schedule only when asked. Iteration order and membership match
    ``dag.leaves`` exactly, so the mapping is indistinguishable from the
    eager dict for every reader.
    """

    __slots__ = ("_leaves", "_leafset", "_reach", "_csize", "_clusters",
                 "_delayed", "_cache", "_extend_lock")

    def __init__(self, leaves, reach, csize, clusters, delayed):
        self._leaves = leaves
        self._leafset = frozenset(leaves)
        self._reach = reach
        self._csize = csize
        self._clusters = clusters
        self._delayed = delayed
        self._cache: dict[str, StaticSchedule] = {}
        # Serializes runtime-expansion table extensions (real concurrency
        # only exists in the realtime clock mode; the virtual substrates
        # run one actor at a time).
        self._extend_lock = _threading.Lock()

    def extend_for_expansion(self, dag, delta) -> StaticSchedule:
        """Extend the retained reach/size tables over an expansion delta
        (``delta.topo`` = base first, re-bound key last) and return the
        schedule rooted at the base node. O(|subgraph|): the re-bound
        key's downstream reach is already in the tables (its out-edges
        did not change) and is reused as-is."""
        reach, csize = self._reach, self._csize
        tasks, children = dag.tasks, dag.children
        with self._extend_lock:
            for k in reversed(delta.topo):
                if k == delta.key:
                    continue  # downstream reach unchanged; reuse
                item = (len(k)
                        + len(getattr(tasks[k].fn, "__name__", "fn"))
                        + _CODE_ITEM_BYTES)
                cs = children[k]
                if len(cs) == 1:
                    c = cs[0]
                    reach[k] = reach[c] | {k}
                    csize[k] = csize[c] + item
                elif not cs:
                    reach[k] = frozenset((k,))
                    csize[k] = item
                else:
                    union: set = {k}
                    for c in cs:
                        union |= reach[c]
                    r = frozenset(union)
                    reach[k] = r
                    csize[k] = sum(
                        len(n)
                        + len(getattr(tasks[n].fn, "__name__", "fn"))
                        + _CODE_ITEM_BYTES
                        for n in r)
            base = delta.base_key
            return _new_schedule(
                base, reach[base], _CODE_BASE_BYTES + csize[base],
                self._clusters, self._delayed)

    def __getitem__(self, leaf: str) -> StaticSchedule:
        s = self._cache.get(leaf)
        if s is None:
            if leaf not in self._leafset:
                raise KeyError(leaf)
            s = self._cache[leaf] = _new_schedule(
                leaf, self._reach[leaf],
                _CODE_BASE_BYTES + self._csize[leaf],
                self._clusters, self._delayed,
            )
        return s

    def __iter__(self):
        return iter(self._leaves)

    def __len__(self) -> int:
        return len(self._leaves)

    def __contains__(self, leaf) -> bool:
        return leaf in self._leafset


class _CoveringIndex(_MappingABC):
    """key -> one leaf whose schedule covers the key.

    Replaces the seed's per-respawn linear scan over every schedule with
    an O(V) index: a leaf covering any parent of ``k`` covers ``k`` too,
    so the first parent's covering leaf propagates in one forward
    topological pass. Built once, on first lookup — the speculative
    monitor only consults it when a straggler respawns, so the common
    job-start path never pays for it; every respawn after the first is an
    O(1) dict hit.
    """

    __slots__ = ("_dag", "_map")

    def __init__(self, dag: DAG):
        self._dag = dag
        self._map: dict[str, str] | None = None

    def _build(self) -> dict[str, str]:
        m: dict[str, str] = {}
        deps = self._dag.deps
        for k in self._dag.topological_order():
            d = deps[k]
            m[k] = m[d[0]] if d else k
        self._map = m
        return m

    def get(self, key, default=None):
        m = self._map
        if m is None:
            m = self._build()
        return m.get(key, default)

    def __getitem__(self, key: str) -> str:
        m = self._map
        if m is None:
            m = self._build()
        return m[key]

    def __iter__(self):
        m = self._map
        if m is None:
            m = self._build()
        return iter(m)

    def __len__(self) -> int:
        m = self._map
        if m is None:
            m = self._build()
        return len(m)


def generate_static_schedules(dag: DAG) -> ScheduleSet:
    """One schedule per leaf node via one reverse-topological sweep.

    Optimizer annotations (``CompiledDAG``) ride into each schedule as
    shared whole-DAG maps; a plain ``DAG`` yields annotation-free
    schedules and singleton batches. Semantics match the paper's per-leaf
    DFS (:func:`generate_static_schedules_dfs`) — see the equivalence
    property in tests/test_kvstore_dataplane.py.
    """
    clusters: Mapping[str, str] = getattr(dag, "clusters", {})
    delayed: frozenset[str] = getattr(dag, "delayed_fanins", frozenset())
    leaf_batches = getattr(dag, "leaf_batches", None) or tuple(
        (leaf,) for leaf in dag.leaves
    )
    topo = dag.topological_order()

    # Reverse sweep: children's reachable sets and code sizes exist before
    # their parents need them, so every set is built exactly once and
    # shared by all upstream nodes (the seed re-walked the region once per
    # leaf).
    tasks = dag.tasks
    children = dag.children
    item: dict[str, int] = {
        k: len(k) + len(getattr(t.fn, "__name__", "fn")) + _CODE_ITEM_BYTES
        for k, t in tasks.items()
    }
    reach: dict[str, frozenset[str]] = {}
    csize: dict[str, int] = {}
    for k in reversed(topo):
        cs = children[k]
        if len(cs) == 1:
            c = cs[0]
            reach[k] = reach[c] | {k}
            # k not in reach[c] (the DAG is acyclic), so sizes stay additive
            csize[k] = csize[c] + item[k]
        elif not cs:
            reach[k] = frozenset((k,))
            csize[k] = item[k]
        else:
            union: set[str] = {k}
            for c in cs:
                union |= reach[c]
            r = frozenset(union)
            reach[k] = r
            csize[k] = sum(item[n] for n in r)

    schedules = _LeafSchedules(dag.leaves, reach, csize, clusters, delayed)

    batches: list[tuple[tuple[str, ...], StaticSchedule]] = []
    for keys in leaf_batches:
        if len(keys) == 1:
            batches.append((tuple(keys), schedules[keys[0]]))
            continue
        k0 = keys[0]
        sig = children[k0]
        same_sig = True
        extra = 0
        for k in keys[1:]:
            if children[k] != sig:
                same_sig = False
                break
            extra += item[k]
        if same_sig:
            # The coalescing pass only batches sibling leaves with an
            # identical child signature, so their reachable sets differ
            # only in the leaves themselves: extend one member's set
            # instead of re-unioning the whole region per batch.
            union_nodes = reach[k0].union(keys[1:])
            code_size = _CODE_BASE_BYTES + csize[k0] + extra
        else:
            union_nodes = frozenset().union(*(reach[k] for k in keys))
            code_size = (_CODE_BASE_BYTES
                         + sum(item[n] for n in union_nodes))
        batches.append((
            tuple(keys),
            _new_schedule(k0, union_nodes, code_size, clusters, delayed),
        ))

    return ScheduleSet(dag=dag, schedules=schedules, batches=tuple(batches),
                       covering=_CoveringIndex(dag))


# ---------------------------------------------------------------------------
# Reference implementation: the paper's per-leaf DFS (the seed behavior).
# Kept as the baseline that the O(V+E) sweep is validated and benchmarked
# against; not used on the production path.
# ---------------------------------------------------------------------------


def generate_static_schedules_dfs(dag: DAG) -> ScheduleSet:
    """One schedule per leaf node, via one DFS per leaf (paper §IV-B)."""
    clusters: Mapping[str, str] = getattr(dag, "clusters", {})
    delayed: frozenset[str] = getattr(dag, "delayed_fanins", frozenset())
    leaf_batches = getattr(dag, "leaf_batches", None) or tuple(
        (leaf,) for leaf in dag.leaves
    )
    schedules: dict[str, StaticSchedule] = {}
    for leaf in dag.leaves:
        nodes = dag.reachable_from(leaf)
        schedules[leaf] = _make_schedule(dag, leaf, nodes, clusters, delayed)
    batches = []
    for keys in leaf_batches:
        if len(keys) == 1:
            batches.append((tuple(keys), schedules[keys[0]]))
        else:
            union: set[str] = set()
            for k in keys:
                union |= schedules[k].nodes
            batches.append(
                (tuple(keys),
                 _make_schedule(dag, keys[0], union, clusters, delayed))
            )
    return ScheduleSet(dag=dag, schedules=schedules, batches=tuple(batches))


def _make_schedule(dag, leaf, nodes, clusters, delayed) -> StaticSchedule:
    return StaticSchedule(
        leaf=leaf,
        nodes=frozenset(nodes),
        code_size_bytes=_estimate_code_size(dag, nodes),
        clusters={k: clusters[k] for k in nodes if k in clusters},
        delayed_fanins=frozenset(k for k in nodes if k in delayed),
    )


def _estimate_code_size(dag: DAG, nodes: set[str]) -> int:
    """Serialized size of the shipped schedule via an actual pickle of the
    key/function-name payload (the reference generator's estimator)."""
    payload = [(k, getattr(dag.tasks[k].fn, "__name__", "fn")) for k in nodes]
    try:
        return len(pickle.dumps(payload))
    except Exception:  # pragma: no cover - defensive
        return 64 * len(nodes)


def subschedule_start_points(
    schedule: StaticSchedule, dag: DAG, node: str
) -> Iterator[str]:
    """Out-edges of ``node`` within ``schedule`` (fan-out targets).

    Each invoked Executor is assigned a static schedule that begins with
    one of the out edges; that schedule is a sub-graph of the inviting
    executor's schedule, so invoked executors reuse the parent's shipped
    code (paper §IV-C).
    """
    for child in dag.children[node]:
        assert schedule.covers(child), (
            "out-edge target must be reachable from the schedule's leaf"
        )
        yield child
