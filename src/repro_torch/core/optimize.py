"""DAG compiler: composable rewrite passes run before scheduling.

The paper attributes WUKONG's wins to shipping static schedules and
keeping data local to executors (§IV-B–C, §V-B); the follow-up work
(*Wukong: A Scalable and Locality-Enhanced Framework for Serverless
Parallel Computing*, PAPERS.md) goes further with task clustering and
delayed I/O to cut KV-store round trips. This module implements that
compiler layer as three composable passes over a ``DAG``:

1. **Linear-chain fusion** (``fuse_chains``): a dependency edge u -> v
   with out-degree(u) == 1 and in-degree(v) == 1 carries a value that
   exactly one consumer will ever read. Maximal runs of such edges are
   collapsed into one fused task keyed by the chain tail, so the
   intermediate values never exist as graph edges at all — they cannot
   hit the KV store, cannot be re-read, and cost zero scheduling
   overhead. Fusion never crosses a fan-in or fan-out boundary: the
   chain head may itself be a fan-in node (the boundary is *before* the
   head) and the tail may fan out (the boundary is *after* the tail),
   but no interior edge touches a node with in-degree or out-degree
   above one.

2. **Task clustering** (``cluster_tasks``): annotates every node with a
   cluster id — the head of the static *become-path* that a Task
   Executor walks (trivial fan-outs and first-child become edges), with
   fan-in nodes joining the cluster of their primary (first) parent.
   The executor uses the annotation to *delay* KV writes at fan-in
   boundaries: arrivals deposit their locally-held inputs atomically
   with the dependency-counter increment (one round trip, not two), and
   the last arriver never writes its own value at all — it keeps the
   object in executor-local memory and carries it through the fan-in.
   This is the delayed-I/O locality optimization from the follow-up
   paper; it deterministically saves one KV ``set`` (plus one base
   round-trip per arriver) at every clustered fan-in node.

3. **Fan-out coalescing** (``coalesce_fanouts``): sibling leaves that
   share an identical child signature are grouped into batches (kept
   below the proxy threshold) so one executor invocation runs the whole
   batch, draining the invoker queue ``batch`` times faster on wide
   fan-outs; the executor applies the same batching to the children it
   invokes at a runtime fan-out.

Every pass is independently switchable through ``OptimizeConfig`` so
§V-B-style factor ablations can measure each one in isolation. Passes
rewrite/annotate only; correctness is preserved by construction: the
optimized DAG computes exactly the same root values as a sequential
topological evaluation of the original DAG (see tests/test_optimize.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

from repro_torch.analysis.dagcheck import check_compiled
from repro_torch.core.dag import DAG, Task, TaskRef


@dataclasses.dataclass(frozen=True)
class OptimizeConfig:
    """Which passes run, and their knobs (all passes default on)."""

    fuse_chains: bool = True
    cluster_tasks: bool = True
    coalesce_fanouts: bool = True
    max_fusion_len: int = 64     # split pathological chains for retry granularity
    coalesce_batch: int = 7      # max leaves per batched invocation; kept
                                 # below the default proxy threshold (8) so
                                 # batched spawns stay on the fast path


#: Convenience preset: every pass enabled with defaults.
ALL_PASSES = OptimizeConfig()
#: Convenience preset: the identity pipeline (compile_dag returns an
#: annotated but unrewritten graph).
NO_PASSES = OptimizeConfig(
    fuse_chains=False, cluster_tasks=False, coalesce_fanouts=False
)


@dataclasses.dataclass(frozen=True)
class PassStats:
    """One row of the compiler report (surfaced in ``JobReport``)."""

    name: str
    before_tasks: int
    after_tasks: int
    detail: str = ""


class CompiledDAG(DAG):
    """A ``DAG`` plus optimizer annotations.

    ``clusters``        — task key -> cluster id (head of its become-path);
                          empty when the clustering pass is off.
    ``delayed_fanins``  — fan-in nodes where executors use the atomic
                          deposit-and-increment protocol (delayed I/O).
    ``leaf_batches``    — tuple of leaf-key tuples; each batch is started
                          by ONE executor invocation. Covers every leaf
                          (singleton batches when coalescing is off).
    ``fused``           — fused task key -> original chain keys, head first.
    ``pass_stats``      — per-pass before/after report.
    """

    def __init__(
        self,
        tasks: Iterable[Task],
        clusters: Mapping[str, str] | None = None,
        delayed_fanins: Iterable[str] = (),
        leaf_batches: Iterable[tuple[str, ...]] | None = None,
        fused: Mapping[str, tuple[str, ...]] | None = None,
        pass_stats: Iterable[PassStats] = (),
        coalesce_batch: int = 0,
    ):
        super().__init__(tasks)
        self.clusters: dict[str, str] = dict(clusters or {})
        self.delayed_fanins: frozenset[str] = frozenset(delayed_fanins)
        self.leaf_batches: tuple[tuple[str, ...], ...] = (
            tuple(tuple(b) for b in leaf_batches)
            if leaf_batches is not None
            else tuple((leaf,) for leaf in self.leaves)
        )
        self.fused: dict[str, tuple[str, ...]] = dict(fused or {})
        self.pass_stats: tuple[PassStats, ...] = tuple(pass_stats)
        self.coalesce_batch = coalesce_batch


# ---------------------------------------------------------------------------
# Pass 1: linear-chain fusion
# ---------------------------------------------------------------------------


def fusible_edges(dag: DAG) -> set[tuple[str, str]]:
    """Edges u->v collapsible without crossing a fan-in/fan-out boundary."""
    return {
        (u, vs[0])
        for u, vs in dag.children.items()
        if len(vs) == 1 and len(dag.deps[vs[0]]) == 1
    }


def find_chains(dag: DAG, max_len: int = 64) -> list[list[str]]:
    """Maximal runs of fusible edges, as key lists (head first).

    Fusible edges form vertex-disjoint paths by construction (a node has
    at most one fusible out-edge and one fusible in-edge), so a simple
    head-scan enumerates them all.
    """
    edges = fusible_edges(dag)
    has_fusible_in = {v for _, v in edges}
    seg_len = max(2, max_len)
    chains: list[list[str]] = []
    for head in dag.tasks:
        if head in has_fusible_in:
            continue  # interior or tail of some chain
        chain = [head]
        while True:
            children = dag.children[chain[-1]]
            if not children or (chain[-1], children[0]) not in edges:
                break
            chain.append(children[0])
        # Disjoint segments of at most seg_len nodes; the edge between two
        # adjacent segments survives as a regular (tail -> next head) edge.
        for i in range(0, len(chain), seg_len):
            seg = chain[i:i + seg_len]
            if len(seg) > 1:
                chains.append(seg)
    return chains


def _make_fused_fn(chain: list[str], tasks: Mapping[str, Task]):
    """One callable running the whole chain; the only graph-visible value
    is the tail's output, so interior values stay on the executor heap."""
    head = tasks[chain[0]]

    def fused(*args: Any, **kwargs: Any) -> Any:
        value = head.fn(*args, **kwargs)
        prev = chain[0]
        for key in chain[1:]:
            t = tasks[key]
            a = [value if isinstance(x, TaskRef) and x.key == prev else x
                 for x in t.args]
            kw = {k: value if isinstance(v, TaskRef) and v.key == prev else v
                  for k, v in t.kwargs.items()}
            value = t.fn(*a, **kw)
            prev = key
        return value

    fused.__name__ = f"fused[{chain[0]}..{chain[-1]}]"
    return fused


def fuse_linear_chains(
    dag: DAG, max_len: int = 64
) -> tuple[list[Task], dict[str, tuple[str, ...]]]:
    """Rewrite: collapse each chain into one task keyed by its tail.

    The fused task inherits the head's args (its in-edges) and the tail's
    key (its out-edges), so the surrounding graph is untouched and root
    keys survive verbatim.
    """
    chains = find_chains(dag, max_len)
    drop: set[str] = set()
    replace: dict[str, Task] = {}
    provenance: dict[str, tuple[str, ...]] = {}
    for chain in chains:
        head, tail = chain[0], chain[-1]
        drop.update(chain[:-1])
        replace[tail] = Task(
            key=tail,
            fn=_make_fused_fn(chain, dag.tasks),
            args=dag.tasks[head].args,
            kwargs=dag.tasks[head].kwargs,
        )
        provenance[tail] = tuple(chain)
    out = [
        replace.get(k, t) for k, t in dag.tasks.items() if k not in drop
    ]
    return out, provenance


# ---------------------------------------------------------------------------
# Pass 2: task clustering (annotation only)
# ---------------------------------------------------------------------------


def compute_clusters(dag: DAG) -> tuple[dict[str, str], frozenset[str]]:
    """Cluster id per node + the set of delayed fan-in nodes.

    A node joins its parent's cluster along edges an executor walks
    without a new invocation: the trivial fan-out / become edge (it is
    the parent's first child) or — for fan-in nodes — the primary
    (first-listed) in-edge, matching the executor that continues through
    the counter. Every other node heads a fresh cluster.
    """
    clusters: dict[str, str] = {}
    delayed: set[str] = set()
    for k in dag.topological_order():
        deps = dag.deps[k]
        if not deps:
            clusters[k] = k
        elif len(deps) == 1:
            parent = deps[0]
            is_become = dag.children[parent] and dag.children[parent][0] == k
            clusters[k] = clusters[parent] if is_become else k
        else:
            clusters[k] = clusters[deps[0]]
            delayed.add(k)  # shares a cluster with its primary parent
    return clusters, frozenset(delayed)


# ---------------------------------------------------------------------------
# Pass 3: fan-out coalescing (annotation only)
# ---------------------------------------------------------------------------


def coalesce_leaves(dag: DAG, batch: int) -> tuple[tuple[str, ...], ...]:
    """Group sibling leaves with an identical child signature into batches
    of at most ``batch`` keys; singleton batches for everything else."""
    groups: dict[tuple[str, ...], list[str]] = {}
    for leaf in dag.leaves:
        groups.setdefault(tuple(sorted(dag.children[leaf])), []).append(leaf)
    batches: list[tuple[str, ...]] = []
    step = max(1, batch)
    for siblings in groups.values():
        for i in range(0, len(siblings), step):
            batches.append(tuple(siblings[i:i + step]))
    return tuple(batches)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def compile_dag(dag: DAG, config: OptimizeConfig | None = None) -> CompiledDAG:
    """Run the enabled passes and return the annotated, rewritten DAG."""
    cfg = config or ALL_PASSES
    stats: list[PassStats] = []
    tasks: Iterable[Task] = dag.tasks.values()
    fused: dict[str, tuple[str, ...]] = {}
    working = dag

    if cfg.fuse_chains:
        before = len(working)
        task_list, fused = fuse_linear_chains(working, cfg.max_fusion_len)
        if fused:
            working = DAG(task_list)
            tasks = working.tasks.values()
        # else: no fusible chains — skip rebuilding (and re-validating)
        # the whole graph; host-side schedule generation is a measured
        # hot path on wide fusion-free DAGs like tree reductions.
        stats.append(PassStats(
            name="fuse_chains", before_tasks=before, after_tasks=len(working),
            detail=f"{len(fused)} chains fused",
        ))

    clusters: dict[str, str] = {}
    delayed: frozenset[str] = frozenset()
    if cfg.cluster_tasks:
        clusters, delayed = compute_clusters(working)
        stats.append(PassStats(
            name="cluster_tasks", before_tasks=len(working),
            after_tasks=len(working),
            detail=(f"{len(set(clusters.values()))} clusters, "
                    f"{len(delayed)} delayed fan-ins"),
        ))

    batches: tuple[tuple[str, ...], ...] | None = None
    if cfg.coalesce_fanouts:
        batches = coalesce_leaves(working, cfg.coalesce_batch)
        stats.append(PassStats(
            name="coalesce_fanouts", before_tasks=len(working.leaves),
            after_tasks=len(batches),
            detail=f"{len(working.leaves)} leaves -> "
                   f"{len(batches)} invocations",
        ))

    compiled = CompiledDAG(
        tasks=tasks,
        clusters=clusters,
        delayed_fanins=delayed,
        leaf_batches=batches,
        fused=fused,
        pass_stats=stats,
        coalesce_batch=cfg.coalesce_batch if cfg.coalesce_fanouts else 0,
    )
    # Pre-flight: every annotation the passes produced must be
    # consistent with the rewritten graph (ConsistencyError here means a
    # compiler-pass bug, caught before any executor is invoked).
    check_compiled(compiled)
    return compiled


def ensure_compiled(dag: DAG, config: OptimizeConfig | None) -> DAG:
    """Engine entry point: compile unless disabled or already compiled."""
    if isinstance(dag, CompiledDAG):
        return dag
    if config is None:
        return dag
    return compile_dag(dag, config)
