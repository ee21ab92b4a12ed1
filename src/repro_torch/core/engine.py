"""DAG engines: WUKONG + every design iteration the paper compares against.

Engines (paper §III's "journey from the serverful to the serverless"):

- ``ServerfulEngine``  — the Dask-distributed stand-in: a centralized
  scheduler with W long-lived workers and direct worker-to-worker data
  transfer (no KV hop). "Dask (EC2)" is W large; "Dask (Laptop)" is W=4.
- ``StrawmanEngine``   — centralized; one Lambda per task; completion ACK
  over a per-Lambda TCP connection handled serially by the scheduler
  (Fig. 1).
- ``PubSubEngine``     — strawman + Redis pub/sub completion notifications
  (Fig. 2).
- ``ParallelInvokerEngine`` — pub/sub + a pool of dedicated invoker
  processes (Fig. 3).
- ``WukongEngine``     — decentralized static/dynamic scheduling (Fig. 5):
  per-leaf static schedules, executor-local data locality, fan-in
  dependency counters, become/invoke fan-outs, proxy for large fan-outs.

All engines consume the same ``DAG`` (the paper could only compare against
Dask because both shared a representation — §V-D; we keep that property
for every baseline) and the same simulated FaaS cost model.

Time never comes from ``time.*`` here: every wait, deadline, and
timestamp goes through the engine clock (repro_torch.core.simclock). Under the
default virtual clock (``CostModel.time_scale == 0``) idle waiting costs
zero wall time, ``job_timeout_s`` means *simulated* seconds, and
``JobReport.wall_s`` is the deterministic simulated makespan; with
``time_scale > 0`` the seed real-time behavior is preserved for
cross-checks.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import TYPE_CHECKING, Any

from repro_torch.core.dag import DAG, DynamicDAG, TaskRef
from repro_torch.core.executor import (
    RESULTS_CHANNEL,
    ExecutorContext,
    TaskExecutor,
    TaskMetrics,
)
from repro_torch.core.faults import (
    FaultConfig,
    FaultInjector,
    FaultStats,
    HeartbeatRegistry,
)
from repro_torch.core.invoker import FanoutProxy, InvokerPool
from repro_torch.core.kvstore import PURGED, CostModel, ShardedKVStore, sizeof
from repro_torch.core.optimize import OptimizeConfig, PassStats, ensure_compiled
from repro_torch.core.schedule import generate_static_schedules
from repro_torch.core.simclock import run_effects, task_clock

if TYPE_CHECKING:  # import cycle: repro_torch.platform imports repro_torch.core
    from repro_torch.platform import FaaSPlatform, PlatformConfig


def _make_platform(config: "PlatformConfig | None", cost: CostModel,
                   clock) -> "FaaSPlatform | None":
    """Instantiate the stateful platform lazily: a module-level import
    of repro_torch.platform here would close an import cycle (repro_torch.platform
    -> repro_torch.core.kvstore -> repro_torch.core.__init__ -> engine) and crash
    any process that imports repro_torch.platform first."""
    if config is None:
        return None
    from repro_torch.platform import FaaSPlatform

    return FaaSPlatform(config, cost, clock)


class JobError(RuntimeError):
    pass


@dataclasses.dataclass
class JobSubstrate:
    """An injected execution substrate for ONE job on a shared platform.

    By default every ``compute()`` builds a private KV store (and with
    it a private clock) plus a private platform — fine for one-job
    benchmarks, useless for studying contention. The orchestrator
    (repro_torch.core.orchestrator) instead builds the substrate ONCE and
    passes each job a ``JobSubstrate``:

    ``kv``        — the job's view of the shared store (normally a
                    ``ShardedKVStore.namespace(job_id)`` so keys,
                    counters, and channels don't collide across jobs);
                    supplies the shared clock via ``kv.clock``.
    ``platform``  — the SHARED stateful FaaS platform, so concurrent
                    jobs compete for warm containers and the account
                    concurrency cap and billing is account-wide. None
                    keeps the legacy stochastic cold-start draw.
    ``function``  — the platform function identity this job invokes
                    (the orchestrator uses one function per *tenant*:
                    warm containers pool per function, so tenants share
                    the account but never each other's containers, and
                    billing is attributable per tenant).

    ``job``       — billing attribution label: invocations run for this
                    substrate are tagged with it in the platform's
                    billing meter, so per-JOB billed USD survives an
                    orchestrator crash (the journal records it) and is
                    auditable on a shared account.
    ``resume``    — crash recovery: executors probe the store for a
                    durable task output before executing and reuse it,
                    so a re-admitted job never re-executes (or re-bills
                    the compute of) journaled-complete work.

    When a substrate is injected the engine creates none of the above
    and ignores ``EngineConfig.platform``; everything else (invoker
    pools, runtime pool, schedules, monitors) stays per-job.
    """

    kv: Any
    platform: "FaaSPlatform | None" = None
    function: str = "executor"
    job: "str | None" = None
    resume: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    cost: CostModel = dataclasses.field(default_factory=CostModel)
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    n_kv_shards: int = 10
    colocate_kv_shards: bool = False      # §V-B factor: shards share one VM
    counter_mode: str = "edge_set"         # or "paper" (plain INCR)
    num_initial_invokers: int = 20         # scheduler-side leaf invokers
    num_proxy_invokers: int = 20           # KV-proxy fan-out invokers
    proxy_threshold: int = 8               # max_task_fanout
    use_proxy: bool = True                 # §V-B factor
    inline_fanout_args: bool = False       # beyond-paper locality opt
    # Data-plane factor (Lambada-style batching): executors gather their
    # inputs with one pipelined mget (one kv_base_ms per shard batch)
    # instead of one round trip per key. Striping, the other data-plane
    # factor, is configured on the CostModel (stripe_threshold_bytes /
    # max_stripes) since it is a property of the storage substrate.
    batch_kv_round_trips: bool = True
    # Simulated Lambda concurrency (runtime-pool cap). Workers are
    # created lazily in both clock modes, so the cap can be raised to
    # AWS-scale (the virtual clock sweeps 8k-64k-task DAGs without the
    # wall-clock cost that used to bind this to 512).
    max_concurrency: int = 4096
    speculative_poll_s: float = 0.01       # simulated s under VirtualClock
    job_timeout_s: float = 600.0           # simulated s under VirtualClock
    # DAG compiler pipeline run before scheduling (repro_torch.core.optimize);
    # None = run the graph verbatim (the seed behavior). Each pass is
    # independently switchable for §V-B-style factor ablations.
    optimize: OptimizeConfig | None = None
    # Stateful FaaS platform model (repro_torch.platform): warm-container pool
    # with keep-alive expiry, account concurrency throttling with burst
    # ramp, and a billing meter. None = the legacy memoryless
    # ``warm_fraction`` draw (kept for cross-checks).
    platform: PlatformConfig | None = None
    # Per-task metrics records cost ~2.5 dicts/task of memory; million-task
    # scaling runs switch them off (charged_ms/kv_stats are unaffected).
    record_metrics: bool = True


@dataclasses.dataclass
class JobReport:
    results: dict[str, Any]
    wall_s: float  # simulated makespan (virtual) / real elapsed (realtime)
    tasks: int
    executors_invoked: int
    kv_stats: dict[str, int]
    metrics: list[dict[str, Any]]
    charged_ms: float
    optimizer: tuple[PassStats, ...] = ()  # compiler pass report
    # Provider-model counters: cold/warm starts, throttle events, peak
    # concurrency, billed USD (pool mode); invoker cold-start counts in
    # every mode (the InvokerPool counter was previously dropped).
    platform_stats: dict[str, Any] = dataclasses.field(default_factory=dict)
    # Fault/retry observability (faults.FaultStats snapshot + the invoker
    # pools' 429-retry tally): task attempts, injected failures, retries,
    # speculative duplicates, throttle retries, resumed tasks.
    fault_stats: dict[str, int] = dataclasses.field(default_factory=dict)
    # Locality observability (repro_torch.core.cache): THIS job's per-tier
    # hits/misses/evictions/spills and bytes served locally vs remotely.
    # Empty unless the platform runs with a container cache configured.
    cache_stats: dict[str, int] = dataclasses.field(default_factory=dict)


def _platform_stats(platform: "FaaSPlatform | None",
                    pools: "list[InvokerPool]") -> dict[str, Any]:
    """The JobReport provider-model block. With the stateful platform:
    its full snapshot (pool / throttle / billing counters). Without it:
    the legacy stochastic-draw counters — surfacing the per-pool
    ``cold_starts`` tally that was previously incremented but never
    reported.

    The block is rebuilt defensively (top level AND nested dicts):
    ``snapshot()`` promises fresh structures, but on a shared platform
    two JobReports must never alias one counters dict even if that
    contract regresses — we mutate the block right below, and callers
    mutate it after us (benchmarks annotate rows in place)."""
    if platform is not None:
        stats = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in platform.snapshot().items()}
    else:
        stats = {"mode": "legacy",
                 "cold_starts": sum(p.cold_starts for p in pools)}
    stats["invocations"] = sum(p.invocations for p in pools)
    return stats


def _cache_stats_block(ctx: ExecutorContext,
                       kv_stats: "dict[str, int]") -> "dict[str, int]":
    """The JobReport locality block: this job's cache-tier counters plus
    bytes served remotely (the KV bytes it actually read — everything a
    cache hit did NOT turn into local service). Empty when no container
    cache ran, so cacheless reports are unchanged."""
    snap = ctx.cache_stats.snapshot()
    if not any(snap.values()):
        return {}
    snap["bytes_remote"] = kv_stats.get("bytes_read", 0)
    return snap


class _ResultWaiter:
    """Collects root results from the results channel, dedupes duplicates
    (speculative executors may publish a root twice).

    Event-driven on the engine clock: the waiter blocks on its
    subscription until a message or the job deadline — no polling, so
    idle waiting costs zero wall time under the virtual clock and
    ``timeout_s`` means clock (simulated) seconds."""

    def __init__(self, kv: ShardedKVStore, roots: tuple[str, ...],
                 dag: "DAG | None" = None):
        self.kv = kv
        self.roots = set(roots)
        # Dynamic completion detection: on a DynamicDAG the total task
        # count — and the root set — is not known at submit time (an
        # expansion may add parentless sinks). The waiter re-reads the
        # live root set each iteration instead of trusting the snapshot.
        self._dag = dag
        self.sub = kv.subscribe(RESULTS_CHANNEL)

    def _live_roots(self) -> set[str]:
        if self._dag is not None:
            self.roots = set(self._dag.roots)
        return self.roots

    def close(self) -> None:
        """Release the results subscription. Without this every job
        leaked its queue into the store's ``_channels`` — invisible when
        the store died with the job, a real accumulation (and publish
        fan-out slowdown) once the substrate outlives jobs."""
        self.kv.unsubscribe(RESULTS_CHANNEL, self.sub)

    def wait_g(self, timeout_s: float):
        clock = self.kv.clock
        done: set[str] = set()
        deadline = clock.now_ms() + timeout_s * 1e3
        while done != self._live_roots():
            remaining_ms = deadline - clock.now_ms()
            if remaining_ms <= 0:
                raise JobError(
                    f"job timed out; missing roots: {sorted(self.roots - done)}"
                )
            try:
                msg = yield ("get", self.sub, remaining_ms / 1e3)
            except queue.Empty:
                continue
            if msg is PURGED:
                raise JobError("job namespace purged while awaiting results")
            if msg["type"] == "error":
                raise JobError(f"task {msg['key']!r} failed: {msg['error']}")
            if msg["key"] in self._live_roots():
                done.add(msg["key"])
        results: dict[str, Any] = {}
        for k in sorted(self.roots):
            results[k] = yield from self.kv.get_g(k)
        return results

    def wait(self, timeout_s: float) -> dict[str, Any]:
        return run_effects(self.kv.clock, self.wait_g(timeout_s))


class WukongEngine:
    """The decentralized engine (paper §IV)."""

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()

    def compute(self, dag: DAG,
                substrate: JobSubstrate | None = None) -> JobReport:
        """Run the job to completion on the engine clock.

        The job body is an effect generator (``compute_g``); the clock's
        ``run`` drives it — as the root continuation of the event loop on
        the event substrate, or inline on the calling (actor) thread on
        the thread/realtime substrates."""
        cfg = self.config
        # DAG compiler: rewrite/annotate before any schedule is generated.
        # Host-side work (compilation, schedule generation) happens before
        # the clock starts: it is scheduler prep, not simulated time.
        dag = ensure_compiled(dag, cfg.optimize)
        if substrate is None:
            kv: Any = ShardedKVStore(
                n_shards=cfg.n_kv_shards,
                cost=cfg.cost,
                colocate_shards=cfg.colocate_kv_shards,
                counter_mode=cfg.counter_mode,
            )
        else:
            kv = substrate.kv
        return kv.clock.run(self._compute_g(dag, kv, substrate))

    def compute_g(self, dag: DAG, substrate: JobSubstrate):
        """The job as an effect generator, for composition inside an
        already-running substrate (the orchestrator's job runners do
        ``yield from engine.compute_g(dag, substrate)``)."""
        dag = ensure_compiled(dag, self.config.optimize)
        return (yield from self._compute_g(dag, substrate.kv, substrate))

    def _compute_g(self, dag: DAG, kv: Any, substrate: JobSubstrate | None):
        cfg = self.config
        function = substrate.function if substrate is not None else "executor"
        clock = kv.clock
        schedule_set = generate_static_schedules(dag)
        # On a shared substrate the clock's cumulative charge counter
        # does not restart per job: report the delta. (With jobs from
        # OTHER tenants charging the same clock concurrently, the
        # per-job delta includes their charges too — per-tenant money
        # accounting goes through the platform's billing meter, which
        # meters per invocation body and is exact.)
        charged0 = clock.charged_ms
        # Storage Manager registers the fan-in counters at workflow
        # start — in ONE batched round trip (Lambada-style request
        # batching), or one per counter when the factor is ablated.
        counters = schedule_set.fan_in_counters()
        if cfg.batch_kv_round_trips:
            yield from kv.register_counters_g(counters)
        else:
            for cid, width in counters.items():
                yield from kv.register_counter_g(cid, width)

        metrics = TaskMetrics(clock, enabled=cfg.record_metrics)
        heartbeats = HeartbeatRegistry()
        faults = FaultInjector(cfg.faults)
        fault_stats = FaultStats()
        pool = clock.pool(cfg.max_concurrency)
        # Self-contained: one platform instance per job (initial and
        # proxy invokers share the cap and container pool). Injected:
        # the SHARED platform — this job contends with every other
        # job on the substrate.
        if substrate is not None:
            platform = substrate.platform
        else:
            platform = _make_platform(cfg.platform, cfg.cost, clock)
            caches = getattr(platform, "caches", None)
            if caches is not None and hasattr(kv, "add_purge_listener"):
                # Namespace reclamation must reach container caches too
                # (idempotent registration). On a shared substrate the
                # orchestrator registers its shared platform instead.
                kv.add_purge_listener(caches.invalidate_prefix)
        job = substrate.job if substrate is not None else None
        initial_invokers = InvokerPool(
            cfg.num_initial_invokers, cfg.cost, clock, pool, name="init",
            platform=platform, function=function, job=job,
        )
        proxy_invokers = InvokerPool(
            cfg.num_proxy_invokers, cfg.cost, clock, pool, name="proxy",
            platform=platform, function=function, job=job,
        )
        proxy = FanoutProxy(kv, proxy_invokers) if cfg.use_proxy else None
        # Per-job stop signal: set at teardown (success OR failure)
        # and checked by executors at task boundaries and by spawn
        # below, so an abandoned job's in-flight work winds down
        # instead of consuming shared capacity.
        stop_job = clock.event()

        ctx: ExecutorContext | None = None

        def spawn(start_key, seed_cache, schedule, width, attempt=0,
                  parent=None, hint_keys=()):
            # Effect generator: spawn charges nothing itself, but the
            # proxy path publishes (a charged KV operation).
            assert ctx is not None
            if stop_job.is_set():
                return  # dead job: drop late retries/speculation
            ship_ms = schedule.code_size_bytes / (
                cfg.cost.schedule_ship_mbps * 1e6
            ) * 1e3
            body = _executor_body(ctx, schedule, start_key, seed_cache,
                                  attempt, parent, hint_keys=hint_keys)
            if proxy is not None and width >= cfg.proxy_threshold:
                # Large fan-out: one pub/sub message offloads all the
                # invocations to the proxy's parallel invoker pool.
                yield from kv.publish_g(FanoutProxy.CHANNEL,
                                        {"spawns": [body]})
            else:
                initial_invokers.submit(body, extra_ms=ship_ms)

        ctx = ExecutorContext(
            dag=dag,
            kv=kv,
            spawn=spawn,
            faults=faults,
            heartbeats=heartbeats,
            metrics=metrics,
            inline_fanout_args=cfg.inline_fanout_args,
            coalesce_batch=getattr(dag, "coalesce_batch", 0),
            batch_kv_round_trips=cfg.batch_kv_round_trips,
            compute_clock=(platform.compute_clock(clock, function)
                           if platform is not None else None),
            stop=stop_job,
            resume=substrate.resume if substrate is not None else False,
            fault_stats=fault_stats,
            schedule_set=schedule_set,
        )

        waiter = _ResultWaiter(
            kv, dag.roots,
            dag=dag if isinstance(dag, DynamicDAG) else None)
        t0_ms = clock.now_ms()
        # Metric stamps are relative to the job's t0 (the clock is
        # shared and does not restart per job).
        metrics.origin_ms = t0_ms
        # Initial Task Executor Invokers: one executor per start batch
        # — one batch per static schedule (paper §IV-C), or fewer when
        # the coalescing pass grouped sibling leaves.
        for keys, sched in schedule_set.batches:
            yield from spawn(keys, {}, sched, width=1)

        stop_monitor = clock.event()
        clock.spawn(
            lambda: _speculative_monitor(
                ctx, stop_monitor, cfg, schedule_set, clock),
            name="spec-monitor",
        )
        try:
            results = yield from waiter.wait_g(cfg.job_timeout_s)
        finally:
            stop_job.set()
            stop_monitor.set()
            initial_invokers.close()
            proxy_invokers.close()
            if proxy is not None:
                yield from proxy.close_g()
            waiter.close()
            # Platform mode: queued-but-unstarted bodies are WRAPPED
            # invocations already holding a concurrency slot and a
            # container (reserved by the invoker lane); cancelling
            # them would leak both into the shared account forever.
            # They must run — the stop signal makes each return at
            # its first task boundary, and the wrapper's finally
            # releases the reservation. Without a platform nothing
            # is reserved, so queued bodies are safely dropped.
            pool.shutdown(wait=False, cancel_futures=platform is None)
        wall = (clock.now_ms() - t0_ms) / 1e3
        # Snapshot every counter while still inside the job generator:
        # the substrate serializes this read against any still-draining
        # leftover work (late retries/speculative duplicates), so the
        # report is deterministic.
        kv_snapshot = kv.stats.snapshot()
        report = JobReport(
            results=results,
            wall_s=wall,
            tasks=len(dag),
            executors_invoked=initial_invokers.invocations
            + proxy_invokers.invocations,
            kv_stats=kv_snapshot,
            metrics=list(metrics.records),
            charged_ms=clock.charged_ms - charged0,
            optimizer=getattr(dag, "pass_stats", ()),
            platform_stats=_platform_stats(
                platform, [initial_invokers, proxy_invokers]),
            fault_stats=_merge_fault_stats(
                fault_stats, [initial_invokers, proxy_invokers]),
            cache_stats=_cache_stats_block(ctx, kv_snapshot),
        )
        return report


def _merge_fault_stats(fault_stats: FaultStats,
                       pools: "list[InvokerPool]") -> dict[str, int]:
    """The JobReport fault/retry block: executor-side counters plus the
    invoker pools' 429-throttle retry tally (counted at the invoker lane,
    where the retry loop lives)."""
    stats = fault_stats.snapshot()
    stats["throttle_retries"] += sum(p.throttle_retries for p in pools)
    return stats


def _executor_body(ctx, schedule, start_key, seed_cache, attempt, parent=None,
                   hint_keys=()):
    def body(container_cache=None):
        return TaskExecutor(ctx, schedule, start_key, seed_cache, attempt,
                            parent=parent,
                            container_cache=container_cache).run_g()

    # Platform handshake: ``accepts_cache`` tells wrap_g to pass the
    # container's multi-tier cache in; ``hint_keys`` (store-qualified
    # input keys) lets the invoker bias placement toward a warm
    # container already holding them. Attributes — not parameters — so
    # the invoker/proxy submit path stays body-shape-agnostic.
    body.accepts_cache = True
    body.hint_keys = tuple(hint_keys)
    return body


def _speculative_monitor(ctx, stop, cfg, schedule_set, clock):
    """Re-invoke executors whose current task exceeds the straggler
    threshold (beyond-paper straggler mitigation; safe via idempotence).

    Heartbeat ages come from the engine clock: under the virtual clock
    they ARE simulated ms; in real-time mode they are real ms scaled back
    to simulated by ``time_scale`` (the seed behavior)."""
    threshold_ms = cfg.faults.speculative_threshold_ms
    if threshold_ms == float("inf"):
        return
    respawned: set[int] = set()
    while True:
        flag = yield ("wait", stop, cfg.speculative_poll_s)
        if flag:
            return
        now_ms = clock.now_ms()
        for hb in ctx.heartbeats.inflight():
            age_ms = now_ms - hb.started_at
            scale = 1.0 if clock.virtual else (cfg.cost.time_scale or 1.0)
            if age_ms / scale > threshold_ms and hb.executor_id not in respawned:
                respawned.add(hb.executor_id)
                # Duplicate every member of a coalesced batch, each with
                # its own covering schedule (a sibling leaf's schedule
                # need not cover the others' reachable sets). The schedule
                # set's covering index makes this O(1) per respawn instead
                # of a linear scan over every schedule.
                for key in hb.start_keys or (hb.start_key,):
                    sched = schedule_set.covering_schedule(key)
                    if sched is not None:
                        ctx.fault_stats.bump("speculative_duplicates")
                        yield from ctx.spawn(key, {}, sched, width=1,
                                             attempt=1, parent=hb.parent)


# ---------------------------------------------------------------------------
# Centralized design iterations (paper §III, Figs. 1-3) and the serverful
# baseline. They share a single implementation parameterized by the
# completion-notification transport and the invoker parallelism.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CentralizedConfig:
    cost: CostModel = dataclasses.field(default_factory=CostModel)
    n_kv_shards: int = 10
    colocate_kv_shards: bool = False
    notification: str = "tcp"      # "tcp" (strawman) | "pubsub"
    num_invokers: int = 1          # >1 = parallel-invoker version
    max_concurrency: int = 4096    # lazily-created runtime workers
    job_timeout_s: float = 600.0   # simulated s under VirtualClock
    # DAG compiler pipeline (chain fusion shrinks the one-Lambda-per-task
    # graph; the executor-level passes are no-ops here). None = verbatim.
    optimize: OptimizeConfig | None = None
    # Stateful FaaS platform model; None = legacy stochastic draw.
    platform: PlatformConfig | None = None
    record_metrics: bool = True    # off for million-task scaling runs


class _CentralizedEngine:
    """Centralized scheduler: tracks readiness, dispatches one Lambda per
    task; Lambdas read inputs from / write outputs to the KV store and
    notify the scheduler, which resolves dependents (Figs. 1-3)."""

    name = "centralized"

    def __init__(self, config: CentralizedConfig | None = None):
        self.config = config or CentralizedConfig()

    def compute(self, dag: DAG,
                substrate: JobSubstrate | None = None) -> JobReport:
        cfg = self.config
        dag = ensure_compiled(dag, cfg.optimize)
        if substrate is None:
            kv: Any = ShardedKVStore(
                n_shards=cfg.n_kv_shards, cost=cfg.cost,
                colocate_shards=cfg.colocate_kv_shards,
            )
        else:
            kv = substrate.kv
        return kv.clock.run(self._compute_g(dag, kv, substrate))

    def compute_g(self, dag: DAG, substrate: JobSubstrate):
        dag = ensure_compiled(dag, self.config.optimize)
        return (yield from self._compute_g(dag, substrate.kv, substrate))

    def _compute_g(self, dag: DAG, kv: Any, substrate: JobSubstrate | None):
        cfg = self.config
        function = substrate.function if substrate is not None else "executor"
        clock = kv.clock
        charged0 = clock.charged_ms
        metrics = TaskMetrics(clock, enabled=cfg.record_metrics)
        pool = clock.pool(cfg.max_concurrency)
        if substrate is not None:
            platform = substrate.platform
        else:
            platform = _make_platform(cfg.platform, cfg.cost, clock)
        invokers = InvokerPool(
            cfg.num_invokers, cfg.cost, clock, pool, platform=platform,
            function=function,
            job=substrate.job if substrate is not None else None)
        compute_clock = (platform.compute_clock(clock, function)
                         if platform is not None else clock)
        done_q = clock.queue()
        inflight = [0]
        inflight_lock = threading.Lock()

        # Scheduler-side message handling is serialized (the §III-B
        # bottleneck). TCP mode additionally pays a per-connection
        # setup and an IRQ-flood term that grows with the number of
        # Lambdas holding open connections (paper §III-C) — the reason
        # pub/sub pulls ahead as tasks get longer and waves of
        # completions pile up.
        def per_msg_ms() -> float:
            if cfg.notification != "tcp":
                return cfg.cost.pubsub_msg_ms
            with inflight_lock:
                n = inflight[0]
            return (cfg.cost.tcp_connect_ms
                    + cfg.cost.tcp_msg_ms
                    * (1.0 + cfg.cost.tcp_irq_factor * n))

        def resolve_g(a):
            if isinstance(a, TaskRef):
                return (yield from kv.get_g(a.key))
            return a

        def lambda_body(key: str):
            def body():
                with inflight_lock:
                    inflight[0] += 1
                try:
                    task = dag.tasks[key]
                    t0 = clock.now_ms()
                    args = []
                    for a in task.args:
                        args.append((yield from resolve_g(a)))
                    kwargs = {}
                    for k, v in task.kwargs.items():
                        kwargs[k] = yield from resolve_g(v)
                    read_ms = clock.now_ms() - t0
                    t0 = clock.now_ms()
                    with task_clock(compute_clock):
                        out = task.fn(*args, **kwargs)
                    # Flush compute deferred inside the task function
                    # (event substrate) before reading the clock delta.
                    yield ("flush",)
                    compute_ms = clock.now_ms() - t0
                    t0 = clock.now_ms()
                    yield from kv.put_g(key, out)
                    write_ms = clock.now_ms() - t0
                    metrics.record(
                        task=key, event="executed", read_ms=read_ms,
                        compute_ms=compute_ms, write_ms=write_ms,
                        nbytes=sizeof(out),
                    )
                    done_q.put((key, None))
                except Exception as exc:  # pragma: no cover - see below
                    done_q.put((key, exc))
                finally:
                    with inflight_lock:
                        inflight[0] -= 1

            return body

        indeg = {k: len(dag.deps[k]) for k in dag.tasks}
        t0_ms = clock.now_ms()
        metrics.origin_ms = t0_ms
        for k in dag.leaves:
            invokers.submit(lambda_body(k))
        remaining = set(dag.tasks)
        deadline = clock.now_ms() + cfg.job_timeout_s * 1e3
        try:
            while remaining:
                timeout_ms = deadline - clock.now_ms()
                if timeout_ms <= 0:
                    raise JobError(f"timeout; remaining={len(remaining)}")
                try:
                    key, err = yield ("get", done_q, timeout_ms / 1e3)
                except queue.Empty:
                    continue
                if err is not None:
                    raise JobError(f"task {key!r} failed: {err!r}")
                # serialized scheduler handling
                yield ("charge", per_msg_ms())
                remaining.discard(key)
                for child in dag.children[key]:
                    indeg[child] -= 1
                    if indeg[child] == 0:
                        invokers.submit(lambda_body(child))
        finally:
            invokers.close()
            # See WukongEngine: platform-wrapped queued bodies hold
            # reservations that only their wrapper's finally releases —
            # run them, don't drop them.
            pool.shutdown(wait=False, cancel_futures=platform is None)
        wall = (clock.now_ms() - t0_ms) / 1e3
        results = {}
        for k in dag.roots:
            results[k] = yield from kv.get_g(k)
        # Snapshot inside the job generator (see WukongEngine).
        report = JobReport(
            results=results,
            wall_s=wall,
            tasks=len(dag),
            executors_invoked=invokers.invocations,
            kv_stats=kv.stats.snapshot(),
            metrics=list(metrics.records),
            charged_ms=clock.charged_ms - charged0,
            optimizer=getattr(dag, "pass_stats", ()),
            platform_stats=_platform_stats(platform, [invokers]),
            fault_stats=_merge_fault_stats(FaultStats(), [invokers]),
        )
        return report


class StrawmanEngine(_CentralizedEngine):
    """Fig. 1: per-Lambda TCP notifications, single invoker."""

    name = "strawman"

    def __init__(self, cost: CostModel | None = None, **kw: Any):
        super().__init__(CentralizedConfig(
            cost=cost or CostModel(), notification="tcp", num_invokers=1, **kw
        ))


class PubSubEngine(_CentralizedEngine):
    """Fig. 2: pub/sub notifications, single invoker."""

    name = "pubsub"

    def __init__(self, cost: CostModel | None = None, **kw: Any):
        super().__init__(CentralizedConfig(
            cost=cost or CostModel(), notification="pubsub",
            num_invokers=1, **kw
        ))


class ParallelInvokerEngine(_CentralizedEngine):
    """Fig. 3: pub/sub + dedicated parallel invoker processes."""

    name = "parallel_invoker"

    def __init__(self, cost: CostModel | None = None, num_invokers: int = 20,
                 **kw: Any):
        super().__init__(CentralizedConfig(
            cost=cost or CostModel(), notification="pubsub",
            num_invokers=num_invokers, **kw
        ))


@dataclasses.dataclass(frozen=True)
class ServerfulConfig:
    cost: CostModel = dataclasses.field(default_factory=CostModel)
    n_workers: int = 25            # paper EC2: 5 VMs x 5 worker processes
    worker_bandwidth_mbps: float = 1000.0  # direct worker<->worker TCP
    job_timeout_s: float = 600.0   # simulated s under VirtualClock
    optimize: OptimizeConfig | None = None  # DAG compiler (chain fusion)
    # Fixed-cluster billing (the serverless counterpart bills GB-seconds
    # through repro_torch.platform): the cluster costs VM-hours for the job's
    # simulated makespan whether its workers are busy or idle — the
    # pay-per-allocation vs pay-per-use comparison of fig14.
    n_vms: int = 5                 # paper: five t2.2xlarge VMs
    vm_price_per_hour_usd: float = 0.3712  # t2.2xlarge on-demand
    record_metrics: bool = True    # off for million-task scaling runs


class ServerfulEngine:
    """Dask-distributed stand-in: long-lived workers, centralized
    scheduler, direct worker-to-worker transfers (no KV hop), finite
    parallelism = n_workers. Locality-aware: tasks prefer the worker that
    holds most of their input bytes (Dask's data-locality heuristic)."""

    name = "serverful"

    def __init__(self, config: ServerfulConfig | None = None):
        self.config = config or ServerfulConfig()

    def compute(self, dag: DAG) -> JobReport:
        cfg = self.config
        dag = ensure_compiled(dag, cfg.optimize)
        clock_cost = dataclasses.replace(cfg.cost)
        kv = ShardedKVStore(n_shards=1, cost=clock_cost)  # clock + channels
        return kv.clock.run(self._compute_g(dag, kv))

    def _compute_g(self, dag: DAG, kv: ShardedKVStore):
        cfg = self.config
        clock = kv.clock
        metrics = TaskMetrics(clock, enabled=cfg.record_metrics)
        owner: dict[str, int] = {}    # task key -> worker that holds it
        data: list[dict[str, Any]] = [dict() for _ in range(cfg.n_workers)]
        owner_lock = threading.Lock()
        done_q = clock.queue()
        pool = clock.pool(cfg.n_workers)

        def run_on_worker(key: str, wid: int):
            def body():
                try:
                    task = dag.tasks[key]
                    t0 = clock.now_ms()

                    def resolve_g(a):
                        if not isinstance(a, TaskRef):
                            return a
                        with owner_lock:
                            src = owner[a.key]
                            val = data[src][a.key]
                        if src != wid:
                            # direct TCP transfer between workers
                            ms = sizeof(val) / (
                                cfg.worker_bandwidth_mbps * 1e6) * 1e3
                            yield ("charge", cfg.cost.tcp_msg_ms + ms)
                        return val

                    args = []
                    for a in task.args:
                        args.append((yield from resolve_g(a)))
                    kwargs = {}
                    for k, v in task.kwargs.items():
                        kwargs[k] = yield from resolve_g(v)
                    read_ms = clock.now_ms() - t0
                    t0 = clock.now_ms()
                    with task_clock(clock):
                        out = task.fn(*args, **kwargs)
                    # Flush compute deferred inside the task function
                    # (event substrate) before reading the clock delta.
                    yield ("flush",)
                    compute_ms = clock.now_ms() - t0
                    with owner_lock:
                        data[wid][key] = out
                        owner[key] = wid
                    metrics.record(task=key, event="executed",
                                   read_ms=read_ms,
                                   compute_ms=compute_ms,
                                   write_ms=0.0, nbytes=sizeof(out))
                    done_q.put((key, None))
                except Exception as exc:
                    done_q.put((key, exc))

            return body

        def pick_worker(key: str, rr: int) -> int:
            # locality: the worker holding the most input bytes
            best, best_bytes = rr % cfg.n_workers, -1
            with owner_lock:
                counts: dict[int, int] = {}
                for dep in dag.deps[key]:
                    w = owner.get(dep)
                    if w is not None:
                        counts[w] = counts.get(w, 0) + sizeof(data[w][dep])
            for w, b in counts.items():
                if b > best_bytes:
                    best, best_bytes = w, b
            return best

        indeg = {k: len(dag.deps[k]) for k in dag.tasks}
        t0_ms = clock.now_ms()
        metrics.origin_ms = t0_ms
        rr = 0
        for k in dag.leaves:
            pool.submit(run_on_worker(k, pick_worker(k, rr)))
            rr += 1
        remaining = set(dag.tasks)
        deadline = clock.now_ms() + cfg.job_timeout_s * 1e3
        try:
            while remaining:
                timeout_ms = deadline - clock.now_ms()
                if timeout_ms <= 0:
                    raise JobError(f"timeout; remaining={len(remaining)}")
                try:
                    key, err = yield ("get", done_q, timeout_ms / 1e3)
                except queue.Empty:
                    continue
                if err is not None:
                    raise JobError(f"task {key!r} failed: {err!r}")
                yield ("charge", cfg.cost.tcp_msg_ms)  # scheduler handling
                remaining.discard(key)
                for child in dag.children[key]:
                    indeg[child] -= 1
                    if indeg[child] == 0:
                        pool.submit(
                            run_on_worker(child, pick_worker(child, rr)))
                        rr += 1
        finally:
            # No FaaS platform here (fixed cluster): queued bodies
            # hold no reservations and are safe to drop.
            pool.shutdown(wait=False, cancel_futures=True)
        wall = (clock.now_ms() - t0_ms) / 1e3
        with owner_lock:
            results = {k: data[owner[k]][k] for k in dag.roots}
        # Snapshot inside the job generator (see WukongEngine).
        report = JobReport(
            results=results, wall_s=wall, tasks=len(dag),
            executors_invoked=0, kv_stats=kv.stats.snapshot(),
            metrics=list(metrics.records), charged_ms=clock.charged_ms,
            optimizer=getattr(dag, "pass_stats", ()),
            platform_stats={
                "mode": "serverful",
                "n_vms": cfg.n_vms,
                "vm_price_per_hour_usd": cfg.vm_price_per_hour_usd,
                # The cluster is billed for the makespan regardless of
                # utilization — allocation-based, not use-based.
                "billed_usd": cfg.n_vms * cfg.vm_price_per_hour_usd
                * wall / 3600.0,
                "cold_starts": 0,
                "invocations": 0,
            },
        )
        return report


ENGINES = {
    "wukong": WukongEngine,
    "strawman": StrawmanEngine,
    "pubsub": PubSubEngine,
    "parallel_invoker": ParallelInvokerEngine,
    "serverful": ServerfulEngine,
}
