"""Multi-tenant job orchestrator: N concurrent DAG jobs, ONE platform.

The paper (and PRs 1-4) run one job at a time: every ``compute()`` call
builds a private KV store, a private clock, and a private platform, so
the warm-container pool and the account concurrency cap never experience
cross-job contention — yet the serverless premise ("pay per use on a
shared auto-scaling provider") only pays off in exactly that regime, and
the ROADMAP north star (serve heavy traffic from many users) is this
axis. ServerMix's tradeoff analysis and Triggerflow's multi-workflow
orchestration both study it; this module makes it runnable here:

- ``Substrate``        — ONE VirtualClock, ONE ShardedKVStore, and (in
                         shared mode) ONE stateful FaaS platform for all
                         jobs. Each job sees the store through a per-job
                         ``KVNamespace`` so names never collide while
                         shards/lanes/clock genuinely contend.
- one platform *function per tenant* — warm containers pool per
  function (tenants share the account concurrency cap and the billing
  account, never each other's containers), each with its own memory
  size (billing rate AND compute speed).
- ``generate_workload`` — seeded Poisson arrivals with a heavy-tailed
                          size mix over the paper's four applications,
                          deterministic under the virtual clock.
- ``JobOrchestrator``  — admits jobs against ``max_concurrent_jobs``
                         with per-tenant fair admission (least-loaded
                         tenant first), runs each admitted job as a
                         clock actor via the engine's injected-substrate
                         path, and reduces everything into an
                         ``OrchestratorReport`` (p50/p95/p99 job
                         latency, per-tenant billed USD, warm-share,
                         peak concurrency).

``isolate_platform=True`` is the control arm: same workload, same
admission, but every job gets a fresh platform — no cross-job warm
reuse, no shared cap. The fig15 benchmark compares the two.

Everything runs on the shared clock's primitives, so a full sweep is
bit-identical across runs (the fig15 smoke gate asserts this down to
per-tenant billed USD).

Durability (the durable control plane): the dispatcher journals every
job lifecycle transition through a :class:`JobStateMachine` persisted
in the shared store (``repro_torch.core.statemachine``), so orchestration
state is external to the process. ``FaultConfig.orchestrator_crash_*``
kills the dispatcher at seeded points; a fresh orchestrator instance
``recover()``s by replaying the journal — journaled-complete jobs are
returned from their journal payloads (never re-executed, never
re-billed), in-flight jobs are re-admitted with ``resume=True`` (their
executors skip durably-completed tasks), and orphaned namespaces are
purged. ``run_with_recovery`` drives the crash→recover loop end to end.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
from collections import deque
from typing import TYPE_CHECKING, Any

from repro_torch.core.engine import EngineConfig, JobSubstrate, WukongEngine
from repro_torch.core.faults import FaultConfig, FaultInjector
from repro_torch.core.kvstore import ShardedKVStore
from repro_torch.core.statemachine import (
    ADMITTED,
    COMPLETED,
    CONTROL_NS,
    FAILED,
    PENDING,
    RUNNING,
    TERMINAL_STATES,
    JobStateMachine,
)
from repro_torch.core.triggers import StreamConfig, TriggerBus, TriggerRule, \
    stream_source

if TYPE_CHECKING:  # import cycle: repro_torch.platform imports repro_torch.core
    from repro_torch.platform import FaaSPlatform, PlatformConfig


# ---------------------------------------------------------------------------
# Workload model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant = one deployed platform function.

    ``memory_mb`` is the tenant's function size: its billing rate (GB-s)
    and its compute speed (CPU share proportional to memory), so tenants
    on one account genuinely differ in cost/latency profile.

    Tiering (admission + SLO accounting):

    ``tier``                — label grouped over in the report's
                              ``per_tier`` block (p50/p95/p99, SLO
                              violations, billed USD per tier).
    ``priority``            — admission priority; higher is admitted
                              first. Equal priorities fall back to the
                              tenant policy (fair least-loaded-tenant or
                              plain FIFO), so single-priority workloads
                              behave exactly as before.
    ``max_concurrent_jobs`` — per-tenant quota: at most this many of
                              the tenant's jobs run at once (None =
                              bounded only by the global admission cap).
    ``slo_s``               — job-latency objective (arrival →
                              completion, simulated seconds); completed
                              jobs over it count as SLO violations in
                              ``per_tier``. None = no objective (batch).
    """

    name: str
    memory_mb: int = 1792
    tier: str = "standard"
    priority: int = 1
    max_concurrent_jobs: "int | None" = None
    slo_s: "float | None" = None

    def __post_init__(self) -> None:
        if self.memory_mb <= 0:
            raise ValueError("memory_mb must be positive")
        if (self.max_concurrent_jobs is not None
                and self.max_concurrent_jobs < 1):
            raise ValueError("max_concurrent_jobs must be >= 1 or None")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ValueError("slo_s must be positive or None")


DEFAULT_TENANTS: "tuple[TenantSpec, ...]" = (
    TenantSpec("tenant-a", 1792, tier="standard", priority=1, slo_s=120.0),
    TenantSpec("tenant-b", 1792, tier="standard", priority=1, slo_s=120.0),
    TenantSpec("tenant-c", 896, tier="batch", priority=0),
    TenantSpec("tenant-d", 3584, tier="premium", priority=2, slo_s=30.0),
)

# app name -> ladder of job sizes, small to large. The ladder index is
# drawn heavy-tailed (geometric), the paper's "many small jobs, few
# huge ones" traffic shape.
_SIZE_LADDERS: "dict[str, tuple[Any, ...]]" = {
    # tree_reduction: array length n (n/2 leaf tasks)
    "tree_reduction": (8, 16, 32, 64, 128),
    # gemm: (n, block_size)
    "gemm": ((64, 32), (128, 32), (128, 64)),
    # svd (TSQR): (rows, cols, n_blocks)
    "svd": ((256, 32, 4), (512, 32, 8), (1024, 32, 8)),
    # svc: (n_samples, n_blocks, n_iters)
    "svc": ((512, 4, 2), (1024, 4, 2), (2048, 8, 2)),
}


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Seeded multi-tenant traffic: Poisson arrivals, heavy-tailed mix."""

    n_jobs: int = 32
    arrival_rate_per_s: float = 4.0   # Poisson arrival intensity
    seed: int = 0
    tenants: "tuple[TenantSpec, ...]" = DEFAULT_TENANTS
    # (app, weight) — drawn per job. Defaults lean on tree reduction
    # (numpy payloads) with a minority of the linear-algebra apps.
    app_mix: "tuple[tuple[str, float], ...]" = (
        ("tree_reduction", 0.55),
        ("gemm", 0.20),
        ("svd", 0.15),
        ("svc", 0.10),
    )
    # P(size rank r) proportional to size_tail**r: ~55% smallest size,
    # a long tail of big jobs at the default 0.45.
    size_tail: float = 0.45
    # Per-task simulated compute at the baseline memory size; the
    # linear-algebra apps convert it to ms-per-flop at their smallest
    # task size so every app's tasks land in the same duration regime.
    compute_ms: float = 20.0
    payload_bytes: int = 0            # edge ballast (tree reduction only)


@dataclasses.dataclass(frozen=True)
class JobRequest:
    """One job of the workload: which tenant submits which DAG when."""

    job_id: int
    tenant: str
    app: str
    size: Any                  # entry of the app's size ladder
    arrival_ms: float          # simulated submit time
    compute_ms: float = 20.0
    payload_bytes: int = 0

    @property
    def name(self) -> str:
        return f"job{self.job_id}"

    def build_dag(self):
        """Materialize the job's DAG (lazy app import: repro_torch.apps sits
        above repro_torch.core in the layering)."""
        if self.app == "tree_reduction":
            from repro_torch.apps import tree_reduction_dag

            return tree_reduction_dag(self.size,
                                      compute_ms=self.compute_ms,
                                      payload_bytes=self.payload_bytes)
        if self.app == "gemm":
            from repro_torch.apps import gemm_dag

            n, bs = self.size
            return gemm_dag(n, bs,
                            ms_per_flop=self.compute_ms / (2.0 * bs ** 3))
        if self.app == "svd":
            from repro_torch.apps import tsqr_svd_dag

            rows, cols, n_blocks = self.size
            block_flops = 2.0 * (rows / n_blocks) * cols * cols
            return tsqr_svd_dag(rows, cols=cols, n_blocks=n_blocks,
                                ms_per_flop=self.compute_ms / block_flops)
        if self.app == "dynamic_tree":
            from repro_torch.apps import dynamic_tree_reduction_dag

            return dynamic_tree_reduction_dag(
                self.size, compute_ms=self.compute_ms,
                payload_bytes=self.payload_bytes)
        if self.app == "svc":
            from repro_torch.apps import svc_dag

            n_samples, n_blocks, n_iters = self.size
            from repro_torch.apps.svc import DIM

            block_flops = 2.0 * (n_samples / n_blocks) * DIM
            return svc_dag(n_samples, n_blocks=n_blocks, n_iters=n_iters,
                           ms_per_flop=self.compute_ms / block_flops)
        raise ValueError(f"unknown app {self.app!r}")


def generate_workload(cfg: WorkloadConfig) -> "list[JobRequest]":
    """Seeded job stream: exponential inter-arrival times (Poisson
    process), tenants drawn uniformly, apps by ``app_mix`` weight, sizes
    heavy-tailed down each app's ladder. Pure function of ``cfg`` — the
    determinism gate reruns it and expects the identical stream."""
    import random

    rng = random.Random(cfg.seed)
    apps = [a for a, _ in cfg.app_mix]
    weights = [w for _, w in cfg.app_mix]
    total_w = sum(weights)
    jobs: list[JobRequest] = []
    t_ms = 0.0
    for job_id in range(cfg.n_jobs):
        t_ms += rng.expovariate(cfg.arrival_rate_per_s) * 1e3
        tenant = cfg.tenants[rng.randrange(len(cfg.tenants))]
        # weighted app draw
        x = rng.random() * total_w
        app = apps[-1]
        for a, w in cfg.app_mix:
            if x < w:
                app = a
                break
            x -= w
        ladder = _SIZE_LADDERS[app]
        # geometric (heavy-tailed) rank, clamped to the ladder
        rank = 0
        while rank < len(ladder) - 1 and rng.random() < cfg.size_tail:
            rank += 1
        jobs.append(JobRequest(
            job_id=job_id,
            tenant=tenant.name,
            app=app,
            size=ladder[rank],
            arrival_ms=t_ms,
            compute_ms=cfg.compute_ms,
            payload_bytes=cfg.payload_bytes,
        ))
    return jobs


def _job_spec(job: JobRequest) -> "dict[str, Any]":
    """The reconstructible job spec journaled with the PENDING
    transition — everything a recovering orchestrator needs to rebuild
    the ``JobRequest`` without the dead process's memory."""
    return {
        "job_id": job.job_id,
        "tenant": job.tenant,
        "app": job.app,
        "size": job.size,
        "arrival_ms": job.arrival_ms,
        "compute_ms": job.compute_ms,
        "payload_bytes": job.payload_bytes,
    }


def _job_from_spec(spec: "dict[str, Any]") -> JobRequest:
    return JobRequest(**spec)


# ---------------------------------------------------------------------------
# The shared substrate
# ---------------------------------------------------------------------------


class Substrate:
    """One clock + one store (+ optionally one platform) shared by every
    job the orchestrator runs. ``job_substrate`` hands out the per-job
    ``JobSubstrate`` views the refactored engines accept."""

    def __init__(self, engine: EngineConfig,
                 platform: "PlatformConfig | None",
                 tenants: "tuple[TenantSpec, ...]" = (),
                 isolate_platform: bool = False):
        self.engine = engine
        self.platform_config = platform
        self.tenants = tuple(tenants)
        self.isolate_platform = isolate_platform
        self.kv = ShardedKVStore(
            n_shards=engine.n_kv_shards,
            cost=engine.cost,
            colocate_shards=engine.colocate_kv_shards,
            counter_mode=engine.counter_mode,
        )
        self.clock = self.kv.clock
        self._control = None
        # The live trigger bus generation on this substrate (recovery
        # detaches the dead one's write listener before attaching its
        # own — orphan source actors must not double-feed the new bus).
        self.trigger_bus: "TriggerBus | None" = None
        self.platform: "FaaSPlatform | None" = None
        if platform is not None and not isolate_platform:
            self.platform = self._new_platform()
            if self.platform.caches is not None:
                # Cache coherence on the shared account: purging a
                # finished job's namespace must also reclaim its objects
                # from every container-resident cache, or a recycled
                # warm container could serve a later job's colliding key
                # from a dead job's bytes. Isolated per-job platforms
                # skip this — their caches die with the job.
                self.kv.add_purge_listener(
                    self.platform.caches.invalidate_prefix)

    def _new_platform(self) -> "FaaSPlatform":
        from repro_torch.platform import FaaSPlatform

        p = FaaSPlatform(self.platform_config, self.engine.cost, self.clock)
        for t in self.tenants:
            p.configure_function(t.name, t.memory_mb)
        return p

    def control(self):
        """The control plane's namespaced view of the shared store (the
        job state machine's journal lives here). One cached view: the
        journal must be the same object across dispatcher generations on
        this substrate — that is the durability being modeled."""
        if self._control is None:
            self._control = self.kv.namespace(CONTROL_NS)
        return self._control

    def job_substrate(self, job_name: str, tenant: str,
                      resume: bool = False) -> JobSubstrate:
        """The per-job view: namespaced KV, the shared platform (or a
        fresh one per job in the isolated control arm), the tenant's
        function identity, the job's billing label — and ``resume=True``
        when a recovering orchestrator re-admits the job (executors then
        reuse durable task outputs instead of re-executing)."""
        if self.platform is not None:
            platform = self.platform
        elif self.platform_config is not None:
            platform = self._new_platform()  # isolated: private per job
        else:
            platform = None
        return JobSubstrate(kv=self.kv.namespace(job_name),
                            platform=platform, function=tenant,
                            job=job_name, resume=resume)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


def _default_engine_config() -> EngineConfig:
    # Smaller per-job invoker pools and runtime cap than the single-job
    # benchmarks: N of these run concurrently on one machine's threads.
    return EngineConfig(num_initial_invokers=4, num_proxy_invokers=4,
                        max_concurrency=512)


def _default_platform_config() -> "PlatformConfig":
    from repro_torch.platform import PlatformConfig

    return PlatformConfig()


@dataclasses.dataclass(frozen=True)
class OrchestratorConfig:
    # Per-job engine knobs. ``engine.platform`` is ignored — the
    # orchestrator owns platform construction (shared or per-job).
    engine: EngineConfig = dataclasses.field(
        default_factory=_default_engine_config)
    # The account model. None = legacy stochastic draws (no pool, no
    # billing) — still a valid multi-tenant data-plane study.
    platform: "PlatformConfig | None" = dataclasses.field(
        default_factory=_default_platform_config)
    workload: WorkloadConfig = dataclasses.field(
        default_factory=WorkloadConfig)
    # Admission gate: how many jobs may run at once. The orchestrator's
    # defense of the shared account cap — admitted jobs' fan-outs hit
    # the throttle directly.
    max_concurrent_jobs: int = 8
    # Fair admission: pick the next job from the tenant with the fewest
    # running jobs (FIFO within a tenant; FIFO across everything when
    # off) so one flooding tenant cannot starve the others.
    fair_admission: bool = True
    # Control arm: per-job private platforms (no cross-job warm sharing,
    # no shared cap) — the isolated-per-job baseline of fig15.
    isolate_platform: bool = False
    # Orchestrator-level fault injection (``orchestrator_crash_point`` /
    # ``orchestrator_crash_at``): kills the dispatcher at a seeded point
    # so crash→replay recovery can be exercised. Task-level faults stay
    # on ``engine.faults``; this config governs the control plane.
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    # Trigger-driven admission: persistent event->job rules (journaled
    # in the ``__triggers__`` namespace, crash-recoverable) and an
    # optional Poisson event stream feeding them. Rule actions must
    # name a tenant from ``workload.tenants``. Empty = plain
    # job-list admission, bit for bit.
    triggers: "tuple[TriggerRule, ...]" = ()
    stream: "StreamConfig | None" = None
    # First job_id the bus assigns to fired jobs (static workload ids
    # must stay below it).
    trigger_id_base: int = 1_000_000


class OrchestratorCrashed(RuntimeError):
    """The dispatcher died at an injected crash point. Carries what a
    supervisor needs to restart: the still-live shared substrate (the
    durable store survives the process) and the fault injector (its
    occurrence counters carry across generations so the same crash does
    not re-fire during recovery)."""

    def __init__(self, point: str, substrate: "Substrate",
                 injector: FaultInjector):
        super().__init__(f"orchestrator crashed at point {point!r}")
        self.point = point
        self.substrate = substrate
        self.injector = injector


@dataclasses.dataclass
class OrchestratorReport:
    mode: str                     # "shared" | "isolated"
    jobs: int
    completed: int
    failed: int
    makespan_s: float             # first arrival -> last completion
    p50_s: float                  # job latency percentiles
    p95_s: float                  # (arrival -> completion, completed jobs)
    p99_s: float
    mean_latency_s: float
    mean_queue_wait_s: float      # arrival -> admission
    warm_share: float             # warm_reuses / invocations with a pool
    cold_starts: int
    warm_reuses: int
    throttle_events: int
    peak_concurrency: int
    billed_usd_total: float
    per_tenant: "dict[str, dict[str, Any]]"
    job_records: "list[dict[str, Any]]"
    # Tier SLO accounting: tier -> {jobs, failed, p50/p95/p99, SLO
    # violations, billed USD} (empty when no tenant declares a tier).
    per_tier: "dict[str, dict[str, Any]]" = dataclasses.field(
        default_factory=dict)
    # Durable-control-plane counters: injected dispatcher crashes
    # survived, in-flight jobs re-admitted by replay, and tasks whose
    # durable outputs were reused instead of re-executed.
    crashes: int = 0
    recovered_jobs: int = 0
    tasks_resumed: int = 0
    # Account-wide locality counters (per-tier cache hits/misses/
    # evictions + residency) when the platform runs with container
    # caches; empty otherwise.
    cache: "dict[str, Any]" = dataclasses.field(default_factory=dict)


def _percentile(sorted_vals: "list[float]", q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not sorted_vals:
        return 0.0
    rank = max(1, -(-len(sorted_vals) * q // 100))  # ceil(n*q/100)
    return sorted_vals[int(rank) - 1]


class JobOrchestrator:
    """Runs a workload of DAG jobs on one shared substrate.

    The orchestrator thread is the dispatcher actor: it feeds arrivals
    from the (pre-sorted, seeded) workload, admits up to
    ``max_concurrent_jobs`` with per-tenant fairness, and spawns each
    admitted job as its own clock actor running
    ``WukongEngine.compute(dag, substrate=...)``. Completions come back
    on a clock queue. Under the virtual clock the whole traffic trace —
    arrivals, queueing, contention, billing — is bit-identical across
    runs."""

    def __init__(self, config: OrchestratorConfig | None = None):
        self.config = config or OrchestratorConfig()
        self.last_substrate: Substrate | None = None
        # Orchestrator-level fault injector. ``run_with_recovery`` hands
        # the SAME instance to each recovering generation, so a crash
        # configured to fire once fires once across the whole lifetime.
        self.injector = FaultInjector(self.config.faults)
        if self.config.engine.platform is not None:
            raise ValueError(
                "set OrchestratorConfig.platform, not engine.platform: "
                "the orchestrator owns platform construction")

    # -- admission policy ---------------------------------------------------
    def _tenant(self, name: str) -> "TenantSpec | None":
        for t in self.config.workload.tenants:
            if t.name == name:
                return t
        return None

    def _pick_next(self, ready: "list[JobRequest]",
                   tenant_running: "dict[str, int]",
                   ) -> "JobRequest | None":
        """The next job to admit, or None when every ready job is
        blocked by its tenant's quota. Order: priority tier first
        (higher ``TenantSpec.priority`` wins), then the tenant policy
        within a tier — least-loaded tenant (fair) or plain FIFO — so
        single-priority workloads behave exactly as before."""
        quota_ok = []
        for j in ready:
            spec = self._tenant(j.tenant)
            quota = spec.max_concurrent_jobs if spec is not None else None
            if quota is not None and tenant_running.get(j.tenant, 0) >= quota:
                continue
            quota_ok.append(j)
        if not quota_ok:
            return None

        def prio(j: JobRequest) -> int:
            spec = self._tenant(j.tenant)
            return spec.priority if spec is not None else 1

        if not self.config.fair_admission:
            # FIFO within a priority tier — deterministic under ties.
            return min(quota_ok,
                       key=lambda j: (-prio(j), j.arrival_ms, j.job_id))
        # Least-loaded tenant first within the tier; FIFO (arrival, id)
        # within a load level.
        return min(quota_ok, key=lambda j: (
            -prio(j), tenant_running.get(j.tenant, 0),
            j.arrival_ms, j.job_id))

    # -- the run loop -------------------------------------------------------
    def run(self, jobs: "list[JobRequest] | None" = None) -> OrchestratorReport:
        """Run the workload from scratch. Raises
        :class:`OrchestratorCrashed` when a configured crash point
        fires — use :meth:`run_with_recovery` (or catch and call
        :meth:`recover` on a fresh instance) to survive it."""
        cfg = self.config
        if jobs is None:
            jobs = generate_workload(cfg.workload)
        substrate = Substrate(cfg.engine, cfg.platform,
                              tenants=cfg.workload.tenants,
                              isolate_platform=cfg.isolate_platform)
        # Kept for introspection (tests, notebooks): the substrate the
        # most recent run() executed on.
        self.last_substrate = substrate
        return substrate.clock.run(self._run_g(jobs, substrate))

    def recover(self, substrate: Substrate,
                injector: "FaultInjector | None" = None,
                ) -> OrchestratorReport:
        """Recover a crashed orchestrator's workload on ITS substrate by
        replaying the control-plane journal. Call on a FRESH instance —
        recovery must need nothing from the dead process's memory; the
        journal is the only input. ``injector`` carries the crashed
        generation's occurrence counters (pass ``crash.injector``) so an
        already-fired crash does not re-fire; omit it to recover with
        this instance's own injector."""
        if injector is not None:
            self.injector = injector
        self.last_substrate = substrate
        return substrate.clock.run(self._recover_g(substrate))

    def run_with_recovery(self, jobs: "list[JobRequest] | None" = None,
                          max_crashes: int = 8) -> OrchestratorReport:
        """The supervised loop: run, and on every injected dispatcher
        crash start a FRESH orchestrator instance that replays the
        journal and carries on — up to ``max_crashes`` restarts (a
        crash-looping control plane should fail loudly, not spin)."""
        crashes = 0
        try:
            report = self.run(jobs)
        except OrchestratorCrashed as crash:
            crashes += 1
            while True:
                orch = JobOrchestrator(self.config)
                try:
                    report = orch.recover(crash.substrate,
                                          injector=crash.injector)
                    break
                except OrchestratorCrashed as again:
                    crashes += 1
                    if crashes > max_crashes:
                        raise
                    crash = again
            self.last_substrate = crash.substrate
        report.crashes = crashes
        return report

    def _run_g(self, jobs: "list[JobRequest]", substrate: Substrate):
        """The dispatcher as an effect generator: the clock drives it as
        the root continuation (event substrate) or inline on the calling
        actor thread (thread/realtime substrates)."""
        machine = JobStateMachine(substrate.control())
        # Submission: journal PENDING (with the reconstructible job
        # spec) for every job before any is admitted — from here on the
        # workload survives the dispatcher.
        clock = substrate.clock
        for job in sorted(jobs, key=lambda j: j.job_id):
            yield from machine.record_g(job.job_id, PENDING,
                                        at_ms=clock.now_ms(),
                                        payload=_job_spec(job))
        bus = None
        if self.config.triggers:
            bus = self._make_bus(substrate)
            for rule in self.config.triggers:
                yield from bus.add_rule_g(rule)
        return (yield from self._dispatch_g(
            jobs, substrate, machine,
            prior_records=[], resume_ids=frozenset(), recovered_jobs=0,
            bus=bus))

    def _make_bus(self, substrate: Substrate) -> TriggerBus:
        bus = TriggerBus(substrate.kv, substrate.clock,
                         id_base=self.config.trigger_id_base)
        substrate.trigger_bus = bus
        return bus

    def _recover_g(self, substrate: Substrate):
        """Replay-recovery as an effect generator: rebuild the state
        machine from the journal (charged scan), split jobs into
        journaled-terminal (returned from their journal payloads, their
        possibly-orphaned namespaces purged) and non-terminal (re-run;
        previously in-flight ones resume against their retained
        namespaces), then dispatch the remainder."""
        machine = JobStateMachine(substrate.control())
        yield from machine.replay_g()
        bus = None
        if self.config.triggers:
            # The dead generation's bus still observes writes (and the
            # orphan sources it spawned still produce them): detach it
            # before this generation's bus attaches, or every stream
            # event would be double-delivered.
            if substrate.trigger_bus is not None:
                substrate.trigger_bus.detach()
            bus = self._make_bus(substrate)
            yield from bus.replay_g()

        to_run: "list[JobRequest]" = []
        all_jobs: "list[JobRequest]" = []
        prior_records: "list[dict[str, Any]]" = []
        resume_ids: "set[int]" = set()
        recovered = 0
        for job_id, state in sorted(machine.jobs().items()):
            spec = machine.payload(job_id, PENDING)
            if spec is None:
                raise RuntimeError(
                    f"journal names job {job_id} without a PENDING spec")
            job = _job_from_spec(spec)
            all_jobs.append(job)
            if state in TERMINAL_STATES:
                rec = machine.payload(job_id, state)
                if rec is not None:
                    rec = dict(rec)
                    rec["from_journal"] = True
                    prior_records.append(rec)
                # The crash may have hit between journaling the terminal
                # state and purging the job's namespace: purge now.
                # Idempotent — dropping an already-purged namespace is a
                # no-op.
                substrate.kv.drop_namespace(job.name)
            else:
                to_run.append(job)
                if state in (ADMITTED, RUNNING):
                    # In flight when the dispatcher died: re-admit with
                    # resume semantics (namespace retained — durable
                    # task outputs are reused, not re-executed).
                    resume_ids.add(job_id)
                    recovered += 1
        if bus is not None:
            # A crash between journaling a fire and journaling its
            # job's PENDING record leaves a fired-but-unsubmitted job:
            # the fire's journal payload carries the full spec, so
            # re-journal and run it here — no fire is ever lost.
            for frec in bus.fired_records():
                if machine.state(frec["job_id"]) is None:
                    job = _job_from_spec(frec["spec"])
                    yield from machine.record_g(
                        job.job_id, PENDING, at_ms=substrate.clock.now_ms(),
                        payload=frec["spec"])
                    all_jobs.append(job)
                    to_run.append(job)
        return (yield from self._dispatch_g(
            all_jobs, substrate, machine,
            prior_records=prior_records, resume_ids=frozenset(resume_ids),
            recovered_jobs=recovered, to_run=to_run, bus=bus))

    def _dispatch_g(self, all_jobs: "list[JobRequest]",
                    substrate: Substrate, machine: JobStateMachine,
                    prior_records: "list[dict[str, Any]]",
                    resume_ids: "frozenset[int]", recovered_jobs: int,
                    to_run: "list[JobRequest] | None" = None,
                    bus: "TriggerBus | None" = None):
        """The admission/dispatch/completion loop shared by fresh runs
        and recovery. ``all_jobs`` is the full workload (reporting);
        ``to_run`` the subset still needing execution (defaults to all).
        Every lifecycle transition is journaled through ``machine``
        BEFORE the action it records is performed, and the injector may
        kill the dispatcher at the seeded crash points in between.

        With a trigger ``bus``, the dispatcher is also the bus's single
        event consumer: source actors (timers, the stream writer, the
        external-event relay) and the KV write listener all enqueue
        tagged events onto the SAME completion queue, and every fire is
        journaled, journaled PENDING, and admitted through the normal
        ``launch_g`` path — trigger-fired jobs are first-class jobs."""
        cfg = self.config
        clock = substrate.clock
        injector = self.injector
        tenant_memory = {t.name: t.memory_mb for t in cfg.workload.tenants}
        if to_run is None:
            to_run = list(all_jobs)

        # Dispatch epoch: submissions were journaled (a charged control-
        # plane write) before this loop, so the clock is already past the
        # earliest arrivals. Queue wait is measured from when a job became
        # ELIGIBLE for admission — max(arrival, dispatch start) — so the
        # journaling overhead is not misattributed to gate queueing.
        t0_ms = clock.now_ms()
        pending = deque(sorted(to_run, key=lambda j: (j.arrival_ms, j.job_id)))
        ready: "list[JobRequest]" = []
        tenant_running: "dict[str, int]" = {}
        records: "list[dict[str, Any]]" = []
        # isolated control arm: (tenant, private-platform snapshot) pairs
        isolated_stats: "list[tuple[str, dict[str, Any]]]" = []
        n_running = 0

        done_q = clock.queue()

        def launch_g(job: JobRequest):
            admit_ms = clock.now_ms()
            yield from machine.record_g(job.job_id, ADMITTED,
                                        at_ms=admit_ms)
            if injector.orchestrator_crash("admit"):
                # Mid-admission: ADMITTED is journaled but no runner
                # exists. Recovery re-admits from the journal.
                raise OrchestratorCrashed("admit", substrate, injector)
            sub = substrate.job_substrate(job.name, job.tenant,
                                          resume=job.job_id in resume_ids)

            def runner():
                start_ms = clock.now_ms()
                rep, error = None, None
                try:
                    engine = WukongEngine(cfg.engine)
                    rep = yield from engine.compute_g(job.build_dag(), sub)
                except Exception as exc:  # JobError, task bugs: record
                    error = repr(exc)
                done_q.put(("done", (job, admit_ms, start_ms,
                                     clock.now_ms(), rep, error, sub)))

            yield from machine.record_g(job.job_id, RUNNING,
                                        at_ms=clock.now_ms())
            clock.spawn(runner, name=job.name)
            if injector.orchestrator_crash("dispatch"):
                # Mid-dispatch: the runner actor is live on the
                # substrate but the dispatcher dies. The orphan keeps
                # running (its writes are idempotent); recovery
                # re-admits the job and resumes over its outputs.
                raise OrchestratorCrashed("dispatch", substrate, injector)

        def job_billed_usd(sub: JobSubstrate, job: JobRequest) -> float:
            if cfg.isolate_platform and sub.platform is not None:
                return sub.platform.snapshot()["billed_usd"]
            if substrate.platform is not None:
                return substrate.platform.meter.job_snapshot(
                    job.name)["billed_usd"]
            return 0.0

        # -- trigger plumbing ------------------------------------------
        n_expected = len(to_run)
        n_sources = 0
        sources_done = 0
        close_sent = bus is None

        def fires_g(ev: "dict[str, Any]"):
            """Offer one event to the bus; journal each fire, journal
            its job PENDING, and hand it to the normal admission path."""
            nonlocal n_expected
            for due in bus.match(ev):
                spec = yield from bus.fire_g(due, clock.now_ms())
                if spec is None:
                    continue  # fire journaled by a dead generation
                job = _job_from_spec(spec)
                yield from machine.record_g(job.job_id, PENDING,
                                            at_ms=clock.now_ms(),
                                            payload=dict(spec))
                all_jobs.append(job)
                n_expected += 1
                ready.append(job)

        if bus is not None:
            bus.attach(done_q)
            for rule in bus.rules.values():
                if rule.source == "timer":
                    clock.spawn(bus.timer_actor(rule, done_q),
                                name=f"timer-{rule.rule_id}")
                    n_sources += 1
            if cfg.stream is not None:
                clock.spawn(
                    stream_source(cfg.stream, substrate.kv, clock, bus,
                                  done_q),
                    name="stream-source")
                n_sources += 1
            clock.spawn(bus.relay_actor(done_q), name="trigger-relay")
            n_sources += 1
            # Re-offer completions journaled by dead generations: a
            # ``job_completed`` fire journaled before the crash is
            # deduped here; one the crash cut off between the terminal
            # journal and the fire journal fires now. Nothing is lost
            # or doubled either way.
            for rec in prior_records:
                bus.job_finished(rec, rec.get("end_ms", clock.now_ms()))
                yield from fires_g({"source": "job_completed",
                                    "record": rec,
                                    "at_ms": clock.now_ms()})

        while len(records) < n_expected or sources_done < n_sources:
            now = clock.now_ms()
            while pending and pending[0].arrival_ms <= now:
                ready.append(pending.popleft())
            while ready and n_running < cfg.max_concurrent_jobs:
                job = self._pick_next(ready, tenant_running)
                if job is None:
                    break  # all ready jobs quota-blocked
                ready.remove(job)
                tenant_running[job.tenant] = (
                    tenant_running.get(job.tenant, 0) + 1)
                n_running += 1
                yield from launch_g(job)
            if (bus is not None and not close_sent
                    and sources_done >= n_sources - 1
                    and len(records) >= n_expected
                    and not pending and not ready):
                # Every bounded source is finished and every job is
                # accounted for: stop the relay (the one open-ended
                # source) so the loop can drain and exit.
                yield from bus.close_g()
                close_sent = True
            try:
                if pending:
                    wait_s = (pending[0].arrival_ms - clock.now_ms()) / 1e3
                    msg = yield ("get", done_q, max(0.0, wait_s))
                else:
                    msg = yield ("get", done_q, None)
            except _queue.Empty:
                continue  # an arrival came due
            tag, body = msg
            if tag == "source_done":
                sources_done += 1
                continue
            if tag == "event":
                yield from fires_g(body)
                continue
            job, admit_ms, start_ms, end_ms, rep, error, sub = body
            tenant_running[job.tenant] -= 1
            n_running -= 1
            rec: "dict[str, Any]" = {
                "job_id": job.job_id,
                "tenant": job.tenant,
                "app": job.app,
                "size": job.size,
                "arrival_ms": job.arrival_ms,
                "admit_ms": admit_ms,
                "end_ms": end_ms,
                "latency_s": (end_ms - job.arrival_ms) / 1e3,
                "queue_wait_s":
                    (admit_ms - max(job.arrival_ms, t0_ms)) / 1e3,
                "error": error,
                "billed_usd": job_billed_usd(sub, job),
            }
            if rep is not None:
                rec["tasks"] = rep.tasks
                rec["executors"] = rep.executors_invoked
                rec["fault_stats"] = dict(rep.fault_stats)
                if rep.cache_stats:
                    rec["cache_stats"] = dict(rep.cache_stats)
            if cfg.isolate_platform and sub.platform is not None:
                # Private platform: its counters ARE this job's.
                isolated_stats.append(
                    (job.tenant, sub.platform.snapshot()))
            # Journal the terminal state WITH the completion record
            # before acting on it: if the dispatcher dies right after,
            # recovery returns this job from the journal — no double
            # execution, no double billing.
            yield from machine.record_g(
                job.job_id, COMPLETED if error is None else FAILED,
                at_ms=end_ms, payload=dict(rec))
            if injector.orchestrator_crash("complete"):
                # Between completion and namespace purge: the journal
                # has the result but the job's namespace is orphaned in
                # the shared store. Recovery purges it.
                raise OrchestratorCrashed("complete", substrate, injector)
            records.append(rec)
            if bus is not None:
                bus.job_finished(rec, end_ms)
                yield from fires_g({"source": "job_completed",
                                    "record": rec,
                                    "at_ms": clock.now_ms()})
            # Reclaim the finished job's namespaced objects/counters
            # from the shared store: memory stays O(concurrent
            # jobs), not O(total traffic). Host-side (no clock
            # charge); any straggler residue is bounded by the
            # job's stop signal.
            sub.kv.purge()

        # All jobs done; counters are stable (the substrate serializes
        # this reduction against any leftover actors).
        if bus is not None:
            bus.detach()
        return self._reduce(all_jobs, prior_records + records, substrate,
                            tenant_memory, isolated_stats,
                            recovered_jobs=recovered_jobs)

    # -- report reduction ---------------------------------------------------
    def _reduce(self, jobs, records, substrate, tenant_memory,
                isolated_stats, recovered_jobs: int = 0,
                ) -> OrchestratorReport:
        cfg = self.config
        records = sorted(records, key=lambda r: r["job_id"])
        ok = [r for r in records if r["error"] is None]
        latencies = sorted(r["latency_s"] for r in ok)
        first_arrival = min((j.arrival_ms for j in jobs), default=0.0)
        last_end = max((r["end_ms"] for r in records), default=0.0)
        tenant_spec = {t.name: t for t in cfg.workload.tenants}

        # -- platform totals + per-tenant billing ---------------------------
        cold = warm = throttled = peak = 0
        billed_total = 0.0
        tenant_billed: "dict[str, float]" = {}
        cache_total: "dict[str, Any]" = {}

        def fold_cache(block: "dict[str, Any] | None") -> None:
            # Sum counters across platforms; peak-style residency fields
            # also sum (concurrent private pools hold bytes at once).
            if not block:
                return
            for k, v in block.items():
                cache_total[k] = cache_total.get(k, 0) + v

        if substrate.platform is not None:          # shared account
            snap = substrate.platform.snapshot()
            cold, warm = snap["cold_starts"], snap["warm_reuses"]
            throttled = snap["throttle_events"]
            peak = snap["peak_concurrency"]
            billed_total = snap["billed_usd"]
            fold_cache(snap.get("cache"))
            for tenant, block in snap.get("billing_by_function",
                                          {}).items():
                tenant_billed[tenant] = block["billed_usd"]
        else:                                        # isolated control arm
            for tenant, snap in isolated_stats:
                cold += snap["cold_starts"]
                warm += snap["warm_reuses"]
                throttled += snap["throttle_events"]
                peak = max(peak, snap["peak_concurrency"])
                billed_total += snap["billed_usd"]
                fold_cache(snap.get("cache"))
                tenant_billed[tenant] = (
                    tenant_billed.get(tenant, 0.0) + snap["billed_usd"])

        per_tenant: "dict[str, dict[str, Any]]" = {}
        for tenant in sorted({j.tenant for j in jobs}):
            t_recs = [r for r in records if r["tenant"] == tenant]
            t_ok = [r for r in t_recs if r["error"] is None]
            lat = sorted(r["latency_s"] for r in t_ok)
            spec = tenant_spec.get(tenant)
            per_tenant[tenant] = {
                "jobs": len(t_recs),
                "failed": len(t_recs) - len(t_ok),
                "memory_mb": tenant_memory.get(tenant),
                "tier": spec.tier if spec is not None else "standard",
                "billed_usd": tenant_billed.get(tenant, 0.0),
                "p50_s": _percentile(lat, 50),
                "p95_s": _percentile(lat, 95),
                "p99_s": _percentile(lat, 99),
                "mean_latency_s": sum(lat) / len(lat) if lat else 0.0,
            }

        # -- per-tier SLO accounting ----------------------------------------
        def tier_of(tenant: str) -> str:
            spec = tenant_spec.get(tenant)
            return spec.tier if spec is not None else "standard"

        per_tier: "dict[str, dict[str, Any]]" = {}
        for tier in sorted({tier_of(j.tenant) for j in jobs}):
            tier_tenants = {j.tenant for j in jobs
                            if tier_of(j.tenant) == tier}
            t_recs = [r for r in records if r["tenant"] in tier_tenants]
            t_ok = [r for r in t_recs if r["error"] is None]
            lat = sorted(r["latency_s"] for r in t_ok)
            # One SLO per tier: the tightest objective any of its
            # tenants declares (None = no objective; nothing violates).
            slos = [tenant_spec[t].slo_s for t in tier_tenants
                    if t in tenant_spec
                    and tenant_spec[t].slo_s is not None]
            slo_s = min(slos) if slos else None
            per_tier[tier] = {
                "jobs": len(t_recs),
                "failed": len(t_recs) - len(t_ok),
                "p50_s": _percentile(lat, 50),
                "p95_s": _percentile(lat, 95),
                "p99_s": _percentile(lat, 99),
                "mean_latency_s": sum(lat) / len(lat) if lat else 0.0,
                "slo_s": slo_s,
                "slo_violations": (
                    sum(1 for v in lat if v > slo_s)
                    if slo_s is not None else 0),
                "billed_usd": sum(
                    tenant_billed.get(t, 0.0) for t in tier_tenants),
            }

        invocations = cold + warm
        return OrchestratorReport(
            mode="isolated" if cfg.isolate_platform else "shared",
            jobs=len(jobs),
            completed=len(ok),
            failed=len(records) - len(ok),
            makespan_s=(last_end - first_arrival) / 1e3,
            p50_s=_percentile(latencies, 50),
            p95_s=_percentile(latencies, 95),
            p99_s=_percentile(latencies, 99),
            mean_latency_s=(sum(latencies) / len(latencies)
                            if latencies else 0.0),
            mean_queue_wait_s=(sum(r["queue_wait_s"] for r in ok) / len(ok)
                               if ok else 0.0),
            warm_share=warm / invocations if invocations else 0.0,
            cold_starts=cold,
            warm_reuses=warm,
            throttle_events=throttled,
            peak_concurrency=peak,
            billed_usd_total=billed_total,
            per_tenant=per_tenant,
            job_records=records,
            per_tier=per_tier,
            recovered_jobs=recovered_jobs,
            tasks_resumed=sum(
                r.get("fault_stats", {}).get("tasks_resumed", 0)
                for r in records),
            cache=cache_total,
        )
