"""The decentralized Task Executor runtime (paper §IV-C).

Each executor is one simulated Lambda invocation. It receives a static
schedule start point and walks the DAG bottom-up along a single path:

  1. *fan-in* at the current node (in-degree > 1): publish locally-held
     input objects, atomically record this in-edge on the dependency
     counter; the LAST arriver continues, everyone else stops. Nobody
     waits — FaaS bills wall-clock, so waiting is money (paper §IV-C).
  2. *execute* the current task, caching the output in executor-local
     memory (data locality: a chain of tasks costs zero network I/O).
  3. *fan-out*: width 1 is trivial (continue along the chain). Width n>1:
     publish the output, *become* the executor of one out-edge and
     *invoke* executors for the other n-1 (through the proxy when the
     width crosses the proxy threshold).

Fault tolerance: an injected failure aborts the invocation; the engine
re-invokes the executor from its start point with a fresh local cache,
exactly like AWS Lambda's automatic retry (≤ 2). Idempotent KV writes and
edge-set counters make retries and speculative duplicates safe.

Optimizer integration (repro_torch.core.optimize):

- *coalescing*: an executor may receive several start keys (a batch of
  sibling leaves, or a chunk of fan-out children). It walks them in
  order with ONE shared local cache, so a batch whose members meet at a
  fan-in resolves the fan-in entirely in executor memory.
- *clustering / delayed I/O*: at fan-in nodes the schedule marks as
  delayed, arrivals use the KV store's atomic deposit-and-increment:
  locally-held inputs are persisted in the same round trip as the
  counter update, and the completing arrival skips the write, carrying
  its objects through the fan-in in local memory. Safe under retries
  and speculation because every (re-)invocation starts from its start
  key and recomputes the values it holds locally.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

from repro_torch.core.cache import CacheStats, ExecutorCache
from repro_torch.core.dag import DAG, Expansion, TaskRef
from repro_torch.core.faults import (
    ExecutorHeartbeat,
    FaultInjector,
    FaultStats,
    HeartbeatRegistry,
    SimulatedTaskFailure,
)
from repro_torch.core.kvstore import ShardedKVStore, sizeof
from repro_torch.core.schedule import StaticSchedule, _counter_id
from repro_torch.core.simclock import BaseClock, task_clock

RESULTS_CHANNEL = "__results__"


class TaskMetrics:
    """Per-task timing records for the Fig.13-style CDF breakdown.

    Every record is stamped ``at_ms`` from the engine clock — virtual
    milliseconds under the virtual clock, so the fig13 CDF is
    deterministic and independent of host load."""

    def __init__(self, clock: BaseClock | None = None,
                 enabled: bool = True) -> None:
        self._lock = threading.Lock()
        self.clock = clock
        # Million-task runs: ~2.5 record dicts per task dominate memory;
        # the scaling benchmarks disable recording (charges/kv counters
        # are unaffected — records never touch the clock).
        self.enabled = enabled
        # Stamps are relative to this origin (the engine sets it to the
        # job's t0). On a shared substrate the clock does not restart per
        # job, so absolute stamps would make otherwise-identical jobs
        # report differently.
        self.origin_ms = 0.0
        self.records: list[dict[str, Any]] = []

    def record(self, **kw: Any) -> None:
        if not self.enabled:
            return
        if self.clock is not None and "at_ms" not in kw:
            kw["at_ms"] = self.clock.now_ms() - self.origin_ms
        with self._lock:
            self.records.append(kw)


class ExecutorContext:
    """Everything an executor needs from the engine (shared, read-mostly)."""

    def __init__(
        self,
        dag: DAG,
        kv: ShardedKVStore,
        spawn: Callable[..., Any],
        faults: FaultInjector,
        heartbeats: HeartbeatRegistry,
        metrics: TaskMetrics,
        inline_fanout_args: bool = False,
        executed_counter: list[int] | None = None,
        coalesce_batch: int = 0,
        batch_kv_round_trips: bool = True,
        compute_clock: Any = None,
        stop: Any = None,
        resume: bool = False,
        fault_stats: "FaultStats | None" = None,
        schedule_set: Any = None,
    ):
        self.dag = dag
        self.kv = kv
        # spawn(start_keys, seed_cache, schedule, width) — a generator
        # function (effect protocol); executors drive it with yield from.
        self.spawn = spawn
        self.faults = faults
        self.heartbeats = heartbeats
        self.metrics = metrics
        self.inline_fanout_args = inline_fanout_args
        # >0: chunk invoked fan-out children into batches of this size
        # (optimizer coalescing pass; 0 disables).
        self.coalesce_batch = coalesce_batch
        # Gather task inputs with one pipelined mget per task (one
        # kv_base_ms per shard batch) instead of one get per key.
        self.batch_kv_round_trips = batch_kv_round_trips
        # Clock installed around task-function calls. The platform model
        # passes a memory-scaled proxy here (CPU share proportional to
        # memory size); None = the engine clock unscaled.
        self.compute_clock = compute_clock or kv.clock
        # Per-job stop signal (Event-compatible). Set when the job
        # resolves OR fails; executors check it at task boundaries so an
        # abandoned job stops consuming shared warm-pool / throttle /
        # lane capacity instead of running its walk to the end.
        self.stop = stop
        # Resumed job (crash recovery): executors probe the store for a
        # durable output before executing each task and reuse it instead
        # of recomputing — journaled-complete work is never re-executed.
        self.resume = resume
        # Shared per-job fault/retry observability counters (JobReport).
        self.fault_stats = fault_stats or FaultStats()
        # The job's ScheduleSet (repro_torch.core.schedule): dynamic-DAG
        # expansions re-schedule incrementally through it. None for
        # callers that never expand (tests building contexts by hand).
        self.schedule_set = schedule_set
        # Per-job cache-tier counters (JobReport.cache_stats): container
        # caches count account-wide on their own; executors pass this
        # sink so the job's report never includes another tenant's hits.
        self.cache_stats = CacheStats()
        # Container caches are shared across jobs of a function, so they
        # key on STORE-QUALIFIED names (namespace prefix included).
        self.cache_prefix = (
            kv.qualified_key("") if hasattr(kv, "qualified_key") else "")
        self._id_lock = threading.Lock()
        self._next_id = 0

    def stopped(self) -> bool:
        return self.stop is not None and self.stop.is_set()

    def next_executor_id(self) -> int:
        with self._id_lock:
            self._next_id += 1
            return self._next_id


class TaskExecutor:
    def __init__(
        self,
        ctx: ExecutorContext,
        schedule: StaticSchedule,
        start_key: "str | tuple[str, ...]",
        seed_cache: dict[str, Any] | None = None,
        attempt: int = 0,
        parent: str | None = None,
        container_cache: "ExecutorCache | None" = None,
    ):
        self.ctx = ctx
        self.schedule = schedule
        # Coalesced invocations carry several start keys; the executor
        # walks them in order with one shared local cache.
        self.start_keys: tuple[str, ...] = (
            (start_key,) if isinstance(start_key, str) else tuple(start_key)
        )
        self.start_key = self.start_keys[0]
        self.seed_cache = dict(seed_cache or {})
        self.attempt = attempt
        # The in-edge this executor travels into its start node (set when
        # invoked at a fan-out). Required so fan-in edge ids are unique per
        # in-edge — two executors invoked into the same fan-in node from
        # different parents must increment different edge ids. Every start
        # key in a coalesced batch shares the same parent (same fan-out).
        self.parent = parent
        self.executor_id = ctx.next_executor_id()
        self.cache: dict[str, Any] = {}
        # The CONTAINER's multi-tier cache (repro_torch.core.cache), handed in
        # by the platform wrapper: outlives this invocation on warm
        # reuse, so it serves objects across executors — unlike
        # ``self.cache``, which is this walk's private (free, unbounded)
        # working set. None without a platform cache configured.
        self.ccache = container_cache
        self.tasks_executed = 0
        self._failed_at = 0  # index of the start key whose walk failed

    # -- helpers -------------------------------------------------------------
    def _edge_id(self, src: str, dst: str) -> str:
        return f"{src}=>{dst}"

    def _publish_local_deps_of_g(self, key: str):
        """Publish locally-held objects that ``key`` depends on. Returns
        simulated ms spent writing (clock delta: charged latency plus any
        lane-contention queueing)."""
        clock = self.ctx.kv.clock
        t0 = clock.now_ms()
        for dep in self.ctx.dag.deps[key]:
            if dep in self.cache:
                yield from self.ctx.kv.put_if_absent_g(dep, self.cache[dep])
        return clock.now_ms() - t0

    def _qkey(self, key: str) -> str:
        return self.ctx.cache_prefix + key

    def _probe_tiers_g(self, key: str):
        """Probe the container cache (memory, then disk) for ``key``.
        Returns ``(hit, value)``; a miss means tier 2 — the shared KV
        store — which the caller was about to pay anyway."""
        if self.ccache is None:
            return False, None
        return (yield from self.ccache.probe_g(
            self._qkey(key), stats=self.ctx.cache_stats))

    def _readthrough_g(self, key: str, value: Any):
        """Deposit a remotely-fetched input into the container cache."""
        if self.ccache is not None:
            yield from self.ccache.deposit_g(
                self._qkey(key), value, sizeof(value),
                stats=self.ctx.cache_stats)

    def _resolve_g(self, a: Any, fetched: dict[str, Any]):
        if isinstance(a, TaskRef):
            if a.key in self.cache:
                return self.cache[a.key]  # data locality: no network
            if a.key in fetched:
                return fetched[a.key]
            hit, val = yield from self._probe_tiers_g(a.key)
            if hit:
                return val
            val = yield from self.ctx.kv.get_g(a.key)
            yield from self._readthrough_g(a.key, val)
            return val
        return a

    def _gather_inputs_g(self, key: str):
        task = self.ctx.dag.tasks[key]
        clock = self.ctx.kv.clock
        t0 = clock.now_ms()

        # Remote inputs (not in the local cache) are fetched in ONE
        # pipelined mget — keys grouped by shard, one base round trip per
        # shard batch — instead of one round trip per key (the fan-in
        # path's completing arrival reads all its siblings' outputs here).
        fetched: dict[str, Any] = {}
        if self.ctx.batch_kv_round_trips:
            need: list[str] = []
            for a in list(task.args) + list(task.kwargs.values()):
                if (isinstance(a, TaskRef) and a.key not in self.cache
                        and a.key not in fetched):
                    # Tier probe before the remote mget: an input a
                    # previous invocation of this container produced (or
                    # spilled) is served locally and drops out of the
                    # remote batch entirely.
                    hit, val = yield from self._probe_tiers_g(a.key)
                    if hit:
                        fetched[a.key] = val
                        continue
                    fetched[a.key] = None
                    need.append(a.key)
            if need:
                values = yield from self.ctx.kv.mget_g(need)
                fetched.update(zip(need, values))
                for k in need:
                    # Read-through: a remote fetch leaves a tier-0 copy
                    # behind, so the NEXT invocation this container hosts
                    # (a hint-steered sibling sharing the input, a
                    # retry) reads it locally. This is where shared
                    # inputs — e.g. a GEMM block feeding b multiplies —
                    # stop costing one KV transfer per consumer.
                    yield from self._readthrough_g(k, fetched[k])

        args = []
        for a in task.args:
            args.append((yield from self._resolve_g(a, fetched)))
        kwargs = {}
        for k, v in task.kwargs.items():
            kwargs[k] = yield from self._resolve_g(v, fetched)
        return args, kwargs, clock.now_ms() - t0

    # -- the walk -------------------------------------------------------------
    def run_g(self):
        """The executor body as an effect-protocol generator (simclock).

        Drive it with ``clock.spawn`` (event substrate runs it as a frame,
        thread substrates interpret it via ``run_effects``)."""
        hb = ExecutorHeartbeat(
            executor_id=self.executor_id,
            start_key=self.start_key,
            current_key=self.start_key,
            started_at=self.ctx.kv.clock.now_ms(),
            parent=self.parent,
            start_keys=self.start_keys,
        )
        self.ctx.heartbeats.beat(hb)
        try:
            yield from self._walk_g()
        except SimulatedTaskFailure:
            failed = self._failed_at
            if self.ctx.stopped():
                pass  # dead job: no retry, no error publish
            elif self.attempt < self.ctx.faults.config.max_retries:
                # Lambda's retry delay: charged (not slept) on the clock,
                # exponential in the attempt number.
                backoff = self.ctx.faults.retry_backoff_ms(self.attempt)
                if backoff > 0:
                    yield ("charge", backoff)
                self.ctx.fault_stats.bump("task_retries")
                # Lambda automatic retry: fresh container. Only the failing
                # start re-runs on the incremented attempt; completed walks
                # are durable (idempotent deposits/spawns), and un-walked
                # batch members have not consumed any of their own retry
                # budget yet, so they respawn at attempt 0. This keeps a
                # coalesced batch's fault tolerance identical per-task to
                # uncoalesced execution.
                hints = ()
                if self.ccache is not None:
                    # Bias the retry toward a container holding the
                    # failed walk's inputs: the retry then refetches
                    # them from its cache tiers instead of the KV store.
                    hints = tuple(dict.fromkeys(
                        self._qkey(d)
                        for d in self.ctx.dag.deps[self.start_keys[failed]]))
                yield from self.ctx.spawn(
                    self.start_keys[failed],
                    dict(self.seed_cache),
                    self.schedule,
                    width=1,
                    attempt=self.attempt + 1,
                    parent=self.parent,
                    hint_keys=hints,
                )
                rest = self.start_keys[failed + 1:]
                if rest:
                    yield from self.ctx.spawn(
                        rest,
                        dict(self.seed_cache),
                        self.schedule,
                        width=1,
                        attempt=0,
                        parent=self.parent,
                    )
            else:
                yield from self.ctx.kv.publish_g(
                    RESULTS_CHANNEL,
                    {"type": "error", "key": self.start_keys[failed],
                     "error": "task failed after max retries"},
                )
        except Exception as exc:  # task-code bug: fail the job loudly
            yield from self.ctx.kv.publish_g(
                RESULTS_CHANNEL,
                {"type": "error", "key": self.start_key, "error": repr(exc)},
            )
        finally:
            self.ctx.heartbeats.done(self.executor_id)

    def _walk_g(self):
        self.cache.update(self.seed_cache)
        # Coalesced batches: walk each start key in order. The local cache
        # persists across walks, so batch members meeting at a fan-in
        # resolve it without any KV reads.
        for i, start in enumerate(self.start_keys):
            self._failed_at = i
            yield from self._walk_from_g(start)

    def _walk_from_g(self, start: str):
        dag = self.ctx.dag
        kv = self.ctx.kv
        clock = kv.clock
        current = start
        prev: str | None = self.parent

        while True:
            # ---- job-cancellation boundary -------------------------------
            if self.ctx.stopped():
                # The job resolved or failed while this executor was in
                # flight: stop here rather than walking (and billing)
                # the rest of the path against a dead job.
                return

            # ---- fan-in operation (paper §IV-C) --------------------------
            indeg = len(dag.deps[current])
            if indeg > 1:
                edge = self._edge_id(prev or "__leaf__", current)
                missing: list[str] = []
                if self.schedule.delayed(current):
                    # Delayed I/O (optimizer clustering pass): deposit the
                    # locally-held inputs atomically with the counter
                    # update; the completing arrival skips the write and
                    # keeps its objects in executor memory. The presence
                    # of the remaining inputs rides the same reply.
                    items = {
                        dep: self.cache[dep]
                        for dep in dag.deps[current]
                        if dep in self.cache
                    }
                    expected = tuple(
                        dep for dep in dag.deps[current] if dep not in items
                    )
                    t0 = clock.now_ms()
                    count, missing = yield from kv.deposit_and_increment_g(
                        _counter_id(current), edge, items, expected
                    )
                    write_ms = clock.now_ms() - t0
                else:
                    write_ms = yield from self._publish_local_deps_of_g(
                        current
                    )
                    count = yield from kv.increment_dependency_g(
                        _counter_id(current), edge
                    )
                if count < indeg:
                    # Some dependencies unsatisfied: store outputs and STOP.
                    # (Never wait: Lambda bills wait time, paper §IV-C.)
                    self.ctx.metrics.record(
                        task=current, event="fanin_stop", write_ms=write_ms,
                        executor=self.executor_id,
                    )
                    return
                # Last arriver: continue through the fan-in.
                if missing:
                    # Delayed I/O keeps the completing arrival's value out
                    # of the KV store, so a retried/coalesced invocation
                    # can observe a fully-recorded counter whose missing
                    # input lives only in the memory of the invocation
                    # that recorded it (e.g. a later start key of this
                    # very batch, not yet re-walked this attempt). Stop;
                    # the invocation that recomputes the value completes
                    # the fan-in.
                    self.ctx.metrics.record(
                        task=current, event="fanin_defer",
                        executor=self.executor_id,
                    )
                    return

            # ---- task execution ------------------------------------------
            if not self.schedule.covers(current):
                raise AssertionError(
                    f"executor schedule {self.schedule.leaf!r} does not "
                    f"cover task {current!r}"
                )
            resumed = False
            read_ms = 0.0
            compute_ms = 0.0
            if self.ctx.resume:
                # Crash recovery: a prior generation may already have
                # executed this task durably. One charged probe round
                # trip; on a hit the output is fetched (charged) and the
                # execution — and its fault injection — is skipped, so
                # journaled-complete work is never re-executed.
                yield ("charge", kv.cost.kv_base_ms)
                if kv.exists(current):
                    out = yield from kv.get_g(current)
                    resumed = True
                    self.ctx.fault_stats.bump("tasks_resumed")

            if not resumed:
                args, kwargs, read_ms = yield from self._gather_inputs_g(
                    current)
                hb = ExecutorHeartbeat(
                    executor_id=self.executor_id,
                    start_key=self.start_key,
                    current_key=current,
                    started_at=clock.now_ms(),
                    parent=self.parent,
                    start_keys=self.start_keys,
                )
                self.ctx.heartbeats.beat(hb)

                self.ctx.fault_stats.bump("task_attempts")
                if self.ctx.faults.should_fail(current, self.attempt):
                    self.ctx.fault_stats.bump("injected_failures")
                    raise SimulatedTaskFailure(current)
                straggle = self.ctx.faults.straggle_ms(current, self.attempt)
                if straggle > 0:
                    yield ("charge", straggle)

                # The engine clock is installed for the duration of the task
                # function so workload-declared compute (simulated_compute /
                # per-flop costs) is charged as simulated time.
                t0 = clock.now_ms()
                with task_clock(self.ctx.compute_clock):
                    out = dag.tasks[current].fn(*args, **kwargs)
                # Event substrate: compute charged inside the task function
                # is deferred (the function cannot yield); flush it onto the
                # clock before reading the delta. No-op on the thread
                # substrates.
                yield ("flush",)
                compute_ms = clock.now_ms() - t0
                self.tasks_executed += 1

            # ---- dynamic expansion (DynamicDAG) ----------------------
            if isinstance(out, Expansion):
                # The task grew the graph: install the subgraph, then
                # relabel this walk to the synthetic base node carrying
                # the task's own value and fall through to the NORMAL
                # sink/fan-out path — every KV write, counter op, and
                # spawn below is then identical to running the
                # statically pre-expanded equivalent graph.
                apply = getattr(dag, "apply_expansion", None)
                if apply is None:
                    raise RuntimeError(
                        f"task {current!r} returned an Expansion but the "
                        f"DAG is not a DynamicDAG")
                delta = apply(current, out)
                # Fan-in counters for the delta: registered/re-bound
                # host-side, uncharged (the job-start batched
                # registration already paid; see
                # ShardedKVStore.rebind_counter). A replayed delta (the
                # task ran twice — resume over a crashed run's counters,
                # or a speculative duplicate) must leave the counters
                # alone: the first application's subgraph is live on
                # them, and a reset would strand its in-flight edges.
                if not delta.replayed:
                    for k, width in delta.fan_in_widths.items():
                        kv.rebind_counter(_counter_id(k), width)
                if self.ctx.schedule_set is not None:
                    self.schedule = \
                        self.ctx.schedule_set.expansion_schedule(delta)
                current = delta.base_key
                out = delta.value

            self.cache[current] = out
            # One sizeof walk per output, reused by metrics and as the
            # KV write's size hint (the store records it per key).
            out_nbytes = sizeof(out)
            if self.ccache is not None:
                # Tier-0 deposit: the output stays container-resident
                # across warm reuses, so later invocations landing here
                # (fan-in completers, retries, other jobs' readers are
                # excluded by key qualification) skip the KV read. The
                # write-through below is unchanged — the static schedule
                # has non-local consumers (invoked children / the result
                # waiter) whenever it happens at all.
                yield from self.ccache.deposit_g(
                    self._qkey(current), out, out_nbytes,
                    stats=self.ctx.cache_stats)

            children = dag.children[current]
            # ---- sink: final result --------------------------------------
            if not children:
                t0 = clock.now_ms()
                yield from kv.put_if_absent_g(current, out, nbytes=out_nbytes)
                write_ms = clock.now_ms() - t0
                yield from kv.publish_g(
                    RESULTS_CHANNEL,
                    {"type": "result", "key": current},
                )
                self.ctx.metrics.record(
                    task=current,
                    event="resumed" if resumed else "executed",
                    read_ms=read_ms, compute_ms=compute_ms,
                    write_ms=write_ms, nbytes=out_nbytes,
                    executor=self.executor_id,
                )
                return

            self.ctx.metrics.record(
                task=current,
                event="resumed" if resumed else "executed",
                read_ms=read_ms, compute_ms=compute_ms, write_ms=0.0,
                nbytes=out_nbytes, executor=self.executor_id,
            )

            # ---- fan-out operation (paper §IV-C) -------------------------
            if len(children) == 1:
                prev, current = current, children[0]  # trivial fan-out
                continue

            # Locality-aware become-choice: walk the child whose inputs
            # are most container-resident (by bytes); its siblings are
            # invoked elsewhere. An empty/absent cache scores every
            # child 0 and the tiebreak keeps the schedule order, so the
            # cacheless walk is unchanged bit for bit.
            if self.ccache is not None and len(children) > 1:
                idx = max(
                    range(len(children)),
                    key=lambda i: (self.ccache.resident_bytes(
                        self._qkey(d) for d in dag.deps[children[i]]), -i),
                )
                become = children[idx]
                invoked = children[:idx] + children[idx + 1:]
            else:
                become, *invoked = children
            write_ms = 0.0
            if not self.ctx.inline_fanout_args:
                # Intermediate outputs needed by the new executors go to the
                # KV store; invoked executors receive the keys (paper §IV-C).
                t0 = clock.now_ms()
                yield from kv.put_if_absent_g(current, out, nbytes=out_nbytes)
                write_ms = clock.now_ms() - t0
                seed: dict[str, Any] = {}
            else:
                # Beyond-paper optimization: carry the value inline with the
                # invocation payload (fan-in republish keeps correctness).
                seed = {current: out}
            # Coalescing (optimizer pass): chunk the invoked children so
            # one invocation walks several siblings, shrinking invoker
            # pressure on large fan-outs.
            batch = self.ctx.coalesce_batch
            if batch > 1:
                groups = [tuple(invoked[i:i + batch])
                          for i in range(0, len(invoked), batch)]
            else:
                groups = [(child,) for child in invoked]
            for group in groups:
                # Placement hint: the group's input keys (store-
                # qualified); the invoker biases this invocation toward
                # a warm container whose cache already holds them.
                hints = ()
                if self.ccache is not None:
                    hints = tuple(dict.fromkeys(
                        self._qkey(d)
                        for k in group for d in dag.deps[k]))
                yield from self.ctx.spawn(group, dict(seed), self.schedule,
                                          width=len(groups), parent=current,
                                          hint_keys=hints)
            self.ctx.metrics.record(
                task=current, event="fanout", width=len(children),
                write_ms=write_ms, executor=self.executor_id,
            )
            prev, current = current, become
