"""Trigger bus: event-fired job submissions over the shared KV store.

The paper's engine runs DAGs handed to it; a serverless platform also
has to *start* them — on a timer, on a storage write, on another job
finishing, on an external event (Triggerflow's trigger model). This
module adds that control-plane layer on top of the multi-tenant orchestrator:

- :class:`TriggerRule`  — a persistent event->job rule. Rules are
  journaled (``journal_append_g``) in a ``__triggers__`` namespace of
  the shared store, exactly like the job state machine, so they
  survive orchestrator crashes and replay through ``recover()``.
- :class:`TriggerBus`   — matches events against the installed rules
  and journals every *fire* (rule match -> job submission) under a
  deterministic fire key BEFORE the job is submitted. Replay rebuilds
  the fired-set, so a recovering orchestrator neither re-fires a
  journaled fire (no duplicate job) nor loses one journaled without a
  PENDING record (the fire's journal payload carries the full job
  spec).
- four event sources, all funnelled into the orchestrator's single
  dispatch queue:

  ``timer``          — a per-rule clock actor charges ``period_ms``
                       between ticks (bounded by ``max_fires``).
  ``kv_write``       — ``ShardedKVStore.add_write_listener``: every
                       durable object write is offered, host-side, to
                       the bus's prefix filters. Rules may aggregate
                       matching writes into tumbling/sliding windows
                       by the event time encoded in the key; each
                       window close fires one job.
  ``job_completed``  — the orchestrator feeds every journaled terminal
                       transition back through the bus.
  ``external``       — ``emit_g`` publishes on a charged ``__triggers__``
                       pub/sub channel; a relay actor forwards to the
                       dispatch queue. An external event may also flush
                       the open windows (end-of-stream).

- :class:`StreamConfig` / :func:`stream_source` — a seeded Poisson
  event writer (the streaming workload of fig19): event ``i`` is a
  durable write of ``<prefix><i>@<event_ms>`` — the event time rides
  in the key, so a crashed-and-recovered orchestrator re-deriving the
  stream assigns every event to the same window and re-computes the
  same fire keys.
- :class:`StreamingReport` — steady-state metrics over a run:
  sustained window-jobs/s, p50/p95/p99 event-to-result latency,
  backlog depth.

Determinism: everything runs on the shared virtual clock; a fresh run
of the same config is bit-identical (fig19 gates this across runs AND
across the event/thread substrates).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core.kvstore import NAMESPACE_SEP, PURGED, ShardedKVStore

TRIGGER_NS = "__triggers__"
RULE_JOURNAL = "rules"
FIRE_JOURNAL = "fires"
EVENT_CHANNEL = "events"
TRIGGER_SOURCES = ("timer", "kv_write", "job_completed", "external")
# relay-stop sentinel event name (never matches a rule)
_CLOSE = "__close__"


# ---------------------------------------------------------------------------
# Rule / stream configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TriggerRule:
    """One persistent trigger: an event source, its match parameters,
    and the job template (``action``) each fire submits.

    ``action`` is a reconstructible job spec fragment — at least
    ``app``, ``size`` and ``tenant`` (``compute_ms``/``payload_bytes``
    optional) — instantiated into a ``JobRequest`` with a bus-assigned
    ``job_id`` and the fire time as ``arrival_ms``.

    Fire keys are deterministic per source so journal replay can
    de-duplicate across crash generations:

    ==============  =========================================
    timer           ``<rule_id>#t<tick>``
    kv_write        ``<rule_id>#w<window>`` (windowed) or
                    ``<rule_id>#<key>`` (per-write)
    job_completed   ``<rule_id>#<job_id of the finished job>``
    external        ``<rule_id>#<event dedup key>``
    ==============  =========================================
    """

    rule_id: str
    source: str
    action: "Mapping[str, Any]"
    # -- timer --------------------------------------------------------------
    period_ms: float = 0.0
    # timer: REQUIRED tick bound (the simulation must terminate).
    # Other sources: optional fire cap, 0 = unbounded.
    max_fires: int = 0
    # -- kv_write -----------------------------------------------------------
    key_prefix: str = ""          # store-qualified key prefix to match
    window_ms: float = 0.0        # > 0: aggregate matches into windows
    slide_ms: float = 0.0         # 0 = tumbling (slide == window)
    min_window_events: int = 1    # windows below this never fire
    # -- job_completed ------------------------------------------------------
    job_app: str = ""             # only completions of this app ("" = any)
    every_n: int = 1              # ... whose job_id % every_n == 0
    # -- external -----------------------------------------------------------
    event: str = ""               # event name to match
    flush_windows: bool = False   # this event also closes open windows

    def __post_init__(self) -> None:
        if not self.rule_id or "#" in self.rule_id:
            raise ValueError("rule_id must be non-empty and '#'-free")
        if self.source not in TRIGGER_SOURCES:
            raise ValueError(
                f"source must be one of {TRIGGER_SOURCES}, "
                f"got {self.source!r}")
        if not isinstance(self.action, Mapping) or not (
                {"app", "size", "tenant"} <= set(self.action)):
            raise ValueError(
                "action must be a mapping with at least app/size/tenant")
        object.__setattr__(self, "action", dict(self.action))
        for name in ("period_ms", "window_ms", "slide_ms"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be non-negative")
        for name in ("max_fires",):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be non-negative")
        for name in ("min_window_events", "every_n"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.source == "timer":
            if self.period_ms <= 0:
                raise ValueError("timer rules need period_ms > 0")
            if self.max_fires < 1:
                raise ValueError(
                    "timer rules need max_fires >= 1 (bounded ticks)")
        if self.source == "kv_write" and not self.key_prefix:
            raise ValueError("kv_write rules need a non-empty key_prefix")
        if self.window_ms > 0 and self.slide_ms > self.window_ms:
            raise ValueError("slide_ms must be <= window_ms")
        if self.source == "external" and not self.event:
            raise ValueError("external rules need a non-empty event name")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """The seeded Poisson event stream fig19 feeds the bus."""

    n_events: int = 256
    rate_per_s: float = 50.0
    seed: int = 7
    payload_bytes: int = 64
    namespace: str = "stream"     # store namespace the events land in
    key_prefix: str = "ev/"
    flush_event: str = ""         # external event emitted after the last
    # write ("" = no end-of-stream emit)

    def __post_init__(self) -> None:
        if self.n_events < 1:
            raise ValueError("n_events must be >= 1")
        if self.rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive")
        if self.payload_bytes < 0:
            raise ValueError("payload_bytes must be non-negative")
        if not self.namespace or NAMESPACE_SEP in self.namespace:
            raise ValueError(
                f"namespace must be non-empty and {NAMESPACE_SEP!r}-free")
        if not self.key_prefix:
            raise ValueError("key_prefix must be non-empty")

    @property
    def store_prefix(self) -> str:
        """The store-qualified prefix a ``kv_write`` rule matches."""
        return f"{self.namespace}{NAMESPACE_SEP}{self.key_prefix}"


def stream_arrivals(cfg: StreamConfig) -> "list[float]":
    """Cumulative event times in ms — a pure function of the config
    (the determinism and crash-replay gates both rerun it)."""
    import random

    rng = random.Random(cfg.seed)
    out: "list[float]" = []
    t = 0.0
    for _ in range(cfg.n_events):
        t += rng.expovariate(cfg.rate_per_s) * 1e3
        out.append(t)
    return out


def stream_key(cfg: StreamConfig, i: int, event_ms: float) -> str:
    """``<prefix><seq>@<event_ms>`` — event time encoded in the key, so
    window assignment survives crash replay (wall clock moves on, the
    key does not)."""
    return f"{cfg.key_prefix}{i:06d}@{event_ms:.3f}"


def _event_ms(key: str, default: float) -> float:
    _, _, ts = key.rpartition("@")
    try:
        return float(ts)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# Steady-state report
# ---------------------------------------------------------------------------


def _percentile(sorted_vals: "list[float]", q: float) -> float:
    if not sorted_vals:
        return 0.0
    rank = max(1, -(-len(sorted_vals) * q // 100))  # ceil(n*q/100)
    return sorted_vals[int(rank) - 1]


@dataclasses.dataclass
class StreamingReport:
    events: int
    fires: "dict[str, int]"        # source type -> jobs fired
    windows_closed: int
    window_jobs_completed: int
    sustained_jobs_per_s: float    # window jobs / (first fire->last done)
    event_to_result_p50_s: float
    event_to_result_p95_s: float
    event_to_result_p99_s: float
    mean_backlog: float            # fired-not-yet-done window jobs,
    max_backlog: int               # sampled at every fire/completion
    duplicate_fires_suppressed: int


# ---------------------------------------------------------------------------
# The bus
# ---------------------------------------------------------------------------


class TriggerBus:
    """Rule store + event matcher + fire journal on one shared store.

    One bus instance per orchestrator generation. All *matching* is
    host-side (pure bookkeeping); all *durability* (rule and fire
    journals, the external-event channel) is charged through the
    ``__triggers__`` namespace of the shared store. The orchestrator's
    dispatch loop is the single consumer: sources enqueue raw events
    onto its queue, and it runs ``fire_g`` for every match the bus
    reports.
    """

    def __init__(self, kv: ShardedKVStore, clock: Any,
                 id_base: int = 1_000_000):
        self.kv = kv
        self.trig = kv.namespace(TRIGGER_NS)
        self.clock = clock
        self.id_base = id_base
        self.rules: "dict[str, TriggerRule]" = {}
        self._next_job = id_base
        # fire_key -> journaled fire record (journal replay rebuilds it)
        self._fired: "dict[str, dict[str, Any]]" = {}
        self._fires_by_rule: "dict[str, int]" = {}
        self._job_rule: "dict[int, TriggerRule]" = {}
        self._queue: Any = None
        self._listener: Any = None
        # kv_write bookkeeping (this generation; replay regenerates)
        self._seen_writes: "set[str]" = set()
        # rule_id -> window_idx -> [(key, event_ms, arrival_ms), ...]
        self._windows: "dict[str, dict[int, list]]" = {}
        self._watermark: "dict[str, float]" = {}
        # steady-state metrics
        self._job_events: "dict[int, list[float]]" = {}
        self._latencies: "list[float]" = []
        self._outstanding: "set[int]" = set()
        self._backlog_samples: "list[int]" = []
        self._first_fire_ms: "float | None" = None
        self._last_window_done_ms = 0.0
        self._window_jobs_done = 0
        self._suppressed = 0

    # -- source plumbing ----------------------------------------------------
    def attach(self, queue: Any) -> None:
        """Start observing durable writes, forwarding matches of any
        ``kv_write`` rule's prefix onto the dispatch ``queue``
        host-side (the listener runs inside the writer's op and must
        not charge)."""
        self._queue = queue

        def on_write(key: str, nbytes: int) -> None:
            for rule in self.rules.values():
                if (rule.source == "kv_write"
                        and key.startswith(rule.key_prefix)):
                    queue.put(("event", {
                        "source": "kv_write", "key": key, "nbytes": nbytes,
                        "at_ms": self.clock.now_ms()}))
                    return

        self._listener = on_write
        self.kv.add_write_listener(on_write)

    def detach(self) -> None:
        """Stop observing writes (a recovering orchestrator detaches
        the dead generation's bus before attaching its own)."""
        if self._listener is not None:
            self.kv.remove_write_listener(self._listener)
            self._listener = None

    def relay_actor(self, queue: Any):
        """The external-event relay: subscribed to the charged
        ``__triggers__`` pub/sub channel, forwards every emit onto the
        dispatch queue, exits on the close sentinel (or on ``PURGED``
        if the namespace is dropped under it) and always reports
        ``source_done``."""
        sub = self.trig.subscribe(EVENT_CHANNEL)
        clock = self.clock

        def relay():
            try:
                while True:
                    msg = yield ("get", sub, None)
                    if msg is PURGED or msg.get("name") == _CLOSE:
                        break
                    queue.put(("event", {
                        "source": "external", "name": msg["name"],
                        "ekey": msg.get("ekey", msg["name"]),
                        "payload": msg.get("payload"),
                        "at_ms": clock.now_ms()}))
            finally:
                self.trig.unsubscribe(EVENT_CHANNEL, sub)
                queue.put(("source_done", "relay"))

        return relay

    def timer_actor(self, rule: TriggerRule, queue: Any):
        """One bounded tick source per timer rule."""
        clock = self.clock

        def timer():
            for i in range(rule.max_fires):
                yield ("charge", rule.period_ms)
                queue.put(("event", {
                    "source": "timer", "rule_id": rule.rule_id,
                    "seq": i, "at_ms": clock.now_ms()}))
            queue.put(("source_done", f"timer:{rule.rule_id}"))

        return timer

    def emit_g(self, name: str, key: "str | None" = None,
               payload: Any = None):
        """Publish an external event (charged pub/sub into
        ``__triggers__``). ``key`` de-duplicates re-emits across crash
        generations — same key, same fire."""
        yield from self.trig.publish_g(EVENT_CHANNEL, {
            "name": name, "ekey": key if key is not None else name,
            "payload": payload})

    def close_g(self):
        """Stop the relay (end of run)."""
        yield from self.trig.publish_g(EVENT_CHANNEL, {"name": _CLOSE})

    # -- rule durability ----------------------------------------------------
    def add_rule_g(self, rule: TriggerRule):
        """Journal-then-install (the ``JobStateMachine.record_g``
        discipline): once this returns, the rule survives the
        orchestrator."""
        if rule.rule_id in self.rules:
            raise ValueError(f"duplicate rule_id {rule.rule_id!r}")
        yield from self.trig.journal_append_g(
            RULE_JOURNAL, {"rule": dataclasses.asdict(rule)})
        self.rules[rule.rule_id] = rule

    def replay_g(self):
        """Rebuild rules and the fired-set from the journals (crash
        recovery). Returns the number of entries folded."""
        n = 0
        if self.trig.journal_len(RULE_JOURNAL):
            entries = yield from self.trig.journal_scan_g(RULE_JOURNAL)
            for e in entries:
                rule = TriggerRule(**e["rule"])
                self.rules[rule.rule_id] = rule
                n += 1
        if self.trig.journal_len(FIRE_JOURNAL):
            fires = yield from self.trig.journal_scan_g(FIRE_JOURNAL)
            for rec in fires:
                self._fired[rec["fire_key"]] = rec
                self._fires_by_rule[rec["rule_id"]] = (
                    self._fires_by_rule.get(rec["rule_id"], 0) + 1)
                self._next_job = max(self._next_job, rec["job_id"] + 1)
                n += 1
        return n

    def fired_records(self) -> "list[dict[str, Any]]":
        """All journaled fires, in fire_key order (recovery walks this
        to find fires whose PENDING record never landed)."""
        return [self._fired[k] for k in sorted(self._fired)]

    # -- matching -----------------------------------------------------------
    def match(self, ev: "dict[str, Any]") -> "list[dict[str, Any]]":
        """Offer one event to every rule; returns the fires now due as
        ``{rule, fire_key, event_times}`` dicts. Pure host-side
        bookkeeping — the caller journals each fire with ``fire_g``
        before acting on it."""
        source = ev["source"]
        out: "list[dict[str, Any]]" = []
        if source == "timer":
            rule = self.rules.get(ev["rule_id"])
            if rule is not None and rule.source == "timer":
                out.extend(self._due(rule, f"t{ev['seq']}", [ev["at_ms"]]))
        elif source == "kv_write":
            key = ev["key"]
            if key in self._seen_writes:
                return out  # duplicate delivery (crash replay overlap)
            self._seen_writes.add(key)
            for rule in self._rules_of("kv_write"):
                if not key.startswith(rule.key_prefix):
                    continue
                if rule.window_ms <= 0:
                    out.extend(self._due(rule, key, [ev["at_ms"]]))
                else:
                    out.extend(self._window_event(rule, ev))
        elif source == "job_completed":
            rec = ev["record"]
            for rule in self._rules_of("job_completed"):
                if rule.job_app and rec.get("app") != rule.job_app:
                    continue
                if rec["job_id"] % rule.every_n:
                    continue
                out.extend(self._due(rule, str(rec["job_id"]),
                                     [ev["at_ms"]]))
        elif source == "external":
            for rule in self._rules_of("external"):
                if rule.event != ev["name"]:
                    continue
                out.extend(self._due(rule, ev["ekey"], [ev["at_ms"]]))
                if rule.flush_windows:
                    out.extend(self.flush())
        return out

    def flush(self) -> "list[dict[str, Any]]":
        """Close every open window of every windowed rule (end of
        stream)."""
        out: "list[dict[str, Any]]" = []
        for rule in self._rules_of("kv_write"):
            if rule.window_ms > 0:
                out.extend(self._close_windows(rule, float("inf")))
        return out

    def _rules_of(self, source: str) -> "list[TriggerRule]":
        return [r for r in self.rules.values() if r.source == source]

    def _due(self, rule: TriggerRule, suffix: str,
             event_times: "list[float]") -> "list[dict[str, Any]]":
        if rule.max_fires and \
                self._fires_by_rule.get(rule.rule_id, 0) >= rule.max_fires:
            return []
        return [{"rule": rule, "fire_key": f"{rule.rule_id}#{suffix}",
                 "event_times": list(event_times)}]

    def _window_event(self, rule: TriggerRule,
                      ev: "dict[str, Any]") -> "list[dict[str, Any]]":
        """Assign one write to its window(s) by the event time in the
        key, advance the rule's watermark, close what's due. Late
        events (crash-replay interleavings deliver out of order) still
        land: a closed-but-unfired window fires as soon as it has an
        event, and journal de-dup keeps re-fires out."""
        rid = rule.rule_id
        ts = _event_ms(ev["key"], ev["at_ms"])
        slide = rule.slide_ms or rule.window_ms
        windows = self._windows.setdefault(rid, {})
        hi = int(ts // slide)
        lo = max(0, int((ts - rule.window_ms) // slide) + 1)
        for w in range(lo, hi + 1):
            # window w covers [w*slide, w*slide + window_ms)
            if ts < w * slide or ts >= w * slide + rule.window_ms:
                continue
            windows.setdefault(w, []).append(
                (ev["key"], ts, ev["at_ms"]))
        self._watermark[rid] = max(self._watermark.get(rid, 0.0), ts)
        return self._close_windows(rule, self._watermark[rid])

    def _close_windows(self, rule: TriggerRule,
                       watermark: float) -> "list[dict[str, Any]]":
        rid = rule.rule_id
        slide = rule.slide_ms or rule.window_ms
        windows = self._windows.setdefault(rid, {})
        out: "list[dict[str, Any]]" = []
        for w in sorted(windows):
            if w * slide + rule.window_ms > watermark:
                break
            events = windows.pop(w)
            if len(events) < rule.min_window_events:
                continue
            out.extend(self._due(rule, f"w{w}",
                                 [arr for _, _, arr in events]))
        return out

    # -- firing -------------------------------------------------------------
    def fire_g(self, due: "dict[str, Any]", at_ms: float):
        """Journal one fire and return the reconstructible job spec —
        or ``None`` when the fire key is already journaled (a crash
        generation fired it; the job journal owns it from here)."""
        rule: TriggerRule = due["rule"]
        fire_key: str = due["fire_key"]
        if fire_key in self._fired:
            self._suppressed += 1
            return None
        job_id = self._next_job
        self._next_job += 1
        spec: "dict[str, Any]" = {
            "job_id": job_id, "arrival_ms": at_ms,
            "compute_ms": 20.0, "payload_bytes": 0,
        }
        spec.update(rule.action)
        rec = {"fire_key": fire_key, "rule_id": rule.rule_id,
               "source": rule.source, "job_id": job_id, "at_ms": at_ms,
               "spec": spec}
        yield from self.trig.journal_append_g(FIRE_JOURNAL, rec)
        self._fired[fire_key] = rec
        self._fires_by_rule[rule.rule_id] = (
            self._fires_by_rule.get(rule.rule_id, 0) + 1)
        self._job_rule[job_id] = rule
        if rule.source == "kv_write":
            self._job_events[job_id] = list(due["event_times"])
            self._outstanding.add(job_id)
            self._backlog_samples.append(len(self._outstanding))
            if self._first_fire_ms is None:
                self._first_fire_ms = at_ms
        return spec

    # -- completion feedback ------------------------------------------------
    def job_finished(self, rec: "dict[str, Any]", end_ms: float) -> None:
        """Steady-state accounting for a finished trigger-fired job
        (host-side; the orchestrator calls it after journaling the
        terminal transition)."""
        job_id = rec["job_id"]
        rule = self._job_rule.get(job_id)
        if rule is None or rule.source != "kv_write":
            return
        self._outstanding.discard(job_id)
        self._backlog_samples.append(len(self._outstanding))
        if rec.get("error") is None:
            self._window_jobs_done += 1
            self._last_window_done_ms = max(
                self._last_window_done_ms, end_ms)
            for arr in self._job_events.pop(job_id, ()):
                self._latencies.append((end_ms - arr) / 1e3)

    # -- reporting ----------------------------------------------------------
    def report(self, n_events: int = 0) -> StreamingReport:
        fires: "dict[str, int]" = {s: 0 for s in TRIGGER_SOURCES}
        for rec in self._fired.values():
            fires[rec["source"]] = fires.get(rec["source"], 0) + 1
        lat = sorted(self._latencies)
        span_s = 0.0
        if self._first_fire_ms is not None:
            span_s = (self._last_window_done_ms - self._first_fire_ms) / 1e3
        backlog = self._backlog_samples
        return StreamingReport(
            events=n_events,
            fires=fires,
            windows_closed=fires.get("kv_write", 0),
            window_jobs_completed=self._window_jobs_done,
            sustained_jobs_per_s=(
                self._window_jobs_done / span_s if span_s > 0 else 0.0),
            event_to_result_p50_s=_percentile(lat, 50),
            event_to_result_p95_s=_percentile(lat, 95),
            event_to_result_p99_s=_percentile(lat, 99),
            mean_backlog=(sum(backlog) / len(backlog) if backlog else 0.0),
            max_backlog=max(backlog, default=0),
            duplicate_fires_suppressed=self._suppressed,
        )


# ---------------------------------------------------------------------------
# The streaming source
# ---------------------------------------------------------------------------


def stream_source(cfg: StreamConfig, kv: ShardedKVStore, clock: Any,
                  bus: TriggerBus, queue: Any):
    """The Poisson event writer as a clock actor: charges each
    inter-arrival gap, durably writes ``stream_key(i, t_i)`` (the write
    listener turns that into a ``kv_write`` event), optionally emits
    the end-of-stream external event, and reports ``source_done``.

    Recovery: a fresh generation re-runs the whole source. Re-writes
    of already-stored keys are value-identical overwrites; the bus
    de-duplicates their events by key and the fire journal
    de-duplicates the window fires, so replay neither loses nor
    duplicates a window job."""
    ns = kv.namespace(cfg.namespace)
    arrivals = stream_arrivals(cfg)

    def source():
        t = 0.0
        for i, ts in enumerate(arrivals):
            gap = ts - t
            t = ts
            if gap > 0:
                yield ("charge", gap)
            yield from ns.put_g(stream_key(cfg, i, ts), ts,
                                nbytes=max(1, cfg.payload_bytes))
        if cfg.flush_event:
            yield from bus.emit_g(cfg.flush_event, key="flush")
        queue.put(("source_done", "stream"))

    return source
