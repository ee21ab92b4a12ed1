"""Failure / straggler injection and retry policy.

The paper relies on AWS Lambda's automatic retry (up to two retries of a
failed function execution, §IV-C) and explicitly lists stragglers as an
open problem (§II-A "functions suffer from the straggler issues").

We implement both:
- bounded automatic retry of a failed Task Executor (re-invoked from its
  schedule start point, paying invocation cost again),
- speculative duplicate execution for stragglers (a monitor re-invokes an
  executor whose current task has run far beyond the observed median).
Both are safe because KV writes are ``put_if_absent`` and fan-in counters
are idempotent edge-sets (kvstore.py), so a duplicate executor can never
double-fire a fan-in or clobber a result — this robustness is a
beyond-paper contribution (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
import random
import threading
import zlib


class SimulatedTaskFailure(RuntimeError):
    """Injected Lambda execution failure."""


def exponential_backoff_ms(base_ms: float, attempt: int,
                           cap_ms: float = float("inf")) -> float:
    """Charged exponential retry delay: attempt ``k`` waits
    ``base * 2**k`` simulated ms, capped. Shared by the Lambda-retry
    path below and the platform model's 429-throttle retries, so both
    retry classes follow one schedule."""
    if base_ms <= 0:
        return 0.0
    return min(cap_ms, base_ms * (2.0 ** attempt))


# Orchestrator crash points (the dispatcher's seeded kill sites). The
# names mark WHERE in the control-plane protocol the process dies:
# after journaling ADMITTED but before the runner exists ("admit"),
# after the runner actor is spawned ("dispatch"), and after journaling
# COMPLETED but before the job's namespace is purged ("complete").
ORCHESTRATOR_CRASH_POINTS = ("admit", "dispatch", "complete")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    task_failure_prob: float = 0.0   # per task attempt
    max_retries: int = 2             # AWS Lambda automatic retry limit
    # Simulated delay before a retry attempt is re-invoked (Lambda waits
    # ~1 min between automatic retries; default 0 keeps the seed
    # behavior). Exponential: attempt k is delayed 2**k * base.
    retry_backoff_base_ms: float = 0.0
    # Exponential doubling is capped here: at high attempt counts an
    # unbounded 2**k delay dominates the simulated makespan (and real
    # SDKs cap retry sleeps the same way).
    max_backoff_ms: float = 60_000.0
    straggler_prob: float = 0.0      # per task attempt
    straggler_slowdown_ms: float = 0.0
    speculative_threshold_ms: float = float("inf")  # re-invoke beyond this
    seed: int = 0
    # Orchestrator-level crash injection: kill the dispatcher the
    # ``orchestrator_crash_at``-th time it passes the named point
    # (None = the orchestrator never crashes).
    orchestrator_crash_point: "str | None" = None
    orchestrator_crash_at: int = 1

    def __post_init__(self) -> None:
        # Reject bad knobs at construction: a negative rate silently
        # disables injection mid-run and a negative backoff/threshold
        # produces negative simulated charges — both are config bugs.
        for prob_field in ("task_failure_prob", "straggler_prob"):
            p = getattr(self, prob_field)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{prob_field} must be in [0, 1], got {p}")
        for nonneg in ("max_retries", "retry_backoff_base_ms",
                       "straggler_slowdown_ms"):
            v = getattr(self, nonneg)
            if v < 0:
                raise ValueError(f"{nonneg} must be >= 0, got {v}")
        if self.max_backoff_ms <= 0:
            raise ValueError(
                f"max_backoff_ms must be > 0, got {self.max_backoff_ms}")
        if self.speculative_threshold_ms <= 0:
            raise ValueError(
                "speculative_threshold_ms must be > 0 "
                f"(inf disables), got {self.speculative_threshold_ms}")
        if (self.orchestrator_crash_point is not None
                and self.orchestrator_crash_point
                not in ORCHESTRATOR_CRASH_POINTS):
            raise ValueError(
                f"orchestrator_crash_point must be one of "
                f"{ORCHESTRATOR_CRASH_POINTS}, "
                f"got {self.orchestrator_crash_point!r}")
        if self.orchestrator_crash_at < 1:
            raise ValueError(
                f"orchestrator_crash_at must be >= 1, "
                f"got {self.orchestrator_crash_at}")


class FaultStats:
    """Thread-safe per-job fault/retry observability counters, surfaced
    in ``JobReport.fault_stats`` so fault runs are inspectable without
    log scraping."""

    FIELDS = ("task_attempts", "injected_failures", "task_retries",
              "speculative_duplicates", "throttle_retries", "tasks_resumed")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.FIELDS, 0)

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._counts[field] += n  # KeyError on a typo'd field: good

    def snapshot(self) -> "dict[str, int]":
        with self._lock:
            return dict(self._counts)


class FaultInjector:
    """Deterministic-per-(task, attempt) fault decisions."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self._lock = threading.Lock()
        # Occurrence counters per orchestrator crash point. They live on
        # the injector INSTANCE and keep counting across recovery
        # generations, so a configured crash fires exactly once per
        # injector — recovery passes the same injector along and does
        # not re-crash at the same point forever.
        self._crash_counts: "dict[str, int]" = {}

    def retry_backoff_ms(self, attempt: int) -> float:
        """Simulated delay charged before respawning retry ``attempt+1``
        (charged on the engine clock, so under the virtual clock it
        advances simulated time without wall-time cost)."""
        return exponential_backoff_ms(self.config.retry_backoff_base_ms,
                                      attempt,
                                      cap_ms=self.config.max_backoff_ms)

    def orchestrator_crash(self, point: str) -> bool:
        """True when the dispatcher must die HERE: the configured crash
        point has been reached for the ``orchestrator_crash_at``-th
        time. Deterministic (occurrence-counted, no RNG), so the same
        workload crashes at the same job on every run."""
        if self.config.orchestrator_crash_point != point:
            return False
        with self._lock:
            self._crash_counts[point] = self._crash_counts.get(point, 0) + 1
            return self._crash_counts[point] == \
                self.config.orchestrator_crash_at

    def _rng(self, task_key: str, attempt: int) -> random.Random:
        # Stable across processes: tuple.__hash__ mixes in the
        # PYTHONHASHSEED-randomized str hash, which silently turned every
        # "verified recoverable" test seed into a per-process lottery
        # (same bug class as hash()-based shard placement, fixed in
        # kvstore the same way).
        token = f"{self.config.seed}|{task_key}|{attempt}".encode()
        return random.Random(zlib.crc32(token))

    def should_fail(self, task_key: str, attempt: int) -> bool:
        if self.config.task_failure_prob <= 0:
            return False
        return self._rng(task_key, attempt).random() < self.config.task_failure_prob

    def straggle_ms(self, task_key: str, attempt: int) -> float:
        if self.config.straggler_prob <= 0:
            return 0.0
        rng = self._rng(task_key, attempt)
        rng.random()  # decorrelate from should_fail
        if rng.random() < self.config.straggler_prob:
            return self.config.straggler_slowdown_ms
        return 0.0


@dataclasses.dataclass
class ExecutorHeartbeat:
    executor_id: int
    start_key: str
    current_key: str
    started_at: float  # engine-clock ms (virtual ms under VirtualClock)
    parent: str | None = None
    # Full start batch for coalesced executors (speculative duplicates
    # must cover every member, not just the first).
    start_keys: tuple[str, ...] = ()


class HeartbeatRegistry:
    """Tracks in-flight executors for the speculative straggler monitor."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._beats: dict[int, ExecutorHeartbeat] = {}

    def beat(self, hb: ExecutorHeartbeat) -> None:
        with self._lock:
            self._beats[hb.executor_id] = hb

    def done(self, executor_id: int) -> None:
        with self._lock:
            self._beats.pop(executor_id, None)

    def inflight(self) -> list[ExecutorHeartbeat]:
        with self._lock:
            return list(self._beats.values())
