"""FaaSPlatform: the stateful platform facade the invocation path uses.

Sits between the invoker lanes and the engine clock and combines the
three sub-models:

- ``ContainerPool``       — warm reuse vs cold provisioning, keep-alive
                            expiry on the engine clock;
- ``ConcurrencyThrottle`` — account cap with burst ramp, 429s retried
                            by the invoker lane with charged backoff;
- ``BillingMeter``        — per-request + GB-second charging of each
                            invocation's simulated execution time.

The invoker lane drives the protocol per invocation:

    while not platform.try_reserve():       # 429 + charged backoff
        clock.charge(platform.backoff_ms(attempt)); attempt += 1
    clock.charge(jittered invoke_ms)        # invoke API round trip
    cid, cold = platform.acquire(fn)        # pool decides cold/warm
    if cold: clock.charge(cold_start_ms)    # provisioning delay
    runtime_pool.submit(platform.wrap(fn, cid, body))

``wrap`` meters the body's simulated charges as billed duration and
releases the container + concurrency slot when the body finishes.

``compute_clock`` scales declared task compute by the memory knob
(CPU share is proportional to memory), which is what makes the
memory sweep a genuine cost-vs-latency trade-off.
"""
from __future__ import annotations

from types import GeneratorType
from typing import Any, Callable

from repro_torch.core.cache import CacheRegistry
from repro_torch.core.kvstore import CostModel
from repro_torch.core.simclock import BaseClock, charge_meter
from repro_torch.platform.billing import BillingMeter
from repro_torch.platform.config import PlatformConfig
from repro_torch.platform.pool import ContainerPool
from repro_torch.platform.throttle import ConcurrencyThrottle

DEFAULT_FUNCTION = "executor"


class ComputeScaledClock:
    """Clock proxy multiplying charges by the memory-derived compute
    scale. Installed as the *task* clock around task-function calls, so
    workload-declared compute (``simulated_compute`` / per-flop costs)
    runs slower on smaller containers; engine-side latencies (KV,
    invoke) are unaffected."""

    def __init__(self, clock: BaseClock, scale: float):
        self._clock = clock
        self._scale = scale

    def charge(self, ms: float) -> None:
        self._clock.charge(ms * self._scale)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._clock, name)


class FaaSPlatform:
    """One platform instance per job: every invoker pool of the job
    (initial + proxy invokers) shares it, so the concurrency cap is
    account-wide and the container pool is function-wide."""

    def __init__(self, config: PlatformConfig, cost: CostModel,
                 clock: BaseClock):
        self.config = config
        self.cost = cost
        self.clock = clock
        self.pool = ContainerPool(config, clock)
        self.throttle = ConcurrencyThrottle(config, clock)
        self.meter = BillingMeter(config)
        # Container-resident multi-tier caches (repro_torch.core.cache): the
        # pool decides container identity, the registry makes each
        # container's cache follow it — retained across warm reuses,
        # dropped on expiry (the pool's on_expire hook).
        self.caches: "CacheRegistry | None" = (
            CacheRegistry(config.cache) if config.cache is not None else None)
        if self.caches is not None:
            self.pool.on_expire = self.caches.drop
        # Per-function memory overrides (multi-tenant: one function per
        # tenant, each with its own memory size -> its own billing rate
        # and compute speed). Unregistered functions use the account
        # default ``config.memory_mb``.
        self._fn_memory: dict[str, int] = {}
        self._configured: set[str] = set()
        if config.prewarm > 0:
            self.pool.prewarm(DEFAULT_FUNCTION, config.prewarm)

    # -- multi-tenant function registry -------------------------------------
    def configure_function(self, function: str,
                           memory_mb: int | None = None) -> None:
        """Declare a deployed function (a tenant, under the
        orchestrator) with its own memory size. Warm containers are
        already pooled per function name, so tenants share the account
        cap and billing meter but never each other's containers.

        ``config.prewarm`` applies per deployed function: the pool is
        keyed by function name, so warming only the default function
        would leave every tenant's first invocations cold and the knob
        silently ineffective in multi-tenant runs."""
        if memory_mb is not None:
            if memory_mb <= 0:
                raise ValueError("memory_mb must be positive")
            self._fn_memory[function] = int(memory_mb)
        if (self.config.prewarm > 0 and function != DEFAULT_FUNCTION
                and function not in self._configured):
            # once per function: reconfiguring must not re-warm
            self.pool.prewarm(function, self.config.prewarm)
        self._configured.add(function)

    def memory_mb(self, function: str = DEFAULT_FUNCTION) -> int:
        return self._fn_memory.get(function, self.config.memory_mb)

    # -- invocation protocol (driven by the invoker lane) -------------------
    def try_reserve(self) -> bool:
        return self.throttle.try_reserve()

    def backoff_ms(self, attempt: int) -> float:
        return self.throttle.backoff_ms(attempt)

    def acquire(self, function: str = DEFAULT_FUNCTION,
                prefer_keys: "tuple[str, ...]" = ()) -> "tuple[int, bool]":
        """Assign a container. ``prefer_keys`` is the locality hint from
        the invoker: store-qualified keys the invocation will read —
        the pool then prefers the idle container already holding the
        most bytes of them (ties keep LIFO reuse)."""
        if self.caches is not None and prefer_keys:
            caches = self.caches

            def score(cid: int) -> int:
                return caches.resident_bytes(function, cid, prefer_keys)

            return self.pool.acquire(function, score=score)
        return self.pool.acquire(function)

    def wrap(self, function: str, container_id: int,
             body: Callable[[], None],
             job: str | None = None) -> Callable[[], None]:
        """Wrap an executor body: meter its simulated charges as billed
        duration, then return the container to the warm pool and free
        the concurrency slot. ``job`` is the billing-attribution label
        recorded with the invocation."""

        memory_mb = self.memory_mb(function)
        cache = (self.caches.cache_for(function, container_id)
                 if self.caches is not None else None)

        def invocation() -> None:
            acc = [0.0]
            try:
                with charge_meter(acc):
                    # Cache-aware bodies (the executor bodies) take the
                    # container's cache; plain bodies run unchanged.
                    if getattr(body, "accepts_cache", False):
                        body(cache)
                    else:
                        body()
            finally:
                self.meter.add_invocation(acc[0], memory_mb=memory_mb,
                                          key=function, job=job)
                self.pool.release(function, container_id)
                self.throttle.release()

        return invocation

    def wrap_g(self, function: str, container_id: int,
               body: Callable[[], Any],
               job: str | None = None) -> Callable[[], Any]:
        """Effect-protocol sibling of ``wrap``: the returned zero-arg
        callable is a generator function, so it composes with bodies
        that are themselves effect generators (the event substrate's
        executor bodies). Metering and release semantics are identical
        to ``wrap``."""

        memory_mb = self.memory_mb(function)
        cache = (self.caches.cache_for(function, container_id)
                 if self.caches is not None else None)

        def invocation():
            acc = [0.0]
            try:
                with charge_meter(acc):
                    if getattr(body, "accepts_cache", False):
                        r = body(cache)
                    else:
                        r = body()
                    if isinstance(r, GeneratorType):
                        yield from r
            finally:
                self.meter.add_invocation(acc[0], memory_mb=memory_mb,
                                          key=function, job=job)
                self.pool.release(function, container_id)
                self.throttle.release()

        return invocation

    def cancel(self, function: str, container_id: int) -> None:
        """Undo an acquire whose body never ran (runtime pool already
        shut down): free the slot, return the container unbilled."""
        self.pool.release(function, container_id)
        self.throttle.release()

    # -- compute scaling ----------------------------------------------------
    def compute_clock(self, clock: BaseClock,
                      function: str = DEFAULT_FUNCTION) -> Any:
        """Task clock for ``function``: CPU share proportional to ITS
        memory size (per-tenant under the orchestrator)."""
        scale = self.config.baseline_memory_mb / self.memory_mb(function)
        if scale == 1.0:
            return clock
        return ComputeScaledClock(clock, scale)

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """Current platform counters. CONTRACT: the returned dict (and
        everything nested in it) is freshly built per call — callers
        (JobReports, the orchestrator) may extend or mutate it without
        aliasing any other snapshot or platform internals."""
        out: dict[str, Any] = {
            "mode": "pool",
            "memory_mb": self.config.memory_mb,
            "keep_alive_s": self.config.keep_alive_s,
            "cold_starts": self.pool.cold_starts,
            "warm_reuses": self.pool.warm_reuses,
            "containers_expired": self.pool.expired,
            "throttle_events": self.throttle.throttle_events,
            "peak_concurrency": self.throttle.peak_concurrency,
        }
        out.update(self.meter.snapshot())
        if self.caches is not None:
            # Account-wide locality counters (per-tier hits/misses/
            # evictions + residency), fresh dict per the contract above.
            out["cache"] = self.caches.snapshot()
        if self._fn_memory:
            # Multi-tenant deployments: the account bill broken down by
            # tenant function (fresh nested dicts, same aliasing contract).
            out["billing_by_function"] = self.meter.per_key_snapshot()
        return out
