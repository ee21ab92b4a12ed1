"""Lambda invocation machinery: parallel invoker pool + large-fan-out proxy.

Invoking an AWS Lambda costs ~50 ms through boto3 (paper §III-C), so
invocation throughput is governed by how many invoker processes issue
calls concurrently:

- The scheduler's *Initial Task Executor Invokers* launch one executor per
  static schedule, in parallel (paper §IV-C).
- A Task Executor performing a *small* fan-out makes its own invocations.
- A fan-out wider than ``proxy_threshold`` publishes one message to the
  KV Store Proxy, whose Fan-out Invokers make the invocations in parallel
  (paper §IV-D "Large Fan-out Task Invocations").

Each invoker lane charges the invocation latency serially per call; P
lanes give P× invocation throughput — the (near-)linear speedup of
§III-C.

Two provider models decide cold starts:

- *legacy* (``platform is None``): latency per call is drawn from
  ``CostModel.invoke_draw`` — seeded lognormal jitter on ``invoke_ms``
  plus a cold start with probability ``1 - warm_fraction``. Memoryless,
  kept for cross-checks.
- *stateful* (``platform`` set): the lane first reserves an account
  concurrency slot — invocations beyond the (burst-ramped) limit are
  throttled 429-style and retried with charged exponential backoff —
  then asks the warm-container pool for a container: a warm hit skips
  the cold start entirely, a miss provisions cold and pays
  ``cold_start_ms``. The executor body is wrapped so its simulated
  execution time is billed (per-request + GB-seconds) and the container
  returns to the pool, warm, when the body finishes.

All blocking (work queues, lane threads) goes through the engine clock's
effect protocol (``simclock``): lanes and the proxy server are generator
actors, so on the event substrate an idle invoker lane is a parked
continuation — no OS thread — and on the thread substrates it degrades
to the familiar blocking loop via ``run_effects``.
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any, Callable

from repro_torch.core.kvstore import CostModel
from repro_torch.core.simclock import BaseClock, run_effects

if TYPE_CHECKING:  # import cycle: repro_torch.platform imports repro_torch.core
    from repro_torch.platform import FaaSPlatform


class InvokerPool:
    """N invoker lanes; each lane issues invocations serially.

    ``submit`` enqueues an invocation request; a free lane picks it up,
    charges the invocation API latency (jitter + cold start, decided by
    the legacy seeded draw or by the stateful platform), then hands the
    executor body to the runtime pool.
    """

    def __init__(
        self,
        n_invokers: int,
        cost: CostModel,
        clock: BaseClock,
        runtime_pool: Any,
        name: str = "invoker",
        platform: "FaaSPlatform | None" = None,
        function: str = "executor",
        job: "str | None" = None,
    ):
        self.cost = cost
        self.clock = clock
        self.runtime_pool = runtime_pool
        self.platform = platform
        self.function = function
        # Billing attribution: invocations issued by this pool are billed
        # against this job label (the orchestrator passes the job's
        # namespace name; None for self-contained single-job runs).
        self.job = job
        self._q = clock.queue()
        self.invocations = 0
        self.cold_starts = 0
        self.throttle_retries = 0
        self._lock = threading.Lock()
        self._closed = False
        self._n_lanes = max(1, n_invokers)
        for i in range(self._n_lanes):
            clock.spawn(self._lane, name=f"{name}-{i}")

    def _invoke_legacy_g(self, body: Callable[[], Any],
                         extra_ms: float, index: int):
        invoke_ms, cold = self.cost.invoke_draw(index)
        if cold:
            with self._lock:
                self.cold_starts += 1
        # Invocation API latency is paid serially per lane.
        yield ("charge", invoke_ms + extra_ms)
        try:
            self.runtime_pool.submit(body)
        except RuntimeError:
            # Runtime already shut down: the job has resolved; late
            # (retry/speculative) invocations are safe to drop.
            return False
        return True

    def _invoke_platform_g(self, body: Callable[[], Any],
                           extra_ms: float, index: int):
        platform = self.platform
        assert platform is not None
        # Account concurrency: beyond the (burst-ramped) cap the invoke
        # API answers 429; the lane retries with charged exponential
        # backoff, which delays every invocation queued behind it —
        # exactly how SDK-side throttling backs pressure up the client.
        attempt = 0
        while not platform.try_reserve():
            if self._closed:
                # Job torn down while this lane was stuck in 429 retry:
                # nothing is reserved yet, so just drop the invocation
                # instead of fighting live tenants for the account cap.
                return False
            yield ("charge", platform.backoff_ms(attempt))
            attempt += 1
            with self._lock:
                self.throttle_retries += 1
        # The invoke API round trip precedes container assignment (as on
        # the real platform), so a container released while this call is
        # in flight is warm for it; the cold-start provisioning delay is
        # then paid only when the pool misses.
        yield ("charge", self.cost.invoke_jitter_ms(index) + extra_ms)
        # Locality-aware placement: executor bodies carry the
        # store-qualified keys they will read (hint_keys); the platform
        # biases container choice toward a warm container already
        # holding those bytes in its cache. Host-side knowledge only —
        # no charge, and a miss just falls back to LIFO reuse.
        cid, cold = platform.acquire(
            self.function, prefer_keys=getattr(body, "hint_keys", ()))
        if cold:
            with self._lock:
                self.cold_starts += 1
            yield ("charge", self.cost.cold_start_ms)
        try:
            self.runtime_pool.submit(
                platform.wrap_g(self.function, cid, body, job=self.job)
            )
        except RuntimeError:
            # Job resolved while this lane was mid-invoke: the body will
            # never run, so hand the slot and container straight back.
            platform.cancel(self.function, cid)
            return False
        return True

    def _lane(self):
        while True:
            item = yield ("get", self._q, None)
            if item is None:
                return
            if self._closed:
                # The job resolved/failed with this invocation still
                # queued: drop it WITHOUT charging invoke latency or
                # touching the platform — a dead job must not consume
                # shared warm-pool or concurrency-cap capacity.
                continue
            body, extra_ms = item
            with self._lock:
                self.invocations += 1
                index = self.invocations
            if self.platform is None:
                ok = yield from self._invoke_legacy_g(body, extra_ms, index)
            else:
                ok = yield from self._invoke_platform_g(body, extra_ms, index)
            if not ok:
                return

    def submit(self, body: Callable[[], Any], extra_ms: float = 0.0) -> None:
        if self._closed:
            return  # job resolved; drop late invocations (idempotent)
        self._q.put((body, extra_ms))

    def close(self) -> None:
        self._closed = True
        for _ in range(self._n_lanes):
            self._q.put(None)


class FanoutProxy:
    """KV Store Proxy: parallelizes large fan-outs (paper §IV-D).

    The executor publishes a fan-out message (fan-out id + payload keys)
    on the proxy channel; the proxy resolves the out-edges from the DAG it
    received at workflow start and issues the invocations through its own
    Fan-out Invoker pool.
    """

    CHANNEL = "__proxy__/fanout"

    def __init__(self, kv, invokers: InvokerPool):
        self.kv = kv
        self.invokers = invokers
        self._sub = kv.subscribe(self.CHANNEL)
        self._stop = threading.Event()
        self.handled_fanouts = 0
        kv.clock.spawn(self._serve, name="kv-proxy")

    def _serve(self):
        # Event-driven: the proxy parks on its subscription (costing
        # zero wall time — and, on the event substrate, zero threads)
        # until a fan-out message or the ``None`` shutdown sentinel
        # published by ``close``.
        while not self._stop.is_set():
            msg = yield ("get", self._sub, None)
            if msg is None:
                return
            spawn_fns = msg["spawns"]  # list of zero-arg callables
            self.handled_fanouts += 1
            for fn in spawn_fns:
                self.invokers.submit(fn)

    def close_g(self):
        self._stop.set()
        # The shutdown sentinel is already queued on our subscription, so
        # releasing it immediately after is safe — and mandatory on a
        # substrate that outlives this job: an abandoned proxy
        # subscription would receive (and leak) every later job's
        # fan-out messages on this channel name.
        yield from self.kv.publish_g(self.CHANNEL, None)
        self.kv.unsubscribe(self.CHANNEL, self._sub)

    def close(self) -> None:
        run_effects(self.kv.clock, self.close_g())
