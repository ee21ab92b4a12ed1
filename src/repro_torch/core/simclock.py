"""Virtual-time simulation core: deterministic discrete-event substrates.

Every engine layer (KV store, executors, invoker pools, schedulers, the
fault monitor) charges FaaS latency on a *clock* instead of calling
``time.sleep``/``time.monotonic`` directly. Three implementations share
one interface:

- ``EventClock`` (the default, ``substrate="event"``) is a
  continuation/event-driven scheduler: actors are *frames* — generators
  yielding effect tuples — driven from a single ready queue by one
  driver thread. No OS thread per actor, so a million-task DAG
  simulates without exhausting threads, and a 4096-leaf tree reduction
  runs an order of magnitude faster than the thread substrate.

- ``VirtualClock`` (``substrate="thread"``) is the PR-3 cooperative
  discrete-event scheduler over real threads, kept as a cross-check
  mode: threads register as *actors*; exactly one actor runs at a time
  (a run token), and every blocking operation yields the token through
  the clock. Both virtual substrates replay the same event sequence —
  FIFO ready queues, timers in (deadline, spawn-seq) order, FIFO
  waiters — so they produce bit-identical ``charged_ms`` / kv_stats /
  billing for the same job.

- ``RealtimeClock`` (``time_scale > 0``) is the seed behavior kept for
  sanity cross-checks: charges really sleep ``ms * time_scale / 1e3``
  seconds, and the primitives are the plain ``threading``/``queue``
  ones. ``REPRO_SIM_SCALE`` is only needed for this mode.

All clocks expose the *same* primitive factories (``queue()``,
``lock()``, ``event()``, ``pool()``, ``spawn()``), so the engines
contain no mode branches: they are written once against the clock and
the mode is picked by the cost model.

Effect protocol
---------------

Actor logic is written once as generator functions yielding effect
tuples; the substrate decides how each effect blocks:

- ``("charge", ms)``    — bill ``ms`` simulated ms and advance time.
- ``("get", q, t)``     — blocking ``q.get(timeout=t)`` (seconds;
  ``None`` = forever). ``queue.Empty`` is raised at the yield site.
- ``("acquire", lock)`` — blocking lock acquire (release is a direct
  ``lock.release()`` call).
- ``("wait", ev, t)``   — blocking ``ev.wait(timeout=t)`` (seconds);
  the yield evaluates to the flag.
- ``("flush",)``        — advance time past charges deferred by
  non-yielding code (``simulated_compute`` inside a task function);
  no-op on the thread substrates where charges advance immediately.
- ``("sleep", ms)``     — advance simulated time without billing.

Non-suspending operations (``q.put``, ``ev.set``, ``lock.release``,
``pool.submit``, ``clock.spawn``) remain direct calls on every
substrate. On the thread substrates the shared interpreter
``run_effects`` maps each effect onto the blocking primitive; on the
``EventClock`` the generator IS the continuation and effects park the
frame in the scheduler.

Determinism contract (virtual substrates): actors are scheduled FIFO in
the order they became ready; timers fire in (deadline, registration-seq)
order; queue/lock waiters are served FIFO. Any randomness (invoke-latency
jitter, cold starts, fault injection) is drawn from counters/keys hashed
with seeds — never from wall time — so two runs of the same job produce
identical traces.

Threads that never registered as actors (unit tests driving the KV store
directly, external callers) degrade gracefully: their charges accumulate
``charged_ms`` without advancing virtual time, and their blocking waits
use real condition variables with real timeouts.
"""
from __future__ import annotations

import heapq
import itertools
import queue as _queue
import sys
import threading
import time
import traceback
from collections import deque
from types import GeneratorType
from typing import Any, Callable

__all__ = [
    "BaseClock",
    "EventClock",
    "RealtimeClock",
    "VirtualClock",
    "charge_meter",
    "clock_for_scale",
    "drain_worker_cache",
    "run_effects",
    "simulated_compute",
    "task_clock",
    "worker_cache_size",
]


# ---------------------------------------------------------------------------
# Frame-local context.
#
# On the EventClock many logical actors share ONE driver thread, so
# anything formerly thread-local (the task clock, the billing tap, the
# kv stats sink) must follow the *frame* instead: when frame A suspends
# mid-scope and frame B runs, B must not observe A's context. The
# driver publishes the currently-stepping frame here; thread-locals
# remain the fallback for the thread substrates and external callers.
# ---------------------------------------------------------------------------

_frame_ctx = threading.local()


def _current_frame() -> "_Frame | None":
    return getattr(_frame_ctx, "frame", None)


# ---------------------------------------------------------------------------
# Task-payload compute charging.
#
# Workload DAGs (tree reduction, GEMM, SVD, SVC) declare per-task compute
# duration in *simulated* ms. The executor installs the engine's clock
# around each task-function call; `simulated_compute` charges the
# duration on whatever clock is installed. Outside an engine (sequential
# reference evaluation in tests) it is free: reference results never
# depend on timing.
# ---------------------------------------------------------------------------

_task_clock = threading.local()


class task_clock:
    """Context manager installing ``clock`` as the current task clock."""

    def __init__(self, clock: "BaseClock | None"):
        self.clock = clock

    def __enter__(self) -> None:
        frame = _current_frame()
        self._frame = frame
        if frame is not None:
            self._prev = frame.task_clock
            frame.task_clock = self.clock
        else:
            self._prev = getattr(_task_clock, "clock", None)
            _task_clock.clock = self.clock

    def __exit__(self, *exc: Any) -> None:
        if self._frame is not None:
            self._frame.task_clock = self._prev
        else:
            _task_clock.clock = self._prev


def simulated_compute(ms: float) -> None:
    """Charge ``ms`` simulated milliseconds of task compute on the
    engine clock running this task (no-op outside an engine)."""
    frame = _current_frame()
    if frame is not None:
        clock = frame.task_clock
    else:
        clock = getattr(_task_clock, "clock", None)
    if clock is not None and ms > 0:
        clock.charge(ms)


# ---------------------------------------------------------------------------
# Per-thread charge metering (billing).
#
# The platform model bills an invocation the simulated time its body
# *charges* while running — not a wall-clock delta — because charge
# amounts are identical across clock modes, which makes billed cost
# bit-identical. The tap lives here so the platform layer never has to
# patch clock internals. On the EventClock the accumulator rides on the
# frame (the body suspends and resumes inside the metered scope).
# ---------------------------------------------------------------------------

_charge_tap = threading.local()


class charge_meter:
    """Context manager accumulating this actor's clock charges into
    ``acc[0]`` (a single-element list). Nesting restores the previous
    accumulator on exit; charges while nested land in the innermost."""

    def __init__(self, acc: "list[float]"):
        self.acc = acc

    def __enter__(self) -> "list[float]":
        frame = _current_frame()
        self._frame = frame
        if frame is not None:
            self._prev = frame.charge_acc
            frame.charge_acc = self.acc
        else:
            self._prev = getattr(_charge_tap, "acc", None)
            _charge_tap.acc = self.acc
        return self.acc

    def __exit__(self, *exc: Any) -> None:
        if self._frame is not None:
            self._frame.charge_acc = self._prev
        else:
            _charge_tap.acc = self._prev


# ---------------------------------------------------------------------------
# Worker-thread cache.
#
# The thread substrates spawn hundreds of short-lived actor threads per
# job (invoker lanes, runtime-pool workers, monitors). OS thread
# creation is ~100s of microseconds — a large fraction of a virtual
# run's wall time — so finished workers park here and get re-dispatched
# instead of dying. Recycling is invisible to the simulation: the
# *actor slot* is created deterministically by ``spawn``; which OS
# thread services it is not an event the scheduler can observe.
# ---------------------------------------------------------------------------

_WORKER_CACHE_MAX = 2048
_worker_cache: "list[_CachedWorker]" = []
_worker_cache_lock = threading.Lock()


class _CachedWorker(threading.Thread):
    def __init__(self) -> None:
        super().__init__(daemon=True, name="simclock-worker")
        self._sem = threading.Semaphore(0)
        self._job: Callable[[], None] | None = None
        self.start()

    def run(self) -> None:
        while True:
            self._sem.acquire()
            job, self._job = self._job, None
            if job is None:
                return
            job()  # an escaping exception retires this thread (no recycle)
            with _worker_cache_lock:
                if len(_worker_cache) >= _WORKER_CACHE_MAX:
                    return
                _worker_cache.append(self)

    def dispatch(self, job: "Callable[[], None] | None") -> None:
        self._job = job
        self._sem.release()


def _dispatch_to_worker(job: Callable[[], None]) -> None:
    with _worker_cache_lock:
        worker = _worker_cache.pop() if _worker_cache else None
    (worker or _CachedWorker()).dispatch(job)


def drain_worker_cache() -> int:
    """Retire every cached worker thread and return how many were
    drained. Call between benchmark iterations (or test runs) so idle
    threads from a thread-substrate run don't linger into — and skew
    the wall-time of — event-substrate runs."""
    with _worker_cache_lock:
        workers = _worker_cache[:]
        _worker_cache.clear()
    for worker in workers:
        worker.dispatch(None)  # `run` exits on a None job
    return len(workers)


def worker_cache_size() -> int:
    """Number of idle cached worker threads (observability for tests)."""
    with _worker_cache_lock:
        return len(_worker_cache)


# ---------------------------------------------------------------------------
# Shared interface
# ---------------------------------------------------------------------------


class BaseClock:
    """Accounting shared by all clock implementations."""

    virtual: bool = False

    def __init__(self) -> None:
        self._charge_lock = threading.Lock()
        self.charged_ms = 0.0
        # Opt-in determinism sanitizer (repro_torch.analysis.divergence.Tracer,
        # duck-typed so the substrate never imports the analysis
        # package): when set, every freshly generated effect is
        # journaled via tracer.record(actor, effect, gen). None is free.
        self.tracer: Any = None

    def _account(self, ms: float) -> None:
        with self._charge_lock:
            self.charged_ms += ms
        frame = _current_frame()
        if frame is not None:
            acc = frame.charge_acc
        else:
            acc = getattr(_charge_tap, "acc", None)
        if acc is not None:
            acc[0] += ms

    # subclass API ----------------------------------------------------------
    def charge(self, ms: float) -> None:  # bill + advance simulated time
        raise NotImplementedError

    def now_ms(self) -> float:  # simulated (virtual) / real elapsed ms
        raise NotImplementedError

    def queue(self) -> Any:  # queue.Queue-compatible
        raise NotImplementedError

    def lock(self) -> Any:  # context-manager lock (transfer lanes)
        raise NotImplementedError

    def event(self) -> Any:  # threading.Event-compatible
        raise NotImplementedError

    def pool(self, max_workers: int) -> Any:  # .submit(fn) / .shutdown()
        raise NotImplementedError

    def spawn(self, fn: Callable[[], Any], name: str = "") -> None:
        raise NotImplementedError

    def actor(self) -> Any:  # context manager registering current thread
        raise NotImplementedError

    def run(self, gen: Any) -> Any:
        """Drive an effect generator to completion on this substrate
        and return its value. Non-generators pass through unchanged."""
        return run_effects(self, gen)


def _blocking_actor_label(clock: BaseClock) -> str:
    """Trace label for the thread substrates: ``actor#<seq>`` when the
    clock tracks the current thread as a registered actor (VirtualClock),
    else the thread name. Deterministic on the virtual substrate —
    actors are numbered in registration order."""
    current = getattr(clock, "_current", None)
    if current is not None:
        actor = current()
        if actor is not None and hasattr(actor, "seq"):
            return f"actor#{actor.seq}"
    return threading.current_thread().name


def run_effects(clock: BaseClock, gen: Any) -> Any:
    """Interpret an effect generator on the blocking (thread-based)
    primitives: the shared cross-check path for ``VirtualClock`` and
    ``RealtimeClock``, and for external threads driving one-off
    operations against any clock. Returns the generator's value."""
    if not isinstance(gen, GeneratorType):
        return gen
    if _current_frame() is not None:
        raise RuntimeError(
            "run_effects() called inside an event-driven frame; compose "
            "generators with 'yield from' instead")
    value: Any = None
    exc: BaseException | None = None
    while True:
        try:
            if exc is not None:
                pending, exc = exc, None
                eff = gen.throw(pending)
            else:
                eff = gen.send(value)
            value = None
        except StopIteration as stop:
            return stop.value
        tracer = getattr(clock, "tracer", None)
        if tracer is not None:
            tracer.record(_blocking_actor_label(clock), eff, gen)
        kind = eff[0]
        if kind == "charge":
            clock.charge(eff[1])
        elif kind == "get":
            try:
                value = eff[1].get(timeout=eff[2])
            except _queue.Empty as empty:
                exc = empty
        elif kind == "acquire":
            eff[1].acquire()
        elif kind == "wait":
            value = eff[1].wait(eff[2])
        elif kind == "flush":
            pass  # thread substrates advance time at charge time
        elif kind == "sleep":
            sleep = getattr(clock, "sleep_ms", None)
            if sleep is not None:
                sleep(eff[1])
        else:
            raise RuntimeError(f"unknown clock effect {eff!r}")


# ---------------------------------------------------------------------------
# Real-time clock (the seed behavior, kept for cross-checks)
# ---------------------------------------------------------------------------


class _RealtimePool:
    """Thin ThreadPoolExecutor wrapper pinning the two methods engines
    use, interpreting effect-generator bodies on the worker thread."""

    def __init__(self, clock: BaseClock, max_workers: int):
        from concurrent.futures import ThreadPoolExecutor

        self._clock = clock
        self._tpe = ThreadPoolExecutor(max_workers=max_workers)

    def _run(self, fn: Callable[[], Any]) -> None:
        run_effects(self._clock, fn())

    def submit(self, fn: Callable[[], Any]) -> None:
        self._tpe.submit(self._run, fn)

    def shutdown(self, wait: bool = False,
                 cancel_futures: bool = True) -> None:
        self._tpe.shutdown(wait=wait, cancel_futures=cancel_futures)


class _NullActor:
    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> None:
        return None


class RealtimeClock(BaseClock):
    """Charges simulated latency by really sleeping ``ms * time_scale``."""

    virtual = False

    def __init__(self, time_scale: float):
        super().__init__()
        self.time_scale = time_scale
        self._t0 = time.perf_counter()

    def charge(self, ms: float) -> None:
        if ms <= 0:
            return
        self._account(ms)
        if self.time_scale > 0:
            time.sleep(ms * self.time_scale / 1e3)

    def sleep_ms(self, ms: float) -> None:
        if self.time_scale > 0 and ms > 0:
            time.sleep(ms * self.time_scale / 1e3)

    def now_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def queue(self) -> "_queue.Queue[Any]":
        return _queue.Queue()

    def lock(self) -> threading.Lock:
        return threading.Lock()

    def event(self) -> threading.Event:
        return threading.Event()

    def pool(self, max_workers: int) -> _RealtimePool:
        return _RealtimePool(self, max_workers)

    def spawn(self, fn: Callable[[], Any], name: str = "") -> None:
        def body() -> None:
            run_effects(self, fn())

        _dispatch_to_worker(body)

    def actor(self) -> _NullActor:
        return _NullActor()


# ---------------------------------------------------------------------------
# Thread substrate: cooperative discrete-event scheduling over threads
# ---------------------------------------------------------------------------

_RUNNING = "running"
_READY = "ready"
_BLOCKED = "blocked"

_WAKE_SIGNAL = "signal"
_WAKE_TIMEOUT = "timeout"


class _Actor:
    __slots__ = ("seq", "cond", "state", "wake_reason", "timer")

    def __init__(self, seq: int, mutex: threading.Lock):
        self.seq = seq
        self.cond = threading.Condition(mutex)
        self.state = _READY
        self.wake_reason: str | None = None
        self.timer: "_Timer | None" = None  # pending virtual timeout


class _Timer:
    """Heap entry waking ``owner`` (a thread actor or an event frame —
    both carry ``seq``) at a virtual deadline."""

    __slots__ = ("deadline", "owner", "cancelled")

    def __init__(self, deadline: float, owner: Any):
        self.deadline = deadline
        self.owner = owner
        self.cancelled = False

    def __lt__(self, other: "_Timer") -> bool:  # heap tiebreak
        return (self.deadline, self.owner.seq) < (
            other.deadline, other.owner.seq)


class _ExternalWaiter:
    """A non-actor thread blocked on a clock primitive (tests, legacy
    callers). It waits on a real condition with a real timeout and does
    not hold back virtual-time advancement."""

    __slots__ = ("cond", "signalled")

    def __init__(self, mutex: "threading.Lock | threading.RLock"):
        self.cond = threading.Condition(mutex)
        self.signalled = False


class VirtualClock(BaseClock):
    """Deterministic discrete-event clock over cooperative actor threads.

    Exactly one registered actor holds the run token at any moment; all
    others are parked on per-actor condition variables sharing one mutex.
    Blocking operations release the token; wake-ups re-enter a FIFO ready
    queue. Virtual time jumps to the earliest pending timer only when no
    actor is ready — i.e. when every actor is provably waiting on
    simulated time or on an event another actor will produce.
    """

    virtual = True

    def __init__(self) -> None:
        super().__init__()
        self._mutex = threading.Lock()
        self._now = 0.0
        self._seq = itertools.count()
        self._actors: dict[int, _Actor] = {}  # thread ident -> actor
        self._ready: list[_Actor] = []
        self._running: _Actor | None = None
        self._timers: list[_Timer] = []
        self.switches = 0        # token handoffs (scheduler cost metric)
        self.actors_spawned = 0  # total actor registrations

    # -- introspection ------------------------------------------------------
    def now_ms(self) -> float:
        return self._now

    def _current(self) -> _Actor | None:
        return self._actors.get(threading.get_ident())

    # -- scheduling core (all called with self._mutex held) -----------------
    def _schedule_next(self) -> None:
        """Hand the run token to the next ready actor, advancing virtual
        time to the earliest timer when nobody is ready."""
        while True:
            if self._ready:
                nxt = self._ready.pop(0)
                nxt.state = _RUNNING
                self._running = nxt
                self.switches += 1
                nxt.cond.notify()
                return
            while self._timers and self._timers[0].cancelled:
                heapq.heappop(self._timers)
            if not self._timers:
                # Fully event-blocked (or no actors at all): idle until an
                # external stimulus re-kicks the scheduler.
                self._running = None
                return
            timer = heapq.heappop(self._timers)
            self._now = max(self._now, timer.deadline)
            actor = timer.owner
            actor.timer = None
            actor.wake_reason = _WAKE_TIMEOUT
            actor.state = _READY
            self._ready.append(actor)

    def _kick(self) -> None:
        """Start the scheduler if the simulation is idle (called after an
        external thread made an actor ready or added a timer)."""
        if self._running is None:
            self._schedule_next()

    def _make_ready(self, actor: _Actor) -> None:
        """Move a blocked actor to the ready queue (waker side)."""
        if actor.timer is not None:
            actor.timer.cancelled = True
            actor.timer = None
        actor.wake_reason = _WAKE_SIGNAL
        actor.state = _READY
        self._ready.append(actor)

    def _block(self, actor: _Actor, timeout_ms: float | None) -> str:
        """Release the run token and wait to be woken. Returns the wake
        reason (``signal`` or ``timeout``)."""
        actor.state = _BLOCKED
        actor.wake_reason = None
        if timeout_ms is not None:
            actor.timer = _Timer(self._now + max(0.0, timeout_ms), actor)
            heapq.heappush(self._timers, actor.timer)
        self._schedule_next()
        while actor.state is not _RUNNING:
            actor.cond.wait()
        return actor.wake_reason or _WAKE_SIGNAL

    def _wait_for_token(self, actor: _Actor) -> None:
        while actor.state is not _RUNNING:
            actor.cond.wait()

    # -- actor lifecycle ----------------------------------------------------
    def _register_current(self) -> _Actor:
        with self._mutex:
            actor = _Actor(next(self._seq), self._mutex)
            actor.state = _READY
            self._actors[threading.get_ident()] = actor
            self._ready.append(actor)
            self._kick()
            self._wait_for_token(actor)
            return actor

    def _deregister_current(self) -> None:
        with self._mutex:
            actor = self._actors.pop(threading.get_ident(), None)
            if actor is None:
                return
            if self._running is actor:
                self._schedule_next()

    class _ActorContext:
        def __init__(self, clock: "VirtualClock"):
            self.clock = clock

        def __enter__(self) -> None:
            self.clock._register_current()

        def __exit__(self, *exc: Any) -> None:
            self.clock._deregister_current()

    def actor(self) -> "_ActorContext":
        return VirtualClock._ActorContext(self)

    def run(self, gen: Any) -> Any:
        """Drive an effect generator as a registered actor (registering
        the calling thread for the duration if it isn't one already)."""
        if not isinstance(gen, GeneratorType):
            return gen
        if self._current() is not None:
            return run_effects(self, gen)
        with self.actor():
            return run_effects(self, gen)

    def spawn(self, fn: Callable[[], Any], name: str = "") -> None:
        # The actor slot enters the ready queue HERE, on the spawning
        # thread, so scheduling order is a pure function of the event
        # sequence — not of how quickly the OS starts (or recycles) the
        # worker thread that will service it.
        with self._mutex:
            actor = _Actor(next(self._seq), self._mutex)
            actor.state = _READY
            self._ready.append(actor)
            self.actors_spawned += 1
            self._kick()

        def body() -> None:
            with self._mutex:
                self._actors[threading.get_ident()] = actor
                self._wait_for_token(actor)
            try:
                r = fn()
                if isinstance(r, GeneratorType):
                    run_effects(self, r)
            finally:
                self._deregister_current()

        _dispatch_to_worker(body)

    # -- time ---------------------------------------------------------------
    def sleep_ms(self, ms: float) -> None:
        with self._mutex:
            actor = self._current()
            if actor is None or self._running is not actor:
                return  # non-actor thread: virtual time is not its to spend
            self._block(actor, ms)

    def charge(self, ms: float) -> None:
        if ms <= 0:
            return
        self._account(ms)
        self.sleep_ms(ms)

    # -- primitives ---------------------------------------------------------
    def queue(self) -> "VirtualQueue":
        return VirtualQueue(self)

    def lock(self) -> "VirtualLock":
        return VirtualLock(self)

    def event(self) -> "VirtualEvent":
        return VirtualEvent(self)

    def pool(self, max_workers: int) -> "VirtualPool":
        return VirtualPool(self, max_workers)


class VirtualQueue:
    """``queue.Queue``-compatible FIFO whose blocking ``get`` cooperates
    with the virtual clock. ``timeout`` is *simulated seconds* for actor
    threads and real seconds for non-actor threads."""

    def __init__(self, clock: VirtualClock):
        self._clock = clock
        self._items: list[Any] = []
        self._waiters: list[_Actor | _ExternalWaiter] = []

    def put(self, item: Any) -> None:
        clock = self._clock
        with clock._mutex:
            self._items.append(item)
            if self._waiters:
                waiter = self._waiters.pop(0)
                if isinstance(waiter, _ExternalWaiter):
                    waiter.signalled = True
                    waiter.cond.notify()
                else:
                    clock._make_ready(waiter)
                    clock._kick()

    def get(self, timeout: float | None = None) -> Any:
        clock = self._clock
        with clock._mutex:
            actor = clock._current()
            if actor is not None and clock._running is actor:
                deadline = (None if timeout is None
                            else clock._now + timeout * 1e3)
                while not self._items:
                    remaining = (None if deadline is None
                                 else deadline - clock._now)
                    if remaining is not None and remaining <= 0:
                        raise _queue.Empty
                    self._waiters.append(actor)
                    reason = clock._block(actor, remaining)
                    if reason == _WAKE_TIMEOUT:
                        if actor in self._waiters:
                            self._waiters.remove(actor)
                        raise _queue.Empty
                return self._items.pop(0)
            # Non-actor thread: real wait, real timeout.
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while not self._items:
                waiter = _ExternalWaiter(clock._mutex)
                self._waiters.append(waiter)
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self._waiters.remove(waiter)
                    raise _queue.Empty
                if not waiter.cond.wait(remaining):
                    if waiter in self._waiters:
                        self._waiters.remove(waiter)
                    if not waiter.signalled:
                        raise _queue.Empty
            return self._items.pop(0)

    def empty(self) -> bool:
        with self._clock._mutex:
            return not self._items

    def drain(self) -> "list[Any]":
        """Atomically remove and return every queued item (pool shutdown
        with ``cancel_futures``: queued-but-unstarted work is dropped)."""
        with self._clock._mutex:
            items, self._items = self._items, []
            return items


class VirtualLock:
    """Transfer-lane lock held across simulated transfers. FIFO handoff:
    ``release`` passes ownership directly to the longest-waiting thread,
    which keeps lane-contention outcomes deterministic."""

    def __init__(self, clock: VirtualClock):
        self._clock = clock
        self._owner: Any = None  # _Actor, _ExternalWaiter, or thread ident
        self._waiters: list[_Actor | _ExternalWaiter] = []

    def acquire(self) -> None:
        clock = self._clock
        with clock._mutex:
            actor = clock._current()
            if actor is not None and clock._running is actor:
                if self._owner is None:
                    self._owner = actor
                    return
                self._waiters.append(actor)
                clock._block(actor, None)  # woken owning the lock
                return
            ident = threading.get_ident()
            if self._owner is None:
                self._owner = ident
                return
            waiter = _ExternalWaiter(clock._mutex)
            self._waiters.append(waiter)
            while not waiter.signalled:
                waiter.cond.wait()
            self._owner = ident

    def release(self) -> None:
        clock = self._clock
        with clock._mutex:
            if not self._waiters:
                self._owner = None
                return
            waiter = self._waiters.pop(0)
            if isinstance(waiter, _ExternalWaiter):
                self._owner = waiter  # placeholder until the thread wakes
                waiter.signalled = True
                waiter.cond.notify()
            else:
                self._owner = waiter
                clock._make_ready(waiter)
                clock._kick()

    def __enter__(self) -> "VirtualLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class VirtualEvent:
    """``threading.Event``-compatible; ``wait`` timeout is simulated
    seconds for actors, real seconds for non-actor threads."""

    def __init__(self, clock: VirtualClock):
        self._clock = clock
        self._flag = False
        self._waiters: list[_Actor | _ExternalWaiter] = []

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        clock = self._clock
        with clock._mutex:
            self._flag = True
            waiters, self._waiters = self._waiters, []
            kicked = False
            for waiter in waiters:
                if isinstance(waiter, _ExternalWaiter):
                    waiter.signalled = True
                    waiter.cond.notify()
                else:
                    clock._make_ready(waiter)
                    kicked = True
            if kicked:
                clock._kick()

    def wait(self, timeout: float | None = None) -> bool:
        clock = self._clock
        with clock._mutex:
            if self._flag:
                return True
            actor = clock._current()
            if actor is not None and clock._running is actor:
                self._waiters.append(actor)
                reason = clock._block(
                    actor, None if timeout is None else timeout * 1e3)
                if reason == _WAKE_TIMEOUT and actor in self._waiters:
                    self._waiters.remove(actor)
                return self._flag
            waiter = _ExternalWaiter(clock._mutex)
            self._waiters.append(waiter)
            waiter.cond.wait(timeout)
            if waiter in self._waiters:
                self._waiters.remove(waiter)
            return self._flag


class VirtualPool:
    """Executor-runtime stand-in for ``ThreadPoolExecutor``: worker
    actors are created lazily up to ``max_workers``, so an 8k-task sweep
    only materializes as many workers as are ever simultaneously busy.
    Queued bodies do NOT hold back virtual time — a full pool models the
    provider's concurrency limit. Shared by both virtual substrates:
    the worker is an effect generator, so on the thread substrate it
    runs as a cooperative actor and on the event substrate as a frame."""

    def __init__(self, clock: BaseClock, max_workers: int):
        self._clock = clock
        self._max_workers = max(1, max_workers)
        self._q = clock.queue()
        self._state_lock = threading.Lock()
        self._workers = 0
        self._idle = 0
        self._closed = False

    def submit(self, fn: Callable[[], Any]) -> None:
        with self._state_lock:
            if self._closed:
                raise RuntimeError("cannot schedule new futures after "
                                   "shutdown")
            spawn = self._idle == 0 and self._workers < self._max_workers
            if spawn:
                self._workers += 1
                n = self._workers
        self._q.put(fn)
        if spawn:
            self._clock.spawn(self._worker, name=f"vpool-{n}")

    def _worker(self) -> Any:
        while True:
            with self._state_lock:
                self._idle += 1
            item = yield ("get", self._q, None)
            with self._state_lock:
                self._idle -= 1
            if item is None:
                return
            r = item()
            if isinstance(r, GeneratorType):
                yield from r

    def shutdown(self, wait: bool = False,
                 cancel_futures: bool = True) -> None:
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            n = self._workers
        if cancel_futures:
            # Drop queued-but-unstarted bodies (matching the
            # ThreadPoolExecutor contract the realtime pool inherits).
            # Before this, a torn-down job's queued executors still ran
            # to completion behind the shutdown sentinels — harmless when
            # the substrate died with the job, a capacity leak once
            # platform and store outlive it.
            self._q.drain()
        for _ in range(n):
            self._q.put(None)


# ---------------------------------------------------------------------------
# Event substrate: continuation frames on one driver thread
# ---------------------------------------------------------------------------


class _Frame:
    """One logical actor on the EventClock: a (not-yet-started) body or
    its live generator, plus the park/wake state the driver needs."""

    __slots__ = ("seq", "fn", "gen", "name", "wait", "wake_reason", "timer",
                 "deferred_ms", "charge_acc", "task_clock", "sink",
                 "done", "root", "result", "exc")

    def __init__(self, seq: int, fn: "Callable[[], Any] | None",
                 name: str, root: bool = False):
        self.seq = seq
        self.fn = fn
        self.gen: Any = None
        self.name = name
        self.wait: "tuple[Any, ...] | None" = None
        self.wake_reason: str | None = None
        self.timer: _Timer | None = None
        self.deferred_ms = 0.0   # charges awaiting a ("flush",)
        self.charge_acc: "list[float] | None" = None
        self.task_clock: Any = None
        self.sink: Any = None    # kv-stats sink (namespace mirroring)
        self.done = False
        self.root = root
        self.result: Any = None
        self.exc: BaseException | None = None


class EventClock(BaseClock):
    """Continuation/event-driven discrete-event clock: the default
    substrate. Actors are *frames* — effect generators — dispatched
    FIFO from one ready deque by whichever thread called ``run()``; no
    OS thread per actor. Scheduling replays the VirtualClock event
    order exactly (FIFO ready, timers in (deadline, seq) order, FIFO
    waiters, one waiter woken per ``put``), so both virtual substrates
    produce bit-identical charges for the same job.

    Charges issued by non-yielding code inside a frame (a task function
    calling ``simulated_compute``) are *deferred*: billed immediately,
    applied to virtual time at the next suspension or explicit
    ``("flush",)`` effect.

    External (non-frame) threads interoperate the same way they do with
    the VirtualClock: registered via ``actor()``, their charges drive
    the frame scheduler forward; unregistered, they bill without
    advancing time and block on real condition variables."""

    virtual = True

    def __init__(self) -> None:
        super().__init__()
        # RLock: frame code runs under the driver's mutex and re-enters
        # it through every primitive call (put/set/release/spawn).
        self._mutex = threading.RLock()
        self._cond = threading.Condition(self._mutex)
        self._now = 0.0
        self._seq = itertools.count()
        self._ready: "deque[_Frame]" = deque()
        self._timers: list[_Timer] = []
        self._driving = False
        self._external_actors: dict[int, int] = {}  # ident -> depth
        self.switches = 0        # frame dispatches (scheduler cost metric)
        self.actors_spawned = 0  # total frames spawned

    # -- introspection ------------------------------------------------------
    def now_ms(self) -> float:
        return self._now

    def _current(self) -> "_Frame | None":
        return _current_frame()

    # -- driver -------------------------------------------------------------
    def run(self, gen: Any) -> Any:
        """Drive ``gen`` as a root frame until it completes, then drain
        any frames it made ready (sentinel cleanup), and return its
        value. Frames still parked on timers stay parked — exactly like
        leftover thread actors — and resume on the next ``run()``."""
        if not isinstance(gen, GeneratorType):
            return gen
        if _current_frame() is not None:
            raise RuntimeError(
                "EventClock.run() called from inside a frame; compose "
                "generators with 'yield from' instead")
        with self._mutex:
            if self._driving:
                raise RuntimeError("EventClock is already being driven")
            root = _Frame(next(self._seq), None, "root", root=True)
            root.gen = gen
            self._ready.append(root)
            self._driving = True
            try:
                self._drive(root)
            finally:
                self._driving = False
        if root.exc is not None:
            raise root.exc
        return root.result

    def _drive(self, root: _Frame) -> None:
        ready = self._ready
        timers = self._timers
        while not root.done:
            if ready:
                self._dispatch(ready.popleft())
                continue
            while timers and timers[0].cancelled:
                heapq.heappop(timers)
            if timers:
                timer = heapq.heappop(timers)
                self._now = max(self._now, timer.deadline)
                frame = timer.owner
                frame.timer = None
                frame.wake_reason = _WAKE_TIMEOUT
                ready.append(frame)
                continue
            # Fully event-blocked: idle until an external stimulus.
            self._cond.wait()
        while ready:
            # Root finished: run frames its teardown made ready (pool
            # sentinels, lane shutdowns) so they don't leak into the
            # next job's ready order; timer-parked frames stay parked.
            self._dispatch(ready.popleft())

    def _dispatch(self, frame: _Frame) -> None:
        self.switches += 1
        wait, frame.wait = frame.wait, None
        reason, frame.wake_reason = frame.wake_reason, None
        if wait is None:  # first dispatch
            self._step(frame, None, None, None)
            return
        kind = wait[0]
        if kind == "get":
            q, deadline = wait[1], wait[2]
            if reason == _WAKE_TIMEOUT:
                try:
                    q._waiters.remove(frame)
                except ValueError:
                    pass
                self._step(frame, None, _queue.Empty(), None)
                return
            if q._items:
                self._step(frame, q._items.pop(0), None, None)
                return
            # Signalled but the item was taken: wait out the remainder
            # (mirrors the VirtualQueue re-check loop).
            remaining = None if deadline is None else deadline - self._now
            if remaining is not None and remaining <= 0:
                self._step(frame, None, _queue.Empty(), None)
                return
            q._waiters.append(frame)
            self._park(frame, ("get", q, deadline), remaining)
            return
        if kind == "wait":
            ev = wait[1]
            if reason == _WAKE_TIMEOUT:
                try:
                    ev._waiters.remove(frame)
                except ValueError:
                    pass
            self._step(frame, ev._flag, None, None)
            return
        if kind == "retire":
            self._finalize(frame)
            return
        if kind == "replay":
            self._step(frame, None, None, wait[1])
            return
        # "resume" (charge/flush/sleep) or "acquire" (woken owning)
        self._step(frame, None, None, None)

    def _park(self, frame: _Frame, wait: "tuple[Any, ...]",
              timeout_ms: float | None) -> None:
        frame.wait = wait
        if timeout_ms is not None:
            timer = _Timer(self._now + max(0.0, timeout_ms), frame)
            frame.timer = timer
            heapq.heappush(self._timers, timer)

    def _make_ready(self, frame: _Frame) -> None:
        if frame.timer is not None:
            frame.timer.cancelled = True
            frame.timer = None
        frame.wake_reason = _WAKE_SIGNAL
        self._ready.append(frame)
        self._cond.notify_all()  # wake an idle driver

    def _defer_flush(self, frame: _Frame, eff: "tuple[Any, ...]") -> None:
        """A suspending effect arrived with compute charges still
        deferred: advance time past them first, then replay the effect
        (keeps the time trajectory identical to the thread substrate,
        where those charges advanced time when issued)."""
        self._park(frame, ("replay", eff), frame.deferred_ms)
        frame.deferred_ms = 0.0

    def _step(self, frame: _Frame, value: Any, exc: "BaseException | None",
              replay: "tuple[Any, ...] | None") -> None:
        _frame_ctx.frame = frame
        try:
            gen = frame.gen
            if gen is None:
                try:
                    r = frame.fn()  # type: ignore[misc]
                except BaseException as e:
                    self._fail(frame, e)
                    return
                frame.fn = None
                if not isinstance(r, GeneratorType):
                    self._retire(frame, r)
                    return
                frame.gen = gen = r
            while True:
                if replay is not None:
                    eff, replay = replay, None
                else:
                    try:
                        if exc is not None:
                            pending, exc = exc, None
                            eff = gen.throw(pending)
                        else:
                            eff = gen.send(value)
                        value = None
                    except StopIteration as stop:
                        self._retire(frame, stop.value)
                        return
                    except BaseException as e:
                        self._fail(frame, e)
                        return
                    # Journal only freshly generated effects — a replayed
                    # effect (deferred-flush re-issue) was already
                    # recorded when the generator first yielded it.
                    tracer = self.tracer
                    if tracer is not None:
                        tracer.record(
                            f"{frame.name or 'frame'}#{frame.seq}", eff, gen)
                kind = eff[0]
                if kind == "charge":
                    ms = eff[1]
                    if ms <= 0:
                        continue
                    self._account(ms)
                    self._park(frame, ("resume",), ms + frame.deferred_ms)
                    frame.deferred_ms = 0.0
                    return
                if kind == "get":
                    if frame.deferred_ms > 0.0:
                        self._defer_flush(frame, eff)
                        return
                    q, timeout = eff[1], eff[2]
                    if q._items:
                        value = q._items.pop(0)
                        continue
                    if timeout is not None and timeout <= 0:
                        exc = _queue.Empty()
                        continue
                    deadline = (None if timeout is None
                                else self._now + timeout * 1e3)
                    q._waiters.append(frame)
                    self._park(frame, ("get", q, deadline),
                               None if timeout is None else timeout * 1e3)
                    return
                if kind == "acquire":
                    if frame.deferred_ms > 0.0:
                        self._defer_flush(frame, eff)
                        return
                    lk = eff[1]
                    if lk._owner is None:
                        lk._owner = frame
                        continue
                    lk._waiters.append(frame)
                    self._park(frame, ("acquire", lk), None)
                    return
                if kind == "wait":
                    if frame.deferred_ms > 0.0:
                        self._defer_flush(frame, eff)
                        return
                    ev, timeout = eff[1], eff[2]
                    if ev._flag:
                        value = True
                        continue
                    ev._waiters.append(frame)
                    self._park(frame, ("wait", ev),
                               None if timeout is None else timeout * 1e3)
                    return
                if kind == "flush":
                    if frame.deferred_ms > 0.0:
                        self._park(frame, ("resume",), frame.deferred_ms)
                        frame.deferred_ms = 0.0
                        return
                    continue
                if kind == "sleep":
                    self._park(frame, ("resume",),
                               max(0.0, eff[1]) + frame.deferred_ms)
                    frame.deferred_ms = 0.0
                    return
                self._fail(frame, RuntimeError(
                    f"unknown clock effect {eff!r}"))
                return
        finally:
            _frame_ctx.frame = None

    def _retire(self, frame: _Frame, result: Any) -> None:
        frame.result = result
        if frame.deferred_ms > 0.0:
            # Auto-flush trailing compute charges so the frame's time
            # footprint matches the thread substrate's.
            self._park(frame, ("retire",), frame.deferred_ms)
            frame.deferred_ms = 0.0
            return
        self._finalize(frame)

    def _finalize(self, frame: _Frame) -> None:
        frame.done = True
        frame.gen = None
        frame.fn = None

    def _fail(self, frame: _Frame, exc: BaseException) -> None:
        frame.gen = None
        frame.fn = None
        frame.done = True
        if frame.root:
            frame.exc = exc
            return
        # Mirror the thread substrate: an exception escaping a spawned
        # actor body is reported (threading excepthook), not raised
        # into the scheduler.
        print(f"Exception in frame {frame.name!r}:", file=sys.stderr)
        traceback.print_exception(type(exc), exc, exc.__traceback__)

    # -- actor lifecycle ----------------------------------------------------
    def spawn(self, fn: Callable[[], Any], name: str = "") -> None:
        with self._mutex:
            frame = _Frame(next(self._seq), fn, name)
            self._ready.append(frame)
            self.actors_spawned += 1
            self._cond.notify_all()

    class _ExternalActorContext:
        def __init__(self, clock: "EventClock"):
            self.clock = clock

        def __enter__(self) -> None:
            ident = threading.get_ident()
            with self.clock._mutex:
                actors = self.clock._external_actors
                actors[ident] = actors.get(ident, 0) + 1

        def __exit__(self, *exc: Any) -> None:
            ident = threading.get_ident()
            with self.clock._mutex:
                actors = self.clock._external_actors
                depth = actors.get(ident, 0) - 1
                if depth <= 0:
                    actors.pop(ident, None)
                else:
                    actors[ident] = depth

    def actor(self) -> "_ExternalActorContext":
        """Register the calling (external) thread as an actor: its
        charges drive the frame scheduler — advancing virtual time and
        firing parked frames' timers — exactly like a thread-substrate
        actor's charges let other actors run."""
        return EventClock._ExternalActorContext(self)

    # -- time ---------------------------------------------------------------
    def charge(self, ms: float) -> None:
        if ms <= 0:
            return
        frame = _current_frame()
        if frame is not None:
            # Non-yielding code inside a frame (simulated_compute in a
            # task function): bill now, advance at the next suspension.
            self._account(ms)
            frame.deferred_ms += ms
            return
        if threading.get_ident() in self._external_actors:
            def once() -> Any:
                yield ("charge", ms)

            self.run(once())
            return
        self._account(ms)

    def sleep_ms(self, ms: float) -> None:
        frame = _current_frame()
        if frame is not None:
            frame.deferred_ms += max(0.0, ms)
            return
        if threading.get_ident() in self._external_actors:
            def once() -> Any:
                yield ("sleep", ms)

            self.run(once())

    # -- primitives ---------------------------------------------------------
    def queue(self) -> "EventQueue":
        return EventQueue(self)

    def lock(self) -> "EventLock":
        return EventLock(self)

    def event(self) -> "EventEvent":
        return EventEvent(self)

    def pool(self, max_workers: int) -> VirtualPool:
        return VirtualPool(self, max_workers)


class EventQueue:
    """``queue.Queue``-compatible FIFO for the event substrate: frames
    suspend via ``("get", q, timeout)`` effects (simulated-seconds
    timeout); external threads block on real condvars with real
    timeouts, exactly like the VirtualQueue non-actor path."""

    def __init__(self, clock: EventClock):
        self._clock = clock
        self._items: list[Any] = []
        self._waiters: list[Any] = []  # _Frame | _ExternalWaiter, FIFO

    def put(self, item: Any) -> None:
        clock = self._clock
        with clock._mutex:
            self._items.append(item)
            if self._waiters:
                waiter = self._waiters.pop(0)
                if isinstance(waiter, _ExternalWaiter):
                    waiter.signalled = True
                    waiter.cond.notify()
                else:
                    clock._make_ready(waiter)

    def get(self, timeout: float | None = None) -> Any:
        if _current_frame() is not None:
            raise RuntimeError(
                "blocking get() inside a frame would deadlock the "
                "driver; yield ('get', q, timeout) instead")
        clock = self._clock
        with clock._mutex:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while not self._items:
                waiter = _ExternalWaiter(clock._mutex)
                self._waiters.append(waiter)
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self._waiters.remove(waiter)
                    raise _queue.Empty
                if not waiter.cond.wait(remaining):
                    if waiter in self._waiters:
                        self._waiters.remove(waiter)
                    if not waiter.signalled:
                        raise _queue.Empty
            return self._items.pop(0)

    def empty(self) -> bool:
        with self._clock._mutex:
            return not self._items

    def drain(self) -> "list[Any]":
        with self._clock._mutex:
            items, self._items = self._items, []
            return items


class EventLock:
    """Transfer-lane lock for the event substrate. Frames acquire via
    ``("acquire", lock)`` effects; ``release`` is a direct call with
    FIFO ownership handoff (deterministic lane contention)."""

    def __init__(self, clock: EventClock):
        self._clock = clock
        self._owner: Any = None  # _Frame, _ExternalWaiter, or thread ident
        self._waiters: list[Any] = []

    def acquire(self) -> None:
        if _current_frame() is not None:
            raise RuntimeError(
                "blocking acquire() inside a frame would deadlock the "
                "driver; yield ('acquire', lock) instead")
        clock = self._clock
        with clock._mutex:
            ident = threading.get_ident()
            if self._owner is None:
                self._owner = ident
                return
            waiter = _ExternalWaiter(clock._mutex)
            self._waiters.append(waiter)
            while not waiter.signalled:
                waiter.cond.wait()
            self._owner = ident

    def release(self) -> None:
        clock = self._clock
        with clock._mutex:
            if not self._waiters:
                self._owner = None
                return
            waiter = self._waiters.pop(0)
            self._owner = waiter
            if isinstance(waiter, _ExternalWaiter):
                waiter.signalled = True
                waiter.cond.notify()
            else:
                clock._make_ready(waiter)  # dispatched owning the lock

    def __enter__(self) -> "EventLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class EventEvent:
    """``threading.Event``-compatible flag for the event substrate.
    Frames wait via ``("wait", ev, timeout)`` effects; ``set`` wakes
    every waiter in FIFO order."""

    def __init__(self, clock: EventClock):
        self._clock = clock
        self._flag = False
        self._waiters: list[Any] = []

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        clock = self._clock
        with clock._mutex:
            self._flag = True
            waiters, self._waiters = self._waiters, []
            for waiter in waiters:
                if isinstance(waiter, _ExternalWaiter):
                    waiter.signalled = True
                    waiter.cond.notify()
                else:
                    clock._make_ready(waiter)

    def wait(self, timeout: float | None = None) -> bool:
        if _current_frame() is not None:
            raise RuntimeError(
                "blocking wait() inside a frame would deadlock the "
                "driver; yield ('wait', event, timeout) instead")
        clock = self._clock
        with clock._mutex:
            if self._flag:
                return True
            waiter = _ExternalWaiter(clock._mutex)
            self._waiters.append(waiter)
            waiter.cond.wait(timeout)
            if waiter in self._waiters:
                self._waiters.remove(waiter)
            return self._flag


# ---------------------------------------------------------------------------
# Mode selection
# ---------------------------------------------------------------------------


def clock_for_scale(time_scale: float,
                    substrate: str = "event") -> BaseClock:
    """``time_scale > 0`` keeps the seed real-time mode for
    cross-checks; otherwise ``substrate`` picks the virtual engine:
    ``"event"`` (default) is the continuation scheduler, ``"thread"``
    the PR-3 thread-per-actor cross-check mode."""
    if time_scale > 0:
        return RealtimeClock(time_scale)
    if substrate == "thread":
        return VirtualClock()
    if substrate == "event":
        return EventClock()
    raise ValueError(f"unknown simulation substrate {substrate!r} "
                     "(expected 'event' or 'thread')")
