"""Sharded KV store with atomic fan-in counters, pub/sub, and a cost model.

Models the paper's intermediate-storage substrate: a Redis cluster
partitioned across shards (paper ran 10 c5.18xlarge shards). Because this
container has no AWS, the *costs* of the serverless environment are
simulated and the *algorithms* are real:

- every op pays a base latency plus size/bandwidth transfer time, charged
  on the engine clock (repro_torch.core.simclock) — the deterministic virtual
  discrete-event clock by default, the seed real-sleep mode when
  ``CostModel.time_scale > 0``,
- a shard's transfer lane is held for the duration of a transfer, so
  concurrent large transfers to one shard queue up — this reproduces the
  NIC contention that §V-B measured ("running each KV Store shard on its
  own separate VM resulted in a significant performance improvement") and
  the heavy read/write tail of Fig. 13,
- ``colocate_shards=True`` puts all shards behind one transfer lane
  (the "all shards on the same VM" configuration of §V-B).

Data-plane optimizations (beyond the paper, from its follow-ups):

- **Striped large objects** (Wukong follow-up's chunked storage): values
  larger than ``CostModel.stripe_threshold_bytes`` are split into up to
  ``max_stripes`` stripes placed on *distinct* shards and transferred
  over their lanes concurrently, so a large object pays the *max* of the
  stripe lane times instead of the *sum* of one lane's serial transfer.
  A manifest entry under the original key keeps ``get``/``exists``/
  ``put_if_absent``/``delete`` and idempotent retries correct. The
  stripes model the byte extents' placement and transfer cost; the
  Python object itself rides the manifest (the costs are simulated, the
  placement/laning/idempotence algorithms are real). With
  ``colocate_shards=True`` every stripe shares one lane, so striping
  degenerates to the serial transfer — exactly the §V-B NIC story.
- **Batched round trips** (Lambada-style): ``mget`` groups keys by shard
  and pays one ``kv_base_ms`` per shard batch instead of one per key;
  ``register_counters`` registers a whole job's fan-in counters in one
  round trip.

Fan-in dependency counters (paper §IV-C) are atomic. Two modes:
- ``paper``: plain atomic increment, exactly the paper's Redis INCR.
- ``edge_set`` (default): the counter is a set of satisfied in-edge ids;
  the "count" is the set size. This makes increments idempotent so that
  Lambda-style automatic retries and speculative duplicate executors
  cannot double-fire a fan-in — a correctness hole in the paper's INCR
  scheme that we close (see DESIGN.md §2).

Multi-tenancy (the orchestrator substrate): ``namespace(job_id)`` returns
a :class:`KVNamespace` — a per-job view over the shared store that
prefixes every key, counter id, and pub/sub channel with the job id and
keeps its OWN :class:`KVStats`, so N concurrent jobs share the shards,
lanes, and clock (contending for them, which is the point) without
colliding on names or polluting each other's reports. Shard *placement*
ignores the namespace prefix, so a job's data-plane behavior (placement,
lane contention with itself) is independent of which job id it was
assigned — two identical jobs on one substrate report identically.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import random
import threading
import zlib
from typing import Any, Iterable, Mapping

from repro_torch.core.simclock import (
    BaseClock,
    _current_frame,
    clock_for_scale,
    run_effects,
)

# Separator between a namespace (job id) and the user key. Placement
# hashing strips everything up to the first separator, so a namespaced
# key lands on the same shard its bare key would.
NAMESPACE_SEP = "::"


class _Purged:
    """Sentinel delivered to subscribers still blocked on a channel when
    ``drop_namespace`` sweeps it away, so a consumer of a cancelled job
    wakes up and can exit instead of waiting forever on a channel nobody
    can publish to anymore. Compare with ``is PURGED``."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<PURGED>"


PURGED = _Purged()

# Per-actor stats sink: while a KVNamespace call is on the stack, the
# parent store's counter bumps are mirrored into the view's own KVStats
# (the view can't re-derive byte counts — entry sizes are recorded once
# at put time and not returned by the ops). On the event substrate the
# sink rides on the *frame* (the op suspends and resumes inside the
# scope, and many frames share one driver thread); thread-locals remain
# the fallback for the thread substrates and external callers.
_stats_sink = threading.local()


class _SinkScope:
    """Installs a view as the current actor's stats sink for one parent
    call (frame-scoped under the event substrate, thread-scoped
    otherwise)."""

    __slots__ = ("view", "_prev", "_frame")

    def __init__(self, view: "KVNamespace"):
        self.view = view

    def __enter__(self) -> None:
        frame = _current_frame()
        self._frame = frame
        if frame is not None:
            self._prev = frame.sink
            frame.sink = self.view
        else:
            self._prev = getattr(_stats_sink, "view", None)
            _stats_sink.view = self.view

    def __exit__(self, *exc: Any) -> None:
        if self._frame is not None:
            self._frame.sink = self._prev
        else:
            _stats_sink.view = self._prev


def sizeof(value: Any) -> int:
    """Approximate wire size of a task payload in bytes."""
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if isinstance(value, str):
        return len(value.encode())
    if isinstance(value, (int, float, bool, type(None))):
        return 8
    if isinstance(value, (tuple, list)):
        return 16 + sum(sizeof(v) for v in value)
    if isinstance(value, dict):
        return 16 + sum(sizeof(k) + sizeof(v) for k, v in value.items())
    try:
        return len(pickle.dumps(value))
    except Exception:
        return 64


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Latency model of the serverless substrate, in *simulated* ms.

    Defaults follow the paper's measurements where it gives them
    (invoke_ms ~50ms via boto3) and plausible AWS numbers elsewhere.

    ``time_scale`` selects the clock mode (repro_torch.core.simclock): 0 — the
    default — runs on a deterministic virtual discrete-event clock
    (idle simulated time costs zero wall time, runs are bit-identical);
    > 0 keeps the seed real-time mode, really sleeping
    ``ms * time_scale / 1e3`` seconds per charge, for sanity
    cross-checks against the virtual substrates.

    ``substrate`` picks the virtual scheduler when ``time_scale == 0``:
    ``"event"`` (the default; override via ``REPRO_SIM_SUBSTRATE``) is
    the continuation/event-driven engine that scales to million-task
    DAGs; ``"thread"`` is the PR-3 thread-per-actor engine kept as a
    cross-check mode. Both produce bit-identical charges.

    Invocation latency is a seeded *distribution*, not a constant, when
    the jitter/cold-start knobs are set: each invocation ``index`` draws
    a lognormal multiplier on ``invoke_ms`` (``invoke_sigma``) and a
    cold start with probability ``1 - warm_fraction`` adding
    ``cold_start_ms`` — the cost dimension ServerMix argues dominates
    serverless analytics. Draws are keyed on ``(latency_seed, index)``
    so runs are reproducible.
    """

    invoke_ms: float = 50.0          # Lambda invocation API call (paper §III-C)
    cold_start_ms: float = 250.0     # container cold start (paper §II-A)
    warm_fraction: float = 1.0       # paper warms a pool of Lambdas (§V-A)
    invoke_sigma: float = 0.0        # lognormal sigma on invoke_ms (0 = const)
    latency_seed: int = 0            # seed for the invocation-latency draws
    kv_base_ms: float = 0.5          # per-op KV latency
    kv_bandwidth_mbps: float = 600.0 # per-shard transfer lane
    tcp_connect_ms: float = 4.0      # per-Lambda TCP connect (strawman)
    tcp_msg_ms: float = 0.4          # scheduler-side serialized msg handling
    tcp_irq_factor: float = 0.5      # IRQ-flood term: extra msg cost per
                                     # concurrently-open Lambda connection
                                     # (paper §III-C: "IRQ requests which
                                     # flood the strawman case")
    pubsub_msg_ms: float = 0.05      # Redis pub/sub message
    schedule_ship_mbps: float = 600.0  # static-schedule payload transfer
    # Striping (Wukong follow-up's chunked large-object storage): values
    # larger than stripe_threshold_bytes split into <= max_stripes stripes
    # on distinct shards. <= 0 disables striping entirely.
    stripe_threshold_bytes: int = 1 << 20
    max_stripes: int = 8
    time_scale: float = 0.0
    substrate: str = dataclasses.field(
        default_factory=lambda: os.environ.get("REPRO_SIM_SUBSTRATE",
                                               "event"))

    def transfer_ms(self, nbytes: int) -> float:
        return nbytes / (self.kv_bandwidth_mbps * 1e6) * 1e3

    def invoke_draw(self, index: int) -> "tuple[float, bool]":
        """(latency_ms, was_cold) for invocation number ``index``.

        Deterministic per (latency_seed, index) via crc32, the same
        process-stable hashing the fault injector and shard placement
        use (tuple/str hash() is a PYTHONHASHSEED lottery)."""
        ms = self.invoke_ms
        if self.invoke_sigma <= 0 and self.warm_fraction >= 1.0:
            return ms, False
        token = f"{self.latency_seed}|invoke|{index}".encode()
        rng = random.Random(zlib.crc32(token))
        if self.invoke_sigma > 0:
            ms *= rng.lognormvariate(0.0, self.invoke_sigma)
        cold = rng.random() >= self.warm_fraction
        if cold:
            ms += self.cold_start_ms
        return ms, cold

    def invoke_jitter_ms(self, index: int) -> float:
        """Jitter-only invocation latency for invocation ``index`` —
        the ``invoke_draw`` lognormal component WITHOUT the stochastic
        cold-start term. The stateful platform model (repro_torch.platform)
        uses this: whether invocation ``index`` is cold is decided by
        the warm-container pool's state, not a coin flip, and the
        cold-start delay is added by the platform when the pool misses.
        Same (latency_seed, index) keying as ``invoke_draw`` so the
        jitter component matches between the two modes."""
        ms = self.invoke_ms
        if self.invoke_sigma <= 0:
            return ms
        token = f"{self.latency_seed}|invoke|{index}".encode()
        rng = random.Random(zlib.crc32(token))
        return ms * rng.lognormvariate(0.0, self.invoke_sigma)


@dataclasses.dataclass
class KVStats:
    gets: int = 0
    puts: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    incrs: int = 0
    publishes: int = 0
    striped_puts: int = 0
    striped_gets: int = 0
    mget_batches: int = 0
    journal_appends: int = 0
    journal_scans: int = 0

    def snapshot(self) -> dict[str, int]:
        return dataclasses.asdict(self)


class _Entry:
    """A stored object plus its wire size, recorded once at put time so
    reads never re-derive it (the recursive ``sizeof`` walk is a host-side
    hot path on deep containers)."""

    __slots__ = ("value", "nbytes")

    def __init__(self, value: Any, nbytes: int):
        self.value = value
        self.nbytes = nbytes


class _StripeManifest:
    """Manifest for a striped object: the home-shard entry under the
    original key. Records the stripe layout so every API (get / exists /
    put_if_absent / delete / retries) resolves the object through one
    stable key."""

    __slots__ = ("value", "nbytes", "n_stripes")

    def __init__(self, value: Any, nbytes: int, n_stripes: int):
        self.value = value
        self.nbytes = nbytes
        self.n_stripes = n_stripes


class _Stripe:
    """One stripe's byte extent (placement + transfer-cost record)."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int):
        self.nbytes = nbytes


def _stripe_key(key: str, i: int) -> str:
    return f"{key}/__stripe__/{i}"


class _Shard:
    def __init__(self, lane: Any) -> None:
        self.data: dict[str, Any] = {}
        self.lock = threading.Lock()          # metadata atomicity
        # Transfer lane (NIC contention): a clock-aware lock, so an actor
        # holding the lane across a simulated transfer cooperates with
        # the virtual clock instead of wedging it.
        self.lane = lane


class ShardedKVStore:
    """The KV Store + Storage Manager counter registry."""

    def __init__(
        self,
        n_shards: int = 10,
        cost: CostModel | None = None,
        colocate_shards: bool = False,
        counter_mode: str = "edge_set",
        clock: BaseClock | None = None,
    ):
        if counter_mode not in ("edge_set", "paper"):
            raise ValueError(counter_mode)
        self.cost = cost or CostModel()
        self.clock: BaseClock = clock or clock_for_scale(
            self.cost.time_scale, getattr(self.cost, "substrate", "event"))
        if colocate_shards:
            # all shards share one VM -> one NIC -> one transfer lane
            shared = self.clock.lock()
            self.shards = [_Shard(shared) for _ in range(max(1, n_shards))]
        else:
            self.shards = [_Shard(self.clock.lock())
                           for _ in range(max(1, n_shards))]
        self.counter_mode = counter_mode
        self._counters: dict[str, set[str] | int] = {}
        self._counter_widths: dict[str, int] = {}
        self._counter_lock = threading.Lock()
        self._channels: dict[str, list[Any]] = {}
        self._chan_lock = threading.Lock()
        # Namespaces handed out by ``namespace()``. Placement hashing
        # only strips prefixes registered here, so ordinary user keys
        # that happen to contain the separator keep their placement.
        self._namespaces: set[str] = set()
        self._ns_lock = threading.Lock()
        # Append-only journals (control-plane event logs), keyed by
        # journal id. Entries are (payload, nbytes) in append order.
        # Kept OUTSIDE shard.data: a journal is a log, not an object —
        # it has no get/exists/delete surface and must survive the
        # object-store observables (shard byte counts, purge sweeps
        # measure *data-plane* state).
        self._journals: dict[str, list[tuple[Any, int]]] = {}
        self._journal_lock = threading.Lock()
        # Called with the dropped prefix after ``drop_namespace`` sweeps
        # the store, so caches holding store-qualified keys (the
        # platform's container caches, repro_torch.core.cache) reclaim a
        # finished job's entries in the same breath as its KV objects.
        self._purge_listeners: list[Any] = []
        # Called host-side with ``(key, nbytes)`` after every durable
        # object write (put / put_if_absent / deposit stores), with the
        # store-qualified key. This is the trigger bus's kv_write event
        # source: listeners observe, they do not charge — the written
        # bytes already paid their round trip.
        self._write_listeners: list[Any] = []
        self.stats = KVStats()
        self._stats_lock = threading.Lock()

    # -- stats -------------------------------------------------------------
    def _bump(self, **fields: int) -> None:
        """Add counter deltas to the store stats and, when the call came
        through a :class:`KVNamespace`, to that view's stats too."""
        with self._stats_lock:
            st = self.stats
            for name, delta in fields.items():
                setattr(st, name, getattr(st, name) + delta)
        frame = _current_frame()
        if frame is not None:
            view = frame.sink
        else:
            view = getattr(_stats_sink, "view", None)
        if view is not None:
            view._bump(**fields)

    # -- placement ---------------------------------------------------------
    def _placement_key(self, key: str) -> str:
        """The key placement hashes on: a REGISTERED namespace prefix is
        stripped, so a job's placement (and therefore its self-contention
        profile) must not depend on its job id. Only registered prefixes
        count — an ordinary user key that happens to contain the
        separator keeps its full-key placement."""
        head, sep, rest = key.partition(NAMESPACE_SEP)
        if sep and head in self._namespaces:
            return rest
        return key

    def _shard_index(self, key: str) -> int:
        # Stable across processes (unlike hash(), which PYTHONHASHSEED
        # randomizes), so shard placement — and therefore lane contention
        # and benchmark numbers — is reproducible run to run.
        return zlib.crc32(
            self._placement_key(key).encode("utf-8")) % len(self.shards)

    def _shard(self, key: str) -> _Shard:
        return self.shards[self._shard_index(key)]

    def stripes_for(self, nbytes: int) -> int:
        """Number of stripes a value of ``nbytes`` would be split into
        (1 = stored whole)."""
        thr = self.cost.stripe_threshold_bytes
        if thr <= 0 or nbytes <= thr or len(self.shards) < 2:
            return 1
        return min(
            self.cost.max_stripes,
            len(self.shards),
            -(-nbytes // thr),  # ceil div
        )

    def _stripe_layout(self, key: str, nbytes: int, n_stripes: int):
        """(shard_index, stripe_key, stripe_bytes) per stripe; stripes go
        on consecutive (distinct) shards starting at the home shard."""
        base = self._shard_index(key)
        n = len(self.shards)
        per, rem = divmod(nbytes, n_stripes)
        return [
            ((base + i) % n, _stripe_key(key, i), per + (1 if i < rem else 0))
            for i in range(n_stripes)
        ]

    def _pay_g(self, shard: _Shard, nbytes: int) -> Any:
        # Base latency is paid outside the lane; transfer holds the lane so
        # concurrent large objects to one shard serialize (NIC model).
        yield ("charge", self.cost.kv_base_ms)
        t_ms = self.cost.transfer_ms(nbytes)
        if t_ms > 0:
            yield ("acquire", shard.lane)
            try:
                yield ("charge", t_ms)
            finally:
                shard.lane.release()

    def _charge_striped_transfer_g(self, layout) -> Any:
        """Charge a striped transfer: stripes move over their lanes
        concurrently, so the op is billed the slowest *lane's* total (one
        stripe per lane when shards are distinct; the full serial sum when
        ``colocate_shards`` folds every lane into one).

        Only the home-shard lane is *held* for that duration: holding all
        stripe lanes would let one striped op block every other (with 8
        stripes over 10 shards, any two ops share a lane — a convoy that
        erases the wall-clock win striping exists to provide). The home
        lane still serializes same-object retries and same-shard
        traffic; remote stripe lanes are modeled as load-spread, which is
        exactly the follow-up paper's argument for chunking across
        shards. Under ``colocate_shards`` every lane IS the home lane, so
        the full serial occupancy is preserved."""
        lane_ms: dict[int, float] = {}
        for shard_idx, _, nbytes in layout:
            lid = id(self.shards[shard_idx].lane)
            lane_ms[lid] = lane_ms.get(lid, 0.0) + self.cost.transfer_ms(
                nbytes)
        wait_ms = max(lane_ms.values(), default=0.0)
        if wait_ms <= 0:
            return
        lane = self.shards[layout[0][0]].lane
        yield ("acquire", lane)
        try:
            yield ("charge", wait_ms)
        finally:
            lane.release()

    # -- object store ------------------------------------------------------
    def _drop_stripes(self, key: str, n_stripes: int, first: int = 0) -> None:
        """Remove stripe records ``first..n_stripes-1`` of ``key``."""
        base = self._shard_index(key)
        n = len(self.shards)
        for i in range(first, n_stripes):
            s = self.shards[(base + i) % n]
            with s.lock:
                s.data.pop(_stripe_key(key, i), None)

    def _write_stripes_g(self, key: str, value: Any, nbytes: int,
                         n_stripes: int, if_absent: bool) -> Any:
        """Write stripes + manifest (manifest last: its insertion is the
        linearization point, so readers never observe a torn object).
        Returns False when ``if_absent`` and the manifest already existed
        — concurrent retried writers produce byte-identical stripes, so
        the loser's stripe writes are harmless no-ops. A plain overwrite
        of a previously-striped value drops the old stripes its new
        layout does not cover."""
        layout = self._stripe_layout(key, nbytes, n_stripes)
        yield ("charge", self.cost.kv_base_ms)
        yield from self._charge_striped_transfer_g(layout)
        for shard_idx, skey, snbytes in layout:
            shard = self.shards[shard_idx]
            with shard.lock:
                if not if_absent or skey not in shard.data:
                    shard.data[skey] = _Stripe(snbytes)
        home = self._shard(key)
        manifest = _StripeManifest(value, nbytes, n_stripes)
        with home.lock:
            if if_absent and key in home.data:
                return False
            old = home.data.get(key)
            home.data[key] = manifest
        if isinstance(old, _StripeManifest) and old.n_stripes > n_stripes:
            self._drop_stripes(key, old.n_stripes, first=n_stripes)
        return True

    def put_g(self, key: str, value: Any, nbytes: int | None = None) -> Any:
        """Store ``value``. ``nbytes`` is an optional caller-known size
        hint (skips the recursive ``sizeof`` walk)."""
        if nbytes is None:
            nbytes = sizeof(value)
        n_stripes = self.stripes_for(nbytes)
        if n_stripes > 1:
            yield from self._write_stripes_g(key, value, nbytes, n_stripes,
                                             if_absent=False)
            self._bump(puts=1, striped_puts=1, bytes_written=nbytes)
            self._notify_write(key, nbytes)
            return
        shard = self._shard(key)
        yield from self._pay_g(shard, nbytes)
        with shard.lock:
            old = shard.data.get(key)
            shard.data[key] = _Entry(value, nbytes)
        if isinstance(old, _StripeManifest):
            # the overwritten value was striped: reclaim its stripes
            self._drop_stripes(key, old.n_stripes)
        self._bump(puts=1, bytes_written=nbytes)
        self._notify_write(key, nbytes)

    def put(self, key: str, value: Any, nbytes: int | None = None) -> None:
        run_effects(self.clock, self.put_g(key, value, nbytes))

    def put_if_absent_g(self, key: str, value: Any,
                        nbytes: int | None = None) -> Any:
        """Idempotent write used by retried/speculative executors."""
        shard = self._shard(key)
        with shard.lock:
            if key in shard.data:
                return False
        if nbytes is None:
            nbytes = sizeof(value)
        n_stripes = self.stripes_for(nbytes)
        if n_stripes > 1:
            ok = yield from self._write_stripes_g(key, value, nbytes,
                                                  n_stripes, if_absent=True)
            if not ok:
                return False
            self._bump(puts=1, striped_puts=1, bytes_written=nbytes)
            self._notify_write(key, nbytes)
            return True
        yield from self._pay_g(shard, nbytes)
        with shard.lock:
            if key in shard.data:
                return False
            shard.data[key] = _Entry(value, nbytes)
        self._bump(puts=1, bytes_written=nbytes)
        self._notify_write(key, nbytes)
        return True

    def put_if_absent(self, key: str, value: Any,
                      nbytes: int | None = None) -> bool:
        return run_effects(self.clock,
                           self.put_if_absent_g(key, value, nbytes))

    def get_g(self, key: str) -> Any:
        shard = self._shard(key)
        with shard.lock:
            if key not in shard.data:
                raise KeyError(key)
            entry = shard.data[key]
        if isinstance(entry, _StripeManifest):
            layout = self._stripe_layout(key, entry.nbytes, entry.n_stripes)
            yield ("charge", self.cost.kv_base_ms)
            yield from self._charge_striped_transfer_g(layout)
            self._bump(gets=1, striped_gets=1, bytes_read=entry.nbytes)
            return entry.value
        # Size was recorded once at put time; reads never re-derive it.
        yield from self._pay_g(shard, entry.nbytes)
        self._bump(gets=1, bytes_read=entry.nbytes)
        return entry.value

    def get(self, key: str) -> Any:
        return run_effects(self.clock, self.get_g(key))

    def exists(self, key: str) -> bool:
        shard = self._shard(key)
        with shard.lock:
            return key in shard.data

    def delete(self, key: str) -> None:
        shard = self._shard(key)
        with shard.lock:
            entry = shard.data.pop(key, None)
        if isinstance(entry, _StripeManifest):
            self._drop_stripes(key, entry.n_stripes)

    # -- fan-in dependency counters (paper §IV-C) ---------------------------
    def register_counter_g(self, counter_id: str, width: int) -> Any:
        yield ("charge", self.cost.kv_base_ms)
        with self._counter_lock:
            self._register_locked(counter_id, width)

    def register_counter(self, counter_id: str, width: int) -> None:
        run_effects(self.clock, self.register_counter_g(counter_id, width))

    def register_counters_g(self, widths: Mapping[str, int]) -> Any:
        """Batched registration: the Storage Manager registers a whole
        job's fan-in counters in ONE round trip at workflow start
        (Lambada-style batching of many small storage requests). An empty
        registration sends nothing and costs nothing."""
        if not widths:
            return
        yield ("charge", self.cost.kv_base_ms)
        with self._counter_lock:
            for counter_id, width in widths.items():
                self._register_locked(counter_id, width)

    def register_counters(self, widths: Mapping[str, int]) -> None:
        run_effects(self.clock, self.register_counters_g(widths))

    def _register_locked(self, counter_id: str, width: int) -> None:
        self._counter_widths[counter_id] = width
        if self.counter_mode == "edge_set":
            self._counters.setdefault(counter_id, set())
        else:
            self._counters.setdefault(counter_id, 0)

    def _record_edge_locked(self, counter_id: str, edge_id: str) -> int:
        """Record a satisfied in-edge; return the new count. Caller must
        hold ``_counter_lock`` (shared by both fan-in protocols so the
        edge_set/INCR semantics can never diverge between them)."""
        cur = self._counters.get(counter_id)
        if cur is None:
            cur = set() if self.counter_mode == "edge_set" else 0
        if self.counter_mode == "edge_set":
            assert isinstance(cur, set)
            cur = cur | {edge_id}
            self._counters[counter_id] = cur
            return len(cur)
        count = int(cur) + 1
        self._counters[counter_id] = count
        return count

    def increment_dependency_g(self, counter_id: str, edge_id: str) -> Any:
        """Atomically record a satisfied in-edge; return the new count.

        ``edge_id`` identifies the in-edge being satisfied. In ``paper``
        mode it is ignored (plain INCR). The caller compares the returned
        count against the fan-in width: equal -> it is the last arriver
        and continues through the fan-in; less -> it stores its outputs
        and stops (nobody ever waits).
        """
        yield ("charge", self.cost.kv_base_ms)
        with self._counter_lock:
            count = self._record_edge_locked(counter_id, edge_id)
        self._bump(incrs=1)
        return count

    def increment_dependency(self, counter_id: str, edge_id: str) -> int:
        return run_effects(
            self.clock, self.increment_dependency_g(counter_id, edge_id))

    def deposit_and_increment_g(
        self,
        counter_id: str,
        edge_id: str,
        items: "dict[str, Any]",
        expected: "tuple[str, ...]" = (),
    ) -> Any:
        """Atomic fan-in arrival with delayed I/O (the optimizer's
        clustering pass; Wukong follow-up's locality optimization).

        Records ``edge_id`` on the dependency counter and — unless this
        arrival completes the fan-in — persists ``items`` (the caller's
        locally-held input objects) in the *same* round trip, saving the
        separate ``set`` round trip of the classic publish-then-increment
        protocol. The completing arrival skips the write entirely: its
        objects stay in executor memory and never touch the network.
        Items above the striping threshold are persisted striped, same as
        ``put``.

        ``expected`` lists keys the caller will need if it completes the
        fan-in; the keys among them absent from the store are reported
        back in the same reply (no extra round trip), so a completing
        arrival can detect inputs that exist only in another invocation's
        memory (retried/coalesced executors) and defer.

        Counters must be registered (width known) for the completing
        arrival to be detected; unregistered counters always store, which
        degrades gracefully to the classic protocol. Edge-set mode keeps
        the op idempotent: a retried arrival on a recorded edge re-reads
        the same count, and its stores are if-absent.
        Returns ``(count, missing_expected_keys)``.
        """
        yield ("charge", self.cost.kv_base_ms)  # one combined round trip
        # Sizes are derived BEFORE the counter lock: the recursive sizeof
        # walk of every item must not serialize the whole job's fan-in
        # protocol (every arrival in the job takes this lock).
        sized = {key: sizeof(value) for key, value in items.items()}
        stored: list[tuple[str, int, int]] = []  # key, nbytes, n_stripes
        missing: list[str] = []
        with self._counter_lock:
            width = self._counter_widths.get(counter_id)
            count = self._record_edge_locked(counter_id, edge_id)
            completing = width is not None and count >= width
            if not completing:
                # Store before the increment becomes visible to the
                # completing arrival (it reads these keys right after).
                for key, value in items.items():
                    home = self._shard(key)
                    with home.lock:
                        if key in home.data:
                            continue
                    nbytes = sized[key]
                    n_stripes = self.stripes_for(nbytes)
                    if n_stripes > 1:
                        layout = self._stripe_layout(key, nbytes, n_stripes)
                        for shard_idx, skey, snb in layout:
                            s = self.shards[shard_idx]
                            with s.lock:
                                s.data.setdefault(skey, _Stripe(snb))
                        with home.lock:
                            if key in home.data:
                                continue
                            home.data[key] = _StripeManifest(
                                value, nbytes, n_stripes)
                    else:
                        with home.lock:
                            if key in home.data:
                                continue
                            home.data[key] = _Entry(value, nbytes)
                    stored.append((key, nbytes, n_stripes))
            for key in expected:
                shard = self._shard(key)
                with shard.lock:
                    if key not in shard.data:
                        missing.append(key)
        self._bump(
            incrs=1,
            puts=len(stored),
            striped_puts=sum(1 for _, _, n in stored if n > 1),
            bytes_written=sum(nb for _, nb, _ in stored),
        )
        for key, nbytes, _ in stored:
            self._notify_write(key, nbytes)
        # Transfer time is charged outside the counter lock: the bytes are
        # already durable; only the simulated clock accounting remains.
        for key, nbytes, n_stripes in stored:
            if n_stripes > 1:
                yield from self._charge_striped_transfer_g(
                    self._stripe_layout(key, nbytes, n_stripes))
                continue
            t_ms = self.cost.transfer_ms(nbytes)
            if t_ms > 0:
                lane = self._shard(key).lane
                yield ("acquire", lane)
                try:
                    yield ("charge", t_ms)
                finally:
                    lane.release()
        return count, missing

    def deposit_and_increment(
        self,
        counter_id: str,
        edge_id: str,
        items: "dict[str, Any]",
        expected: "tuple[str, ...]" = (),
    ) -> "tuple[int, list[str]]":
        return run_effects(self.clock, self.deposit_and_increment_g(
            counter_id, edge_id, items, expected))

    def counter_value(self, counter_id: str) -> int:
        with self._counter_lock:
            cur = self._counters.get(counter_id, 0)
            return len(cur) if isinstance(cur, set) else int(cur)

    def rebind_counter(self, counter_id: str, width: int) -> None:
        """Host-side (uncharged) reset of a counter to a new width with
        no recorded edges. Used when a dynamic-DAG expansion rebinds a
        task key to the tail of its expansion subgraph: the key's fan-in
        is now the subgraph's, and the edges satisfied under the OLD
        binding must not count toward it. Uncharged by design — the
        batched ``register_counters_g`` round trip at job start already
        paid for registration, and counter ids never affect per-op
        charges, so charge parity with a statically pre-expanded graph
        is preserved (see repro_torch.core.dag.DynamicDAG)."""
        with self._counter_lock:
            self._counter_widths[counter_id] = width
            if self.counter_mode == "edge_set":
                self._counters[counter_id] = set()
            else:
                self._counters[counter_id] = 0

    # -- pub/sub (paper §III-B) ---------------------------------------------
    def subscribe(self, channel: str) -> Any:
        """Returns a ``queue.Queue``-compatible subscription (clock-aware
        in virtual mode, so blocked subscribers never hold back virtual
        time). Callers MUST :meth:`unsubscribe` the returned queue when
        done — on a substrate that outlives one job, an abandoned
        subscription is a leak: it accumulates in ``_channels`` forever
        and every later ``publish`` still fans out to it."""
        q = self.clock.queue()
        with self._chan_lock:
            self._channels.setdefault(channel, []).append(q)
        return q

    def unsubscribe(self, channel: str, q: Any) -> None:
        """Release a subscription returned by :meth:`subscribe`. The
        channel entry is dropped once its last subscriber leaves, so a
        torn-down job leaves ``_channels`` exactly as it found it.
        Idempotent: unsubscribing twice (or a queue that was never
        subscribed) is a no-op."""
        with self._chan_lock:
            subs = self._channels.get(channel)
            if subs is None:
                return
            try:
                subs.remove(q)
            except ValueError:
                return
            if not subs:
                del self._channels[channel]

    def subscriber_count(self, channel: str | None = None,
                         prefix: str = "") -> int:
        """Live subscriptions on ``channel`` (channels starting with
        ``prefix`` when None; every channel by default) — the
        leak-regression observable for teardown tests."""
        with self._chan_lock:
            if channel is not None:
                return len(self._channels.get(channel, ()))
            return sum(len(subs) for ch, subs in self._channels.items()
                       if ch.startswith(prefix))

    def publish_g(self, channel: str, message: Any) -> Any:
        yield ("charge", self.cost.pubsub_msg_ms)
        with self._chan_lock:
            subs = list(self._channels.get(channel, ()))
        for q in subs:
            q.put(message)
        self._bump(publishes=1)

    def publish(self, channel: str, message: Any) -> None:
        run_effects(self.clock, self.publish_g(channel, message))

    # -- journals ----------------------------------------------------------
    def journal_append_g(self, journal: str, entry: Any,
                         nbytes: int | None = None) -> Any:
        """Append ``entry`` to the named event journal. Charged like a
        small put to the journal's home shard (base round trip + lane
        transfer), because durability is not free — the control plane
        pays the same store it shares with the data plane. Returns the
        entry's sequence number (0-based)."""
        if nbytes is None:
            nbytes = sizeof(entry)
        yield from self._pay_g(self._shard(journal), nbytes)
        with self._journal_lock:
            log = self._journals.setdefault(journal, [])
            seq = len(log)
            log.append((entry, nbytes))
        self._bump(journal_appends=1, bytes_written=nbytes)
        return seq

    def journal_append(self, journal: str, entry: Any,
                       nbytes: int | None = None) -> int:
        return run_effects(self.clock,
                           self.journal_append_g(journal, entry, nbytes))

    def journal_scan_g(self, journal: str) -> Any:
        """Read the full journal in append order. Charged one base round
        trip plus the transfer of every recorded entry — replay cost
        grows with journal length, which is exactly the recovery-time
        observable fig17 sweeps. Missing journal reads as empty (a fresh
        control plane has nothing to replay)."""
        with self._journal_lock:
            log = list(self._journals.get(journal, ()))
        total = sum(nb for _, nb in log)
        yield from self._pay_g(self._shard(journal), total)
        self._bump(journal_scans=1, bytes_read=total)
        return [entry for entry, _ in log]

    def journal_scan(self, journal: str) -> list[Any]:
        return run_effects(self.clock, self.journal_scan_g(journal))

    def journal_len(self, journal: str) -> int:
        """Host-side (uncharged) journal length — an observability probe,
        not a simulated op."""
        with self._journal_lock:
            return len(self._journals.get(journal, ()))

    # -- bulk --------------------------------------------------------------
    def mget_g(self, keys: Iterable[str]) -> Any:
        """Pipelined multi-get: keys are grouped by shard and each shard
        batch pays ONE ``kv_base_ms`` round trip (Lambada-style batching
        of small requests); transfer time is still charged per lane.
        Returns values in input order."""
        keys = list(keys)
        by_shard: dict[int, list[str]] = {}
        queued: set[str] = set()
        for k in keys:
            if k not in queued:
                queued.add(k)
                by_shard.setdefault(self._shard_index(k), []).append(k)
        entries: dict[str, Any] = {}
        striped: list[tuple[str, Any]] = []
        total_bytes = 0
        n_striped = 0
        for idx in sorted(by_shard):
            shard = self.shards[idx]
            yield ("charge", self.cost.kv_base_ms)  # one RT per shard batch
            with shard.lock:
                for k in by_shard[idx]:
                    if k not in shard.data:
                        raise KeyError(k)
                    entries[k] = shard.data[k]
            batch_bytes = 0
            for k in by_shard[idx]:
                e = entries[k]
                if isinstance(e, _StripeManifest):
                    striped.append((k, e))
                    n_striped += 1
                else:
                    batch_bytes += e.nbytes
                total_bytes += e.nbytes
            t_ms = self.cost.transfer_ms(batch_bytes)
            if t_ms > 0:
                yield ("acquire", shard.lane)
                try:
                    yield ("charge", t_ms)
                finally:
                    shard.lane.release()
        for k, manifest in striped:
            yield from self._charge_striped_transfer_g(
                self._stripe_layout(k, manifest.nbytes, manifest.n_stripes))
        self._bump(gets=len(queued), striped_gets=n_striped,
                   mget_batches=len(by_shard), bytes_read=total_bytes)
        return [entries[k].value for k in keys]

    def mget(self, keys: Iterable[str]) -> list[Any]:
        return run_effects(self.clock, self.mget_g(keys))

    def reset_stats(self) -> None:
        with self._stats_lock:
            self.stats = KVStats()

    def qualified_key(self, key: str) -> str:
        """The store-global form of ``key`` as seen through this view —
        the identity here; ``KVNamespace`` prefixes. Container caches
        key on this, so bare keys of different jobs never collide."""
        return key

    # -- write notifications (trigger bus event source) ---------------------
    def add_write_listener(self, fn: Any) -> None:
        """Register ``fn(key, nbytes)`` to run host-side after every
        durable object write, with the store-qualified key. Idempotent.
        Listeners must be cheap and must not perform charged KV ops —
        they run inside the writer's op, after its charges."""
        if fn not in self._write_listeners:
            self._write_listeners.append(fn)

    def remove_write_listener(self, fn: Any) -> None:
        """Deregister a write listener (no-op when absent)."""
        try:
            self._write_listeners.remove(fn)
        except ValueError:
            pass

    def _notify_write(self, key: str, nbytes: int) -> None:
        for fn in tuple(self._write_listeners):
            fn(key, nbytes)

    # -- multi-tenancy ------------------------------------------------------
    def add_purge_listener(self, fn: Any) -> None:
        """Register ``fn(prefix)`` to run after ``drop_namespace``
        removes a namespace's objects (idempotent: re-registering the
        same callable is a no-op)."""
        if fn not in self._purge_listeners:
            self._purge_listeners.append(fn)

    def namespace(self, name: str) -> "KVNamespace":
        """A per-job view of this store: keys, counter ids, and pub/sub
        channels are prefixed with ``name`` and the view keeps its own
        :class:`KVStats`. Shards, transfer lanes, and the clock are
        shared — which is exactly how concurrent jobs contend. The name
        is registered so placement hashing can strip it (and ONLY
        registered prefixes)."""
        view = KVNamespace(self, name)
        with self._ns_lock:
            self._namespaces.add(name)
        return view

    def drop_namespace(self, name: str) -> int:
        """Host-side reclamation of a finished job's namespaced state:
        every object (incl. stripe records), fan-in counter, and channel
        under ``name`` is removed; returns the number of objects
        dropped. On a substrate that outlives jobs this is what keeps
        store memory O(concurrent jobs) instead of O(total traffic) —
        the provider reclaiming a job's intermediates, so it charges
        nothing on the clock. A straggling executor of the dropped job
        may re-create a few entries afterwards (its writes are
        if-absent); the stop signal bounds that residue to the job's
        in-flight work."""
        prefix = name + NAMESPACE_SEP
        removed = 0
        for shard in self.shards:
            with shard.lock:
                doomed = [k for k in shard.data if k.startswith(prefix)]
                for k in doomed:
                    del shard.data[k]
                removed += len(doomed)
        with self._counter_lock:
            for cid in [c for c in self._counters if c.startswith(prefix)]:
                del self._counters[cid]
            for cid in [c for c in self._counter_widths
                        if c.startswith(prefix)]:
                del self._counter_widths[cid]
        with self._chan_lock:
            for ch in [c for c in self._channels if c.startswith(prefix)]:
                # Release still-subscribed queues, not just the channel
                # entry: a consumer blocked on a dropped channel would
                # otherwise wait forever (nobody can publish to it again)
                # and its subscription would read as a leak. The PURGED
                # sentinel wakes it so it can exit and the subscriber
                # count under the dropped prefix really ends at 0.
                for q in self._channels[ch]:
                    q.put(PURGED)
                del self._channels[ch]
        with self._journal_lock:
            for j in [j for j in self._journals if j.startswith(prefix)]:
                del self._journals[j]
        # Same reclamation, one layer out: container-resident cache
        # entries of the dropped job (keyed store-qualified) must go
        # too, or a recycled warm container could serve a stale object
        # to a later job reusing the bare key.
        for fn in tuple(self._purge_listeners):
            fn(prefix)
        return removed


class KVNamespace:
    """A job-scoped view over a shared :class:`ShardedKVStore`.

    Engine-compatible: exposes the same op surface the executors and
    schedulers use, rewriting every key / counter id / channel to
    ``"<name>::<key>"`` before delegating, and keeping its OWN stats so
    a JobReport built from a shared store never includes another job's
    traffic. All *costs* (clock charges, lane occupancy) hit the shared
    substrate — the view renames, it does not isolate performance.
    """

    def __init__(self, parent: ShardedKVStore, name: str):
        if NAMESPACE_SEP in name:
            raise ValueError(f"namespace may not contain {NAMESPACE_SEP!r}")
        self.parent = parent
        self.name = name
        self._prefix = name + NAMESPACE_SEP
        self.cost = parent.cost
        self.clock = parent.clock
        self.counter_mode = parent.counter_mode
        self.stats = KVStats()
        self._stats_lock = threading.Lock()

    def _k(self, key: str) -> str:
        return self._prefix + key

    def qualified_key(self, key: str) -> str:
        """Store-global key form (see ``ShardedKVStore.qualified_key``);
        container caches use it so jobs never collide on bare keys."""
        return self._k(key)

    def _bump(self, **fields: int) -> None:
        with self._stats_lock:
            st = self.stats
            for name, delta in fields.items():
                setattr(st, name, getattr(st, name) + delta)

    # -- object store -------------------------------------------------------
    def put_g(self, key: str, value: Any, nbytes: int | None = None) -> Any:
        with _SinkScope(self):
            yield from self.parent.put_g(self._k(key), value, nbytes)

    def put(self, key: str, value: Any, nbytes: int | None = None) -> None:
        run_effects(self.clock, self.put_g(key, value, nbytes))

    def put_if_absent_g(self, key: str, value: Any,
                        nbytes: int | None = None) -> Any:
        with _SinkScope(self):
            return (yield from self.parent.put_if_absent_g(
                self._k(key), value, nbytes))

    def put_if_absent(self, key: str, value: Any,
                      nbytes: int | None = None) -> bool:
        return run_effects(self.clock,
                           self.put_if_absent_g(key, value, nbytes))

    def get_g(self, key: str) -> Any:
        with _SinkScope(self):
            try:
                return (yield from self.parent.get_g(self._k(key)))
            except KeyError:
                raise KeyError(key) from None

    def get(self, key: str) -> Any:
        return run_effects(self.clock, self.get_g(key))

    def exists(self, key: str) -> bool:
        return self.parent.exists(self._k(key))

    def delete(self, key: str) -> None:
        self.parent.delete(self._k(key))

    def mget_g(self, keys: Iterable[str]) -> Any:
        with _SinkScope(self):
            return (yield from self.parent.mget_g(
                [self._k(k) for k in keys]))

    def mget(self, keys: Iterable[str]) -> list[Any]:
        return run_effects(self.clock, self.mget_g(keys))

    def stripes_for(self, nbytes: int) -> int:
        return self.parent.stripes_for(nbytes)

    # -- fan-in counters ----------------------------------------------------
    def register_counter_g(self, counter_id: str, width: int) -> Any:
        yield from self.parent.register_counter_g(self._k(counter_id), width)

    def register_counter(self, counter_id: str, width: int) -> None:
        run_effects(self.clock, self.register_counter_g(counter_id, width))

    def register_counters_g(self, widths: Mapping[str, int]) -> Any:
        yield from self.parent.register_counters_g(
            {self._k(cid): width for cid, width in widths.items()})

    def register_counters(self, widths: Mapping[str, int]) -> None:
        run_effects(self.clock, self.register_counters_g(widths))

    def increment_dependency_g(self, counter_id: str, edge_id: str) -> Any:
        with _SinkScope(self):
            return (yield from self.parent.increment_dependency_g(
                self._k(counter_id), edge_id))

    def increment_dependency(self, counter_id: str, edge_id: str) -> int:
        return run_effects(
            self.clock, self.increment_dependency_g(counter_id, edge_id))

    def deposit_and_increment_g(
        self,
        counter_id: str,
        edge_id: str,
        items: "dict[str, Any]",
        expected: "tuple[str, ...]" = (),
    ) -> Any:
        with _SinkScope(self):
            count, missing = yield from self.parent.deposit_and_increment_g(
                self._k(counter_id),
                edge_id,
                {self._k(k): v for k, v in items.items()},
                tuple(self._k(k) for k in expected),
            )
        plen = len(self._prefix)
        return count, [k[plen:] for k in missing]

    def deposit_and_increment(
        self,
        counter_id: str,
        edge_id: str,
        items: "dict[str, Any]",
        expected: "tuple[str, ...]" = (),
    ) -> "tuple[int, list[str]]":
        return run_effects(self.clock, self.deposit_and_increment_g(
            counter_id, edge_id, items, expected))

    def counter_value(self, counter_id: str) -> int:
        return self.parent.counter_value(self._k(counter_id))

    def rebind_counter(self, counter_id: str, width: int) -> None:
        self.parent.rebind_counter(self._k(counter_id), width)

    # -- pub/sub ------------------------------------------------------------
    def subscribe(self, channel: str) -> Any:
        return self.parent.subscribe(self._k(channel))

    def unsubscribe(self, channel: str, q: Any) -> None:
        self.parent.unsubscribe(self._k(channel), q)

    def subscriber_count(self, channel: str | None = None) -> int:
        """THIS view's live subscriptions only: with ``channel=None``
        the count covers the namespace's channels, never another job's."""
        if channel is not None:
            return self.parent.subscriber_count(self._k(channel))
        return self.parent.subscriber_count(None, prefix=self._prefix)

    def purge(self) -> int:
        """Reclaim everything this view ever stored (see
        ``ShardedKVStore.drop_namespace``)."""
        return self.parent.drop_namespace(self.name)

    def publish_g(self, channel: str, message: Any) -> Any:
        with _SinkScope(self):
            yield from self.parent.publish_g(self._k(channel), message)

    def publish(self, channel: str, message: Any) -> None:
        run_effects(self.clock, self.publish_g(channel, message))

    # -- journals ------------------------------------------------------------
    def journal_append_g(self, journal: str, entry: Any,
                         nbytes: int | None = None) -> Any:
        with _SinkScope(self):
            return (yield from self.parent.journal_append_g(
                self._k(journal), entry, nbytes))

    def journal_append(self, journal: str, entry: Any,
                       nbytes: int | None = None) -> int:
        return run_effects(self.clock,
                           self.journal_append_g(journal, entry, nbytes))

    def journal_scan_g(self, journal: str) -> Any:
        with _SinkScope(self):
            return (yield from self.parent.journal_scan_g(self._k(journal)))

    def journal_scan(self, journal: str) -> list[Any]:
        return run_effects(self.clock, self.journal_scan_g(journal))

    def journal_len(self, journal: str) -> int:
        return self.parent.journal_len(self._k(journal))

    # -- stats --------------------------------------------------------------
    def reset_stats(self) -> None:
        with self._stats_lock:
            self.stats = KVStats()
