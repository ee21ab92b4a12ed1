"""Executor-local multi-tier cache (Wukong's locality enhancement).

The paper attributes Wukong's headline speedup on real DAG jobs to
*locality*: executors keep intermediate objects close and schedule their
own children, instead of round-tripping every cross-executor edge
through remote storage. This module models the storage side of that
claim as a three-tier hierarchy, per *container*:

- **tier 0** — in-container memory: a modeled capacity with LRU,
  size-aware eviction. Hits are free on the clock (the object is already
  in the invocation's address space).
- **tier 1** — local scratch disk: evicted tier-0 entries spill here and
  pay a charged write; a tier-1 hit pays a charged read and promotes the
  entry back to memory. Its capacity is modeled too; overflow is
  dropped (next stop: the KV store).
- **tier 2** — the shared :class:`~repro_torch.core.kvstore.ShardedKVStore`.
  This module never talks to it: a probe miss simply means the executor
  falls through to the (already charged) remote ``mget``/``get`` path.

A cache belongs to a *container*, not an invocation: the platform's
warm-container pool hands the same :class:`ExecutorCache` to every
invocation that reuses the container, so warm reuse carries data — a
real reason warm matters beyond skipping the cold start. A cold start
gets a fresh cache; keep-alive expiry drops the container's cache with
the container (``ContainerPool`` notifies the registry).

Every charged operation is an effect-protocol generator (``..._g``), so
costs land on the engine clock identically under the event and thread
substrates — cached runs stay bit-identical across substrates and
repeats, like every other charge in the system.

Keys are *store-qualified* (namespace prefix included): a container is
shared across the jobs of one platform function, so two jobs' bare keys
must never collide in its cache. ``ShardedKVStore.drop_namespace``
notifies registered purge listeners, and the registry drops the dead
job's entries from every container — a recycled warm container can
never serve a stale object to a later job (see tests/test_orchestrator).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Iterable


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Knobs of the executor-local cache hierarchy.

    ``memory_bytes=0`` disables tier 0 (every deposit falls through),
    ``disk_bytes=0`` disables tier 1 (memory evictions are dropped);
    both zero models a cacheless container while keeping the plumbing —
    charges are then bit-identical to ``PlatformConfig.cache=None``.
    """

    memory_bytes: int = 64 << 20       # tier-0 capacity per container
    disk_bytes: int = 512 << 20        # tier-1 spill capacity per container
    disk_base_ms: float = 0.1          # per-op local-disk latency
    disk_read_mbps: float = 200.0      # tier-1 read bandwidth (charged)
    disk_write_mbps: float = 100.0     # tier-1 spill-write bandwidth (charged)

    def __post_init__(self) -> None:
        if self.memory_bytes < 0 or self.disk_bytes < 0:
            raise ValueError("cache capacities must be >= 0")
        if self.disk_base_ms < 0:
            raise ValueError("disk_base_ms must be >= 0")
        if self.disk_read_mbps <= 0 or self.disk_write_mbps <= 0:
            raise ValueError("disk bandwidths must be positive")

    def disk_read_ms(self, nbytes: int) -> float:
        return self.disk_base_ms + nbytes / (self.disk_read_mbps * 1e6) * 1e3

    def disk_write_ms(self, nbytes: int) -> float:
        return self.disk_base_ms + nbytes / (self.disk_write_mbps * 1e6) * 1e3


@dataclasses.dataclass
class CacheStats:
    """Per-tier hit/miss/eviction counters plus bytes served per tier.

    Kept twice: each :class:`ExecutorCache` counts its own traffic
    (surfaced account-wide through the registry / platform snapshot),
    and executors pass a per-job sink so ``JobReport.cache_stats`` never
    includes another tenant's hits on a shared platform.
    """

    mem_hits: int = 0          # tier-0 hits (free on the clock)
    disk_hits: int = 0         # tier-1 hits (charged read + promotion)
    misses: int = 0            # fell through to the shared KV store
    deposits: int = 0          # outputs written into tier 0
    spills: int = 0            # tier-0 entries demoted to disk (charged)
    mem_evictions: int = 0     # entries pushed out of tier 0
    disk_evictions: int = 0    # entries dropped from tier 1
    bytes_local: int = 0       # bytes served from tier 0
    bytes_disk: int = 0        # bytes served from tier 1

    def snapshot(self) -> "dict[str, int]":
        return dataclasses.asdict(self)

    def add(self, other: "CacheStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


class ExecutorCache:
    """One container's memory → disk cache (tiers 0 and 1).

    Host-side mutation is atomic under ``_lock`` and happens *before*
    the charge is yielded, so a concurrent executor (or a retried task)
    always observes a fully inserted/spilled/evicted entry — never a
    half-spilled one. Charges are computed from the mutation and yielded
    once, keeping the op a single effect-protocol step.
    """

    def __init__(self, config: CacheConfig):
        self.config = config
        self._lock = threading.Lock()
        # key -> (value, nbytes); insertion order is LRU order (oldest
        # first) — move_to_end on every touch.
        self._mem: "OrderedDict[str, tuple[Any, int]]" = OrderedDict()
        self._disk: "OrderedDict[str, tuple[Any, int]]" = OrderedDict()
        self._mem_bytes = 0
        self._disk_bytes = 0
        self.stats = CacheStats()

    # -- host-side inspection (uncharged) -----------------------------------
    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._mem or key in self._disk

    def resident_bytes(self, keys: Iterable[str]) -> int:
        """Total bytes of ``keys`` resident in either tier — the
        locality score used for become-choice and warm-container
        placement (scheduler-side knowledge, so uncharged)."""
        total = 0
        with self._lock:
            for k in keys:
                entry = self._mem.get(k) or self._disk.get(k)
                if entry is not None:
                    total += entry[1]
        return total

    @property
    def mem_bytes(self) -> int:
        return self._mem_bytes

    @property
    def disk_bytes(self) -> int:
        return self._disk_bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem) + len(self._disk)

    # -- stats (call with _lock held) ---------------------------------------
    def _count(self, sink: "CacheStats | None", **fields: int) -> None:
        for target in (self.stats, sink):
            if target is None:
                continue
            for name, delta in fields.items():
                setattr(target, name, getattr(target, name) + delta)

    # -- charged operations (effect protocol) -------------------------------
    def probe_g(self, key: str, stats: "CacheStats | None" = None):
        """Look ``key`` up through the tiers. Returns ``(hit, value)``.

        Tier-0 hit: free. Tier-1 hit: charged disk read, and the entry is
        promoted back to memory (possibly spilling colder entries, whose
        writes are charged in the same step). Miss: free — the caller
        pays the remote fetch it was about to do anyway.
        """
        charge = 0.0
        with self._lock:
            entry = self._mem.get(key)
            if entry is not None:
                self._mem.move_to_end(key)
                self._count(stats, mem_hits=1, bytes_local=entry[1])
                return True, entry[0]
            entry = self._disk.get(key)
            if entry is not None:
                # Promote to tier 0: pay the disk read; the insert may
                # spill colder entries (charged writes, same step).
                del self._disk[key]
                self._disk_bytes -= entry[1]
                charge = self.config.disk_read_ms(entry[1])
                charge += self._insert_mem(key, entry[0], entry[1], stats)
                self._count(stats, disk_hits=1, bytes_disk=entry[1])
            else:
                self._count(stats, misses=1)
                return False, None
        yield ("charge", charge)
        return True, entry[0]

    def deposit_g(self, key: str, value: Any, nbytes: int,
                  stats: "CacheStats | None" = None):
        """Insert a task output into tier 0, spilling LRU entries to
        disk (charged writes) as the capacity demands. Depositing a key
        already resident refreshes it (LRU touch), charging nothing."""
        charge = 0.0
        with self._lock:
            self._count(stats, deposits=1)
            if key in self._mem:
                self._mem.move_to_end(key)
            else:
                if key in self._disk:
                    # Re-produced after a spill (e.g. a retry recomputed
                    # it): the fresh copy supersedes the spilled one.
                    _, old_n = self._disk.pop(key)
                    self._disk_bytes -= old_n
                charge = self._insert_mem(key, value, nbytes, stats)
        if charge > 0:
            yield ("charge", charge)
        return None

    # -- insertion / eviction internals (call with _lock held) ---------------
    def _insert_mem(self, key: str, value: Any, nbytes: int,
                    sink: "CacheStats | None") -> float:
        if nbytes > self.config.memory_bytes:
            # Too large for tier 0 outright: straight to disk (the
            # common case for capacity-0 configs, where it then also
            # fails the disk bound and is simply not cached).
            self._count(sink, mem_evictions=1)
            return self._insert_disk(key, value, nbytes, sink)
        self._mem[key] = (value, nbytes)
        self._mem_bytes += nbytes
        charge = 0.0
        while self._mem_bytes > self.config.memory_bytes:
            victim, (vval, vn) = self._mem.popitem(last=False)
            self._mem_bytes -= vn
            self._count(sink, mem_evictions=1)
            charge += self._insert_disk(victim, vval, vn, sink)
        return charge

    def _insert_disk(self, key: str, value: Any, nbytes: int,
                     sink: "CacheStats | None") -> float:
        if nbytes > self.config.disk_bytes:
            return 0.0  # exceeds the whole tier: not cached at all
        self._disk[key] = (value, nbytes)
        self._disk_bytes += nbytes
        self._count(sink, spills=1)
        while self._disk_bytes > self.config.disk_bytes:
            _, (_, vn) = self._disk.popitem(last=False)
            self._disk_bytes -= vn
            self._count(sink, disk_evictions=1)
        return self.config.disk_write_ms(nbytes)

    # -- reclamation (host-side, uncharged) ---------------------------------
    def invalidate_prefix(self, prefix: str) -> int:
        """Drop every entry under ``prefix`` (a finished job's
        namespace) from both tiers. Provider-side reclamation, like
        ``drop_namespace`` — charges nothing."""
        removed = 0
        with self._lock:
            for tier, attr in ((self._mem, "_mem_bytes"),
                               (self._disk, "_disk_bytes")):
                doomed = [k for k in tier if k.startswith(prefix)]
                for k in doomed:
                    _, n = tier.pop(k)
                    setattr(self, attr, getattr(self, attr) - n)
                removed += len(doomed)
        return removed

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._disk.clear()
            self._mem_bytes = 0
            self._disk_bytes = 0


class CacheRegistry:
    """All container caches of one platform, keyed ``(function, cid)``.

    The platform's warm pool decides container identity; the registry
    just makes the cache follow it: ``cache_for`` on (re)use, ``drop``
    when the pool expires or reclaims a container (its stats are folded
    into the retired accumulator so account-wide totals survive), and
    ``invalidate_prefix`` when a job's namespace is purged.
    """

    def __init__(self, config: CacheConfig):
        self.config = config
        self._lock = threading.Lock()
        self._caches: "dict[tuple[str, int], ExecutorCache]" = {}
        self._retired = CacheStats()

    def cache_for(self, function: str, container_id: int) -> ExecutorCache:
        key = (function, container_id)
        with self._lock:
            cache = self._caches.get(key)
            if cache is None:
                cache = ExecutorCache(self.config)
                self._caches[key] = cache
            return cache

    def get(self, function: str, container_id: int) -> "ExecutorCache | None":
        with self._lock:
            return self._caches.get((function, container_id))

    def drop(self, function: str, container_id: int) -> None:
        """The container is gone (keep-alive expiry / zero keep-alive
        reclamation): its cache dies with it."""
        with self._lock:
            cache = self._caches.pop((function, container_id), None)
            if cache is not None:
                self._retired.add(cache.stats)

    def invalidate_prefix(self, prefix: str) -> int:
        """Purge a finished job's entries from every container cache
        (registered as a ``ShardedKVStore`` purge listener)."""
        with self._lock:
            caches = list(self._caches.values())
        return sum(c.invalidate_prefix(prefix) for c in caches)

    def resident_bytes(self, function: str, container_id: int,
                       keys: Iterable[str]) -> int:
        cache = self.get(function, container_id)
        return cache.resident_bytes(keys) if cache is not None else 0

    def snapshot(self) -> "dict[str, Any]":
        """Account-wide cache counters: live + retired container stats,
        plus current residency. Fresh dict per call (the platform
        snapshot contract)."""
        with self._lock:
            caches = list(self._caches.values())
            total = CacheStats()
            total.add(self._retired)
        for c in caches:
            total.add(c.stats)
        out: "dict[str, Any]" = total.snapshot()
        out["containers"] = len(caches)
        out["resident_mem_bytes"] = sum(c.mem_bytes for c in caches)
        out["resident_disk_bytes"] = sum(c.disk_bytes for c in caches)
        return out
