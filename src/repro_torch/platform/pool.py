"""Warm-container pool: the platform's container-reuse state machine.

An invocation of function F either reuses an idle warm container of F
(no cold start) or provisions a cold one. A container released by a
finishing invocation parks in the idle pool and expires ``keep_alive_s``
simulated seconds later — expiry is evaluated lazily against the engine
clock on the next acquire, so no reaper actor is needed and the pool
stays deterministic under the virtual clock.

Reuse is LIFO (most-recently-released container first), matching
observed FaaS behavior: a steady trickle of traffic keeps one hot
container alive while the rest of the fleet ages out.
"""
from __future__ import annotations

import threading
from typing import Callable

from repro_torch.core.simclock import BaseClock
from repro_torch.platform.config import PlatformConfig


class ContainerPool:
    """Per-function idle-container stacks keyed on the engine clock."""

    def __init__(self, config: PlatformConfig, clock: BaseClock):
        self.config = config
        self.clock = clock
        self._lock = threading.Lock()
        # function -> stack of (expiry_deadline_ms, container_id); LIFO
        # reuse means the top of the stack has the latest expiry, so
        # expired containers accumulate at the bottom.
        self._idle: dict[str, list[tuple[float, int]]] = {}
        self._next_id = 0
        self.cold_starts = 0
        self.warm_reuses = 0
        self.expired = 0
        # Notified with (function, container_id) when a container is
        # reclaimed (keep-alive expiry, or zero keep-alive). The
        # platform points this at its cache registry so a container's
        # cache dies with the container.
        self.on_expire: "Callable[[str, int], None] | None" = None

    def prewarm(self, function: str, n: int) -> None:
        """Provision ``n`` warm containers at the current clock time
        (the paper's §V-A pool warming). Prewarmed containers age out on
        the same keep-alive timer as any other idle container."""
        if n <= 0:
            return
        expiry = self.clock.now_ms() + self.config.keep_alive_s * 1e3
        with self._lock:
            stack = self._idle.setdefault(function, [])
            for _ in range(n):
                self._next_id += 1
                stack.append((expiry, self._next_id))

    def acquire(self, function: str,
                score: "Callable[[int], int] | None" = None,
                ) -> "tuple[int, bool]":
        """Assign a container for one invocation of ``function``.
        Returns ``(container_id, was_cold)``.

        ``score`` is the locality hint: a host-side callable rating each
        idle container (e.g. bytes of the invocation's inputs resident
        in its cache). The highest-scoring live container is taken;
        ties keep the LIFO choice, so a zero-information score degrades
        exactly to the default reuse order."""
        now = self.clock.now_ms()
        with self._lock:
            stack = self._idle.get(function)
            if stack:
                # Reap from the bottom: oldest releases expire first.
                while stack and stack[0][0] <= now:
                    _, dead = stack.pop(0)
                    self.expired += 1
                    if self.on_expire is not None:
                        self.on_expire(function, dead)
            if stack:
                idx = len(stack) - 1
                if score is not None and len(stack) > 1:
                    # max() keeps the first maximum; the index tiebreak
                    # makes that the most recently released container.
                    idx = max(range(len(stack)),
                              key=lambda i: (score(stack[i][1]), i))
                _, cid = stack.pop(idx)
                self.warm_reuses += 1
                return cid, False
            self._next_id += 1
            self.cold_starts += 1
            return self._next_id, True

    def release(self, function: str, container_id: int) -> None:
        """Return a container to the idle pool; it stays warm for
        ``keep_alive_s`` simulated seconds."""
        if self.config.keep_alive_s <= 0:
            # Immediately reclaimed: every invocation is cold, and any
            # container-resident state (cache) is reclaimed with it.
            if self.on_expire is not None:
                self.on_expire(function, container_id)
            return
        expiry = self.clock.now_ms() + self.config.keep_alive_s * 1e3
        with self._lock:
            self._idle.setdefault(function, []).append((expiry, container_id))

    def idle_count(self, function: str) -> int:
        now = self.clock.now_ms()
        with self._lock:
            stack = self._idle.get(function, [])
            return sum(1 for expiry, _ in stack if expiry > now)
