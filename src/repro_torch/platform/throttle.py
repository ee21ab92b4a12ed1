"""Account-level concurrency throttling with a burst ramp.

AWS rejects invocations beyond the account's concurrent-execution
limit with a 429 ``TooManyRequestsException``; the SDK retries with
exponential backoff. The *effective* limit is not flat: a fresh
account starts from a burst allowance and gains capacity over time
(documented as +500 concurrent executions per minute) until the
account cap is reached — which is what reshapes mega-fan-outs
(Lambada's observation: provider rate limits bound the usable width
of a serverless scan).

The throttle only admits/rejects; the *retry* (a charged exponential
backoff on the engine clock, shared with faults.py) is driven by the
invoker lane, so a throttled invocation delays the lane exactly like a
slow invoke API call would.
"""
from __future__ import annotations

import threading

from repro_torch.core.faults import exponential_backoff_ms
from repro_torch.core.simclock import BaseClock
from repro_torch.platform.config import PlatformConfig


class ConcurrencyThrottle:
    """Tracks in-flight invocations against the time-ramped limit."""

    def __init__(self, config: PlatformConfig, clock: BaseClock):
        self.config = config
        self.clock = clock
        self._lock = threading.Lock()
        self.active = 0
        self.peak_concurrency = 0
        self.throttle_events = 0

    def limit_now(self) -> int:
        """Concurrency admitted at the current clock time: the burst
        allowance plus the ramp, capped by the account limit."""
        cfg = self.config
        ramped = cfg.burst_concurrency + int(
            cfg.burst_ramp_per_min * self.clock.now_ms() / 60_000.0
        )
        return min(cfg.account_concurrency, ramped)

    def try_reserve(self) -> bool:
        """Admit one invocation, or record a 429 and refuse."""
        limit = self.limit_now()
        with self._lock:
            if self.active >= limit:
                self.throttle_events += 1
                return False
            self.active += 1
            if self.active > self.peak_concurrency:
                self.peak_concurrency = self.active
            return True

    def release(self) -> None:
        with self._lock:
            self.active -= 1

    def backoff_ms(self, attempt: int) -> float:
        """Charged retry delay for the ``attempt``-th consecutive 429 —
        the same exponential schedule Lambda-retry uses in faults.py."""
        return exponential_backoff_ms(
            self.config.throttle_backoff_base_ms,
            attempt,
            cap_ms=self.config.throttle_backoff_cap_ms,
        )
