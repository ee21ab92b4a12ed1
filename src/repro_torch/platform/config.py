"""Knobs of the stateful serverless-platform model.

Defaults follow AWS Lambda's published numbers where they exist:

- pricing: $0.20 per 1M requests and $0.0000166667 per GB-second of
  billed duration (x86, us-east-1), billed at 1 ms granularity;
- keep-alive: idle containers are reclaimed after minutes of
  inactivity (observed ~5-10 min for lightly-used functions);
- concurrency: a 1000-concurrent-executions account limit, reached
  from an initial burst allowance that ramps up over time (AWS
  documents a +500/min ramp above the regional burst limit);
- memory/CPU coupling: Lambda allocates CPU *proportionally to
  memory* — 1792 MB buys one full vCPU — so the memory size is also
  the compute-speed knob, which is exactly what makes cost and
  latency genuinely trade off (ServerMix's core observation).

Everything is expressed in *simulated* time/money so the model stays
deterministic under the virtual clock.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cache import CacheConfig


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    """Configuration of the stateful FaaS platform model.

    Setting ``platform=PlatformConfig(...)`` on an engine config
    replaces the memoryless ``CostModel.warm_fraction`` coin flip with
    the stateful warm-container pool (the legacy draw remains the
    behavior when ``platform is None``).
    """

    # -- warm-container pool ------------------------------------------------
    keep_alive_s: float = 600.0       # idle container lifetime (simulated s)
    prewarm: int = 0                  # containers warmed before the job
    #                                   (paper §V-A warms a Lambda pool)
    # Executor-local multi-tier cache (repro_torch.core.cache): each container
    # keeps task outputs in modeled memory with disk spill, retained
    # across warm reuses and dropped on keep-alive expiry. None = the
    # cacheless data plane (every cross-executor edge pays the KV store).
    cache: CacheConfig | None = None

    # -- account concurrency + burst ramp -----------------------------------
    account_concurrency: int = 1000   # hard account-wide cap
    burst_concurrency: int = 500      # instantly available at t=0
    burst_ramp_per_min: float = 500.0  # additional slots granted per minute
    # Throttled (429) invocations retry with the charged exponential
    # backoff shared with faults.py (base * 2**attempt, capped).
    throttle_backoff_base_ms: float = 100.0
    throttle_backoff_cap_ms: float = 20_000.0

    # -- billing meter -------------------------------------------------------
    memory_mb: int = 1792             # billed memory size (also CPU share)
    baseline_memory_mb: int = 1792    # memory at which ms_per_flop-style
    #                                   compute declarations are calibrated
    price_per_request_usd: float = 0.20e-6
    price_per_gb_s_usd: float = 16.6667e-6
    billing_granularity_ms: float = 1.0

    def __post_init__(self) -> None:
        if self.memory_mb <= 0 or self.baseline_memory_mb <= 0:
            raise ValueError("memory sizes must be positive")
        if self.account_concurrency < 1 or self.burst_concurrency < 1:
            raise ValueError("concurrency limits must be >= 1")
        if self.billing_granularity_ms <= 0:
            raise ValueError("billing granularity must be positive")
        if self.throttle_backoff_base_ms <= 0:
            # A zero backoff would let a throttled invoker lane spin
            # without ever advancing the clock (virtual-mode livelock).
            raise ValueError("throttle backoff base must be positive")

    @property
    def compute_scale(self) -> float:
        """Multiplier on declared task-compute durations: CPU share is
        proportional to memory (1792 MB = one full vCPU), so half the
        memory runs compute twice as slow."""
        return self.baseline_memory_mb / self.memory_mb

    def billed_ms(self, duration_ms: float) -> float:
        """Round a raw duration up to the billing granularity."""
        gran = self.billing_granularity_ms
        units = -(-duration_ms // gran) if duration_ms > 0 else 0
        return units * gran

    def gb_s(self, billed_ms: float) -> float:
        return (self.memory_mb / 1024.0) * (billed_ms / 1e3)
