"""Stateful serverless-platform model (warm pool, throttling, billing).

Replaces the memoryless ``CostModel.warm_fraction`` coin flip with a
platform that has *state*: a warm-container pool with keep-alive expiry
on the engine clock, an account concurrency limit with a burst ramp
(429-style throttling retried with charged exponential backoff), and a
billing meter charging per-request fees plus GB-seconds — with the
memory size doubling as the compute-speed knob, so cost and latency
genuinely trade off (the ServerMix / Lambada economics the paper's
pay-per-use premise rests on).

Enable it by setting ``platform=PlatformConfig(...)`` on an engine
config; ``platform=None`` (the default) keeps the legacy stochastic
draw for cross-checks.
"""
from repro_torch.platform.billing import BillingMeter
from repro_torch.platform.config import PlatformConfig
from repro_torch.platform.model import (
    DEFAULT_FUNCTION,
    ComputeScaledClock,
    FaaSPlatform,
)
from repro_torch.platform.pool import ContainerPool
from repro_torch.platform.throttle import ConcurrencyThrottle

__all__ = [
    "BillingMeter",
    "ComputeScaledClock",
    "ConcurrencyThrottle",
    "ContainerPool",
    "DEFAULT_FUNCTION",
    "FaaSPlatform",
    "PlatformConfig",
]
