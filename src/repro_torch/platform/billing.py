"""Billing meter: per-request fees plus GB-seconds of billed duration.

An invocation's billed duration is the simulated time its container
spends executing the function body — measured as the sum of simulated-
latency charges made by the invocation's thread (``charge_meter`` in
repro_torch.core.simclock), NOT as a wall-clock delta. Charge sums are
identical in virtual and real-time clock modes (both modes charge the
same simulated amounts), so a job's billed cost is *bit-identical
across clock modes* — the cross-check tests rely on this. Like AWS,
the cold-start provisioning delay and the invoke API latency are not
billed as duration.

Multi-tenancy: each invocation is recorded against a ``key`` (the
platform function name — one per tenant under the orchestrator) with
that function's memory size, so one shared account meter can answer
"what does tenant T owe" (``per_key_snapshot``) as well as "what does
the account owe" (``snapshot``). Invocations additionally carry an
optional ``job`` label (the orchestrator passes the job's namespace
name), so ``per_job_snapshot`` can answer "what did job J cost" — the
attribution the durable control plane journals at job completion and
the crash-recovery tests audit against the uncrashed baseline.

Snapshots sum per-invocation GB-seconds in sorted record order so the
total is independent of the (thread-racy, in real-time mode) order in
which invocations complete.
"""
from __future__ import annotations

import threading

from repro_torch.platform.config import PlatformConfig


class BillingMeter:
    def __init__(self, config: PlatformConfig):
        self.config = config
        self._lock = threading.Lock()
        # one (key, job, billed_ms, memory_mb) record per invocation
        self._records: list[tuple[str, str, float, int]] = []

    def add_invocation(self, duration_ms: float, memory_mb: int | None = None,
                       key: str = "executor",
                       job: str | None = None) -> float:
        """Record one finished invocation; returns its billed ms.
        ``memory_mb`` defaults to the account-wide config size (the
        platform passes the invoked function's own size); ``job`` is an
        optional attribution label for ``per_job_snapshot``."""
        billed = self.config.billed_ms(duration_ms)
        mem = int(memory_mb) if memory_mb else self.config.memory_mb
        with self._lock:
            self._records.append((key, job or "", billed, mem))
        return billed

    @staticmethod
    def _gb_s(billed_ms: float, memory_mb: int) -> float:
        return (memory_mb / 1024.0) * (billed_ms / 1e3)

    def _totals(self,
                records: "list[tuple[str, str, float, int]]",
                ) -> dict[str, float]:
        cfg = self.config
        total_ms = sum(ms for _, _, ms, _ in records)
        gb_s = sum(self._gb_s(ms, mem) for _, _, ms, mem in records)
        requests = len(records)
        usd = (requests * cfg.price_per_request_usd
               + gb_s * cfg.price_per_gb_s_usd)
        return {
            "billed_requests": requests,
            "billed_duration_ms": total_ms,
            "billed_gb_s": gb_s,
            "billed_usd": usd,
        }

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            records = sorted(self._records)
        return self._totals(records)

    def per_key_snapshot(self) -> "dict[str, dict[str, float]]":
        """Account totals broken down by billing key (tenant function):
        key -> the same block ``snapshot`` returns. Freshly built on
        every call — callers may mutate the result freely."""
        with self._lock:
            records = sorted(self._records)
        by_key: dict[str, list[tuple[str, str, float, int]]] = {}
        for rec in records:
            by_key.setdefault(rec[0], []).append(rec)
        return {key: self._totals(recs) for key, recs in by_key.items()}

    def per_job_snapshot(self) -> "dict[str, dict[str, float]]":
        """Account totals broken down by job label (invocations recorded
        without one are grouped under ``""``). Same freshness contract
        as ``per_key_snapshot``."""
        with self._lock:
            records = sorted(self._records)
        by_job: dict[str, list[tuple[str, str, float, int]]] = {}
        for rec in records:
            by_job.setdefault(rec[1], []).append(rec)
        return {job: self._totals(recs) for job, recs in by_job.items()}

    def job_snapshot(self, job: str) -> dict[str, float]:
        """One job's bill (zeroed block when the job never invoked)."""
        with self._lock:
            records = sorted(r for r in self._records if r[1] == job)
        return self._totals(records)
