"""Durable job lifecycle state machine (the control plane's source of
truth).

The orchestrator used to hold every job's lifecycle in process memory,
so an orchestrator crash lost all of it. Following Triggerflow's
event-sourcing design (PAPERS.md, arxiv 2006.08654) and the
rmhgeoapi CoreMachine template, job state now lives in the shared
:class:`ShardedKVStore` as an append-only journal under a control-plane namespace:

    PENDING -> ADMITTED -> RUNNING -> {COMPLETED, FAILED, CANCELLED}

Transitions are **monotonic** (a journal entry can only move a job to a
strictly higher lifecycle rank; the first terminal state wins) and
therefore **replay-safe**: replaying the journal any number of times,
with any suffix of duplicate entries, folds to the same state. That is
what lets a fresh orchestrator instance recover from a crash by
scanning the journal — duplicates appended by the crashed generation
are no-ops, not corruption.

Every append and scan is charged through the normal KV cost model
(`journal_append_g` / `journal_scan_g`): durability is a real cost the
control plane pays on the same store the data plane contends for.

Task-level lifecycle is deliberately NOT journaled per-transition: task
durability already comes from the data plane's idempotent primitives
(``put_if_absent`` task outputs, edge-set fan-in counters), so a
resumed job re-walks its DAG and skips any task whose durable output
exists. Journaling only job-level transitions keeps the journal
O(jobs), not O(tasks).
"""
from __future__ import annotations

import threading
from typing import Any

from .kvstore import KVNamespace, ShardedKVStore

# Lifecycle states.
PENDING = "PENDING"        # submitted, journaled, not yet admitted
ADMITTED = "ADMITTED"      # passed admission control
RUNNING = "RUNNING"        # runner actor dispatched
COMPLETED = "COMPLETED"    # terminal: finished, results recorded
FAILED = "FAILED"          # terminal: job raised
CANCELLED = "CANCELLED"    # terminal: cancelled before/while running

TERMINAL_STATES = frozenset((COMPLETED, FAILED, CANCELLED))

_RANK = {PENDING: 0, ADMITTED: 1, RUNNING: 2,
         COMPLETED: 3, FAILED: 3, CANCELLED: 3}

# The control plane's reserved namespace in the shared store. Job
# namespaces are "job<N>", tenants are "t-*"/"tenant-*"; the dunder
# prefix keeps it collision-free.
CONTROL_NS = "__control__"

# Journal id within the control namespace.
JOB_JOURNAL = "journal"


class InvalidTransition(ValueError):
    """An entry names a state outside the lifecycle lattice."""


def check_state(state: str) -> None:
    if state not in _RANK:
        raise InvalidTransition(
            f"unknown lifecycle state {state!r}; "
            f"expected one of {sorted(_RANK)}")


class JobStateMachine:
    """Event-sourced view of every job's lifecycle state.

    All mutation goes through :meth:`record_g`, which journals the
    transition (charged) before applying it to the in-memory fold; the
    in-memory dicts are always a pure fold of the journal, so a crashed
    orchestrator's successor rebuilds exactly this object with
    :meth:`replay_g`.
    """

    def __init__(self, ctrl_kv: "KVNamespace | ShardedKVStore"):
        self.kv = ctrl_kv
        self._lock = threading.Lock()
        self._states: dict[int, str] = {}
        # Latest payload per (job_id, state) — e.g. the reconstructible
        # job spec at PENDING, the completion record at COMPLETED.
        self._payloads: dict[tuple[int, str], Any] = {}

    # -- read side ---------------------------------------------------------
    def state(self, job_id: int) -> str | None:
        with self._lock:
            return self._states.get(job_id)

    def payload(self, job_id: int, state: str) -> Any:
        with self._lock:
            return self._payloads.get((job_id, state))

    def jobs(self) -> dict[int, str]:
        with self._lock:
            return dict(self._states)

    def is_terminal(self, job_id: int) -> bool:
        return self.state(job_id) in TERMINAL_STATES

    # -- fold --------------------------------------------------------------
    def _apply(self, job_id: int, state: str, payload: Any) -> bool:
        """Fold one entry into the in-memory state. Returns False (and
        changes nothing) when the entry does not advance the job's
        rank — the idempotence that makes replay safe."""
        check_state(state)
        with self._lock:
            cur = self._states.get(job_id)
            if cur is not None and _RANK[state] <= _RANK[cur]:
                return False  # duplicate / regression / second terminal
            self._states[job_id] = state
            if payload is not None:
                self._payloads[(job_id, state)] = payload
            return True

    # -- write side --------------------------------------------------------
    def record_g(self, job_id: int, state: str, at_ms: float = 0.0,
                 payload: Any = None) -> Any:
        """Journal-then-apply one lifecycle transition (charged). A
        non-advancing transition is a no-op that is NOT journaled —
        recovery re-drives jobs through the same code path and must not
        grow the journal with duplicates. Returns True iff the job's
        state advanced."""
        check_state(state)
        with self._lock:
            cur = self._states.get(job_id)
            advances = cur is None or _RANK[state] > _RANK[cur]
        if not advances:
            return False
        entry = {"job_id": job_id, "state": state, "at_ms": at_ms}
        if payload is not None:
            entry["payload"] = payload
        yield from self.kv.journal_append_g(JOB_JOURNAL, entry)
        # Re-fold under the lock (another actor may have advanced the
        # job between the check and the append; _apply re-validates).
        self._apply(job_id, state, payload)
        return True

    def replay_g(self) -> Any:
        """Rebuild state from the journal (charged scan). Returns the
        number of entries folded. Safe to call on a machine that already
        holds state: non-advancing entries are skipped."""
        entries = yield from self.kv.journal_scan_g(JOB_JOURNAL)
        for e in entries:
            self._apply(e["job_id"], e["state"], e.get("payload"))
        return len(entries)

    def journal_len(self) -> int:
        return self.kv.journal_len(JOB_JOURNAL)
