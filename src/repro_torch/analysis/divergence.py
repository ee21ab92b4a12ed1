"""Runtime determinism sanitizer: effect-trace journaling + diffing.

The static lint (``repro_torch.analysis.effects``) catches the *sources* of
nondeterminism it can see syntactically; this module catches the ones
it can't, at runtime. In trace mode every effect an actor yields —
``("charge", ms)``, ``("get", q, t)``, … — is journaled as a
:class:`TraceEvent` ``(actor, seq, effect, charge, src)`` tuple, and
:func:`diff_traces` compares two journals (two runs of the same job, or
an EventClock run against a VirtualClock cross-check) and reports the
FIRST divergent event with the actor and source line that produced it
— turning "charged_ms differs in the 9th decimal" into "frame
invoker#12, kvstore.py:431, charged 3.07 vs 3.11".

Usage::

    clock = EventClock()
    clock.tracer = Tracer()          # opt-in: None (the default) is free
    engine.compute(dag, ...)
    trace_a = clock.tracer.events

    # ... second run, second tracer ...
    div = diff_traces(trace_a, trace_b)
    assert div is None, div.describe()

The hook is duck-typed: the substrates call ``tracer.record(actor,
effect, gen)`` on every freshly generated effect (replayed/deferred
effects are not re-recorded), so ``repro_torch.core.simclock`` never imports
this module. Event order is deterministic on both virtual substrates
(FIFO ready queues, (deadline, seq) timers), so two traced runs of a
deterministic job produce identical journals; the thread substrate
additionally interleaves *unrelated* actors' records under the OS
scheduler, which is what :func:`diff_traces`'s ``by_actor`` mode is
for — per-actor effect sequences are deterministic even when the
global interleaving is not.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Iterable, Sequence

__all__ = ["Divergence", "TraceEvent", "Tracer", "diff_traces"]


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One journaled effect.

    ``seq``    — global position in this trace (append order).
    ``actor``  — the frame/actor label that yielded the effect
                 (``name#seq`` — substrate-assigned, deterministic).
    ``effect`` — the effect kind ("charge", "get", "acquire", "wait",
                 "flush", "sleep").
    ``charge`` — the simulated ms for "charge"/"sleep" effects, None
                 otherwise.
    ``src``    — ``file.py:line`` of the innermost generator's yield
                 (the actual source line, through any ``yield from``
                 chain).
    """

    seq: int
    actor: str
    effect: str
    charge: "float | None"
    src: str

    def signature(self) -> tuple[str, "float | None", str]:
        """The substrate-independent projection compared by
        :func:`diff_traces` (actor labels differ across substrates)."""
        return (self.effect, self.charge, self.src)


def _source_of(gen: Any) -> str:
    """``file.py:line`` of the suspended yield, following the
    ``yield from`` delegation chain to the innermost generator."""
    seen = 0
    while seen < 64:  # defensive bound; real chains are a few deep
        sub = getattr(gen, "gi_yieldfrom", None)
        if sub is None or not hasattr(sub, "gi_frame"):
            break
        gen = sub
        seen += 1
    frame = getattr(gen, "gi_frame", None)
    if frame is None:
        return "?"
    fname = frame.f_code.co_filename.rsplit("/", 1)[-1]
    return f"{fname}:{frame.f_lineno}"


class Tracer:
    """Collects :class:`TraceEvent` records; attach as ``clock.tracer``.

    Thread-safe: on the thread substrate multiple actor threads record
    concurrently (the lock keeps ``seq`` consistent with list order)."""

    def __init__(self) -> None:
        self.events: list[TraceEvent] = []
        self._lock = threading.Lock()

    def record(self, actor: str, effect: tuple, gen: Any) -> None:
        """Substrate hook: journal one freshly generated effect."""
        kind = effect[0]
        charge = float(effect[1]) if kind in ("charge", "sleep") else None
        src = _source_of(gen)
        with self._lock:
            self.events.append(TraceEvent(
                seq=len(self.events), actor=actor, effect=kind,
                charge=charge, src=src))

    def __len__(self) -> int:
        return len(self.events)


@dataclasses.dataclass(frozen=True)
class Divergence:
    """The first point two traces disagree.

    ``index`` is the position within the compared sequence (global, or
    per-actor in ``by_actor`` mode — ``actor`` then names which
    actor's sequence split). ``left``/``right`` are the events at that
    position (None when one trace ended early)."""

    index: int
    left: "TraceEvent | None"
    right: "TraceEvent | None"
    actor: "str | None" = None

    def describe(self) -> str:
        where = (f"actor {self.actor!r} event {self.index}"
                 if self.actor is not None else f"event {self.index}")

        def side(e: "TraceEvent | None") -> str:
            if e is None:
                return "<trace ended>"
            charge = "" if e.charge is None else f" {e.charge:g}ms"
            return f"{e.effect}{charge} @ {e.src} [{e.actor}]"

        return (f"traces diverge at {where}: "
                f"{side(self.left)}  !=  {side(self.right)}")


def _events(trace: "Tracer | Iterable[TraceEvent]") -> Sequence[TraceEvent]:
    if isinstance(trace, Tracer):
        return trace.events
    return list(trace)


def _first_diff(a: Sequence[TraceEvent], b: Sequence[TraceEvent],
                actor: "str | None" = None) -> "Divergence | None":
    for i, (ea, eb) in enumerate(zip(a, b)):
        if ea.signature() != eb.signature():
            return Divergence(index=i, left=ea, right=eb, actor=actor)
    if len(a) != len(b):
        i = min(len(a), len(b))
        return Divergence(
            index=i,
            left=a[i] if i < len(a) else None,
            right=b[i] if i < len(b) else None,
            actor=actor)
    return None


def diff_traces(a: "Tracer | Iterable[TraceEvent]",
                b: "Tracer | Iterable[TraceEvent]",
                by_actor: bool = False) -> "Divergence | None":
    """First divergence between two effect traces, or None.

    Events compare by ``(effect, charge, src)`` — actor labels are
    reported, not compared, so an EventClock trace diffs cleanly
    against a VirtualClock one. Default mode compares the global
    journal order (exact for the deterministic substrates); ``by_actor``
    compares each actor's own effect sequence instead, pairing the
    k-th distinct actor of one trace with the k-th of the other (spawn
    order is deterministic even where thread interleaving is not) and
    reporting the divergence of the earliest-spawned actor that has
    one.
    """
    ea, eb = _events(a), _events(b)
    if not by_actor:
        return _first_diff(ea, eb)
    grouped_a = _by_actor(ea)
    grouped_b = _by_actor(eb)
    for (actor_a, seq_a), (actor_b, seq_b) in zip(grouped_a, grouped_b):
        label = actor_a if actor_a == actor_b else f"{actor_a}|{actor_b}"
        div = _first_diff(seq_a, seq_b, actor=label)
        if div is not None:
            return div
    if len(grouped_a) != len(grouped_b):
        longer = grouped_a if len(grouped_a) > len(grouped_b) else grouped_b
        actor, seq = longer[min(len(grouped_a), len(grouped_b))]
        return Divergence(
            index=0,
            left=seq[0] if longer is grouped_a else None,
            right=seq[0] if longer is grouped_b else None,
            actor=actor)
    return None


def _by_actor(events: Sequence[TraceEvent]) \
        -> list[tuple[str, list[TraceEvent]]]:
    """Per-actor sequences in first-appearance (spawn) order."""
    order: list[str] = []
    groups: dict[str, list[TraceEvent]] = {}
    for e in events:
        if e.actor not in groups:
            groups[e.actor] = []
            order.append(e.actor)
        groups[e.actor].append(e)
    return [(actor, groups[actor]) for actor in order]
