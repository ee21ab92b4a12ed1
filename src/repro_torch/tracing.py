"""Spans and counters inside the port, recorded only while a torch profiler records.

``span(name, device=..., **attrs)`` is a context manager around one piece of
work at a layer boundary. While a profiler records
(``torch.autograd._profiler_enabled()``, one call at entry) a span keeps its
name, its start and end on the host in nanoseconds, the span it opened inside
and the engine job it belongs to, and opens
``torch.profiler.record_function("repro_torch: <name>")``, so the profiler's
trace shows it above the kernels it launched. Given a CUDA ``device``, it also
records a ``torch.cuda.Event`` on that device's current stream at entry and
at exit; their interval is resolved only when ``spans()`` reads it, so a span
adds no synchronisation. Counters ride on spans as attributes (``set``); one
may be a device tensor, which ``spans()`` sums and reads back, so counting
adds no kernel to the work it counts.

While nothing records, ``span`` returns one shared object that does nothing,
and allocates nothing: no entry, no event, no counter (callers test
``.recording`` before attaching one).

Host stamps are ``time.time_ns()``, the clock of the profiler's events, so a
span and the device trace share one timeline.

Inside a CUDA graph's capture (``capture()``, on the capturing thread) spans
record whether or not a profiler records, into the ``Capture`` and not into
``spans()``: a device span's two events become nodes of the graph, timed at
every replay, and a tensor counter is the buffer the graph rewrites. Each
replay under a profiler then records those spans anew (``Capture.replayed``).

The parent of a span is the innermost open span on its thread, or, on a
thread with none open (the autograd engine's, the engine's actor threads),
the latest open span of any thread. The job of a span is the id of the
``engine.job`` span it lies in. ``python.gc`` spans, one per interpreter
collection with its ``collected`` count, come from a ``gc.callbacks`` hook
that the first span opened under a profiler installs; it records only while
a profiler records, and ``reset`` removes it.

Never hold a span open across a ``yield`` of the engine's effect generators:
on the event substrate, frames interleave on one thread.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Iterator

import torch

PREFIX = "repro_torch: "
JOB = "engine.job"
GC = "python.gc"


class _Off:
    """What ``span`` returns while nothing records."""

    recording = False

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


OFF = _Off()


class _Recorder:
    """Every span recorded since the last ``reset``. Each change is one call on
    a list, atomic under the interpreter lock, so a collection that records a
    span in the middle of another span's entry cannot deadlock on a lock."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.open: list[Span] = []       # open spans of every thread, by entry
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.gc_hooked = False

    def stack(self) -> list[Span]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


class Span:
    """One recorded span (see the module's docstring)."""

    recording = True
    __slots__ = ("name", "attrs", "device", "id", "parent", "job", "start_ns", "end_ns",
                 "events", "device_ms", "_range", "_rec", "_cap")

    def __init__(self, name: str, device: torch.device | None, attrs: dict[str, Any],
                 cap: Capture | None = None):
        self.name, self.attrs = name, attrs
        self.device = device if device is not None and device.type == "cuda" else None
        self.end_ns = None
        self.events = None
        self.device_ms = None
        self._cap = cap

    def __enter__(self) -> Span:
        if self._cap is not None:
            return self._cap.enter(self)
        rec = self._rec = _REC
        if not rec.gc_hooked:
            rec.gc_hooked = True
            gc.callbacks.append(_on_gc)
        stack = rec.stack()
        parent = stack[-1] if stack else (rec.open[-1] if rec.open else None)
        self.id = next(rec.ids)
        self.parent = parent.id if parent is not None else None
        self.job = self.id if self.name == JOB else (parent.job if parent is not None else None)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.start_ns = time.time_ns()  # lint: allow(REPRO001) — the profiler's clock
        stack.append(self)
        rec.open.append(self)
        rec.spans.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self._cap is not None:
            self._cap.stack.remove(self)
            return False
        self.end_ns = time.time_ns()  # lint: allow(REPRO001)
        self._range.__exit__(*exc)
        self._rec.stack().remove(self)
        self._rec.open.remove(self)
        return False

    def set(self, **attrs: Any) -> None:
        """Attach counters (numbers, or tensors that ``spans()`` sums) to the span."""
        self.attrs.update(attrs)

    def record(self) -> dict[str, Any]:
        device_ms = self.device_ms
        if device_ms is None and self.events is not None:
            self.events[1].synchronize()
            device_ms = self.events[0].elapsed_time(self.events[1])
        attrs = {k: v.sum().item() if isinstance(v, torch.Tensor) else v
                 for k, v in self.attrs.items()}
        return {"id": self.id, "name": self.name, "parent": self.parent, "job": self.job,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "device_ms": device_ms,
                "attrs": attrs}


class Capture:
    """The spans recorded while a CUDA graph was captured (``capture``), which
    every replay of the graph under a profiler records anew (``replayed``).

    A captured span of a CUDA device records its events as nodes of the graph
    (``external``), so each replay times it again; its tensor counters are
    the buffers the graph writes. A replay overwrites both: ``replayed``
    copies the counters right after the replay is launched (one
    concatenation per dtype, no synchronisation), and ``settle``, which must
    run before the graph replays again, reads the events of the last replay
    recorded."""

    def __init__(self) -> None:
        self.spans: list[Span] = []       # in the order they opened
        self.stack: list[Span] = []
        self.pending: list[Span] = []     # the last replay's spans, events unread

    def enter(self, sp: Span) -> Span:
        sp.parent = self.stack[-1] if self.stack else None
        if sp.device is not None:
            sp.events = (torch.cuda.Event(enable_timing=True, external=True),
                         torch.cuda.Event(enable_timing=True, external=True))
            sp.events[0].record(torch.cuda.current_stream(sp.device))
        self.stack.append(sp)
        self.spans.append(sp)
        return sp

    def replayed(self, start_ns: int, end_ns: int) -> None:
        """Under a profiler, record every captured span for the replay just
        launched between host stamps ``start_ns`` and ``end_ns``: nested as
        captured, the outermost under the span open on this thread."""
        if not torch.autograd._profiler_enabled():
            return
        rec = _REC
        by_dtype: dict[torch.dtype, list[tuple[int, str, torch.Tensor]]] = defaultdict(list)
        for i, sp in enumerate(self.spans):
            for k, v in sp.attrs.items():
                if isinstance(v, torch.Tensor):
                    by_dtype[v.dtype].append((i, k, v))
        copies = {}
        for group in by_dtype.values():
            flat, at = torch.cat([v.reshape(-1) for _, _, v in group]), 0
            for i, k, v in group:
                copies[i, k] = flat[at:at + v.numel()]
                at += v.numel()
        stack = rec.stack()
        outer = stack[-1] if stack else (rec.open[-1] if rec.open else None)
        made: dict[int, Span] = {}
        for i, sp in enumerate(self.spans):
            r = Span(sp.name, None, {k: copies.get((i, k), v) for k, v in sp.attrs.items()})
            parent = made[id(sp.parent)] if sp.parent is not None else outer
            r.id = next(rec.ids)
            r.parent = parent.id if parent is not None else None
            r.job = parent.job if parent is not None else None
            r.start_ns, r.end_ns, r.events = start_ns, end_ns, sp.events
            made[id(sp)] = r
            rec.spans.append(r)
        self.pending = [r for r in made.values() if r.events is not None]

    def settle(self) -> None:
        """Read the device ms of the last replay recorded, waiting for it."""
        for r in self.pending:
            r.events[1].synchronize()
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
        self.pending = []


_CAPTURING = threading.local()


@contextlib.contextmanager
def capture() -> Iterator[Capture]:
    """While a CUDA graph is captured on this thread: the spans recorded
    meanwhile go into the ``Capture`` yielded."""
    cap = _CAPTURING.cap = Capture()
    try:
        yield cap
    finally:
        _CAPTURING.cap = None


def span(name: str, *, device: torch.device | None = None, **attrs: Any) -> Span | _Off:
    """A span named ``name`` with attributes ``attrs``; with a CUDA ``device``
    it also takes the span's time on that device's timeline. ``OFF`` unless a
    profiler records or a graph is captured on this thread (``capture``)."""
    cap = getattr(_CAPTURING, "cap", None)
    if cap is not None:
        return Span(name, device, attrs, cap)
    if not torch.autograd._profiler_enabled():
        return OFF
    return Span(name, device, attrs)


def traced(name: str) -> Callable:
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args: Any, **kwargs: Any) -> Any:
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def countable(x: torch.Tensor) -> bool:
    """Whether a counter over ``x`` can be read back: a plain tensor with
    data, not a dry run's meta or fake tensor, nor a DTensor."""
    return type(x) is torch.Tensor and x.device.type != "meta"


def _on_gc(phase: str, info: dict[str, int]) -> None:
    local = _REC.local
    if phase == "start":
        if torch.autograd._profiler_enabled():
            local.gc_span = Span(GC, None, {"generation": info["generation"]}).__enter__()
    else:
        sp = getattr(local, "gc_span", None)
        if sp is not None:
            local.gc_span = None
            sp.set(collected=info["collected"])
            sp.__exit__(None, None, None)


def spans() -> list[dict[str, Any]]:
    """Every closed span since the last ``reset``, in the order they opened,
    as plain dicts: ``id``, ``name``, ``parent`` and ``job`` (ids or None),
    ``start_ns`` and ``end_ns`` (``time.time_ns()``), ``device_ms``
    (None without a CUDA device) and ``attrs`` (counters read back, a tensor
    as its sum)."""
    return [s.record() for s in list(_REC.spans) if s.end_ns is not None]


def reset() -> None:
    """Forget every span and remove the collection hook."""
    global _REC
    if _REC.gc_hooked and _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    _REC = _Recorder()
