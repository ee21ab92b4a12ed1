"""A profiled stretch of a run: the card's busy time, its kernels by name, and
its idle gaps by what the host was doing.

``Stretch`` wraps a few steps or jobs in ``torch.profiler`` and reads the
raw events once it closes. Busy time is the union of the card's intervals
(kernels, copies, fills). Recording the host's operations slows the host,
so the card's busy share is read from a stretch that records the card
alone, and the idle gaps from a second one that records both: a gap is a
stretch between the card's intervals, named after the innermost host
operation running at its middle, on any thread.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict

import torch

NAME_CHARS = 120


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


class Stretch:
    def __init__(self, host: bool):
        self.host = host

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if self.host or not torch.cuda.is_available() else []
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def read(self) -> dict:
        """``busy_s``, ``window_s``, ``kernel_s`` (name -> seconds, every
        device activity), ``device_ops`` and, where the host was recorded,
        ``idle_gaps`` (the ten largest, [name, seconds]), ``kernels`` (count
        of device activities)."""
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append(rec)
            elif e.duration_ns() > 0:
                host.append(rec)
        kernel_s: dict[str, float] = defaultdict(float)
        for s, t, name in device:
            kernel_s[name] += (t - s) / 1e9
        merged = []
        for s, t, _ in sorted(device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy_ns = sum(t - s for s, t in merged)
        lo = min((s for s, _, _ in host + device), default=0)
        hi = max((t for _, t, _ in host + device), default=0)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        return {"busy_s": busy_ns / 1e9, "window_s": self.wall_s, "kernels": len(device),
                "kernel_s": dict(kernel_s),
                "device_ops": top(kernel_s),
                "idle_gaps": top(_gaps_by_host(gaps, host)) if self.host else None}


def top(by_name: dict[str, float], n: int = 10) -> list[list]:
    return [[_short(k), v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def _gaps_by_host(gaps: list[tuple[int, int]], host: list[tuple[int, int, str]]
                  ) -> dict[str, float]:
    """Seconds of idle gaps by the innermost (latest started) host operation
    running at each gap's middle; "(no host operation)" where none runs."""
    out: dict[str, float] = defaultdict(float)
    events = sorted(host)
    running: list[tuple[int, int, str]] = []        # heap on -start
    i = 0
    for s, t in sorted(gaps):
        mid = (s + t) // 2
        while i < len(events) and events[i][0] <= mid:
            heapq.heappush(running, (-events[i][0], events[i][1], events[i][2]))
            i += 1
        while running and running[0][1] < mid:
            heapq.heappop(running)
        name = running[0][2] if running else "(no host operation)"
        out[name] += (t - s) / 1e9
    return out


def seconds_of(kernel_s: dict[str, float], *prefixes: str) -> float:
    """Device seconds of the kernels whose bare name, without a ``void ``
    return type or an anonymous namespace, starts with one of ``prefixes``."""
    total = 0.0
    for name, sec in kernel_s.items():
        bare = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
        if bare.startswith(prefixes):
            total += sec
    return total
