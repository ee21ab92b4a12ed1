"""The program's own spans (``repro_torch.tracing``), as the per-layer readers
read them.

The program records spans only while a torch profiler records, which in a
run is the traced stretches (``trace.Stretch``) alone. A reader returns None
where there is nothing to read: a run without ``--trace 1``, a program
without ``repro_torch.tracing``, or no span of the names it reads.
"""
from __future__ import annotations

import statistics


def recorded(rec: dict, kind: str) -> list[dict] | None:
    """The spans the traced stretches of ``rec`` recorded, if ``rec`` is of
    ``kind`` and traced; else None."""
    if rec["kind"] != kind or not rec.get("trace"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.spans() or None


def named(spans: list[dict], name: str) -> list[dict]:
    return [s for s in spans if s["name"] == name]


def device_share(spans: list[dict] | None, part: tuple[str, ...], whole: tuple[str, ...]
                 ) -> float | None:
    """Percent: the device ms of the spans named in ``part`` over those named
    in ``whole``."""
    if not spans:
        return None

    def ms(names):
        return sum(s["device_ms"] or 0.0 for s in spans if s["name"] in names)

    num, den = ms(part), ms(whole)
    if den <= 0 or not any(s["name"] in part for s in spans):
        return None
    return 100.0 * num / den


def slot_use(spans: list[dict] | None) -> float | None:
    """Percent: the assignments kept over the expert rows computed, summed over
    every ``moe.dispatch`` span that counted them."""
    counted = [s["attrs"] for s in named(spans or [], "moe.dispatch") if "rows" in s["attrs"]]
    rows = sum(a["rows"] for a in counted)
    return 100.0 * sum(a["kept"] for a in counted) / rows if rows else None


def covered_ns(lo: int, hi: int, intervals: list[tuple[int, int]]) -> int:
    """Nanoseconds of [lo, hi] that the union of ``intervals`` covers."""
    total, end = 0, lo
    for s, t in sorted(intervals):
        s, t = max(s, end), min(t, hi)
        if t > s:
            total += t - s
            end = t
    return total


def self_ms(job: dict, spans: list[dict]) -> float:
    """An ``engine.job`` span's duration less the union of its ``engine.task``
    spans, on whatever thread each ran, in ms."""
    tasks = [(s["start_ns"], s["end_ns"]) for s in spans
             if s["name"] == "engine.task" and s["job"] == job["id"]]
    lo, hi = job["start_ns"], job["end_ns"]
    return (hi - lo - covered_ns(lo, hi, tasks)) / 1e6


def engine_self_ms(spans: list[dict] | None) -> float | None:
    """The median over the traced jobs of each job's ``self_ms``."""
    jobs = named(spans or [], "engine.job")
    return statistics.median(self_ms(j, spans) for j in jobs) if jobs else None
