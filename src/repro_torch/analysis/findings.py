"""Findings and the grandfathering baseline for ``repro_torch.analysis``.

A :class:`Finding` is one rule violation at one source location. The
baseline file (checked in, JSON) lists findings that predate the rule
and are tolerated; ``python -m repro_torch.analysis`` only fails on findings
NOT in the baseline, so a new rule can land before every historical
violation is fixed.

Baseline matching is keyed on ``(rule, path, snippet)`` — the stripped
source line text rather than the line *number* — so unrelated edits
above a grandfathered site don't resurrect it as "new".
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``path`` is repo-relative POSIX (stable across machines and CI);
    ``snippet`` is the stripped source line, the drift-tolerant half of
    the baseline key.
    """

    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "Finding":
        return cls(
            rule=obj["rule"],
            path=obj["path"],
            line=int(obj.get("line", 0)),
            col=int(obj.get("col", 0)),
            message=obj.get("message", ""),
            snippet=obj.get("snippet", ""),
        )

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def load_baseline(path: "str | Path | None") -> set[tuple[str, str, str]]:
    """Baseline keys from a JSON file; a missing path is an empty
    baseline (the shipped tree aims for zero grandfathered findings)."""
    if path is None:
        return set()
    p = Path(path)
    if not p.exists():
        return set()
    data = json.loads(p.read_text())
    return {Finding.from_json(f).key() for f in data.get("findings", ())}


def write_baseline(findings: Iterable[Finding], path: "str | Path") -> None:
    payload = {"findings": [f.to_json() for f in sorted(
        findings, key=lambda f: (f.path, f.line, f.rule))]}
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def new_findings(findings: Iterable[Finding],
                 baseline: set[tuple[str, str, str]]) -> list[Finding]:
    """Findings not grandfathered by ``baseline``."""
    return [f for f in findings if f.key() not in baseline]
