"""Static analysis + determinism sanitizer for the simulation substrate.

Three passes guard the effect-protocol contract (see README
"Determinism contract & static analysis"):

- :mod:`repro_torch.analysis.effects`    — AST lint encoding the contract as
  rules (wall-clock, unseeded randomness, ``*_g`` generator
  discipline, key hygiene).
- :mod:`repro_torch.analysis.dagcheck`   — unified DAG / expansion / schedule
  validation, invoked by ``DAG.__init__`` / ``DynamicDAG`` /
  ``compile_dag`` and callable standalone.
- :mod:`repro_torch.analysis.divergence` — opt-in runtime effect tracing plus
  ``diff_traces`` pinpointing the first divergent event between runs.

``python -m repro_torch.analysis --check src`` runs the static lint with the
checked-in baseline and exits non-zero on new findings (the CI
``static-analysis`` job).

This package is a *leaf*: it imports nothing from ``repro_torch.core``
(``dagcheck`` duck-types graphs), which is what lets the core modules
route their validation through it without an import cycle.
"""
from repro_torch.analysis.dagcheck import (
    ConsistencyError,
    CycleError,
    ExpansionError,
    check_compiled,
    check_expansion,
    check_fan_in_counters,
    check_schedule_set,
    verify_dag,
)
from repro_torch.analysis.divergence import Divergence, TraceEvent, Tracer, diff_traces
from repro_torch.analysis.effects import ALL_RULES, lint_file, lint_source, lint_tree
from repro_torch.analysis.findings import Finding, load_baseline, new_findings, write_baseline

__all__ = [
    "ALL_RULES",
    "ConsistencyError",
    "CycleError",
    "Divergence",
    "ExpansionError",
    "Finding",
    "TraceEvent",
    "Tracer",
    "check_compiled",
    "check_expansion",
    "check_fan_in_counters",
    "check_schedule_set",
    "diff_traces",
    "lint_file",
    "lint_source",
    "lint_tree",
    "load_baseline",
    "new_findings",
    "verify_dag",
    "write_baseline",
]
