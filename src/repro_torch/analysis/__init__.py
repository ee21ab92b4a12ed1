"""DAG validation for the copied engine.

``dagcheck`` is a verbatim copy of ``repro.analysis.dagcheck`` (package
imports renamed); the lint and the determinism sanitizer are not copied.
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

__all__ = [
    "ConsistencyError",
    "CycleError",
    "ExpansionError",
    "check_compiled",
    "check_expansion",
    "check_fan_in_counters",
    "check_schedule_set",
    "verify_dag",
]
