"""The engine's own host milliseconds a serving job: the median over the traced
jobs of the program's ``engine.job`` span less the union of its ``engine.task``
spans (compile, schedules, the executors' walk, the report)."""
from portbench import spans as S


def read(rec):
    return S.engine_self_ms(S.recorded(rec, "serve"))
