"""Percent of the expert rows the MoE layers computed in the traced serving
jobs' decode steps that held a kept assignment routed to a held expert: the
``kept`` counts of the program's ``moe.dispatch`` spans over their ``rows``."""
from portbench import spans as S


def read(rec):
    return S.slot_use(S.recorded(rec, "serve"))
