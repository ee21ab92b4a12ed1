"""Percent of the traced training steps' device time in the optimizer: the
device ms of the program's ``train.optimizer`` spans (the schedule, the global
norm, the clip and AdamW's passes) over those of its ``train.step`` spans."""
from portbench import spans as S


def read(rec):
    return S.device_share(S.recorded(rec, "train"), ("train.optimizer",), ("train.step",))
