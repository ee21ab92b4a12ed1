"""Percent of the traced training steps' device time in gradient accumulation:
the device ms of the program's ``train.grad_accum`` spans (each microbatch's
fp32 cast and sum, and the mean) over those of its ``train.step`` spans."""
from portbench import spans as S


def read(rec):
    return S.device_share(S.recorded(rec, "train"), ("train.grad_accum",), ("train.step",))
