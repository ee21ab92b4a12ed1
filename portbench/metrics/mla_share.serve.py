"""Percent of the traced requests' decode-loop device time in latent
attention: the device ms of the program's ``mla`` spans (the whole mixer,
projections to output) over those of ``serve.prompt`` and ``serve.generate``."""
from portbench import spans as S


def read(rec):
    return S.device_share(S.recorded(rec, "serve"), ("mla",), ("serve.prompt", "serve.generate"))
