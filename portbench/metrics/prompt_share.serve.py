"""Percent of the traced requests' decode-loop device time spent ingesting
prompts: the device ms of the program's ``serve.prompt`` spans (the steps whose
logits are discarded) over those of ``serve.prompt`` and ``serve.generate``."""
from portbench import spans as S


def read(rec):
    return S.device_share(S.recorded(rec, "serve"), ("serve.prompt",),
                          ("serve.prompt", "serve.generate"))
